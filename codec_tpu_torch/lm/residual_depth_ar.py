"""residual_depth_ar (Type C) — c0 from a linear head off the backbone
hidden; c1..c_{N-1} from a small Llama-style depth transformer run over the
growing prefix [h_in, embd(c0), embd(c1), ...]. Counterpart of
codec_tpu/lm/residual_depth_ar.py's host path.

Reference: src/lm/residual_depth_ar.cpp. Variants handled by flags:
  - shared in_proj (CSM / Qwen3-TTS): prefix rows in hidden_dim space,
    one 2D in_proj (or identity) applied to every row.
  - per-pos in_proj (Moshi): prefix rows already in depth_hidden space;
    position p adds in_proj[p] @ h_in (+ bias[p]); pos 0 is
    text_embd[text_token].
  - depth_emits_c0: all N codebooks come from the depth decoder.
  - heads: per-cb 2D `lm.depth.heads_{i}` or one 3D `lm.depth.heads`
    sliced per position; optional per-head pre-norm.
  - optional qk-norm (Qwen3), RoPE NEOX/NORMAL or none, llama3 freq
    factors.

Each depth step re-runs the full prefix (T <= n_codebook rows), as the
reference's CPU path does. The prefix rows live on the device in a
[n_codebook, row_dim] buffer: a pushed code writes its embedding row, and
row k is read only by steps after it. The on-device frame loop
(`fused_frame`) and the LFM2 compose table are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import attn, norms, rope
from .base import CodecLM, LmError, LmInfo, LmState, read_common_info, register_kind


def _per_pos_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w: [out, in] shared or [N, out, in] per-pos; x: [T, in] → [T, out]."""
    if w.ndim == 2:
        return F.linear(x, w)
    return torch.einsum("ti,toi->to", x, w[: x.shape[0]])


@register_kind("residual_depth_ar")
class ResidualDepthArLM(CodecLM):
    def _load(self, r: GGUFReader) -> LmInfo:
        info = read_common_info(r, "residual_depth_ar")
        dev = self.device

        def g(name):
            return torch.from_numpy(np.array(r.get(name), np.float32)).to(dev)

        def gopt(name):
            return g(name) if r.has_tensor(name) else None

        self.depth_layers = r.get_i32("codec.lm.residual.depth_layers", 0)
        self.depth_hidden = r.get_i32("codec.lm.residual.depth_hidden", 0)
        self.n_heads = r.get_i32("codec.lm.residual.depth_n_heads", 0)
        self.n_kv_heads = r.get_i32("codec.lm.residual.depth_n_kv_heads", 0)
        self.head_dim = r.get_i32("codec.lm.residual.depth_head_dim", 0)
        self.rope_theta = r.get_f32("codec.lm.residual.depth_rope_theta", 10000.0)
        self.rms_eps = r.get_f32("codec.lm.residual.depth_rms_norm_eps", 1e-5)
        self.has_in_proj = r.get_bool("codec.lm.residual.depth_has_in_proj", False)
        self.has_qk_norm = r.get_bool("codec.lm.residual.depth_has_qk_norm", False)
        self.has_output_norm = r.get_bool("codec.lm.residual.depth_has_output_norm", True)
        self.use_rope = r.get_bool("codec.lm.residual.depth_use_rope", True)
        self.in_proj_per_pos = r.get_bool("codec.lm.residual.depth_in_proj_per_pos", False)
        self.has_pre_head_norm = r.get_bool("codec.lm.residual.depth_has_pre_head_norm", False)
        self.depth_emits_c0 = r.get_bool("codec.lm.residual.depth_emits_c0", False)
        self.rope_interleaved = r.get_bool("codec.lm.residual.depth_rope_interleaved", False)
        modality = r.get_str("codec.lm.residual.c0_input_modality", "audio")
        self.c0_is_text = modality == "text"
        self.c0_is_none = modality == "none"
        if self.c0_is_text or self.c0_is_none:
            self.depth_emits_c0 = True
        if r.has_tensor("lm.compose.audio_embd.weight"):
            raise LmError("residual_depth_ar: the LFM2 compose table "
                          "(lm.compose.audio_embd) is not ported yet")

        # audio_embds[i] embeds c_i (prefix row i+1 uses table i; compose
        # sums all N); the last table may be absent (Moshi)
        self.audio_embds: List[Optional[torch.Tensor]] = []
        for i in range(info.n_codebook):
            t = gopt(f"lm.depth.audio_embd_{i}.weight")
            if t is None:
                t = gopt(f"lm.audio_embd_{i}.weight")
            self.audio_embds.append(t)
        self.text_embd = g("lm.depth.text_embd.weight") if self.c0_is_text else None
        self.c0_head = g("lm.c0_head.weight") if not self.depth_emits_c0 else None
        self.flex_heads = gopt("lm.depth.heads.weight")              # [N, V, H]
        self.depth_heads: List[torch.Tensor] = []
        self.heads_pre_norm: List[Optional[torch.Tensor]] = []
        n_depth_heads = info.n_codebook if self.depth_emits_c0 else info.n_codebook - 1
        if self.flex_heads is None:
            for i in range(max(0, n_depth_heads)):
                self.depth_heads.append(g(f"lm.depth.heads_{i}.weight"))
                self.heads_pre_norm.append(gopt(f"lm.depth.heads_{i}_norm.weight"))
        self.in_proj = (g("lm.depth.in_proj.weight")
                        if self.has_in_proj or self.in_proj_per_pos else None)
        if self.in_proj is not None and self.in_proj.ndim == 3:
            # the reference infers per-pos from in_proj->ne[2] > 1 at init
            self.in_proj_per_pos = True
        self.in_proj_bias = gopt("lm.depth.in_proj.bias")
        self.output_norm = (g("lm.depth.output_norm.weight")
                            if self.has_output_norm else None)
        self.freq_factors = gopt("lm.depth.rope_freq_factors")

        self.layers: List[Dict[str, Any]] = []
        for li in range(self.depth_layers):
            p = f"lm.depth.blk_{li}"
            lw = {k: g(f"{p}.{n}.weight") for k, n in (
                ("attn_norm", "attn_norm"), ("q", "q"), ("k", "k"), ("v", "v"),
                ("o", "o"), ("ffn_norm", "ffn_norm"), ("gate", "ffn_gate"),
                ("up", "ffn_up"), ("down", "ffn_down"))}
            if self.has_qk_norm:
                lw["q_norm"] = g(f"{p}.q_norm.weight")
                lw["k_norm"] = g(f"{p}.k_norm.weight")
            self.layers.append(lw)
        return info

    # -- depth forward -----------------------------------------------------
    def _depth_trunk(self, prefix: torch.Tensor, h_in: torch.Tensor) -> torch.Tensor:
        """prefix [T, row_dim], h_in [hidden] → hidden rows [T, depth_hidden]
        after the output norm (causal: row k depends on rows 0..k only)."""
        t = prefix.shape[0]
        if not self.in_proj_per_pos:
            x = _per_pos_linear(self.in_proj, prefix) if self.in_proj is not None else prefix
            if self.in_proj is not None and self.in_proj_bias is not None:
                x = x + self.in_proj_bias
        else:
            x = prefix
            if self.in_proj is not None:
                proj = torch.einsum("i,toi->to", h_in, self.in_proj[:t])
                if self.in_proj_bias is not None:
                    b = self.in_proj_bias
                    proj = proj + (b[:t] if b.ndim == 2 else b)
                x = x + proj

        mask = attn.attn_mask(t, t, causal=True, device=prefix.device)
        rope_cs = None
        if self.use_rope:
            rope_cs = rope.rope_cos_sin(torch.arange(t, device=prefix.device),
                                        self.head_dim, self.rope_theta,
                                        freq_factors=self.freq_factors)
        nh, nkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        xb = x
        for lw in self.layers:
            h = norms.rms_norm(xb, lw["attn_norm"], self.rms_eps)
            q = _per_pos_linear(lw["q"], h).reshape(t, nh, hd).transpose(0, 1)[None]
            k = _per_pos_linear(lw["k"], h).reshape(t, nkv, hd).transpose(0, 1)[None]
            v = _per_pos_linear(lw["v"], h).reshape(t, nkv, hd).transpose(0, 1)[None]
            if self.has_qk_norm:
                q = norms.rms_norm(q, lw["q_norm"], self.rms_eps)
                k = norms.rms_norm(k, lw["k_norm"], self.rms_eps)
            if rope_cs is not None:
                q = rope.rotate(q, *rope_cs, neox=not self.rope_interleaved)
                k = rope.rotate(k, *rope_cs, neox=not self.rope_interleaved)
            if nkv != nh:
                k = torch.repeat_interleave(k, nh // nkv, dim=1)
                v = torch.repeat_interleave(v, nh // nkv, dim=1)
            ctx = attn.sdpa(q, k, v, mask=mask)
            ctx = ctx[0].transpose(0, 1).reshape(t, nh * hd)
            xb = xb + _per_pos_linear(lw["o"], ctx)
            m2 = norms.rms_norm(xb, lw["ffn_norm"], self.rms_eps)
            gate = F.silu(_per_pos_linear(lw["gate"], m2))
            up = _per_pos_linear(lw["up"], m2)
            xb = xb + _per_pos_linear(lw["down"], gate * up)
        if self.output_norm is not None:
            xb = norms.rms_norm(xb, self.output_norm, self.rms_eps)
        return xb

    def _depth_forward(self, prefix: torch.Tensor, h_in: torch.Tensor,
                       head_idx: int) -> torch.Tensor:
        """prefix [T, row_dim], h_in [hidden] → logits [V_head]
        (reference: rda_build_depth_step)."""
        last = self._depth_trunk(prefix, h_in)[prefix.shape[0] - 1]
        if self.has_pre_head_norm and self.heads_pre_norm[head_idx] is not None:
            last = norms.rms_norm(last, self.heads_pre_norm[head_idx], self.rms_eps)
        head = (self.flex_heads[head_idx] if self.flex_heads is not None
                else self.depth_heads[head_idx])
        return head @ last

    # -- step machine hooks ------------------------------------------------
    def _begin(self, state: LmState, h: np.ndarray) -> None:
        h_dev = torch.from_numpy(np.array(h, np.float32)).to(self.device)
        prefix = torch.zeros((self.info.n_codebook, self.info.audio_embed_dim),
                             dtype=torch.float32, device=self.device)
        if not self.in_proj_per_pos:
            prefix[0, : self.info.hidden_dim] = h_dev
        elif self.c0_is_text and state.text_context is not None:
            prefix[0] = self.text_embd[state.text_context]
        # c0_is_none: row 0 stays zero
        state.kind_state["h"] = h_dev
        state.kind_state["prefix"] = prefix

    def _logits(self, state: LmState, k: int) -> np.ndarray:
        h = state.kind_state["h"]
        if k == 0 and not self.depth_emits_c0:
            return (self.c0_head @ h).cpu().numpy()
        if self.in_proj_per_pos and self.c0_is_text and state.text_context is None:
            raise LmError("c0_input_modality=text: call set_text_context first")
        head_idx = k if self.depth_emits_c0 else k - 1
        prefix = state.kind_state["prefix"][: k + 1]
        return self._depth_forward(prefix, h, head_idx).cpu().numpy()

    def _pushed(self, state: LmState, k: int, code: int) -> None:
        if k + 1 < self.info.n_codebook:
            state.kind_state["prefix"][k + 1] = self.audio_embds[k][code]

    # -- embeddings --------------------------------------------------------
    def audio_embd(self, cb_idx: int, code: int) -> np.ndarray:
        embd = self.audio_embds[cb_idx]
        if not (0 <= code < embd.shape[0]):
            raise LmError(f"code {code} out of range")
        return embd[code].cpu().numpy()

    def compose_audio_embd(self, codes: Sequence[int]) -> np.ndarray:
        """Sum of the codes' embedding rows (-1 skips a codebook): one
        gather and one copy to the host, then the reference's f32 sum in
        codebook order."""
        out = np.zeros((self.info.audio_embed_dim,), np.float32)
        rows = [self.audio_embds[i][c] for i, c in enumerate(codes)
                if c >= 0 and i < len(self.audio_embds)
                and self.audio_embds[i] is not None]
        if rows:
            for g in torch.stack(rows).cpu().numpy():
                out += g
        return out
