"""residual_depth_ar (Type C) — c0 from a linear head off the backbone
hidden; c1..c_{N-1} from a small Llama-style depth transformer run over the
growing prefix [h_in, embd(c0), embd(c1), ...]. Counterpart of
codec_tpu/lm/residual_depth_ar.py's host path.

Reference: src/lm/residual_depth_ar.cpp. Variants handled by flags:
  - shared in_proj (CSM / Qwen3-TTS): prefix rows in hidden_dim space,
    one 2D in_proj (or identity) applied to every row.
  - per-pos in_proj (Moshi / LFM2-Audio): prefix rows already in
    depth_hidden space; position p adds in_proj[p] @ h_in (+ bias[p]);
    pos 0 is text_embd[text_token] (Moshi) or zero (LFM2).
  - depth_emits_c0: all N codebooks come from the depth decoder.
  - heads: per-cb 2D `lm.depth.heads_{i}` or one 3D `lm.depth.heads`
    sliced per position; optional per-head pre-norm (LFM2).
  - a backbone-side compose table (LFM2-Audio, MOSS-TTS-Realtime):
    `lm.compose.audio_embd` [n_cb · stride, hidden]; the next backbone
    input sums its rows codes[i] + i · stride instead of the depth tables.
  - optional qk-norm (Qwen3), RoPE NEOX/NORMAL or none, llama3 freq
    factors.

Each depth step of the host step machine re-runs the growing prefix (T <=
n_codebook rows), as the reference's CPU path does. The prefix rows live
on the device in a [n_codebook, row_dim] buffer: a pushed code writes its
embedding row, and row k is read only by steps after it.

The on-device frame (`_build_frame`, codec_tpu's `fused_frame` and
`fused_frame_batched` in one: B streams as one batch of tensors) runs a
whole frame with in-graph sampling (ops/sample.py): the c0 head,
then one full-prefix depth trunk over the fixed [n_codebook, row_dim]
buffer per depth step (causal masking makes the unfilled rows inert), as
codec_tpu's frame does. The fixed shapes and the absence of host reads are
what let lm/fused_gen.py capture it in a CUDA graph. Its repetition-penalty
form (`_build_frame(rep=)`, codec_tpu's `_build_frame_rp`) carries a
per-codebook history for the realtime-streaming chunk.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import attn, norms, rope
from ..ops.sample import (apply_repetition_penalty, mask_outside_range,
                          sample_logits, sample_logits_dyn,
                          seen_mask_from_ring)
from .base import CodecLM, LmError, LmInfo, LmState, read_common_info, register_kind


def _per_pos_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w: [out, in] shared or [N, out, in] per-pos; x: [..., T, in] →
    [..., T, out]."""
    if w.ndim == 2:
        return F.linear(x, w)
    return torch.einsum("...ti,toi->...to", x, w[: x.shape[-2]])


class FusedConsts(NamedTuple):
    """What the on-device frame reads besides the layers: the heads
    stacked and vocab-padded, each head's vocab, the per-head pre-norms
    (None where a head has none), the embedding tables of the codes fed
    back into the prefix (stacked, padded), the widths of the c0 and depth
    logits, and the fixed prefix buffer's causal mask and RoPE."""
    n: int                          # codebooks
    off: int                        # 1 when c0 comes from the c0 head
    n_dh: int                       # depth heads
    heads: Optional[torch.Tensor]   # [n_dh, V, depth_hidden]
    sizes: List[int]
    pre_norms: List[Optional[torch.Tensor]]
    tabs: Optional[torch.Tensor]    # [n - 1 - off, rows, row_dim]
    c0_width: int
    head_width: int
    mask: torch.Tensor              # [n, n]
    rope_cs: Optional[tuple]


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
        # the backbone-side compose table (LFM2-Audio, MOSS-TTS-Realtime):
        # code c of codebook i is row c + i * stride
        self.compose_table = gopt("lm.compose.audio_embd.weight")
        self.compose_stride = r.get_i32(
            "codec.lm.compose.codebook_stride",
            r.get_i32("codec.lm.residual.compose_codebook_stride", 0))
        self._fused_consts_cache: Optional[FusedConsts] = None
        return info

    # -- depth forward -----------------------------------------------------
    def _depth_trunk(self, prefix: torch.Tensor, h_in: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     rope_cs: Optional[tuple] = None) -> torch.Tensor:
        """prefix [..., T, row_dim], h_in [..., hidden] → hidden rows [..., T,
        depth_hidden] after the output norm (causal: row k depends on rows
        0..k only). mask and rope_cs: the T rows' causal mask and RoPE
        angles, built here when not given."""
        lead, t = prefix.shape[:-2], prefix.shape[-2]
        prefix = prefix.reshape(-1, t, prefix.shape[-1])
        b = prefix.shape[0]
        if not self.in_proj_per_pos:
            x = _per_pos_linear(self.in_proj, prefix) if self.in_proj is not None else prefix
            if self.in_proj is not None and self.in_proj_bias is not None:
                x = x + self.in_proj_bias
        else:
            x = prefix
            if self.in_proj is not None:
                proj = torch.einsum("bi,toi->bto", h_in.reshape(b, -1),
                                    self.in_proj[:t])
                if self.in_proj_bias is not None:
                    bias = self.in_proj_bias
                    proj = proj + (bias[:t] if bias.ndim == 2 else bias)
                x = x + proj

        if mask is None:
            mask = attn.attn_mask(t, t, causal=True, device=prefix.device)
        if rope_cs is None and self.use_rope:
            rope_cs = rope.rope_cos_sin(torch.arange(t, device=prefix.device),
                                        self.head_dim, self.rope_theta,
                                        freq_factors=self.freq_factors)
        nh, nkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        xb = x
        for lw in self.layers:
            h = norms.rms_norm(xb, lw["attn_norm"], self.rms_eps)
            q = _per_pos_linear(lw["q"], h).reshape(b, t, nh, hd).transpose(1, 2)
            k = _per_pos_linear(lw["k"], h).reshape(b, t, nkv, hd).transpose(1, 2)
            v = _per_pos_linear(lw["v"], h).reshape(b, t, nkv, hd).transpose(1, 2)
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
            ctx = ctx.transpose(1, 2).reshape(b, t, nh * hd)
            xb = xb + _per_pos_linear(lw["o"], ctx)
            m2 = norms.rms_norm(xb, lw["ffn_norm"], self.rms_eps)
            gate = F.silu(_per_pos_linear(lw["gate"], m2))
            up = _per_pos_linear(lw["up"], m2)
            xb = xb + _per_pos_linear(lw["down"], gate * up)
        if self.output_norm is not None:
            xb = norms.rms_norm(xb, self.output_norm, self.rms_eps)
        return xb.reshape(*lead, t, xb.shape[-1])

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

    # -- fused on-device frame ----------------------------------------------
    def _fused_consts(self) -> FusedConsts:
        """The frame's stacked tables (built once; see FusedConsts)."""
        c = self._fused_consts_cache
        if c is not None:
            return c
        info = self.info
        n = info.n_codebook
        off = 0 if self.depth_emits_c0 else 1
        n_dh = n - off
        if self.flex_heads is not None:
            heads = self.flex_heads
        elif self.depth_heads:
            vmax = max(int(w.shape[0]) for w in self.depth_heads)
            heads = torch.stack([F.pad(w, (0, 0, 0, vmax - w.shape[0]))
                                 for w in self.depth_heads])
        else:
            heads = None
        pre_norms = [None] * n_dh
        if self.has_pre_head_norm and self.heads_pre_norm:
            pre_norms = list(self.heads_pre_norm)
        # code i (off <= i <= n - 2) is embedded into prefix row i + 1
        tabs = [self.audio_embds[i] for i in range(off, n - 1)]
        if any(t is None for t in tabs):
            raise LmError("fused frame: missing depth audio_embd table")
        tabs_s = None
        if tabs:
            rmax = max(int(t.shape[0]) for t in tabs)
            tabs_s = torch.stack([F.pad(t, (0, 0, 0, rmax - t.shape[0]))
                                  for t in tabs])
        dev = self.device
        rope_cs = None
        if self.use_rope:
            rope_cs = rope.rope_cos_sin(torch.arange(n, device=dev),
                                        self.head_dim, self.rope_theta,
                                        freq_factors=self.freq_factors)
        c = FusedConsts(
            n=n, off=off, n_dh=n_dh, heads=heads,
            sizes=list(info.codebook_sizes[off:]), pre_norms=pre_norms,
            tabs=tabs_s,
            c0_width=int(self.c0_head.shape[0]) if self.c0_head is not None else 0,
            head_width=int(heads.shape[1]) if heads is not None else 0,
            mask=attn.attn_mask(n, n, causal=True, device=dev),
            rope_cs=rope_cs)
        self._fused_consts_cache = c
        return c

    def noise_width(self) -> int:
        """The last dim of the frame's Gumbel noise [..., n_codebook, W]:
        the widest logits row (codebook k reads the first width of its
        logits)."""
        c = self._fused_consts()
        return max(c.c0_width, c.head_width)

    def _build_frame(self, chain, cb0_range=None, rep=None) -> Callable:
        """The batched frame for a sampler chain: frame(h [B, hidden] f32,
        noise [B, n_codebook, noise_width()] f32, text_ctx [B] int64,
        chains=None) → codes [B, n_codebook] int64, on the device with no
        host read and no shape that depends on a value.

        `chain` is (temperature, top_k, top_p, min_p), or None for the
        chain as data: then `chains` [B, 4] gives each stream's row
        (`sample_logits_dyn`). `cb0_range=(start, end, *extra)` masks the
        c0 logits to the host RangeConstraint's set. `rep=(penalty,
        window)` builds the repetition-penalized frame instead
        (`_build_frame_rp`)."""
        if rep is not None:
            return self._build_frame_rp(chain, rep)
        return self._frame_fn(chain, cb0_range)

    def _frame_fn(self, chain, cb0_range=None, penalty: float = 1.0) -> Callable:
        """_build_frame's frame; with `penalty` != 1 it takes `seen` [n_cb,
        max vocab] bool too and penalizes each codebook's seen ids on the
        raw logits before the chain (ops/sample.apply_repetition_penalty)."""
        c = self._fused_consts()
        info = self.info
        row_dim, hidden = info.audio_embed_dim, info.hidden_dim
        if chain is None:
            def draw(lg, g, cv):
                return sample_logits_dyn(lg, g, cv)
        else:
            def draw(lg, g, cv):
                return sample_logits(lg, g, temperature=chain[0],
                                     top_k=chain[1], top_p=chain[2],
                                     min_p=chain[3])

        def sample(lg, g, cv, seen, k):
            if seen is not None:
                lg = apply_repetition_penalty(lg, seen[k, : lg.shape[-1]],
                                              penalty)
            return draw(lg, g, cv)
        # the padded tail of each head's logits: -inf
        valid = [None if size >= c.head_width else
                 torch.arange(c.head_width, device=self.device) < size
                 for size in c.sizes]

        def frame(h, noise, text_ctx, chains=None, seen=None):
            b = h.shape[0]
            buf = h.new_zeros((b, c.n, row_dim))
            if not self.in_proj_per_pos:
                buf[:, 0, :hidden] = h
            elif self.c0_is_text:
                buf[:, 0] = self.text_embd[text_ctx]
            # c0_is_none: row 0 stays zero
            codes = []
            if not self.depth_emits_c0:
                lg0 = F.linear(h, self.c0_head)
                if cb0_range is not None:
                    lg0 = mask_outside_range(lg0, cb0_range[0], cb0_range[1],
                                             cb0_range[2:])
                c0 = sample(lg0, noise[:, 0, :c.c0_width], chains, seen, 0)
                codes.append(c0)
                if c.n > 1:
                    buf[:, 1] = self.audio_embds[0][c0]
            for i in range(c.n_dh):
                x = self._depth_trunk(buf, h, c.mask, c.rope_cs)
                row = x[:, i + c.off]
                if c.pre_norms[i] is not None:
                    row = norms.rms_norm(row, c.pre_norms[i], self.rms_eps)
                lg = F.linear(row, c.heads[i])
                if valid[i] is not None:
                    lg = torch.where(valid[i], lg, float("-inf"))
                code = sample(lg, noise[:, i + c.off, :c.head_width], chains,
                              seen, i + c.off)
                codes.append(code)
                if c.tabs is not None and i < c.n_dh - 1:
                    buf[:, i + c.off + 1] = c.tabs[i][code]
            return torch.stack(codes, dim=1)

        return frame

    def _build_frame_rp(self, chain, rep) -> Callable:
        """The repetition-penalized frame of the realtime-streaming chunk
        (codec_tpu's `_build_frame_rp`), one stream: frame(h [1, hidden],
        noise [1, n_codebook, W], text_ctx [1], hist) → (codes [1,
        n_codebook], hist'). `rep = (penalty, window)`. For window > 0 hist
        is (rings [n_codebook, window] int, ptr [1] int64): each codebook's
        last `window` codes in a ring whose empty slots hold -1, frame f
        writing slot f % window; for window < 0 a seen mask [n_codebook,
        max vocab] bool of every code so far (ops/sample.py and
        fused_gen.init_rep_hist make both). The penalty hits the raw logits
        before the chain only when temperature > 0, penalty != 1 and window
        != 0, the host SamplerChain's rule; the history advances either
        way, so one state shape serves greedy and sampled runs. As in
        codec_tpu, an empty ring slot marks id vocab - 1 as seen
        (seen_mask_from_ring)."""
        pen, window = float(rep[0]), int(rep[1])
        vmax = max(self.info.codebook_sizes)
        use_pen = chain[0] > 0.0 and pen != 1.0 and window != 0
        frame = self._frame_fn(chain, penalty=pen)

        def frame_rp(h, noise, text_ctx, hist):
            if window > 0:
                rings, ptr = hist
                seen = seen_mask_from_ring(rings, vmax) if use_pen else None
            else:
                seen = hist if use_pen else None
            codes = frame(h, noise, text_ctx, seen=seen)
            row = codes[0]
            if window > 0:
                slot = torch.arange(window, device=rings.device) == ptr % window
                rings = torch.where(slot[None, :], row[:, None].to(rings.dtype),
                                    rings)
                return codes, (rings, ptr + 1)
            hit = torch.arange(hist.shape[-1], device=hist.device) == row[:, None]
            return codes, hist | hit

        return frame_rp

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
        """The next backbone input of a frame: the compose table's rows
        codes[i] + i · stride summed (a file with the table; a zero row
        when no code is live), else the depth tables' rows of the codes
        summed. A negative code skips its codebook. One gather and one copy
        to the host, then codec_tpu's f32 sums: the table's rows by
        `rows.sum(axis=0)`, the depth tables' in codebook order."""
        if self.compose_table is not None:
            idx = [int(c) + i * self.compose_stride
                   for i, c in enumerate(codes) if c >= 0]
            if not idx:
                return np.zeros((self.info.compose_audio_embed_dim,),
                                np.float32)
            rows = self.compose_table[torch.as_tensor(
                idx, device=self.compose_table.device)]
            return rows.cpu().numpy().sum(axis=0)
        out = np.zeros((self.info.audio_embed_dim,), np.float32)
        rows = [self.audio_embds[i][c] for i, c in enumerate(codes)
                if c >= 0 and i < len(self.audio_embds)
                and self.audio_embds[i] is not None]
        if rows:
            for g in torch.stack(rows).cpu().numpy():
                out += g
        return out

    def compose_embd_fn(self) -> Callable:
        """The device form of compose_audio_embd for the generation chunk
        (lm/fused_gen.py): codes [B, n_codebook] int64 → [B, width], the
        rows gathered (table[codes + i · stride] with a compose table, else
        the depth tables') and summed in f32 with no host read. Sampled
        codes are in range, so the host path's -1 guard is not needed."""
        if self.compose_table is not None:
            table, n = self.compose_table, self.info.n_codebook
            offs = torch.arange(n, device=table.device) * int(self.compose_stride)

            def compose_table(codes):
                return table[codes + offs].float().sum(dim=1)

            return compose_table

        live = [i for i, t in enumerate(self.audio_embds) if t is not None]
        if not live:
            raise LmError("compose_embd_fn: no audio embedding tables")

        def compose(codes):
            acc = self.audio_embds[live[0]][codes[:, live[0]]]
            for i in live[1:]:
                acc = acc + self.audio_embds[i][codes[:, i]]
            return acc

        return compose
