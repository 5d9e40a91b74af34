"""flow_lm (Pocket-TTS): the self-contained continuous-latent AR model
(counterpart of codec_tpu/lm/flow_lm.py, eager).

Reference: src/lm/flow_lm.cpp. The AR transformer, the text LUT, the LSD
flow head (SimpleMLPAdaLN) and the EOS head all live in the codec GGUF: no
external backbone. Sequence = [text LUT rows | optional BOS | voice rows |
AR latent rows]. Each frame is one transformer token over the KV cache →
an EOS logit and an LSD-decoded latent (unrolled Euler), fed back as the
next input. Latents are denormalized by lm.emb_std / lm.emb_mean before
the Pocket-Mimi decode.

The KV cache is one [L, 2, H, max_T, D] tensor on the model's device,
written in place at the new positions; a step attends slots [0, kv_pos]
only, which equals codec_tpu's attention over the whole cache (its -1e30
logits give those slots zero weight). `flow_run` runs K frames with the
latent fed back on the device and copies the K packed [latent ; eos]
rows to the host once, codec_tpu's `lax.scan` as an eager loop. The
attention is plain torch: codec_tpu runs it as an einsum, not a kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, norms, rope
from .base import (CodecLM, LmError, LmInfo, LmState, register_kind,
                   tensors_from_tree)
from .spm import SpmUnigram

_LAYER_KEYS = (("inln_w", "inln.w"), ("inln_b", "inln.b"),
               ("paln_w", "paln.w"), ("paln_b", "paln.b"),
               ("q", "attn.q_proj.w"), ("k", "attn.k_proj.w"),
               ("v", "attn.v_proj.w"), ("o", "attn.o_proj.w"),
               ("fc1", "mlp.fc1.w"), ("fc2", "mlp.fc2.w"))
_HOST_KEYS = ("text_embed", "bos_before_voice", "emb_std", "emb_mean",
              "speaker_proj")


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """codec_tpu's FlowLM weight tree (`lm.w`, leaves as NumPy arrays or
    anything np.asarray takes, None where a tensor is absent) → this
    module's weights, the same keys as f32 tensors on `device`."""
    return tensors_from_tree(tree, device)


@register_kind("flow_lm")
class FlowLM(CodecLM):
    max_T = 2048

    def _load(self, r: GGUFReader) -> LmInfo:
        dev = self.device

        def g(n):
            return tensors_from_tree(r.get(n), dev)

        def gopt(n):
            return g(n) if r.has_tensor(n) else None

        self.d_model = r.get_i32("codec.lm.d_model", 1024)
        self.n_layers = r.get_i32("codec.lm.n_layers", 6)
        self.n_heads = r.get_i32("codec.lm.n_heads", 16)
        self.head_dim = r.get_i32("codec.lm.head_dim",
                                  self.d_model // max(1, self.n_heads))
        self.ldim = r.get_i32("codec.lm.ldim", 32)
        self.flow_dim = r.get_i32("codec.lm.flow_dim", 512)
        self.flow_depth = r.get_i32("codec.lm.flow_depth", 6)
        self.insert_bos_before_voice = r.get_bool(
            "codec.lm.insert_bos_before_voice", False)
        self.lsd_steps = max(1, r.get_i32("codec.lm.lsd_decode_steps", 1))
        self.frames_after_eos = r.get_i32("codec.lm.frames_after_eos", -1)
        self.max_period = r.get_f32("codec.lm.max_period", 10000.0)
        self.temperature = r.get_f32("codec.lm.temperature", 0.7)
        self.eos_threshold = r.get_f32("codec.lm.eos_threshold", -4.0)
        self.ln_eps = 1e-5
        self.flow_ln_eps = 1e-6
        self.flow_rms_eps = 1e-5

        w: Dict[str, Any] = {
            "text_embed": g("lm.text.embed.w"),           # [n_bins+1, d_model]
            "bos_before_voice": gopt("lm.bos_before_voice"),
            "bos_emb": g("lm.bos_emb"),                   # [ldim]
            "input_linear": g("lm.input_linear.w"),       # [d_model, ldim]
            "out_norm_w": g("lm.out_norm.w"), "out_norm_b": g("lm.out_norm.b"),
            "out_eos_w": g("lm.out_eos.w"),               # [1, d_model]
            "out_eos_b": g("lm.out_eos.b"),
            "emb_std": gopt("lm.emb_std"), "emb_mean": gopt("lm.emb_mean"),
            "speaker_proj": gopt("lm.speaker_proj.w"),    # [d_model, ldim]
            "layers": [{k: g(f"lm.tf.l{li}.{s}") for k, s in _LAYER_KEYS}
                       for li in range(self.n_layers)],
        }
        fw: Dict[str, Any] = {
            "in_w": g("lm.flow.input_proj.w"), "in_b": g("lm.flow.input_proj.b"),
            "cond_w": g("lm.flow.cond_embed.w"), "cond_b": g("lm.flow.cond_embed.b"),
            "final_adaln_w": g("lm.flow.final.adaln.w"),
            "final_adaln_b": g("lm.flow.final.adaln.b"),
            "final_w": g("lm.flow.final.linear.w"),
            "final_b": g("lm.flow.final.linear.b"),
        }
        fw["time"] = [{k: g(f"lm.flow.time_embed.{i}.{s}") for k, s in (
            ("freqs", "freqs"), ("l1_w", "l1.w"), ("l1_b", "l1.b"),
            ("l2_w", "l2.w"), ("l2_b", "l2.b"), ("rms", "rms.alpha"))}
            for i in range(2)]
        fw["res"] = [{k: g(f"lm.flow.res.{b}.{s}") for k, s in (
            ("adaln_w", "adaln.w"), ("adaln_b", "adaln.b"),
            ("ln_w", "in_ln.w"), ("ln_b", "in_ln.b"),
            ("l1_w", "mlp.l1.w"), ("l1_b", "mlp.l1.b"),
            ("l2_w", "mlp.l2.w"), ("l2_b", "mlp.l2.b"))}
            for b in range(self.flow_depth)]
        w["flow"] = fw
        self.w = w
        # the host copies read per request (prefix assembly, latent
        # denorm, speaker projection)
        self._host = {k: None if w[k] is None else w[k].cpu().numpy()
                      for k in _HOST_KEYS}

        b64 = r.get_str("codec.lm.tokenizer.spm_b64", "")
        self.spm: Optional[SpmUnigram] = SpmUnigram.from_b64(b64) if b64 else None
        return LmInfo(kind="flow_lm", hidden_dim=self.d_model,
                      is_continuous=True, latent_dim=self.ldim, patch_size=1)

    # -- transformer core --------------------------------------------------
    def _rope_cs(self, pos: torch.Tensor):
        return rope.rope_cos_sin(pos, self.head_dim, self.max_period)

    def _qkv(self, lw, x, cs):
        """x [T, d_model] → q, k, v [H, T, D] (q and k NORMAL-rotated)."""
        t = x.shape[0]
        h = norms.layer_norm(x, lw["inln_w"], lw["inln_b"], self.ln_eps)
        q, k, v = (F.linear(h, lw[n]).reshape(t, self.n_heads, self.head_dim)
                   .transpose(0, 1) for n in ("q", "k", "v"))
        q = rope.rotate(q[None], *cs, neox=False)[0]
        k = rope.rotate(k[None], *cs, neox=False)[0]
        return q, k, v

    def _block_out(self, lw, x, ctx):
        """x [T, d_model] + the attention output ctx [H, T, D], then the
        GELU-tanh MLP."""
        x = x + F.linear(ctx.transpose(0, 1).reshape(x.shape[0], -1), lw["o"])
        f = norms.layer_norm(x, lw["paln_w"], lw["paln_b"], self.ln_eps)
        return x + F.linear(act.gelu_tanh(F.linear(f, lw["fc1"])), lw["fc2"])

    def _layer_step(self, x, lw, kv, kv_pos: int, cs):
        """One incremental token. x [1, d_model]; kv [2, H, max_T, D] is
        written at slot kv_pos; the query attends slots [0, kv_pos]."""
        q, k, v = self._qkv(lw, x, cs)
        kv[0, :, kv_pos] = k[:, 0]
        kv[1, :, kv_pos] = v[:, 0]
        keys, vals = kv[0, :, : kv_pos + 1], kv[1, :, : kv_pos + 1]
        logits = torch.matmul(q, keys.transpose(-1, -2)) / (self.head_dim ** 0.5)
        ctx = torch.matmul(torch.softmax(logits, dim=-1), vals)
        return self._block_out(lw, x, ctx)

    def _time_embed(self, tw, sval: float):
        args = tw["freqs"] * sval
        emb = torch.cat([torch.cos(args), torch.sin(args)])
        h = F.silu(F.linear(emb, tw["l1_w"], tw["l1_b"]))
        h = F.linear(h, tw["l2_w"], tw["l2_b"])
        # unbiased (ddof = 1) RMS around the mean
        var = torch.var(h, correction=1)
        return h / torch.sqrt(var + self.flow_rms_eps) * tw["rms"]

    def _flow_net(self, cond, sval: float, tval: float, x):
        fw = self.w["flow"]
        fd = self.flow_dim
        xh = F.linear(x, fw["in_w"], fw["in_b"])
        t_comb = 0.5 * (self._time_embed(fw["time"][0], sval) +
                        self._time_embed(fw["time"][1], tval))
        sy = F.silu(t_comb + F.linear(cond, fw["cond_w"], fw["cond_b"]))
        for rb in fw["res"]:
            mod = F.linear(sy, rb["adaln_w"], rb["adaln_b"])
            shift, scale, gate = mod[:fd], mod[fd:2 * fd], mod[2 * fd:]
            hn = norms.layer_norm(xh, rb["ln_w"], rb["ln_b"], self.flow_ln_eps)
            hn = hn * (1.0 + scale) + shift
            hn = F.linear(F.silu(F.linear(hn, rb["l1_w"], rb["l1_b"])),
                          rb["l2_w"], rb["l2_b"])
            xh = xh + gate * hn
        fmod = F.linear(sy, fw["final_adaln_w"], fw["final_adaln_b"])
        fshift, fscale = fmod[:fd], fmod[fd:]
        # the final norm: a LayerNorm with no affine
        xf = F.layer_norm(xh, (fd,), eps=self.flow_ln_eps)
        return F.linear(xf * (1.0 + fscale) + fshift, fw["final_w"], fw["final_b"])

    def _step(self, kv, prev, is_bos: bool, kv_pos: int, noise):
        """One AR frame (reference: build_step): prev, noise [ldim] on the
        device → packed [ldim + 1] = [latent ; eos_logit]."""
        seq = self.w["bos_emb"] if is_bos else prev
        x = F.linear(seq, self.w["input_linear"])[None]
        cs = self._rope_cs(torch.arange(kv_pos, kv_pos + 1, device=self.device))
        for li, lw in enumerate(self.w["layers"]):
            x = self._layer_step(x, lw, kv[li], kv_pos, cs)
        c = norms.layer_norm(x[0], self.w["out_norm_w"], self.w["out_norm_b"],
                             self.ln_eps)
        eos = F.linear(c, self.w["out_eos_w"], self.w["out_eos_b"])
        cur, n = noise, self.lsd_steps
        for i in range(n):
            cur = cur + self._flow_net(c, i / n, (i + 1) / n, cur) / n
        return torch.cat([cur, eos])

    def _prefill(self, kv, seq):
        """Fill the KV cache with the prefix (reference: build_prefill):
        seq [T, d_model], causal attention."""
        t = seq.shape[0]
        pos = torch.arange(t, device=self.device)
        cs = self._rope_cs(pos)
        mask = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30)
        x = seq
        for li, lw in enumerate(self.w["layers"]):
            q, k, v = self._qkv(lw, x, cs)
            kv[li, 0, :, :t] = k
            kv[li, 1, :, :t] = v
            logits = torch.matmul(q, k.transpose(-1, -2)) / (self.head_dim ** 0.5)
            ctx = torch.matmul(torch.softmax(logits + mask, dim=-1), v)
            x = self._block_out(lw, x, ctx)

    # -- public API (mirrors codec_lm_flow_*) ------------------------------
    def new_state(self) -> LmState:
        st = LmState(self)
        self._init_kv(st)
        return st

    def _init_kv(self, st: LmState) -> None:
        st.kind_state["kv"] = torch.zeros(
            (self.n_layers, 2, self.n_heads, self.max_T, self.head_dim),
            dtype=torch.float32, device=self.device)
        st.kind_state["kv_pos"] = 0
        st.kind_state["frame"] = 0
        st.kind_state["rng"] = np.random.default_rng(0)

    def flow_reset(self, st: LmState) -> None:
        st.reset()
        self._init_kv(st)

    def tokenize(self, text: str):
        if self.spm is None:
            raise LmError("no SentencePiece tokenizer baked in")
        return self.spm.encode(text)

    def speaker_rows(self, mu: np.ndarray) -> np.ndarray:
        """mu [T, ldim] → voice rows [T, d_model] (F.linear, no bias)."""
        if self._host["speaker_proj"] is None:
            raise LmError("model has no speaker_proj (no voice cloning)")
        return np.asarray(mu, np.float32) @ self._host["speaker_proj"].T

    def denorm_latent(self, latent: np.ndarray) -> np.ndarray:
        return np.asarray(latent) * self._host["emb_std"] + \
            self._host["emb_mean"]

    def flow_prefill(self, st: LmState, token_ids, voice_rows=None) -> None:
        token_ids = np.asarray(token_ids, np.int32)
        parts = [self._host["text_embed"][token_ids]]
        has_voice = voice_rows is not None and len(voice_rows)
        if self.insert_bos_before_voice and has_voice:
            parts.append(self._host["bos_before_voice"][None])
        if has_voice:
            parts.append(np.asarray(voice_rows, np.float32))
        seq = np.concatenate(parts, axis=0)
        t = seq.shape[0]
        if t > self.max_T:
            raise LmError(f"prefix length {t} exceeds KV capacity {self.max_T}")
        with torch.inference_mode():
            self._prefill(st.kind_state["kv"],
                          torch.from_numpy(seq).to(self.device))
        st.kind_state["kv_pos"] = t
        st.kind_state["frame"] = 0

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    def flow_step(self, st: LmState, prev_latent=None, noise=None):
        """→ (latent [ldim], eos_logit, is_eos). The first frame consumes
        BOS."""
        ks = st.kind_state
        if ks["kv_pos"] >= self.max_T:
            raise LmError("KV cache full")
        if noise is None:
            noise = ks["rng"].normal(0.0, np.sqrt(self.temperature),
                                     self.ldim).astype(np.float32)
        prev = (np.zeros(self.ldim, np.float32) if prev_latent is None
                else prev_latent)
        with torch.inference_mode():
            packed = self._step(ks["kv"], self._dev(prev), ks["frame"] == 0,
                                ks["kv_pos"], self._dev(noise))
            packed = packed.cpu().numpy()             # one copy to the host
        ks["kv_pos"] += 1
        ks["frame"] += 1
        eos_logit = float(packed[self.ldim])
        return packed[: self.ldim], eos_logit, eos_logit > self.eos_threshold

    def flow_run(self, st: LmState, noises, prev_latent=None):
        """Run len(noises) AR frames in one call, each frame's latent fed
        back on the device, the K packed rows copied to the host once: the
        frames of repeated flow_step. noises [K, ldim] → (latents [K,
        ldim], eos_logits [K]) NumPy. The state advances K frames; a caller
        that stops at EOS mid-chunk drops the tail (later frames never
        change earlier ones)."""
        ks = st.kind_state
        noises = np.asarray(noises, np.float32).reshape(-1, self.ldim)
        k_frames = noises.shape[0]
        if ks["kv_pos"] + k_frames > self.max_T:
            raise LmError("KV cache full")
        prev = (np.zeros(self.ldim, np.float32) if prev_latent is None
                else prev_latent)
        with torch.inference_mode():
            prev, nz = self._dev(prev), self._dev(noises)
            rows = []
            for i in range(k_frames):
                row = self._step(ks["kv"], prev, ks["frame"] + i == 0,
                                 ks["kv_pos"] + i, nz[i])
                rows.append(row)
                prev = row[: self.ldim]
            packed = torch.stack(rows).cpu().numpy()  # one copy to the host
        ks["kv_pos"] += k_frames
        ks["frame"] += k_frames
        return packed[:, : self.ldim], packed[:, self.ldim]
