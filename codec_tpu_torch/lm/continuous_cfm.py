"""continuous_latent_cfm (VoxCPM / BlueMagpie): the whole-generation-step
adaptor (counterpart of codec_tpu/lm/continuous_cfm.py, eager).

Reference: src/lm/bluemagpie_cfm.cpp + src/models/bluemagpie_blocks.cpp.
Each AR step, on the device:

  h_in → tslm_adapter → FSQ → lm_hidden
  RALM (causal, KV) over fusion([lm_hidden ; prev_feedback_lm]) → residual_hidden
  mu = [lm_to_dit(lm_hidden) ; res_to_dit(residual_hidden)]
  patch = LocDiT CFM Euler (sway schedule, zero-init skip, CFG-zero-star)
  stop  = stop_head(lm_hidden) (argmax of 2 logits, min_len guard)
  LocEnc(patch) → feedback (enc_to_tslm for the backbone, enc_to_lm for RALM)

The RALM KV cache is one [L, 2, n_kv, max_T, D] tensor written in place;
a step writes slot kv_pos and attends all max_T slots under codec_tpu's
-1e30 mask key <= kv_pos, with kv_pos a device tensor: a step
(`_generate`) has no host read and no shape that depends on the position,
so lm/fused_gen.py::build_continuous_chunk can capture K of them in a CUDA
graph. The guided and unguided LocDiT passes of an Euler step run as one
batch of two. The patch, the RALM feedback and the prefill rows stay on
the device from one step to the next; the host reads one packed [patch ;
stop logits ; feedback] row a step. Teacher forcing and fixed noise are
the reference's parity hooks (codec_lm_set_teacher_patch).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import norms
from .base import (CodecLM, LmError, LmInfo, LmState, register_kind,
                   tensors_from_tree)


def sway_schedule(n: int):
    """(t_real, dt) of the sway-warped t-span with the 4% zero-init skip
    (reference: step_generate, bluemagpie_cfm.cpp), float64 NumPy."""
    ts = 1.0 - np.arange(n + 1) / n
    tspan = ts + 1.0 * (np.cos(np.pi / 2 * ts) - 1.0 + ts)
    zero_init = max(1, int((n + 1) * 0.04))
    t_real, dts = [], []
    t = tspan[0]
    dt = tspan[0] - tspan[1]
    for step in range(1, n + 1):
        if step > zero_init:
            t_real.append(t)
            dts.append(dt)
        t -= dt
        if step < n:
            dt = t - tspan[step + 1]
    return np.asarray(t_real), np.asarray(dts)


def sinusoidal(val: float, dim: int) -> np.ndarray:
    half = dim // 2
    step = np.log(10000.0) / (half - 1)
    e = 1000.0 * val * np.exp(np.arange(half) * -step)
    return np.concatenate([np.sin(e), np.cos(e)]).astype(np.float32)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """codec_tpu's ContinuousLatentCfmLM weight tree (`lm.w`; leaves as
    NumPy arrays, None for an absent bias) → this module's weights, the
    same keys as f32 tensors on `device`."""
    return tensors_from_tree(tree, device)


@register_kind("continuous_latent_cfm")
class ContinuousLatentCfmLM(CodecLM):
    max_T = 2048

    def _load(self, r: GGUFReader) -> LmInfo:
        dev = self.device

        def g(n):
            return torch.from_numpy(np.array(r.get(n), np.float32)).to(dev)

        def gopt(n):
            return g(n) if r.has_tensor(n) else None

        self.h_barbet = r.get_i32("codec.lm.hidden_dim", 1024)
        self.h_vox = r.get_i32("codec.lm.h_vox", 2048)
        self.h_enc = r.get_i32("codec.lm.h_enc", 1024)
        self.h_dit = r.get_i32("codec.lm.h_dit", 1024)
        self.latent_dim = r.get_i32("codec.lm.latent_dim", 64)
        self.patch_size = r.get_i32("codec.lm.patch_size", 4)
        self.n_mu = 2
        self.n_locenc = r.get_i32("codec.lm.n_locenc", 12)
        self.n_locdit = r.get_i32("codec.lm.n_locdit", 12)
        self.n_ralm = r.get_i32("codec.lm.n_ralm", 8)
        self.n_heads = r.get_i32("codec.lm.n_heads", 16)
        self.n_kv = r.get_i32("codec.lm.n_kv", 2)
        self.head_dim = r.get_i32("codec.lm.head_dim", 128)
        self.fsq_scale = r.get_i32("codec.lm.fsq_scale", 9)
        self.min_len = r.get_i32("codec.lm.min_len", 2)
        self.eps = r.get_f32("codec.lm.rms_eps", 1e-5)

        def lin(prefix):
            return {"w": g(prefix + ".w"), "b": gopt(prefix + ".b")}

        def block(prefix):
            blk = {"ln1": g(prefix + ".ln1.w"), "ln2": g(prefix + ".ln2.w"),
                   "o": g(prefix + ".attn_o.w"), "down": g(prefix + ".down.w")}
            if r.has_tensor(prefix + ".attn_qkv.w"):
                blk["qkv"] = g(prefix + ".attn_qkv.w")
            else:
                for k in ("q", "k", "v"):
                    blk[k] = g(f"{prefix}.attn_{k}.w")
            if r.has_tensor(prefix + ".gate_up.w"):
                blk["gate_up"] = g(prefix + ".gate_up.w")
            else:
                blk["gate"] = g(prefix + ".gate.w")
                blk["up"] = g(prefix + ".up.w")
            return blk

        w: Dict[str, Any] = {
            "tslm_norm": g("lm.tslm_adapter.norm.w"),
            "tslm_proj": lin("lm.tslm_adapter.proj"),
            "tslm_blk_ln": g("lm.tslm_adapter.blk0.ln.w"),
            "tslm_gate": g("lm.tslm_adapter.blk0.gate.w"),
            "tslm_up": g("lm.tslm_adapter.blk0.up.w"),
            "tslm_down": g("lm.tslm_adapter.blk0.down.w"),
            "fsq_in": lin("lm.fsq.in_proj"), "fsq_out": lin("lm.fsq.out_proj"),
            "fusion": lin("lm.proj.fusion_concat"),
            "lm_to_dit": lin("lm.proj.lm_to_dit"),
            "res_to_dit": lin("lm.proj.res_to_dit"),
            "enc_to_tslm": lin("lm.proj.enc_to_tslm"),
            "enc_to_lm": lin("lm.proj.enc_to_lm"),
            "stop_proj": lin("lm.stop.proj"),
            "stop_head": {"w": g("lm.stop.head.w"), "b": None},
            "ralm_norm": g("lm.ralm.norm.w"),
            "locdit_norm": g("lm.locdit.norm.w"),
            "locdit_in": lin("lm.locdit.in_proj"),
            "locdit_cond": lin("lm.locdit.cond_proj"),
            "locdit_out": lin("lm.locdit.out_proj"),
            "locenc_in": lin("lm.locenc.in_proj"),
            "locenc_sp": g("lm.locenc.special_token"),
            "locenc_norm": g("lm.locenc.norm.w"),
            "rope_cos": g("lm.rope.cos"),                 # [max_pos, head_dim]
            "rope_sin": g("lm.rope.sin"),
        }
        for mlp in ("time_mlp", "dtime_mlp"):
            w[mlp] = {"l1": lin(f"lm.locdit.{mlp}.l1"),
                      "l2": lin(f"lm.locdit.{mlp}.l2")}
        w["ralm"] = [block(f"lm.ralm.layers.{i}") for i in range(self.n_ralm)]
        w["locdit"] = [block(f"lm.locdit.layers.{i}")
                       for i in range(self.n_locdit)]
        w["locenc"] = [block(f"lm.locenc.layers.{i}")
                       for i in range(self.n_locenc)]
        self.w = w
        self._sched_cache: Dict[int, tuple] = {}
        return LmInfo(kind="continuous_latent_cfm", hidden_dim=self.h_barbet,
                      is_continuous=True, patch_size=self.patch_size,
                      latent_dim=self.latent_dim)

    # -- primitives --------------------------------------------------------
    @staticmethod
    def _lin(p, x):
        return F.linear(x, p["w"], p["b"])

    def _qkv(self, blk, h):
        """h [..., T, hidden] → q [..., H, T, D], k / v [..., n_kv, T, D]."""
        qd = self.n_heads * self.head_dim
        kd = self.n_kv * self.head_dim
        if "qkv" in blk:
            qkv = F.linear(h, blk["qkv"])
            q, k, v = qkv[..., :qd], qkv[..., qd:qd + kd], qkv[..., qd + kd:]
        else:
            q, k, v = (F.linear(h, blk[n]) for n in ("q", "k", "v"))

        def heads(x, n):
            return x.reshape(*x.shape[:-1], n, self.head_dim).transpose(-3, -2)
        return heads(q, self.n_heads), heads(k, self.n_kv), heads(v, self.n_kv)

    def _mlp(self, blk, h):
        if "gate_up" in blk:
            gu = F.linear(h, blk["gate_up"])
            half = gu.shape[-1] // 2
            m = F.silu(gu[..., :half]) * gu[..., half:]
        else:
            m = F.silu(F.linear(h, blk["gate"])) * F.linear(h, blk["up"])
        return F.linear(m, blk["down"])

    def _rope(self, x):
        """x [..., heads, T, D] at positions 0..T-1: the baked cos / sin
        tables, rotate-half."""
        t, d = x.shape[-2], self.head_dim
        cos, sin = self.w["rope_cos"][:t], self.w["rope_sin"][:t]
        xr = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
        return x * cos + xr * sin

    def _attend(self, q, k, v, mask=None):
        """q [..., H, Tq, D] over k / v [..., n_kv, Tk, D]: query head j
        reads KV head j // (H / n_kv), as jnp.repeat does → [..., Tq, H·D]."""
        rep = self.n_heads // self.n_kv
        k = torch.repeat_interleave(k, rep, dim=-3)
        v = torch.repeat_interleave(v, rep, dim=-3)
        logits = torch.matmul(q, k.transpose(-1, -2)) / (self.head_dim ** 0.5)
        if mask is not None:
            logits = logits + mask
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v)
        ctx = ctx.transpose(-3, -2)
        return ctx.reshape(*ctx.shape[:-2], -1)

    def _minicpm(self, x, blk, mask=None, use_rope=True):
        """x [..., T, hidden]: one MiniCPM block over the whole rows
        (LocDiT, LocEnc: no mask; the RALM prefill: causal)."""
        q, k, v = self._qkv(blk, norms.rms_norm(x, blk["ln1"], self.eps))
        if use_rope:
            q, k = self._rope(q), self._rope(k)
        x = x + F.linear(self._attend(q, k, v, mask), blk["o"])
        return x + self._mlp(blk, norms.rms_norm(x, blk["ln2"], self.eps))

    def _ralm_step(self, x, blk, kv, kv_pos, mask):
        """One incremental RALM token (causal, no rope). x [1, h_vox]; kv
        [2, n_kv, max_T, D] written at slot kv_pos ([1] int64, on the
        device); mask [1, max_T] additive (keys <= kv_pos)."""
        q, k, v = self._qkv(blk, norms.rms_norm(x, blk["ln1"], self.eps))
        kv[0][:, kv_pos] = k
        kv[1][:, kv_pos] = v
        ctx = self._attend(q, kv[0], kv[1], mask)
        x = x + F.linear(ctx, blk["o"])
        return x + self._mlp(blk, norms.rms_norm(x, blk["ln2"], self.eps))

    def _tslm_adapter(self, h):
        a = self._lin(self.w["tslm_proj"],
                      norms.rms_norm(h, self.w["tslm_norm"], self.eps))
        bn = norms.rms_norm(a, self.w["tslm_blk_ln"], self.eps)
        m = F.silu(F.linear(bn, self.w["tslm_gate"])) * \
            F.linear(bn, self.w["tslm_up"])
        return a + F.linear(m, self.w["tslm_down"])

    def _fsq(self, a):
        q = torch.tanh(self._lin(self.w["fsq_in"], a))
        q = torch.round(q * self.fsq_scale) / self.fsq_scale
        return self._lin(self.w["fsq_out"], q)

    def _time_mlp(self, name, s_emb):
        h = F.silu(self._lin(self.w[name]["l1"], s_emb))
        return self._lin(self.w[name]["l2"], h)

    def _locdit(self, x_h, cond_h, mu_h, t_h):
        """x_h / cond_h [P, h_dit], mu_h [B, n_mu, h_dit] (B = 2: guided and
        unguided), t_h [h_dit] → velocity [B, P, D]."""
        b = mu_h.shape[0]
        rest = torch.cat([t_h[None], cond_h, x_h])
        seq = torch.cat([mu_h, rest.expand(b, *rest.shape)], dim=1)
        for blk in self.w["locdit"]:
            seq = self._minicpm(seq, blk)
        seq = norms.rms_norm(seq, self.w["locdit_norm"], self.eps)
        start = self.n_mu + 1 + self.patch_size
        return self._lin(self.w["locdit_out"],
                         seq[:, start:start + self.patch_size])

    def _locenc_feedback(self, patch):
        """patch [P, D] → (fb_tslm [h_barbet], fb_lm [h_vox])."""
        le = self._lin(self.w["locenc_in"], patch)
        le = torch.cat([self.w["locenc_sp"][None], le])
        for blk in self.w["locenc"]:
            le = self._minicpm(le, blk)
        cls = norms.rms_norm(le, self.w["locenc_norm"], self.eps)[0]
        return (self._lin(self.w["enc_to_tslm"], cls),
                self._lin(self.w["enc_to_lm"], cls))

    # -- step --------------------------------------------------------------
    def _generate(self, kv, kv_pos, h_in, prev_fb_lm, prev_patch, z, sched,
                  cfg_value: float, primed=None, le_override=None):
        """One generation step on the device (codec_tpu's _step_fn): kv
        [L, 2, n_kv, max_T, D] written at kv_pos ([1] int64 on the device,
        at most max_T - 1) unless `primed` = (prefill_lm, prefill_res) is
        given → (patch [P, D], fb_lm [h_vox], packed [P·D + 2 +
        h_barbet]). No host read: the continuous chunk captures it."""
        tsin, dtsin, dts = sched
        if primed is not None:
            lm_hidden, residual = primed
        else:
            lm_hidden = self._fsq(self._tslm_adapter(h_in))
            x = self._lin(self.w["fusion"],
                          torch.cat([lm_hidden, prev_fb_lm]))[None]
            key_pos = torch.arange(self.max_T, device=kv_pos.device)
            mask = torch.where(key_pos[None, :] <= kv_pos[:, None], 0.0,
                               -1e30)
            for blk, kv_l in zip(self.w["ralm"], kv):
                x = self._ralm_step(x, blk, kv_l, kv_pos, mask)
            residual = norms.rms_norm(x[0], self.w["ralm_norm"], self.eps)

        mu = torch.stack([self._lin(self.w["lm_to_dit"], lm_hidden),
                          self._lin(self.w["res_to_dit"], residual)])
        mu2 = torch.stack([mu, torch.zeros_like(mu)])    # guided, unguided
        cond_h = self._lin(self.w["locdit_cond"], prev_patch)
        dt_emb = self._time_mlp("dtime_mlp", dtsin)
        x = z
        for s in range(tsin.shape[0]):
            x_h = self._lin(self.w["locdit_in"], x)
            t_h = self._time_mlp("time_mlp", tsin[s]) + dt_emb
            pos, neg = self._locdit(x_h, cond_h, mu2, t_h)
            # CFG-zero-star
            st = torch.sum(pos * neg) / (torch.sum(neg * neg) + 1e-8)
            neg_st = neg * st
            x = x - (neg_st + cfg_value * (pos - neg_st)) * float(dts[s])

        sp = F.silu(self._lin(self.w["stop_proj"], lm_hidden))
        stop_logits = F.linear(sp, self.w["stop_head"]["w"])       # [2]
        fb_tslm, fb_lm = self._locenc_feedback(
            x if le_override is None else le_override)
        return x, fb_lm, torch.cat([x.reshape(-1), stop_logits, fb_tslm])

    def _step(self, ks, h_in, z, sched, cfg_value: float, le_override):
        """`_generate` on a state's kind_state (the host path's step)."""
        primed = ((ks["prefill_lm"], ks["prefill_res"]) if ks["primed"]
                  else None)
        kv_pos = torch.tensor([ks["kv_pos"]], device=self.device)
        return self._generate(ks["kv"], kv_pos, h_in, ks["prev_fb_lm"],
                              ks["prev_patch"], z, sched, cfg_value, primed,
                              le_override)

    # -- state / public API ------------------------------------------------
    def new_state(self) -> LmState:
        st = LmState(self)
        self._init_state(st)
        return st

    def _init_state(self, st: LmState) -> None:
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        st.kind_state.update(
            kv=zeros(self.n_ralm, 2, self.n_kv, self.max_T, self.head_dim),
            kv_pos=0, patch_index=0, primed=False,
            prev_patch=zeros(self.patch_size, self.latent_dim),
            prev_fb_lm=zeros(self.h_vox),
            fb_tslm=np.zeros(self.h_barbet, np.float32),
            prefill_lm=zeros(self.h_vox), prefill_res=zeros(self.h_vox),
            teacher=None, min_len=-1, rng=np.random.default_rng(0))

    def set_min_len(self, st: LmState, min_len: int) -> None:
        st.kind_state["min_len"] = int(min_len)

    def set_teacher_patch(self, st: LmState, patch: np.ndarray) -> None:
        st.kind_state["teacher"] = np.asarray(patch, np.float32).reshape(
            self.patch_size, self.latent_dim)

    def text_prefill(self, st: LmState, hiddens: np.ndarray) -> None:
        """hiddens [T, h_barbet]: prime the RALM over the prompt prefix
        (reference: codec_lm_text_prefill → build_prefill). The adapter
        output is not FSQ-quantized here, as in the reference."""
        ks = st.kind_state
        hs = torch.from_numpy(np.array(hiddens, np.float32)).to(self.device)
        t = hs.shape[0]
        if t > self.max_T:
            raise LmError(f"prefix length {t} exceeds RALM KV capacity "
                          f"{self.max_T}")
        pos = torch.arange(t, device=self.device)
        mask = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30)
        with torch.inference_mode():
            lm_h = self._tslm_adapter(hs)                        # [T, h_vox]
            x = self._lin(self.w["fusion"],
                          torch.cat([lm_h, torch.zeros_like(lm_h)], dim=-1))
            for blk, kv in zip(self.w["ralm"], ks["kv"]):
                h = norms.rms_norm(x, blk["ln1"], self.eps)
                q, k, v = self._qkv(blk, h)
                kv[0, :, :t] = k
                kv[1, :, :t] = v
                x = x + F.linear(self._attend(q, k, v, mask), blk["o"])
                x = x + self._mlp(blk, norms.rms_norm(x, blk["ln2"], self.eps))
            res = norms.rms_norm(x, self.w["ralm_norm"], self.eps)
        ks["prefill_lm"], ks["prefill_res"] = lm_h[-1], res[-1]
        ks["kv_pos"] = t
        ks["primed"] = True

    def schedule(self, n_timesteps: int):
        """(tsin [n_real, h_dit], dtsin [h_dit]) on the device and dts
        [n_real] f32 on the host for `n_timesteps` Euler steps (cached)."""
        sched = self._sched_cache.get(n_timesteps)
        if sched is None:
            t_real, dts = sway_schedule(n_timesteps)
            dev = self.device
            sched = (torch.from_numpy(np.stack(
                [sinusoidal(t, self.h_dit) for t in t_real])).to(dev),
                torch.from_numpy(sinusoidal(0.0, self.h_dit)).to(dev),
                dts.astype(np.float32))
            self._sched_cache[n_timesteps] = sched
        return sched

    def step_generate(self, st: LmState, h_in, cfg_value: float = 2.0,
                      n_timesteps: int = 10, noise=None):
        """→ (patch [P, D], stop, feedback [h_barbet])
        (reference: codec_lm_step_generate)."""
        ks = st.kind_state
        if ks["kv_pos"] >= self.max_T:
            raise LmError("RALM KV cache full")
        sched = self.schedule(int(n_timesteps))
        if noise is None:
            noise = ks["rng"].standard_normal(
                (self.patch_size, self.latent_dim)).astype(np.float32)
        noise = np.asarray(noise, np.float32).reshape(self.patch_size,
                                                      self.latent_dim)
        teacher = ks["teacher"]
        dev = self.device
        with torch.inference_mode():
            patch_dev, fb_lm, packed = self._step(
                ks, torch.from_numpy(np.array(h_in, np.float32)).to(dev),
                torch.from_numpy(noise).to(dev), sched, float(cfg_value),
                None if teacher is None else torch.from_numpy(teacher).to(dev))
            packed = packed.cpu().numpy()                # one copy to the host
        ks["prev_fb_lm"] = fb_lm
        pd = self.patch_size * self.latent_dim
        patch = packed[:pd].reshape(self.patch_size, self.latent_dim)
        stop_logits = packed[pd:pd + 2]
        ks["fb_tslm"] = packed[pd + 2:]
        stop = bool(stop_logits[1] > stop_logits[0])
        min_len = ks["min_len"] if ks["min_len"] >= 0 else self.min_len
        if ks["patch_index"] <= min_len:
            stop = False
        if not ks["primed"]:
            ks["kv_pos"] += 1
        ks["primed"] = False
        ks["patch_index"] += 1
        ks["prev_patch"] = (patch_dev if teacher is None else
                            torch.from_numpy(teacher).to(dev))
        ks["teacher"] = None
        return patch, stop, ks["fb_tslm"]

    def step_feedback_embd(self, st: LmState) -> np.ndarray:
        return st.kind_state["fb_tslm"]
