"""MOSS-Audio-Tokenizer (Nano and full), encode and decode, in PyTorch.

Counterpart of codec_tpu/models/moss_audio.py: a pure-transformer codec.
Patch modules fold time into channels (encode) or back (decode); between
them, causal sliding-window transformer blocks (LayerNorm, fused QKV,
RoPE-NORMAL, LayerScale, tanh-GELU FFN) with optional input and output
projections; in the middle a 16-level residual cosine-LFQ quantizer (each
level: projection in, the nearest L2-normalised codebook row by cosine,
first maximum wins, projection out). Stereo runs as one mono-equivalent
stream, the channels interleaved sample by sample (moss.channel_interleave).
The module schema (patch sizes, widths, layers, windows in seconds, RoPE
periods) comes from the GGUF's metadata, so one implementation serves
every variant.

Every transformer layer's attention is causal over a sliding window: the
CUDA kernel's wrapper attn_cuda.flash_sdpa_window (its plain banded
version for a CPU tensor). An encode whose per-channel length is no hop
multiple is zero-padded; codec_tpu then masks the keys past the true
length (`n_valid`) in every layer. Query rows before n_valid never reach
such a key (the mask is causal), so they are plain windowed attention and
run on the kernel; the rows at and past n_valid (fewer than one hop's
worth of tokens at each stage) are computed again with codec_tpu's whole
additive mask, the n_valid term summed onto the causal window's as
codec_tpu sums them.

Parameters (`load_moss_params`, `params_from_jax`), linear weights [out,
in]:
  q: per level in_w, in_b, out_w, out_b, cb [V, D], cb_norm [V, D]
  q_output_proj_w, q_output_proj_b; q_input_proj_w, q_input_proj_b (encoder)
  enc, dec: per module None (a patch) or {in_proj, out_proj (each or
      None), layers: per layer n1w, n1b, n2w, n2b, qkv [3C, C], out, fc1,
      fc2, ls1, ls2}
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, attn, norms, rope
from ..ops.attn_cuda import flash_sdpa_window
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.perf_log import perf_scope


@dataclass(frozen=True)
class MossModuleCfg:
    kind: int              # 0 = patch, 1 = transformer
    patch: int = 1
    in_dim: int = 0
    out_dim: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_layers: int = 0
    context_duration: float = 0.0
    max_period: float = 10000.0


@dataclass(frozen=True)
class MossConfig:
    sample_rate: int = 24000
    hop_size: int = 1920
    n_q: int = 16
    codebook_size: int = 1024
    codebook_dim: int = 16
    latent_dim: int = 1024
    rvq_dim: int = 1024
    number_channels: int = 1
    channel_interleave: bool = True
    enc_modules: Tuple[MossModuleCfg, ...] = ()
    dec_modules: Tuple[MossModuleCfg, ...] = ()

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "MossConfig":
        def mods(side: str) -> Tuple[MossModuleCfg, ...]:
            n = r.get_i32(f"moss.{side}.n_modules", 0)
            kinds = r.get_arr(f"moss.{side}.module_types", [1] * n)
            patch = r.get_arr(f"moss.{side}.patch_sizes", [1] * n)
            ind = r.get_arr(f"moss.{side}.in_dims", [0] * n)
            outd = r.get_arr(f"moss.{side}.out_dims", [0] * n)
            dm = r.get_arr(f"moss.{side}.d_models", [0] * n)
            nh = r.get_arr(f"moss.{side}.n_heads", [0] * n)
            nl = r.get_arr(f"moss.{side}.n_layers", [0] * n)
            cd = r.get_arr(f"moss.{side}.context_durations", [0.0] * n)
            mp = r.get_arr(f"moss.{side}.max_periods", [10000.0] * n)
            return tuple(MossModuleCfg(int(kinds[i]), int(patch[i]),
                                       int(ind[i]), int(outd[i]), int(dm[i]),
                                       int(nh[i]), int(nl[i]), float(cd[i]),
                                       float(mp[i]))
                         for i in range(n))

        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=r.get_i32("codec.hop_size", 1920),
            n_q=r.get_i32("codec.n_q", 16),
            codebook_size=r.get_i32("codec.codebook_size", 1024),
            codebook_dim=r.get_i32("codec.codebook_dim", 16),
            latent_dim=r.get_i32("codec.latent_dim", 1024),
            rvq_dim=r.get_i32("moss.rvq_dim", 1024),
            number_channels=r.get_i32("moss.number_channels", 1),
            channel_interleave=r.get_bool("moss.channel_interleave", True),
            enc_modules=mods("enc"),
            dec_modules=mods("dec"),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


_LAYER = (("n1w", "norm1.w"), ("n1b", "norm1.b"), ("n2w", "norm2.w"),
          ("n2b", "norm2.b"), ("qkv", "attn.qkv.w"), ("out", "attn.out.w"),
          ("fc1", "ffn.fc1.w"), ("fc2", "ffn.fc2.w"), ("ls1", "ls1"),
          ("ls2", "ls2"))
_LEVEL = ("in_w", "in_b", "out_w", "out_b", "cb", "cb_norm")


def load_moss_params(r: GGUFReader, cfg: MossConfig, dtype=torch.float32,
                     device="cpu") -> Dict[str, Any]:
    """Parameters from a MOSS GGUF (moss.* names); the quantizer's k=1
    conv weights [out, in, 1] become linear weights [out, in]."""
    t = partial(_to, dtype=dtype, device=device)

    def g(name):
        return t(r.get(name))

    def g1(name):
        return t(r.get(name)[:, :, 0])

    def gopt(name):
        a = r.get_or_none(name)
        return t(a) if a is not None else None

    def block(base: str, n_layers: int):
        return {"in_proj": gopt(base + ".input_proj.w"),
                "out_proj": gopt(base + ".output_proj.w"),
                "layers": [{k: g(f"{base}.l{li}.{n}") for k, n in _LAYER}
                           for li in range(n_layers)]}

    def side(name, mods):
        return [block(f"moss.{name}.b{mi}", m.n_layers) if m.kind == 1
                else None for mi, m in enumerate(mods)]

    p: Dict[str, Any] = {"q": [{
        "in_w": g1(f"moss.q.{qi}.in_proj.w"), "in_b": g(f"moss.q.{qi}.in_proj.b"),
        "out_w": g1(f"moss.q.{qi}.out_proj.w"),
        "out_b": g(f"moss.q.{qi}.out_proj.b"),
        "cb": g(f"moss.q.{qi}.codebook"),
        "cb_norm": g(f"moss.q.{qi}.codebook_norm")} for qi in range(cfg.n_q)]}
    p["q_output_proj_w"] = g1("moss.q.output_proj.w")
    p["q_output_proj_b"] = g("moss.q.output_proj.b")
    if r.has_tensor("moss.q.input_proj.w"):
        p["q_input_proj_w"] = g1("moss.q.input_proj.w")
        p["q_input_proj_b"] = g("moss.q.input_proj.b")
        p["enc"] = side("enc", cfg.enc_modules)
    p["dec"] = side("dec", cfg.dec_modules)
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu MOSS parameter tree (from its `load_moss_params`; leaves
    as NumPy arrays or anything np.asarray takes) → this module's
    parameters (the same layouts)."""
    t = partial(_to, dtype=dtype, device=device)

    def opt(a):
        return t(a) if a is not None else None

    def side(blocks):
        return [None if blk is None else {
            "in_proj": opt(blk["in_proj"]), "out_proj": opt(blk["out_proj"]),
            "layers": [{k: t(lw[k]) for k, _ in _LAYER}
                       for lw in blk["layers"]]} for blk in blocks]

    p: Dict[str, Any] = {"q": [{k: t(q[k]) for k in _LEVEL}
                               for q in tree["q"]]}
    for k in ("q_output_proj_w", "q_output_proj_b", "q_input_proj_w",
              "q_input_proj_b"):
        if k in tree:
            p[k] = t(tree[k])
    if "enc" in tree:
        p["enc"] = side(tree["enc"])
    p["dec"] = side(tree["dec"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _patch_encode(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, T, C] → [B, T/p, C*p], channel c*p + p_idx."""
    if patch <= 1:
        return x
    b, t, c = x.shape
    return x.reshape(b, t // patch, patch, c).transpose(2, 3).reshape(
        b, t // patch, c * patch)


def _patch_decode(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, T, C] → [B, T*p, C/p], the inverse of _patch_encode."""
    if patch <= 1:
        return x
    b, t, c = x.shape
    return x.reshape(b, t, c // patch, patch).transpose(2, 3).reshape(
        b, t * patch, c // patch)


def _win_tokens(cfg: MossConfig, duration: float, cum_down: int) -> int:
    """A window in seconds → tokens at a stage cum_down samples a token,
    rounded as Python's round rounds (half to even: 12.5 → 12)."""
    fr = cfg.sample_rate * (cfg.number_channels if cfg.channel_interleave
                            else 1)
    return int(round(duration * fr / cum_down))


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int], n_valid: Optional[int] = None,
                     attention: Optional[Callable] = None) -> torch.Tensor:
    """Causal sliding-window self-attention over [B, H, T, D] with
    codec_tpu's n_valid key mask: one call of `attention` (default
    flash_sdpa_window) over every row, then the rows i >= n_valid (where
    the key mask matters) again through the masked sdpa with codec_tpu's
    mask, attn_mask(causal, window) + (0 where j < n_valid, else NEG_INF).

    While every such row's window holds a valid key, the keys before the
    rows' band carry -1e30 or less beside a finite logit and weigh exactly
    0, so only the band's keys are read. A row whose window holds no valid
    key (i - window + 1 >= n_valid) weighs its masked keys uniformly, as
    codec_tpu does (not a NaN): then every key is read."""
    t = q.shape[2]
    ctx = (attention or flash_sdpa_window)(q, k, v, window=window)
    if n_valid is not None and n_valid < t:
        lo = (max(0, n_valid - window + 1) if window is not None
              and 0 < n_valid and t - window < n_valid else 0)
        kj = lo + torch.arange(t - lo, device=q.device)[None, :]
        m = attn.attn_mask(t - n_valid, t - lo, causal=True, window=window,
                           device=q.device, q_off=n_valid - lo)
        m = m + torch.where(kj < n_valid, 0.0, attn.NEG_INF)
        ctx[:, :, n_valid:] = attn.sdpa(q[:, :, n_valid:], k[:, :, lo:],
                                        v[:, :, lo:], mask=m)
    return ctx


def _moss_layer(x: torch.Tensor, lw: Dict[str, torch.Tensor], n_heads: int,
                cos: torch.Tensor, sin: torch.Tensor, window: Optional[int],
                n_valid: Optional[int],
                attention: Optional[Callable]) -> torch.Tensor:
    b, t, c = x.shape
    d = c // n_heads
    h = norms.layer_norm(x, lw["n1w"], lw["n1b"], 1e-5)
    q, k, v = F.linear(h, lw["qkv"]).reshape(b, t, 3, n_heads, d).permute(
        2, 0, 3, 1, 4)
    q = rope.rotate(q, cos, sin, neox=False).contiguous()
    k = rope.rotate(k, cos, sin, neox=False).contiguous()
    ctx = window_attention(q, k, v.contiguous(), window, n_valid, attention)
    ctx = ctx.transpose(1, 2).reshape(b, t, c)
    x = x + F.linear(ctx, lw["out"]) * lw["ls1"]
    h = norms.layer_norm(x, lw["n2w"], lw["n2b"], 1e-5)
    h = F.linear(act.gelu_tanh(F.linear(h, lw["fc1"])), lw["fc2"])
    return x + h * lw["ls2"]


def _projected_transformer(x: torch.Tensor, blk: Dict[str, Any],
                           mod: MossModuleCfg, window: int,
                           n_valid: Optional[int],
                           attention: Optional[Callable]) -> torch.Tensor:
    if blk["in_proj"] is not None:
        x = F.linear(x, blk["in_proj"])
    cos, sin = rope.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                 mod.d_model // mod.n_heads, mod.max_period)
    win = window if window and window > 0 else None
    for lw in blk["layers"]:
        x = _moss_layer(x, lw, mod.n_heads, cos, sin, win, n_valid, attention)
    if blk["out_proj"] is not None:
        x = F.linear(x, blk["out_proj"])
    return x


def moss_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                          cfg: MossConfig, n_valid_pcm: int,
                          attention: Optional[Callable] = None
                          ) -> torch.Tensor:
    """pcm [B, n_mono_eq] (a multiple of the encoder's patch product) → the
    quantizer's input [B, T, rvq_dim], after q_input_proj."""
    x = pcm[..., None]
    cum = 1
    for mi, mod in enumerate(cfg.enc_modules):
        if mod.kind == 0:
            x = _patch_encode(x, mod.patch)
            cum *= mod.patch
        else:
            x = _projected_transformer(
                x, params["enc"][mi], mod,
                _win_tokens(cfg, mod.context_duration, cum),
                n_valid_pcm // cum, attention)
    return F.linear(x, params["q_input_proj_w"], params["q_input_proj_b"])


def lfq_encode(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The residual cosine LFQ: x [B, T, rvq_dim] → codes [B, T, n_q]
    int64. Cosines are float32 products (exact for 16-bit operands), the
    first maximum wins."""
    residual = x
    codes = []
    for q in params["q"]:
        z = F.linear(residual, q["in_w"], q["in_b"])
        zn = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                             min=1e-12)
        idx = torch.argmax(torch.matmul(zn.float(), q["cb_norm"].float().t()),
                           dim=-1)
        codes.append(idx)
        residual = residual - F.linear(q["cb"][idx], q["out_w"], q["out_b"])
    return torch.stack(codes, dim=-1)


def moss_encode_fn(params: Dict[str, Any], pcm: torch.Tensor,
                   cfg: MossConfig, n_valid_pcm: int,
                   attention: Optional[Callable] = None) -> torch.Tensor:
    """pcm [B, n_mono_eq] → codes [B, n / hop_total, n_q] int64."""
    return lfq_encode(params, moss_encode_latent_fn(
        params, pcm, cfg, n_valid_pcm, attention))


def _dec_window_tokens(cfg: MossConfig) -> List[int]:
    """Each decoder module's window in tokens (0 at a patch module): its
    stage has the product of the later patches' sizes samples a token."""
    out = []
    for mi, mod in enumerate(cfg.dec_modules):
        rem = int(np.prod([m.patch for m in cfg.dec_modules[mi + 1:]
                           if m.kind == 0] or [1]))
        out.append(_win_tokens(cfg, mod.context_duration, rem)
                   if mod.kind == 1 else 0)
    return out


def moss_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                   cfg: MossConfig, attention: Optional[Callable] = None
                   ) -> torch.Tensor:
    """codes [B, T, n_q] int → pcm [B, n_mono_eq] (the channels interleaved
    where the model has more than one). `attention` replaces
    flash_sdpa_window (e.g. by its plain version)."""
    codes = codes.clamp(0, cfg.codebook_size - 1)
    acc = None
    for qi in range(codes.shape[-1]):
        q = params["q"][qi]
        zq = F.linear(q["cb"][codes[..., qi]], q["out_w"], q["out_b"])
        acc = zq if acc is None else acc + zq
    x = F.linear(acc, params["q_output_proj_w"], params["q_output_proj_b"])
    for mi, (mod, win) in enumerate(zip(cfg.dec_modules,
                                        _dec_window_tokens(cfg))):
        if mod.kind == 0:
            x = _patch_decode(x, mod.patch)
        else:
            x = _projected_transformer(x, params["dec"][mi], mod, win, None,
                                       attention)
    return x[..., 0]


class MossAudioCodec(CodecModel):
    arch = "moss_audio_tokenizer"
    causal_time = True         # fully causal transformer stacks

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = MossConfig.from_gguf(reader)
        self.params = load_moss_params(reader, self.cfg,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.latent_dim
        self.expected_channels = self.cfg.number_channels
        self.has_encoder = "q_input_proj_w" in self.params
        self.has_decoder = True

    def _use_nq(self, n_q: int, have: int) -> int:
        """A decode reads every level whatever n_q asks, as codec_tpu's."""
        super()._use_nq(n_q, self.n_q)
        if have < self.n_q:
            raise CodecError(f"{self.arch}: a decode reads all {self.n_q} "
                             f"levels, the codes carry {have}")
        return self.n_q

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return moss_decode_fn(self.params, codes, self.cfg)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] mono or [n, channels] (float, or int16) → codes int32
        [ceil(n/hop), n_q]. The channels are interleaved into one
        mono-equivalent stream, each zero-padded to a hop multiple first;
        the keys past the true length are masked (n_valid). One stream a
        call, and every level whatever n_q asks, as codec_tpu encodes."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        if not 0 <= n_q <= self.n_q:
            raise CodecError(f"n_q must be 0 or in [1, {self.n_q}]")
        pcm = self._pcm_host_f32(pcm)
        nch = self.cfg.number_channels
        if pcm.ndim == 2 and pcm.shape[1] == nch and nch > 1:
            per_ch = pcm.shape[0]
        else:
            pcm = pcm.reshape(-1, 1)
            per_ch = pcm.shape[0]
            nch = 1
        if per_ch == 0:
            raise CodecError(f"bad pcm shape {pcm.shape}")
        hop = self.hop_size
        pad = (-per_ch) % hop
        if pad:
            pcm = np.pad(pcm, ((0, pad), (0, 0)))
        flat = pcm.reshape(-1)                          # interleaved
        fold = int(np.prod([m.patch for m in self.cfg.enc_modules
                            if m.kind == 0] or [1]))
        if flat.shape[0] % fold:
            raise CodecError(
                f"{self.arch}: a stream of {flat.shape[0]} samples is no "
                f"multiple of the encoder's {fold} samples a code (a mono "
                f"stream on a {self.cfg.number_channels}-channel model)")
        n_valid = per_ch * nch if self.cfg.channel_interleave else per_ch
        x = torch.from_numpy(np.ascontiguousarray(flat[None]))
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            with perf_scope("graph_compute", "encode"):
                codes = moss_encode_fn(
                    self.params, x.to(self.device, self.compute_dtype),
                    self.cfg, n_valid)
                return self._host(codes[0].to(torch.int32))
