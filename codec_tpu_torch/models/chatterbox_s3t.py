"""Chatterbox S3Tokenizer (16 kHz speech → 25 Hz ternary-FSQ tokens), in
PyTorch.

Counterpart of codec_tpu/models/chatterbox_s3t.py:
  host:   16 kHz PCM zero-padded to a 640-sample multiple → the Whisper-style
          log-mel of dsp/audio.py (n_fft 400, hop 160, the file's mel filters
          and window, log10 floored at the global max − 8, (x + 4) / 4)
          [T_mel, n_mels]
  device: conv k3 s2 p1 + GELU(erf), twice → T_mel/4 frames → 6 blocks of
          (LayerNorm → q, k, v (k without a bias) → RoPE-NEOX → non-causal
          attention → o, plus an FSMN depthwise k31 conv on the pre-RoPE v,
          plus v, all onto the same residual) → (LayerNorm → fc1 → GELU(erf)
          → fc2) → the quantizer's projection → tanh → ×0.999 → round → + 1
          → ternary digits → Σ 3^k ∈ [0, 6561)

Encoder only: the tokens decode through Chatterbox S3Gen. The attention is
the plain masked sdpa (no kernel of codec_tpu covers non-causal
attention); the FSMN conv is ops/conv.py::conv1d with groups = C, which
runs float16 without cuDNN on the card.

Parameters (`load_s3t_params`, `params_from_jax`): linear weights [out,
in]; conv1_w, conv2_w [C_out, C_in, 3]; per layer fsmn_w as conv.conv1d
takes it, WIO [K, 1, C].
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.audio import whisper_log_mel
from ..io.gguf import GGUFReader
from ..ops import conv, norms, rope
from ..ops.act import gelu_erf
from ..ops.attn import sdpa
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.perf_log import perf_scope

TOKEN_HOP = 640          # 16 kHz samples per token (25 Hz)
MEL_HOP = 160


@dataclass(frozen=True)
class S3TConfig:
    sample_rate: int = 24000
    encode_sample_rate: int = 16000
    hop_size: int = 960
    n_q: int = 1
    codebook_size: int = 6561
    n_fft: int = 400
    win_length: int = 400
    n_mels: int = 128
    hidden: int = 1280
    n_heads: int = 20
    n_layers: int = 6
    fsmn_kernel: int = 31
    rope_theta: float = 10000.0

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "S3TConfig":
        d = cls()
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", d.sample_rate),
            encode_sample_rate=r.get_i32("codec.encode_sample_rate",
                                         d.encode_sample_rate),
            hop_size=r.get_i32("codec.hop_size", d.hop_size),
            n_q=r.get_i32("codec.n_q", d.n_q),
            codebook_size=r.get_i32("codec.codebook_size", d.codebook_size),
            n_fft=r.get_i32("codec.n_fft", d.n_fft),
            win_length=r.get_i32("codec.win_length", d.win_length),
            n_mels=r.get_i32("codec.n_mels", d.n_mels),
            hidden=r.get_i32("chatterbox_s3t.audio_state", d.hidden),
            n_heads=r.get_i32("chatterbox_s3t.audio_head", d.n_heads),
            n_layers=r.get_i32("chatterbox_s3t.audio_layer", d.n_layers),
            fsmn_kernel=r.get_i32("chatterbox_s3t.fsmn_kernel_size",
                                  d.fsmn_kernel),
            rope_theta=r.get_f32("chatterbox_s3t.rope_theta", d.rope_theta),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


_FLAT = (("conv1_w", "s3t.enc.conv1.w"), ("conv1_b", "s3t.enc.conv1.b"),
         ("conv2_w", "s3t.enc.conv2.w"), ("conv2_b", "s3t.enc.conv2.b"),
         ("proj_w", "s3t.q.proj.w"), ("proj_b", "s3t.q.proj.b"))
_LAYER = (("attn_ln_w", "attn_ln.w"), ("attn_ln_b", "attn_ln.b"),
          ("q_w", "attn.q.w"), ("q_b", "attn.q.b"), ("k_w", "attn.k.w"),
          ("v_w", "attn.v.w"), ("v_b", "attn.v.b"), ("o_w", "attn.o.w"),
          ("o_b", "attn.o.b"), ("fsmn_w", "attn.fsmn.w"),
          ("mlp_ln_w", "mlp_ln.w"), ("mlp_ln_b", "mlp_ln.b"),
          ("fc1_w", "mlp.fc1.w"), ("fc1_b", "mlp.fc1.b"),
          ("fc2_w", "mlp.fc2.w"), ("fc2_b", "mlp.fc2.b"))


def load_s3t_params(r: GGUFReader, cfg: S3TConfig, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Parameters from a Chatterbox S3T GGUF (s3t.* names)."""
    t = partial(_to, dtype=dtype, device=device)
    p: Dict[str, Any] = {k: t(r.get(n)) for k, n in _FLAT}
    p["layers"] = []
    for li in range(cfg.n_layers):
        lw = {k: r.get(f"s3t.enc.blk.{li}.{n}") for k, n in _LAYER}
        lw["fsmn_w"] = lw["fsmn_w"].transpose(2, 1, 0)      # [K, 1, C]
        p["layers"].append({k: t(v) for k, v in lw.items()})
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu S3T tree (from its `load_s3t_params`; leaves as NumPy
    arrays or anything np.asarray takes) → this module's parameters: the
    front end's conv weights from WIO [K, C_in, C_out] back to PyTorch's
    layout; the FSMN weights stay WIO."""
    t = partial(_to, dtype=dtype, device=device)
    p: Dict[str, Any] = {k: t(tree[k]) for k, _ in _FLAT}
    for k in ("conv1_w", "conv2_w"):
        p[k] = t(np.asarray(tree[k]).transpose(2, 1, 0))
    p["layers"] = [{k: t(lw[k]) for k, _ in _LAYER} for lw in tree["layers"]]
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _s3t_block(x: torch.Tensor, lw: Dict[str, torch.Tensor],
               cos: torch.Tensor, sin: torch.Tensor,
               cfg: S3TConfig) -> torch.Tensor:
    b, t, c = x.shape
    nh = cfg.n_heads
    h = norms.layer_norm(x, lw["attn_ln_w"], lw["attn_ln_b"], 1e-5)
    q = F.linear(h, lw["q_w"], lw["q_b"])
    k = F.linear(h, lw["k_w"])
    v = F.linear(h, lw["v_w"], lw["v_b"])

    def heads(z):
        return z.reshape(b, t, nh, c // nh).transpose(1, 2)

    a = sdpa(rope.rotate(heads(q), cos, sin, neox=True),
             rope.rotate(heads(k), cos, sin, neox=True), heads(v))
    attn_out = F.linear(a.transpose(1, 2).reshape(b, t, c), lw["o_w"],
                        lw["o_b"])
    # the FSMN memory branch on the pre-RoPE value projection
    fsmn = conv.conv1d(v, lw["fsmn_w"], padding=cfg.fsmn_kernel // 2,
                       groups=c)
    x = x + attn_out + fsmn + v
    m = norms.layer_norm(x, lw["mlp_ln_w"], lw["mlp_ln_b"], 1e-5)
    m = gelu_erf(F.linear(m, lw["fc1_w"], lw["fc1_b"]))
    return x + F.linear(m, lw["fc2_w"], lw["fc2_b"])


def s3t_latent_fn(params: Dict[str, Any], mel: torch.Tensor,
                  cfg: S3TConfig) -> torch.Tensor:
    """mel [B, T_mel, n_mels] → the quantizer's bounded value [B, T_mel/4,
    8] (tanh × 0.999, before the round)."""
    x = gelu_erf(F.conv1d(mel.transpose(1, 2), params["conv1_w"],
                          params["conv1_b"], stride=2, padding=1))
    x = gelu_erf(F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2,
                          padding=1)).transpose(1, 2)
    cos, sin = rope.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                 cfg.hidden // cfg.n_heads, cfg.rope_theta)
    for lw in params["layers"]:
        x = _s3t_block(x, lw, cos, sin, cfg)
    return torch.tanh(F.linear(x, params["proj_w"], params["proj_b"])) \
        * 0.9990000128746033


def s3t_encode_fn(params: Dict[str, Any], mel: torch.Tensor,
                  cfg: S3TConfig) -> torch.Tensor:
    """mel [B, T_mel, n_mels] → tokens [B, T_mel/4, 1] int32."""
    q = s3t_latent_fn(params, mel, cfg)
    digits = torch.round(q) + 1.0                          # {0, 1, 2}
    powers = 3.0 ** torch.arange(q.shape[-1], dtype=torch.float32,
                                 device=q.device)
    return torch.sum(digits * powers, dim=-1).to(torch.int32)[..., None]


class ChatterboxS3T(CodecModel):
    arch = "chatterbox_s3t"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = S3TConfig.from_gguf(reader)
        self.sample_rate = self.cfg.sample_rate
        self.encode_sample_rate = self.cfg.encode_sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = -1
        self.has_encoder = reader.get_bool("codec.has_encoder", True)
        self.has_decoder = reader.get_bool("codec.has_decoder", False)
        self.params = load_s3t_params(reader, self.cfg,
                                      dtype=self.compute_dtype,
                                      device=self.device)
        self._mel_filters = np.asarray(reader.get("s3t.mel_filters"),
                                       np.float64).T       # [n_bins, n_mels]
        self._window = (np.asarray(reader.get("s3t.window"), np.float64)
                        if reader.has_tensor("s3t.window") else None)

    def log_mel(self, pcm) -> np.ndarray:
        """16 kHz PCM → [T_mel, n_mels] float32, on the host."""
        pcm = self._pcm_host_f32(pcm).reshape(-1)
        if pcm.size == 0:
            raise CodecError("empty Chatterbox-S3T PCM input")
        padded = -(-len(pcm) // TOKEN_HOP) * TOKEN_HOP
        pcm = np.pad(pcm, (0, padded - len(pcm)))
        return whisper_log_mel(pcm, n_mels=self.cfg.n_mels,
                               n_fft=self.cfg.n_fft, hop=MEL_HOP,
                               sr=self.encode_sample_rate,
                               mel_filters=self._mel_filters,
                               window=self._window).T

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] / [B, n] at 16 kHz (float, or int16) → tokens int32
        [T, 1] / [B, T, 1], T = ceil(n / 640); one row at a time, as
        codec_tpu encodes it."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        if n_q not in (0, 1):
            raise CodecError("Chatterbox-S3T encode n_q must be 0 or 1")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        outs = []
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            for row in pcm:
                mel = torch.from_numpy(np.ascontiguousarray(
                    self.log_mel(row)[None]))
                with perf_scope("graph_compute", "encode"):
                    toks = s3t_encode_fn(self.params, mel.to(
                        self.device, self.compute_dtype), self.cfg)
                    outs.append(toks[0].clamp(0, self.codebook_size - 1)
                                .cpu().numpy())
        return outs[0] if squeeze else np.stack(outs)
