"""Soprano decoder (a latent-only vocoder), in PyTorch.

Counterpart of codec_tpu/models/soprano.py: latent [T, latent_dim] →
linear-interpolation time upsample ×upscale (upscale·(T-1)+1 frames) → 1x1
embed conv → LayerNorm → ConvNeXt stack (depthwise kernel dw_kernel) →
final LN → head linear → iSTFT (DC and Nyquist bins zeroed, the file's
window, trim n_fft/2) → (upscale·(T-1))·hop samples at 32 kHz. It takes
latents only: `decode(codes)` raises. Stock torch throughout (codec_tpu
computes it outside any Pallas kernel).

Parameters (`load_soprano_params`, `params_from_jax`): embed_w [dim,
latent, 1], embed_b, norm_w, norm_b, fln_w, fln_b, head_w [n_fft+2, dim],
head_b, window [n_fft] (or None: periodic Hann), cnx: ConvNeXt dicts
(ops/blocks.py::convnext_block).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import blocks, norms
from ..ops.istft import istft_from_head
from ..runtime.model import CodecError, CodecModel


@dataclass(frozen=True)
class SopranoConfig:
    sample_rate: int = 32000
    hop_size: int = 256
    n_fft: int = 1024
    latent_dim: int = 512
    decoder_dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    upscale: int = 4
    dw_kernel: int = 7

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "SopranoConfig":
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 32000),
            hop_size=r.get_i32("codec.hop_size", 256),
            n_fft=r.get_i32("codec.n_fft", 1024),
            latent_dim=r.get_i32("codec.latent_dim", 512),
            decoder_dim=r.get_i32("soprano.decoder_dim", 512),
            intermediate_dim=r.get_i32("soprano.intermediate_dim", 1536),
            num_layers=r.get_i32("soprano.num_layers", 8),
            upscale=r.get_i32("soprano.upscale", 4),
            dw_kernel=r.get_i32("soprano.dw_kernel", 7),
        )


def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


_CNX = {"dw_w": "dw.w", "dw_b": "dw.b", "ln_w": "ln.w", "ln_b": "ln.b",
        "pw1_w": "pw1.w", "pw1_b": "pw1.b", "pw2_w": "pw2.w",
        "pw2_b": "pw2.b", "gamma": "gamma"}
_FLAT = {"embed_w": "embed.w", "embed_b": "embed.b", "norm_w": "norm.w",
         "norm_b": "norm.b", "fln_w": "fln.w", "fln_b": "fln.b",
         "head_w": "head.out.w", "head_b": "head.out.b"}


def load_soprano_params(r: GGUFReader, cfg: SopranoConfig,
                        dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Parameters from a Soprano GGUF (sop.decode.* names, PyTorch
    layouts)."""
    t = partial(_to, dtype=dtype, device=device)
    p: Dict[str, Any] = {k: t(r.get(f"sop.decode.{n}"))
                         for k, n in _FLAT.items()}
    win = r.get_or_none("sop.decode.istft.window")
    p["window"] = t(np.asarray(win).reshape(-1)) if win is not None else None
    p["cnx"] = [{k: t(r.get(f"sop.decode.cnx.{li}.{n}"))
                 for k, n in _CNX.items()} for li in range(cfg.num_layers)]
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu Soprano parameter tree (from its `load_soprano_params`;
    leaves as NumPy arrays or anything np.asarray takes) → this module's
    parameters (conv weights from WIO [K, C_in, C_out] back to PyTorch's
    [C_out, C_in, K])."""
    t = partial(_to, dtype=dtype, device=device)

    def conv(w):
        return t(np.asarray(w).transpose(2, 1, 0))

    p: Dict[str, Any] = {k: t(tree[k]) for k in _FLAT if k != "embed_w"}
    p["embed_w"] = conv(tree["embed_w"])
    p["window"] = t(tree["window"]) if tree["window"] is not None else None
    p["cnx"] = [{k: conv(b[k]) if k == "dw_w" else t(b[k]) for k in _CNX}
                for b in tree["cnx"]]
    return p


def soprano_upsample_linear(latent: torch.Tensor, upscale: int
                            ) -> torch.Tensor:
    """[B, T, C] → [B, upscale·(T-1)+1, C] by linear interpolation between
    neighbouring frames."""
    b, t, c = latent.shape
    t_up = upscale * (t - 1) + 1
    ti = torch.arange(t_up, device=latent.device)
    base = torch.clamp(ti // upscale, max=t - 1)
    nxt = torch.clamp(base + 1, max=t - 1)
    frac = ((ti - base * upscale) / upscale).to(latent.dtype)
    v0, v1 = latent[:, base], latent[:, nxt]
    return v0 + (v1 - v0) * frac[None, :, None]


def soprano_decode_latent_fn(params: Dict[str, Any], latent: torch.Tensor,
                             cfg: SopranoConfig) -> torch.Tensor:
    """latent [B, T, latent_dim] → pcm [B, upscale·(T-1)·hop] float32."""
    x = soprano_upsample_linear(latent, cfg.upscale)
    x = F.linear(x, params["embed_w"][:, :, 0], params["embed_b"])
    x = norms.layer_norm(x, params["norm_w"], params["norm_b"], 1e-6)
    for blk in params["cnx"]:
        x = blocks.convnext_block(x, blk)
    x = norms.layer_norm(x, params["fln_w"], params["fln_b"], 1e-6)
    head = F.linear(x, params["head_w"], params["head_b"])
    return istft_from_head(head, cfg.hop_size, window=params["window"],
                           skip_dc_nyquist=True)


_NO_TOKENS = "Soprano decoder does not accept token inputs; use decode_latent"


class SopranoCodec(CodecModel):
    arch = "soprano"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = SopranoConfig.from_gguf(reader)
        self.params = load_soprano_params(reader, self.cfg,
                                          dtype=self.compute_dtype,
                                          device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.latent_dim = self.cfg.latent_dim
        self.n_q = 0
        self.has_encoder = False
        self.has_decoder = True

    def _decode_impl(self, codes, n_q):
        raise CodecError(_NO_TOKENS)

    def decode(self, codes, n_q: int = 0, pcm_format: str = "f32"):
        raise CodecError(_NO_TOKENS)

    def decode_latent(self, latent, pcm_format: str = "f32") -> np.ndarray:
        """latent [T, latent_dim] or [B, T, latent_dim] → pcm [samples] or
        [B, samples]; float32, or int16 with pcm_format="i16"."""
        latent = np.asarray(latent, dtype=np.float32)
        squeeze = latent.ndim == 2
        if squeeze:
            latent = latent[None]
        if latent.ndim != 3 or latent.shape[1] == 0:
            raise CodecError(f"bad latent shape {latent.shape}: want [T, "
                             f"{self.latent_dim}] or [B, T, "
                             f"{self.latent_dim}]")
        if latent.shape[-1] != self.cfg.latent_dim:
            raise CodecError(f"Soprano latent_dim mismatch: "
                             f"{latent.shape[-1]} != {self.cfg.latent_dim}")
        z = torch.from_numpy(latent).to(self.device, self.compute_dtype)
        out = self._run_on_device(
            lambda: soprano_decode_latent_fn(self.params, z, self.cfg),
            pcm_format)
        return out[0] if squeeze else out
