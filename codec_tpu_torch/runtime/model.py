"""CodecModel: the public runtime object (load → decode).

Counterpart of codec_tpu/runtime/model.py, eager: no jit cache, no shape
buckets (every Mimi decode layer is causal, so decoding at the exact T
gives what a padded-and-cropped decode gives), no mesh. Each model holds
its parameters on one `device` in one `compute_dtype`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..io.gguf import (GGML_TYPE_BF16, GGML_TYPE_F16, GGML_TYPE_F32,
                       GGUFReader)


class CodecError(ValueError):
    """Invalid-argument / invalid-state errors."""


_DTYPE_ALIASES = {
    "float32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def resolve_compute_dtype(spec, reader: Optional[GGUFReader] = None
                          ) -> torch.dtype:
    """Resolve "float32" | "bfloat16" | "auto" | a torch dtype.

    "auto" follows the checkpoint by byte share: bfloat16 when 16-bit
    (F16/BF16) tensors hold more than half the bytes and nothing is
    quantized, float32 otherwise (quantized checkpoints compute in f32)."""
    if isinstance(spec, torch.dtype):
        if spec not in _DTYPE_ALIASES.values():
            raise CodecError(f"unsupported compute dtype {spec}")
        return spec
    if not isinstance(spec, str):
        raise CodecError(f"unknown compute dtype {spec!r}")
    s = spec.lower()
    if s in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[s]
    if s == "auto":
        if reader is not None:
            b16 = tot = qnt = 0
            for info in reader.tensors.values():
                tot += info.n_bytes
                if info.ggml_type in (GGML_TYPE_F16, GGML_TYPE_BF16):
                    b16 += info.n_bytes
                elif info.ggml_type != GGML_TYPE_F32:
                    qnt += info.n_bytes
            if qnt == 0 and tot and b16 * 2 > tot:
                return torch.bfloat16
        return torch.float32
    raise CodecError(f"unknown compute dtype {spec!r}")


@contextlib.contextmanager
def f32_precision(enabled: bool = True):
    """Run float32 matmuls and convolutions in full float32 on the card.

    PyTorch lets cuDNN convolutions use TF32 by default, which keeps about
    three decimal digits; the f32 path is the parity path, so it turns
    TF32 off for both matmuls and convolutions and restores the previous
    settings afterwards."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class CodecModel:
    """Base class; per-arch subclasses live in codec_tpu_torch/models/ and
    are listed in models/registry.py."""

    arch: str = ""

    # Subclasses set these after load:
    sample_rate: int = 0
    hop_size: int = 1
    n_q: int = 0
    codebook_size: int = 0
    latent_dim: int = 0
    has_encoder: bool = False
    has_decoder: bool = True

    def __init__(self, reader: GGUFReader, compute_dtype="float32",
                 device="cuda"):
        self.reader = reader
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, reader)
        self.metadata: Dict[str, Any] = dict(reader.kv)
        self._load(reader)

    # -- subclass hooks ----------------------------------------------------
    def _load(self, reader: GGUFReader) -> None:
        raise NotImplementedError

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        """codes [B, T, n_q] int64 on the device → pcm [B, T*hop]."""
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    @staticmethod
    def _fmt_out(pcm: torch.Tensor, pcm_format: str) -> torch.Tensor:
        """"f32" passes float32 through; "i16" converts to 16-bit PCM with
        io/wav.py::write_wav's formula (round half to even), so a WAV
        written from it is byte-identical to one written from f32."""
        if pcm_format == "f32":
            return pcm.float()
        if pcm_format == "i16":
            return torch.clamp(torch.round(pcm.float() * 32767.0),
                               -32768, 32767).to(torch.int16)
        raise CodecError(f"unknown pcm_format {pcm_format!r}")

    def decode(self, codes, n_q: int = 0,
               pcm_format: str = "f32") -> np.ndarray:
        """codes: [T, Q] or [B, T, Q] int → pcm [T*hop] / [B, T*hop] on the
        host; float32, or int16 with pcm_format="i16".

        n_q=0 means all model codebooks (or all the codes carry, if fewer)."""
        if not self.has_decoder:
            raise CodecError(f"{self.arch}: model has no decoder")
        if pcm_format not in ("f32", "i16"):
            raise CodecError(f"unknown pcm_format {pcm_format!r}")
        codes = np.asarray(codes)
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[None]
        if codes.ndim != 3 or codes.shape[1] == 0:
            raise CodecError(f"bad codes shape {codes.shape}")
        use_nq = n_q if n_q > 0 else min(self.n_q, codes.shape[2])
        if n_q < 0 or use_nq < 1 or use_nq > self.n_q or codes.shape[2] < use_nq:
            raise CodecError(f"n_q must be 0 or in [1, {self.n_q}]")
        t = codes.shape[1]
        c = torch.from_numpy(np.ascontiguousarray(codes[:, :, :use_nq],
                                                  dtype=np.int64))
        with torch.inference_mode(), \
                f32_precision(self.compute_dtype == torch.float32):
            pcm = self._decode_impl(c.to(self.device), use_nq)
            pcm = self._fmt_out(pcm[:, : t * self.hop_size], pcm_format)
            out = pcm.cpu().numpy()
        return out[0] if squeeze else out
