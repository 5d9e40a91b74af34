"""Causal sliding-window flash attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of codec_tpu/ops/attn_pallas.py::flash_sdpa_window. The kernel
is csrc/flash_sdpa_window.cu, built by kernels/build.py on first launch
(never at import). For a CPU tensor the wrapper runs the plain version;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .attn import attn_mask, sdpa

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_BQ = 64                      # queries per block (csrc/flash_sdpa_window.cu)
_MAX_Q_TILES = 65535          # gridDim.y limit


def flash_sdpa_window_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the masked sdpa with a causal (+ window) mask."""
    t = q.shape[-2]
    return sdpa(q, k, v, scale=scale,
                mask=attn_mask(t, t, causal=True, window=window,
                               device=q.device))


@functools.cache
def _kernel_fn():
    from ..kernels.build import load_library

    lib = load_library()
    fn = lib.codec_flash_sdpa_window
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.codec_cuda_error_string


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_sdpa_window: {name} {tuple(x.shape)} {x.dtype} on "
                f"{x.device} does not match q {tuple(q.shape)} {q.dtype} "
                f"on {q.device}")
    if q.ndim != 4:
        raise ValueError(f"flash_sdpa_window: q must be [B, H, T, D], got "
                         f"{tuple(q.shape)}")
    b, h, t, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_sdpa_window: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_sdpa_window: head dim {d} not supported "
                         f"{_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_sdpa_window: q, k and v must be contiguous")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_sdpa_window: window must be None or a "
                         f"positive int, got {window!r}")
    if t < 1 or -(-t // _BQ) > _MAX_Q_TILES or b * h < 1 or b * h >= 2 ** 31:
        raise ValueError(f"flash_sdpa_window: shape {tuple(q.shape)} out of "
                         f"the kernel's range")


def flash_sdpa_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Causal (+ optional sliding-window) self-attention.

    q, k, v: [B, H, T, D] (f32 or bf16; D in {64, 128} on CUDA) →
    [B, H, T, D] in v's dtype. Query i sees key j iff i - window < j <= i.
    Counts its kernel launches in `flash_sdpa_window.launches`."""
    if q.device.type == "cpu":
        return flash_sdpa_window_ref(q, k, v, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sdpa_window: no kernel for device {q.device}")
    _check(q, k, v, window)
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    fn, err_str = _kernel_fn()
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, t, d, window or 0, float(scale), _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_sdpa_window: kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    flash_sdpa_window.launches += 1
    return out


flash_sdpa_window.launches = 0
