"""Causal sliding-window flash attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of codec_tpu/ops/attn_pallas.py::flash_sdpa_window, extended to
the keys a streaming step carries (k longer than q; the masked attention of
codec_tpu/models/mimi.py::_transformer_stream). The kernel
is csrc/flash_sdpa_window.cu, built by kernels/build.py on first launch
(never at import). For a CPU tensor the wrapper runs the plain version;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..kernels.build import launch_on
from .attn import attn_mask, sdpa

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_BQ = 16                      # queries per block (csrc/flash_sdpa_window.cu)
_MAX_Q_TILES = 65535          # gridDim.y limit
MAX_T = _BQ * _MAX_Q_TILES    # the most queries one launch takes
REF_BLOCK = 512               # queries per step of the plain version


def flash_sdpa_window_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          k_start: int = 0,
                          block: int = REF_BLOCK) -> torch.Tensor:
    """Plain version: the masked sdpa with a causal (+ window) mask, query i
    at key position Tk - Tq + i, keys before k_start masked.

    Banded: each block of `block` queries, at key positions p0 .. p1 - 1,
    meets only the keys its rows can see, [max(k_start, p0 - window + 1),
    p1), under the same mask cut to that band. The keys left out are those
    the full mask hides, whose softmax weights are exactly 0, so each row
    is the same function of the same logits; memory is O(Tq·(block +
    window)) instead of O(Tq·Tk) (3 heads at T 120 000 would need 173 GB
    of logits in one piece)."""
    t_q, t_k = q.shape[-2], k.shape[-2]
    if t_q == 0:
        return torch.empty(*q.shape[:-1], v.shape[-1], dtype=v.dtype,
                           device=q.device)
    outs = []
    for i0 in range(0, t_q, block):
        i1 = min(i0 + block, t_q)
        p0, p1 = t_k - t_q + i0, t_k - t_q + i1
        lo = k_start if window is None else max(k_start, p0 - window + 1)
        outs.append(sdpa(q[..., i0:i1, :], k[..., lo:p1, :],
                         v[..., lo:p1, :], scale=scale,
                         mask=attn_mask(i1 - i0, p1 - lo, causal=True,
                                        window=window, device=q.device,
                                        q_off=p0 - lo)))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


@functools.cache
def _kernel_fn():
    from ..kernels.build import load_library

    lib = load_library()
    fn = lib.codec_flash_sdpa_window
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.codec_cuda_error_string


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], k_start: int) -> None:
    """Raises unless the kernel takes these arguments. A Mimi layer's
    attention is a few microseconds on the card, so every test reads only
    what the tensors hold (no device objects); the messages are built on
    failure."""
    shape, dev = q.shape, q.get_device()
    if len(shape) != 4:
        raise ValueError(f"flash_sdpa_window: q must be [B, H, T, D], got "
                         f"{tuple(shape)}")
    for name, x in (("k", k), ("v", v)):
        if (x.shape != k.shape or x.shape[:2] != shape[:2]
                or x.shape[3:] != shape[3:] or x.shape[2] < shape[2]
                or x.dtype is not q.dtype or x.get_device() != dev):
            raise ValueError(
                f"flash_sdpa_window: {name} {tuple(x.shape)} {x.dtype} on "
                f"{x.device} does not fit q {tuple(shape)} {q.dtype} on "
                f"{q.device} (k and v [B, H, Tk, D] with Tk >= Tq)")
    if not (isinstance(k_start, int) and 0 <= k_start <= k.shape[2] - shape[2]):
        raise ValueError(f"flash_sdpa_window: k_start must be an int in "
                         f"[0, Tk - Tq = {k.shape[2] - shape[2]}], got "
                         f"{k_start!r}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_sdpa_window: dtype {q.dtype} not supported "
                         f"(float32, bfloat16 or float16)")
    if shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash_sdpa_window: head dim {shape[3]} not "
                         f"supported {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_sdpa_window: q, k and v must be contiguous")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_sdpa_window: window must be None or a "
                         f"positive int, got {window!r}")
    if not (1 <= shape[2] <= MAX_T and k.shape[2] < 2 ** 31
            and 1 <= shape[0] * shape[1] < 2 ** 31):
        raise ValueError(f"flash_sdpa_window: shape {tuple(shape)} out of "
                         f"the kernel's range")


def flash_sdpa_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None,
                      window: Optional[int] = None,
                      k_start: int = 0) -> torch.Tensor:
    """Causal (+ optional sliding-window) attention.

    q: [B, H, Tq, D], k, v: [B, H, Tk, D] with Tk >= Tq (f32, bf16 or f16; D in
    {64, 128} on CUDA) → [B, H, Tq, D] in v's dtype. Query i sits at key
    position p = Tk - Tq + i and sees key j iff k_start <= j <= p and
    p - window < j; 0 <= k_start <= Tk - Tq. With Tk == Tq and k_start 0
    this is causal self-attention. Counts its kernel launches in
    `flash_sdpa_window.launches`."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_sdpa_window_ref(q, k, v, scale=scale, window=window,
                                         k_start=k_start)
        raise ValueError(f"flash_sdpa_window: no kernel for device {q.device}")
    _check(q, k, v, window, k_start)
    b, h, t, d = q.shape
    if scale is None:
        scale = d ** -0.5
    fn, err_str = _kernel_fn()
    # the kernel copies 16-byte words: a view that starts off such a word
    # is copied to a fresh (aligned) tensor
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    err = launch_on(q.get_device(), lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t,
        k.shape[2], k_start, d, window or 0, float(scale),
        _DTYPE_CODES[q.dtype], stream))
    if err != 0:
        raise RuntimeError(f"flash_sdpa_window: kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    flash_sdpa_window.launches += 1
    return out


flash_sdpa_window.launches = 0
