"""Fused Euclidean RVQ search: the CUDA kernel's wrapper.

Counterpart of codec_tpu/ops/rvq_pallas.py::rvq_encode_fused. The kernel is
csrc/rvq_encode.cu, built by kernels/build.py on first launch (never at
import); it runs every level of the search in one launch, with the residual
kept on chip. Its plain version is ops/rvq.py::rvq_encode. For a CPU tensor
the wrapper runs the plain version; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .rvq import codebook_norms, rvq_encode
from .seanet_cuda import smem_per_block


@functools.cache
def _lib():
    from ..kernels.build import load_library

    lib = load_library()
    lib.codec_rvq_encode.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.codec_rvq_encode.restype = ctypes.c_int
    lib.codec_rvq_encode_smem_bytes.argtypes = [ctypes.c_int]
    lib.codec_rvq_encode_smem_bytes.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, codebooks: torch.Tensor) -> None:
    for name, t, ndim in (("x", x, 3), ("codebooks", codebooks, 3)):
        if t.dtype != torch.float32:
            raise ValueError(f"rvq_encode_fused: {name} must be float32, got "
                             f"{t.dtype} (cast a bf16 model's latent and "
                             f"codebooks to f32 first)")
        if t.ndim != ndim or 0 in t.shape:
            raise ValueError(f"rvq_encode_fused: {name} must be a non-empty "
                             f"{ndim}-d tensor, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"rvq_encode_fused: {name} is on {t.device}, x "
                             f"on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rvq_encode_fused: {name} must be contiguous")
    if codebooks.shape[2] != x.shape[2]:
        raise ValueError(f"rvq_encode_fused: x has D={x.shape[2]}, the "
                         f"codebooks D={codebooks.shape[2]}")
    n = x.shape[0] * x.shape[1]
    if n >= 2 ** 31 or codebooks.numel() >= 2 ** 31:
        raise ValueError("rvq_encode_fused: shape out of the kernel's range")


def rvq_encode_fused(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] f32, codebooks [n_q, V, D] f32 → codes [B, T, n_q]
    int32, equal to ops/rvq.py::rvq_encode up to the order of the dot
    products' sums (bit for bit where those are exact).

    Counts its kernel launches in `rvq_encode_fused.launches`."""
    if x.device.type == "cpu":
        return rvq_encode(x, codebooks)
    if x.device.type != "cuda":
        raise ValueError(f"rvq_encode_fused: no kernel for device {x.device}")
    _check(x, codebooks)
    b, t, d = x.shape
    n_q, v, _ = codebooks.shape
    lib = _lib()
    limit = smem_per_block(x.device.index or 0)
    need = lib.codec_rvq_encode_smem_bytes(d)
    if need > limit:
        raise ValueError(f"rvq_encode_fused: D={d} needs {need} bytes of "
                         f"shared memory, the device has {limit}")
    norms = codebook_norms(codebooks)
    codes = torch.empty((b, t, n_q), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.codec_rvq_encode(x.data_ptr(), codebooks.data_ptr(),
                                   norms.data_ptr(), codes.data_ptr(), b * t,
                                   d, n_q, v, stream)
    if err != 0:
        raise RuntimeError(f"rvq_encode_fused: kernel launch failed: "
                           f"{lib.codec_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    rvq_encode_fused.launches += 1
    return codes


rvq_encode_fused.launches = 0
