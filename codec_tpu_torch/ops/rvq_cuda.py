"""Fused Euclidean RVQ search: the CUDA kernel's wrapper and its launch plan.

Counterpart of codec_tpu/ops/rvq_pallas.py::rvq_encode_fused. The kernel is
csrc/rvq_encode.cu, built by kernels/build.py on first launch (never at
import); it runs every level of the search in one launch, with the residual
kept on chip. Its plain version is ops/rvq.py::rvq_encode. For a CPU tensor
the wrapper runs the plain version; for a CUDA tensor it launches the
kernel or raises.

The launch plan (`plan`) picks how many frames a cluster of 8 blocks takes
(32, 16 or 8) from N and D.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.build import launch_on
from .rvq import codebook_norms, rvq_encode
from .seanet_cuda import smem_per_block

FRAMES = (32, 16, 8)          # frames per cluster (the kernel's instantiations)
CLUSTER = 8                   # blocks per cluster: the split of V
HELD = 15                     # clusters of 8 an H100 holds at once
                              # (cudaOccupancyMaxActiveClusters at 16 and 32
                              # frames, D 256)
TILE_V = 256                  # codebook rows a block scores per pass
_CHUNK_BYTES = TILE_V * 32 * 4    # one staged chunk: 256 rows x 32 columns f32
_STAGES = {32: 3, 16: 4, 8: 2}


def smem_bytes(frames: int, d: int) -> int:
    """Dynamic shared memory of one block (csrc/rvq_encode.cu::layout):
    the codebook stages, the residual's split hi and lo (each F x dp f32),
    the winners' rows (F x dp f32; at 8 frames only their F indices), the
    candidates, the barriers, and 1024 bytes to align the stages."""
    dp = -(-d // 32) * 32
    stages = _STAGES[frames]
    rows = 4 * frames * (dp if frames != 8 else 1)
    total = (stages * _CHUNK_BYTES + 8 * frames * dp + rows
             + 8 * 2 * CLUSTER * frames + 8 * 8 * frames)
    return 1024 + total + 8 * (2 * stages + 3)


def plan(n: int, d: int, smem_limit: int) -> int:
    """Frames per cluster for N frames of dimension d: 16 while N's clusters
    of 16 frames all run in one round (N <= 16 x HELD), else 32, the faster
    of the two at each N of the sweep (PERF.md §6); fewer where that many
    frames' residual does not fit in smem_limit bytes beside the stages (32
    frames take D up to 320, 16 up to 480, 8 up to 2560)."""
    first = 16 if -(-n // 16) <= HELD else 32
    for frames in FRAMES[FRAMES.index(first):]:
        if smem_bytes(frames, d) <= smem_limit:
            return frames
    raise ValueError(f"rvq_encode_fused: D={d} needs {smem_bytes(8, d)} "
                     f"bytes of shared memory, the device has {smem_limit}")


@functools.cache
def _lib():
    from ..kernels.build import load_library

    lib = load_library()
    lib.codec_rvq_encode.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.codec_rvq_encode.restype = ctypes.c_int
    lib.codec_rvq_encode_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.codec_rvq_encode_smem_bytes.restype = ctypes.c_int
    lib.codec_rvq_encode_max_clusters.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.codec_rvq_encode_max_clusters.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(what: str, err: int):
    raise RuntimeError(f"rvq_encode_fused: {what}: "
                       f"{_lib().codec_cuda_error_string(err).decode()} "
                       f"(cudaError {err})")


def held_clusters(device: int, frames: int, d: int) -> int:
    """How many clusters of the `frames` kernel device holds at once for
    dimension d (cudaOccupancyMaxActiveClusters): what HELD stands for, read
    by the tools and the tests, not by a launch."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().codec_rvq_encode_max_clusters(frames, d, ctypes.byref(out))
    if err != 0:
        _raise("cudaOccupancyMaxActiveClusters failed", err)
    return out.value


_smem_limit = functools.cache(smem_per_block)   # per device index


def _check(x: torch.Tensor, codebooks: torch.Tensor,
           norms: Optional[torch.Tensor]) -> None:
    """Raises unless the kernel takes these arguments. Every test reads only
    what the tensors hold (no device objects): the kernel's launch is a few
    microseconds of host time. The messages are built on failure."""
    dev = x.get_device()
    for name, t, ndim in (("x", x, 3), ("codebooks", codebooks, 3),
                          ("norms", norms, 2)):
        if t is None:
            continue
        if t.dtype is not torch.float32:
            raise ValueError(f"rvq_encode_fused: {name} must be float32, got "
                             f"{t.dtype} (cast a bf16 model's latent and "
                             f"codebooks to f32 first)")
        if t.dim() != ndim or t.numel() == 0:
            raise ValueError(f"rvq_encode_fused: {name} must be a non-empty "
                             f"{ndim}-d tensor, got {tuple(t.shape)}")
        if t.get_device() != dev:
            raise ValueError(f"rvq_encode_fused: {name} is on {t.device}, x "
                             f"on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rvq_encode_fused: {name} must be contiguous")
    if codebooks.shape[2] != x.shape[2]:
        raise ValueError(f"rvq_encode_fused: x has D={x.shape[2]}, the "
                         f"codebooks D={codebooks.shape[2]}")
    if norms is not None and norms.shape != codebooks.shape[:2]:
        raise ValueError(f"rvq_encode_fused: norms must be [n_q, V] = "
                         f"{tuple(codebooks.shape[:2])}, got "
                         f"{tuple(norms.shape)}")
    if x.numel() >= 2 ** 31 or codebooks.numel() >= 2 ** 31:
        raise ValueError("rvq_encode_fused: shape out of the kernel's range")


def rvq_encode_fused(x: torch.Tensor, codebooks: torch.Tensor,
                     norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D] f32, codebooks [n_q, V, D] f32 → codes [B, T, n_q]
    int32, equal to ops/rvq.py::rvq_encode up to the order and the split-f32
    rounding of the dot products (bit for bit where those are exact).
    norms [n_q, V] f32 (ops/rvq.py::codebook_norms of the codebooks, which
    a model keeps from load) is computed here when not given.

    Counts its kernel launches in `rvq_encode_fused.launches`."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rvq_encode(x, codebooks, norms)
        raise ValueError(f"rvq_encode_fused: no kernel for device {x.device}")
    _check(x, codebooks, norms)
    b, t, d = x.shape
    n_q, v, _ = codebooks.shape
    if norms is None:
        norms = codebook_norms(codebooks)
    if d % 4 or codebooks.data_ptr() % 16:
        # the tensor map reads rows of whole 16-byte words: zero columns
        # change no product and no norm
        pad = -d % 4
        x = F.pad(x, (0, pad))
        codebooks = F.pad(codebooks, (0, pad))
        d += pad
    device = x.get_device()
    frames = plan(b * t, d, _smem_limit(device))
    codes = x.new_empty((b, t, n_q), dtype=torch.int32)
    lib = _lib()
    err = launch_on(device, lambda stream: lib.codec_rvq_encode(
        x.data_ptr(), codebooks.data_ptr(), norms.data_ptr(), codes.data_ptr(),
        b * t, d, n_q, v, frames, stream))
    if err != 0:
        _raise("kernel launch failed", err)
    rvq_encode_fused.launches += 1
    return codes


rvq_encode_fused.launches = 0
