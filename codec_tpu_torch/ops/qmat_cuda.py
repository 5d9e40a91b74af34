"""Dequantizing matrix products over packed Q8_0 / Q4_K weights: the CUDA
kernels' wrappers beside their plain PyTorch versions.

Counterparts of codec_tpu/ops/qmat_pallas.py::q8_0_matmul and
::q4_k_matmul. The kernels are csrc/qmat.cu, built by kernels/build.py on
first launch (never at import). For a CPU tensor a wrapper runs the plain
version (ops/qmat.py); for a CUDA tensor it launches the kernel or raises.
Each counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .qmat import _FUSED_MAX_M, QGROUP, q4_k_matmul_ref, q8_0_matmul_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q4K_IN_MULTIPLE = 256          # a Q4_K super-block


@functools.cache
def _kernel_fns():
    from ..kernels.build import load_library

    lib = load_library()
    q8, q4k = lib.codec_q8_0_matmul, lib.codec_q4_k_matmul
    q8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    q4k.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    q8.restype = q4k.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return q8, q4k, lib.codec_cuda_error_string


def _check(name: str, x: torch.Tensor, in_multiple: int, packed) -> tuple:
    """Raise on what the kernel does not take; → (m, in, out)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.ndim != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x must be [m, in] float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    m, in_d = x.shape
    out_d = packed[0][1].shape[0]
    if not 1 <= m <= _FUSED_MAX_M:
        raise ValueError(f"{name}: m={m} rows, the kernel takes 1 to "
                         f"{_FUSED_MAX_M}")
    if in_d % in_multiple or out_d < 1 or in_d * out_d >= 2 ** 31:
        raise ValueError(f"{name}: in={in_d} out={out_d} out of the kernel's "
                         f"range (in a multiple of {in_multiple})")
    for label, t, dtype, shape in packed:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: {label} must be {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for label, t in [("x", x)] + [(p[0], p[1]) for p in packed]:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.data_ptr() % 16 or packed[0][1].data_ptr() % 16:
        raise ValueError(f"{name}: x and qs must be 16-byte aligned")
    return m, in_d, out_d


def _launch(name: str, fn, err_str, x: torch.Tensor, ptrs, m: int, in_d: int,
            out_d: int) -> torch.Tensor:
    y = torch.empty((m, out_d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *ptrs, y.data_ptr(), m, in_d, out_d,
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    return y


def q8_0_matmul(x: torch.Tensor, qs: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [m, in] (f32 or bf16; m <= 32 on CUDA) @ dequant(qs int8 [out,
    in], scale f32 [out, in/32])ᵀ → y [m, out] float32."""
    if x.device.type == "cpu":
        return q8_0_matmul_ref(x, qs, scale)
    in_d = x.shape[-1]
    m, in_d, out_d = _check("q8_0_matmul", x, QGROUP, [
        ("qs", qs, torch.int8, (qs.shape[0], in_d)),
        ("scale", scale, torch.float32, (qs.shape[0], in_d // QGROUP))])
    fn, _, err_str = _kernel_fns()
    y = _launch("q8_0_matmul", fn, err_str, x,
                (qs.data_ptr(), scale.data_ptr()), m, in_d, out_d)
    q8_0_matmul.launches += 1
    return y


def q4_k_matmul(x: torch.Tensor, qs: torch.Tensor, scale: torch.Tensor,
                minv: torch.Tensor) -> torch.Tensor:
    """x [m, in] (f32 or bf16; m <= 32, in % 256 == 0 on CUDA) @
    dequant(qs uint8 [out, in/2], scale, minv f32 [out, in/32])ᵀ → y [m,
    out] float32."""
    if x.device.type == "cpu":
        return q4_k_matmul_ref(x, qs, scale, minv)
    in_d = x.shape[-1]
    groups = (qs.shape[0], in_d // QGROUP)
    m, in_d, out_d = _check("q4_k_matmul", x, _Q4K_IN_MULTIPLE, [
        ("qs", qs, torch.uint8, (qs.shape[0], in_d // 2)),
        ("scale", scale, torch.float32, groups),
        ("minv", minv, torch.float32, groups)])
    _, fn, err_str = _kernel_fns()
    y = _launch("q4_k_matmul", fn, err_str, x,
                (qs.data_ptr(), scale.data_ptr(), minv.data_ptr()), m, in_d,
                out_d)
    q4_k_matmul.launches += 1
    return y


q8_0_matmul.launches = 0
q4_k_matmul.launches = 0
