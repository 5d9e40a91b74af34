"""Dequantizing matrix products over packed Q8_0 / Q4_K weights: the CUDA
kernels' wrappers beside their plain PyTorch versions, and the launch plan.

Counterparts of codec_tpu/ops/qmat_pallas.py::q8_0_matmul and
::q4_k_matmul. The kernels are csrc/qmat.cu, built by kernels/build.py on
first launch (never at import). For a CPU tensor a wrapper runs the plain
version (ops/qmat.py); for a CUDA tensor it launches the kernel or raises.
Each counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .qmat import _FUSED_MAX_M, QGROUP, q4_k_matmul_ref, q8_0_matmul_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q4K_IN_MULTIPLE = 256          # a Q4_K super-block

# the kernel's fixed tile (csrc/qmat.cu) and the plan's targets
ROWS = 32                       # output rows per block
MAX_SPLIT = 8                   # blocks of a cluster (portable limit)
MAX_STAGES = 4
TARGET_BLOCKS = 64              # a block per two of the H100's 132 SMs
MAX_KSLICE = 4096               # columns of a block's slice
KC_MAX = 512                    # columns per staged chunk
X_BYTES = 64 * 1024             # f32 x staged per pass
BOX = 128                       # qs bytes per row of a tensor-copy box


@dataclass(frozen=True)
class Plan:
    split: int      # K slices, the blocks of one cluster
    kslice: int     # columns of a slice
    kc: int         # columns per chunk (one ring stage)
    xk: int         # columns of x staged per pass
    stages: int     # ring stages
    bulk: bool      # tensor copies (else the cp.async form)
    blocks: int     # blocks on the card, of ROWS output rows each


def m_bucket(m: int) -> int:
    """m rounded up to the kernel's register bucket (1, 2, 4, 8, 16, 32)."""
    return next(b for b in (1, 2, 4, 8, 16, 32) if m <= b)


def granule(kind: str, in_d: int) -> int:
    """The columns that chunks and K slices are whole multiples of: a qs
    box of BOX bytes with tensor copies, a 32-group in the cp.async form."""
    if kind == "q4_k":
        return 2 * BOX
    return BOX if in_d % 128 == 0 else QGROUP


def plan(kind: str, m: int, in_d: int, out_d: int, split: int = 0) -> Plan:
    """The launch plan of q8_0_matmul ("q8_0") or q4_k_matmul ("q4_k") for
    x [m, in] and an [out, in] weight.

    - bulk: tensor copies need 16-byte row strides, so Q8_0 takes them
      only when its scale rows are 16-byte aligned (in % 128 == 0); Q4_K
      always (in % 256 == 0). Chunks are then whole qs boxes of BOX bytes
      (128 columns of Q8_0, 256 of Q4_K), else multiples of 32 columns
      (the cp.async form).
    - split: the fewest K slices (whole multiples of that granule, at most
      8, the cluster) that put TARGET_BLOCKS blocks of ROWS rows on the
      card with at most MAX_KSLICE columns each; the most that divide K
      when none does. Measured on the H100 (tools/qmat_plans.py), a
      cluster costs more than a block's slice of up to ~2048 columns
      saves: 64 blocks of 512 columns beat 128 of 256 at 512 × 2048, one
      slice of 2048 beats two of 1024 at 2048 × 2048, and two slices of
      4096 beat one of 8192 at 2048 × 8192. A given split (the tools'
      other plans) replaces that choice.
    - kc: the widest chunk up to KC_MAX that divides a slice; xk: the widest
      whole number of chunks that divides a slice with m's bucket of f32
      rows in X_BYTES; stages: 4 (18 KB of Q8_0 or 12 KB of Q4_K each at
      kc = 512), at most the slice's chunks.
    """
    bulk = kind == "q4_k" or in_d % 128 == 0
    g = granule(kind, in_d)
    row_blocks = -(-out_d // ROWS)
    if not split:
        for split in (s for s in range(1, MAX_SPLIT + 1) if (in_d // g) % s == 0):
            if row_blocks * split >= TARGET_BLOCKS and in_d // split <= MAX_KSLICE:
                break
    kslice = in_d // split
    kc = max(c for c in range(g, min(KC_MAX, kslice) + 1, g) if kslice % c == 0)
    rows_x = m_bucket(m)
    xk = max(c for c in range(kc, kslice + 1, kc)
             if kslice % c == 0 and (c == kc or rows_x * c * 4 <= X_BYTES))
    stages = min(kslice // kc, MAX_STAGES)
    return Plan(split, kslice, kc, xk, stages, bulk, row_blocks * split)


@functools.cache
def _kernel_fns():
    from ..kernels.build import load_library

    lib = load_library()
    q8, q4k = lib.codec_q8_0_matmul, lib.codec_q4_k_matmul
    q8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    q4k.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    if x.data_ptr() % 16 or any(p[1].data_ptr() % 16 for p in packed):
        raise ValueError(f"{name}: x and the packed tensors must be 16-byte "
                         f"aligned")
    return m, in_d, out_d


def _launch(name: str, fn, err_str, x: torch.Tensor, ptrs, m: int, in_d: int,
            out_d: int, p: Plan = None) -> torch.Tensor:
    """One launch under plan p (default: plan()); the tools pass others."""
    p = p or plan(name[:4], m, in_d, out_d)
    y = torch.empty((m, out_d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *ptrs, y.data_ptr(), m, in_d, out_d,
                 _DTYPE_CODES[x.dtype], p.split, p.kc, p.xk, p.stages, stream)
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
