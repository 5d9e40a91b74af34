"""Packed Q8_0 / Q4_K weights: packing from GGUF blocks, the plain
dequantizer, and the `qmatmul` dispatch.

Counterpart of codec_tpu/ops/qmat_pallas.py's host side; its two kernels
are ops/qmat_cuda.py (csrc/qmat.cu). The weights stay quantized on the
device and are dequantized inside the kernel:

  Q8_0: qs int8 [out, in], scale f32 [out, in/32]            (1.125 B/weight)
  Q4_K: qs uint8 [out, in/2], scale and minv f32 [out, in/32]  (0.75 B/weight)

The packing is this package's own, in natural column order: Q8_0's column
j is element j; Q4_K's 16 bytes of 32-group g hold element 32g+j in the
low nibble and 32g+16+j in the high nibble, so one 16-byte load is one
group with one scale and one min. (The TPU packing is group-minor, for
`pltpu.repeat`; `natural_order` converts it.) Dequantized values equal
GGUF's bit for bit: Q8_0 is q·d, Q4_K is (q·(d·sc)) − dmin·m with the two
products and the difference each rounded to f32, as GGUF's dequantizer
computes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..io.gguf import K_SCALE_SIZE, QK_K, _unpack_scale_min_k4

QGROUP = 32
# rows up to which a CUDA product launches the kernel; beyond it the
# product is prefill-sized and goes to dequant + torch.matmul, as the
# reference sends it to dequant + XLA dot (qmat_pallas.py:260-277)
_FUSED_MAX_M = 32


def pack_q8_0(raw: np.ndarray, shape) -> Dict[str, np.ndarray]:
    """raw: uint8 GGUF Q8_0 blocks of an [out, in] (numpy-shape) tensor."""
    out_d, in_d = int(np.prod(shape[:-1])), int(shape[-1])
    if in_d % QGROUP:
        raise ValueError(f"Q8_0 needs in % {QGROUP} == 0, got {in_d}")
    nb = in_d // QGROUP
    buf = np.asarray(raw, np.uint8).reshape(out_d * nb, 2 + QGROUP)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    qs = buf[:, 2:].copy().view(np.int8).reshape(out_d, in_d)
    return {"qs": qs, "scale": d.reshape(out_d, nb)}


def pack_q4_k(raw: np.ndarray, shape) -> Dict[str, np.ndarray]:
    """raw: uint8 GGUF Q4_K super-blocks of an [out, in] tensor."""
    out_d, in_d = int(np.prod(shape[:-1])), int(shape[-1])
    if in_d % QK_K:
        raise ValueError(f"Q4_K needs in % {QK_K} == 0, got {in_d}")
    ng = in_d // QGROUP
    buf = np.asarray(raw, np.uint8).reshape(-1, 4 + K_SCALE_SIZE + QK_K // 2)
    d = buf[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
    dmin = buf[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:4 + K_SCALE_SIZE])        # [N, 8]
    qs = buf[:, 4 + K_SCALE_SIZE:].reshape(-1, 4, 32)
    # GGUF: byte j of 32-byte chunk c holds element 64c+j (low nibble, group
    # 2c) and 64c+32+j (high nibble, group 2c+1); regroup per 32-group
    q = np.stack([qs & 0x0F, qs >> 4], axis=2).reshape(-1, 8, 32)
    packed = (q[:, :, :16] | (q[:, :, 16:] << 4)).astype(np.uint8)
    return {"qs": packed.reshape(out_d, in_d // 2),
            "scale": (d[:, None] * sc.astype(np.float32)).reshape(out_d, ng),
            "minv": (dmin[:, None] * mn.astype(np.float32)).reshape(out_d, ng)}


def pack_tensor(reader, name: str) -> Dict[str, np.ndarray]:
    """Pack a GGUF Q8_0/Q4_K tensor (raises ValueError on other types)."""
    kind, raw, shape = reader.get_raw_quant(name)
    if kind == "Q8_0":
        return pack_q8_0(raw, shape)
    if kind == "Q4_K":
        return pack_q4_k(raw, shape)
    raise ValueError(f"no packed path for {kind} tensor {name}")


def natural_order(qt: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A codec_tpu packed dict (group-minor columns: column j' holds
    element 32·(j' % n_groups) + j' // n_groups, or byte j' // n_groups of
    group j' % n_groups for Q4_K) → this package's natural order, bit for
    bit. Scales and mins are [out, n_groups] in both."""
    qs = np.asarray(qt["qs"])
    out_d, cols = qs.shape
    ng = np.asarray(qt["scale"]).shape[-1]
    qs = qs.reshape(out_d, cols // ng, ng).transpose(0, 2, 1).reshape(out_d, cols)
    return {k: np.ascontiguousarray(qs if k == "qs" else np.asarray(v))
            for k, v in qt.items()}


def to_device(qt: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
            .to(device) for k, v in qt.items()}


def in_features(qt: Dict[str, torch.Tensor]) -> int:
    return qt["qs"].shape[1] * (2 if "minv" in qt else 1)


def dequant_ref(qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The whole dequantized [out, in] float32 matrix."""
    qs, scale = qt["qs"], qt["scale"]
    out_d, ng = scale.shape
    if "minv" not in qt:
        w = qs.float().reshape(out_d, ng, QGROUP) * scale[:, :, None]
        return w.reshape(out_d, ng * QGROUP)
    q = qs.reshape(out_d, ng, 16)
    s, mv = scale[:, :, None], qt["minv"][:, :, None]
    lo = (q & 0x0F).float() * s - mv
    hi = (q >> 4).float() * s - mv
    return torch.cat([lo, hi], dim=2).reshape(out_d, ng * QGROUP)


def q8_0_matmul_ref(x: torch.Tensor, qs: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the Q8_0 kernel: x [m, in] @ dequant(W)ᵀ in f32."""
    return x.float() @ dequant_ref({"qs": qs, "scale": scale}).T


def q4_k_matmul_ref(x: torch.Tensor, qs: torch.Tensor, scale: torch.Tensor,
                    minv: torch.Tensor) -> torch.Tensor:
    """Plain version of the Q4_K kernel: x [m, in] @ dequant(W)ᵀ in f32."""
    return x.float() @ dequant_ref({"qs": qs, "scale": scale,
                                    "minv": minv}).T


def qmatmul_plain(x: torch.Tensor, qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ dequant(qt)ᵀ → [..., out] float32 on any device."""
    _check_in(x, qt)
    return x.float() @ dequant_ref(qt).T


def qmatmul(x: torch.Tensor, qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ dequant(qt)ᵀ → [..., out] float32.

    A CUDA x with at most 32 rows launches the Q8_0 or Q4_K kernel
    (ops/qmat_cuda.py), which raises on what it cannot take; more rows
    dequantize and go to torch.matmul. A CPU x takes the plain version."""
    _check_in(x, qt)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cuda" and x2.shape[0] <= _FUSED_MAX_M:
        from .qmat_cuda import q4_k_matmul, q8_0_matmul

        x2 = x2.contiguous()
        if "minv" in qt:
            y = q4_k_matmul(x2, qt["qs"], qt["scale"], qt["minv"])
        else:
            y = q8_0_matmul(x2, qt["qs"], qt["scale"])
    else:
        y = qmatmul_plain(x2, qt)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _check_in(x: torch.Tensor, qt: Dict[str, torch.Tensor]) -> None:
    in_d = in_features(qt)
    if in_d % QGROUP or x.shape[-1] != in_d:
        raise ValueError(f"qmatmul: x [..., {x.shape[-1]}] against a packed "
                         f"weight of {in_d} inputs (a multiple of {QGROUP} "
                         f"is needed)")
