"""The least time an H100 could take for a kernel's work: the bound that
`chip_smoke.py` and `tools/seanet_times.py` set beside each kernel time."""

from __future__ import annotations

import torch

# H100 SXM data-sheet peaks (dense): f32 on the FMA units, bf16 and f16 on
# the tensor cores, "tf32" the tensor cores' TF32 rate (the split-f32 kernels
# run each f32 product as three TF32 passes, csrc/tf32x3.cuh), and HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def least_time(flops, nbytes):
    """The larger of the bytes over the HBM rate and the operations over
    their type's peak; flops is [(count, dtype)]. Returns (ms, "bytes" or
    "operations")."""
    t_ops = sum(f / PEAK_FLOPS[dt] for f, dt in flops)
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")
