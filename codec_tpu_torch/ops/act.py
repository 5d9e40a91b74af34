"""Elementwise activations (counterpart of codec_tpu/ops/act.py)."""

from __future__ import annotations

import torch


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))
