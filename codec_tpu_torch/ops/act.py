"""Elementwise activations (counterpart of codec_tpu/ops/act.py)."""

from __future__ import annotations

import torch


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (torch's gelu(approximate="tanh"), ggml_gelu),
    written out as the JAX package writes it."""
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3)))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x·tanh(softplus(x)), softplus as log(eˣ + 1) = logaddexp(x, 0), as
    the JAX package writes it (not F.mish)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def snake(x: torch.Tensor, alpha: torch.Tensor,
          eps: float = 1e-9) -> torch.Tensor:
    """Snake x + sin²(αx)/(α+eps) (DAC), α per channel on the last dim."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + eps)
