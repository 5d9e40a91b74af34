"""Normalization over channels-last activations (counterpart of
codec_tpu/ops/norms.py)."""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor,
               beta: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing (channel) dim."""
    return torch.nn.functional.layer_norm(x, x.shape[-1:], gamma, beta, eps)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the trailing dim, in x's dtype: x / rms(x) * gamma."""
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               n_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [B, T, C]: each channel group normalised over (T,
    group), then the per-channel affine. (The aten op: F.group_norm
    refuses a group of one value, which normalises to 0.)"""
    y = torch.group_norm(x.transpose(1, 2), n_groups, gamma, beta, eps)
    return y.transpose(1, 2)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize over the trailing (channel) dim (cosine RVQ)."""
    n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)
