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


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize over the trailing (channel) dim (cosine RVQ)."""
    n = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)
