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
