"""Rotary position embeddings on [B, H, T, D] (counterpart of
codec_tpu/ops/rope.py), NEOX mode: pairs (i, i + D/2) rotate together."""

from __future__ import annotations

from typing import Optional

import torch


def rope_freqs(head_dim: int, theta: float, freq_scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [D/2], float32."""
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -2.0 * i / head_dim) * freq_scale


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               theta: float = 10000.0, freq_scale: float = 1.0
               ) -> torch.Tensor:
    """x: [B, H, T, D] → rotated [B, H, T, D] in x's dtype.

    positions: [T] or [B, T] (default arange(T)). Angles and the rotation
    are float32."""
    d = x.shape[-1]
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device)
    ang = positions.float()[..., None] * rope_freqs(d, theta, freq_scale,
                                                    x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.ndim == 2:                                 # [T, D/2]
        cos, sin = cos[None, None], sin[None, None]
    else:                                             # [B, T, D/2]
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.float()[..., : d // 2], x.float()[..., d // 2:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)
