"""Rotary position embeddings on [B, H, T, D] (counterpart of
codec_tpu/ops/rope.py). NEOX mode rotates pairs (i, i + D/2) together;
NORMAL (interleaved) mode rotates pairs (2i, 2i + 1).

`rope_cos_sin` computes the angles once for a set of positions, so a
transformer can rotate q and k of every layer with them (`rotate`);
`apply_rope` does both in one call."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, freq_scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Per-pair inverse frequencies [D/2], float32."""
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(theta, -2.0 * i / head_dim) * freq_scale


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, freq_scale: float = 1.0,
                 freq_factors: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [T] or [B, T] → (cos, sin), each [T, D/2] or [B, T, D/2]
    float32. freq_factors [D/2] divide the inverse frequencies (llama3
    rope scaling, baked by the converters)."""
    inv = rope_freqs(head_dim, theta, freq_scale, positions.device)
    if freq_factors is not None:
        inv = inv / freq_factors
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           neox: bool = True) -> torch.Tensor:
    """x: [B, H, T, D] rotated by rope_cos_sin's angles, in x's dtype
    (the rotation itself is float32)."""
    if cos.ndim == 2:                                 # [T, D/2]
        cos, sin = cos[None, None], sin[None, None]
    else:                                             # [B, T, D/2]
        cos, sin = cos[:, None], sin[:, None]
    d = x.shape[-1]
    xf = x.float()
    if neox:
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:
        xe, xo = xf[..., 0::2], xf[..., 1::2]
        y = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                        dim=-1).reshape(xf.shape)
    return y.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               theta: float = 10000.0, freq_scale: float = 1.0,
               neox: bool = True,
               freq_factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, H, T, D] → rotated [B, H, T, D] in x's dtype.

    positions: [T] or [B, T] absolute positions (default arange(T))."""
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device)
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, freq_scale,
                            freq_factors)
    return rotate(x, cos, sin, neox)
