"""Residual vector quantization decode (counterpart of
codec_tpu/ops/rvq.py::rvq_decode_sum)."""

from __future__ import annotations

from typing import Optional

import torch


def rvq_decode_sum(codes: torch.Tensor, codebooks: torch.Tensor,
                   n_q: Optional[int] = None) -> torch.Tensor:
    """Sum of codebook rows. codes: [B, T, n_q] int, codebooks [n_q, V, D]
    → [B, T, D]. A gather per level and a sum over levels: the same value
    as the reference's one-hot contraction."""
    if n_q is None:
        n_q = codes.shape[-1]
    levels = torch.arange(n_q, device=codes.device)
    return codebooks[levels, codes[..., :n_q].long()].sum(dim=-2)
