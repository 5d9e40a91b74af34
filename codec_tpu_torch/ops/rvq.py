"""Residual vector quantization: the encode search and the decode sum
(counterparts of codec_tpu/ops/rvq.py::rvq_layer_encode, ::rvq_encode and
::rvq_decode_sum).

The search uses argmin_v ||r - cb_v||² = argmax_v (2 r·cb_v - ||cb_v||²)
with f32 scores; torch.argmax returns the first maximum, as jnp.argmax
does, so exact ties go to the lowest index. ops/rvq_cuda.py holds the CUDA
kernel that runs all levels of `rvq_encode` in one launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def codebook_norms(codebooks: torch.Tensor) -> torch.Tensor:
    """||cb_v||² in f32 over the trailing dim ([..., V, D] → [..., V])."""
    return torch.sum(torch.square(codebooks.float()), dim=-1)


def search_state(codebooks: torch.Tensor) -> dict:
    """What an encoder's search takes, built once at load: {"cb": the
    codebooks in f32, contiguous (an f32 model's own tensor; a 16-bit model
    keeps an f32 copy), "norms": their codebook_norms}."""
    cb = codebooks.float().contiguous()
    return {"cb": cb, "norms": codebook_norms(cb)}


def rvq_layer_encode(residual: torch.Tensor, codebook: torch.Tensor,
                     norms: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level. residual [..., D], codebook [V, D] (norms [V], computed
    when not given) → (indices [...] int32, residual - codebook[indices])."""
    if norms is None:
        norms = codebook_norms(codebook)
    scores = 2.0 * torch.matmul(residual.float(), codebook.float().T) - norms
    idx = torch.argmax(scores, dim=-1)
    return idx.to(torch.int32), residual - codebook[idx]


def rvq_encode(x: torch.Tensor, codebooks: torch.Tensor,
               norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All levels of stacked codebooks [n_q, V, D]. x [B, T, D] → codes
    [B, T, n_q] int32. norms [n_q, V] (codebook_norms of the codebooks) is
    computed here when not given."""
    if norms is None:
        norms = codebook_norms(codebooks)
    codes = []
    residual = x
    for q in range(codebooks.shape[0]):
        idx, residual = rvq_layer_encode(residual, codebooks[q], norms[q])
        codes.append(idx)
    return torch.stack(codes, dim=-1)


def rvq_decode_sum(codes: torch.Tensor, codebooks: torch.Tensor,
                   n_q: Optional[int] = None) -> torch.Tensor:
    """Sum of codebook rows. codes: [B, T, n_q] int, codebooks [n_q, V, D]
    → [B, T, D]. A gather per level and a sum over levels: the same value
    as the reference's one-hot contraction."""
    if n_q is None:
        n_q = codes.shape[-1]
    levels = torch.arange(n_q, device=codes.device)
    return codebooks[levels, codes[..., :n_q].long()].sum(dim=-2)
