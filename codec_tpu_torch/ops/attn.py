"""Scaled-dot-product attention with causal / sliding-window / n_valid masks.

Counterpart of codec_tpu/ops/attn.py. Layout is [B, H, T, D]; logits and
softmax are float32 whatever the compute dtype.

Dispatch in `mha`: causal self-attention without `n_valid` goes to
`attn_cuda.flash_sdpa_window`, which launches the CUDA kernel for a CUDA
tensor (any T, any window) and runs its plain version for a CPU tensor.
Non-causal attention and attention with `n_valid` use the masked `sdpa`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def attn_mask(t_q: int, t_k: int, causal: bool = True,
              window: Optional[int] = None,
              n_valid: Optional[torch.Tensor] = None,
              device=None) -> torch.Tensor:
    """Additive float32 mask [T_q, T_k] (or [B, T_q, T_k] with n_valid).

    Window w: key j is visible to query i iff i - w < j <= i; with n_valid,
    keys j >= n_valid[b] are masked for batch row b."""
    qi = torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_k, device=device)[None, :]
    ok = torch.ones((t_q, t_k), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None and window > 0:
        ok &= kj > qi - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    mask = torch.where(ok, zero, neg)
    if n_valid is not None:
        valid = kj < n_valid.to(device)[:, None, None]       # [B, 1, T_k]
        mask = mask[None] + torch.where(valid, zero, neg)
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T_q, D] in v's dtype.

    mask: additive [T_q, T_k] / [B, T_q, T_k]. The logits are float32
    products of the inputs (exact for bf16)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + (mask if mask.ndim == 2 else mask[:, None])
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def mha(x: torch.Tensor, wq, wk, wv, wo, n_heads: int,
        rope_fn: Optional[Callable] = None, causal: bool = True,
        window: Optional[int] = None,
        n_valid: Optional[torch.Tensor] = None,
        attention: Optional[Callable] = None) -> torch.Tensor:
    """Multi-head self-attention over [B, T, C].

    Linear weights are [out, in]; y = x @ w.T. `attention` replaces the
    causal attention function (default `attn_cuda.flash_sdpa_window`) with
    another of the same signature, e.g. its plain version, so a caller can
    compare the two on the same weights."""
    from .attn_cuda import flash_sdpa_window

    b, t, _ = x.shape
    d = wq.shape[0] // n_heads

    def heads(w):
        return torch.nn.functional.linear(x, w).reshape(
            b, t, n_heads, d).transpose(1, 2)

    q, k, v = heads(wq), heads(wk), heads(wv)
    if rope_fn is not None:
        q = rope_fn(q)
        k = rope_fn(k)
    if causal and n_valid is None:
        attend = attention or flash_sdpa_window
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                     window=window)
    else:
        m = attn_mask(t, t, causal=causal, window=window, n_valid=n_valid,
                      device=x.device)
        ctx = sdpa(q, k, v, mask=m)
    ctx = ctx.transpose(1, 2).reshape(b, t, n_heads * d)
    return torch.nn.functional.linear(ctx, wo)
