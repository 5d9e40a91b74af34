"""Scaled-dot-product attention with causal / sliding-window / n_valid masks.

Counterpart of codec_tpu/ops/attn.py. Layout is [B, H, T, D]; logits and
softmax are float32 whatever the compute dtype.

Dispatch in `mha`: causal self-attention without `n_valid` goes to
`attn_cuda.flash_sdpa_window`, which launches the CUDA kernel for a CUDA
tensor (any T, any window) and runs its plain version for a CPU tensor.
Non-causal attention and attention with `n_valid` use the masked `sdpa`,
as do the attentions no Pallas kernel of codec_tpu covers: a per-head
additive bias (`sdpa(bias=)`, the distill encoder's block-local attention)
and Shaw relative keys (`sdpa_rel_key`, the W2V-BERT conformer).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def attn_mask(t_q: int, t_k: int, causal: bool = True,
              window: Optional[int] = None,
              n_valid: Optional[torch.Tensor] = None,
              device=None, q_off: int = 0, k_start: int = 0) -> torch.Tensor:
    """Additive float32 mask [T_q, T_k] (or [B, T_q, T_k] with n_valid).

    Query i sits at key position p = q_off + i. Window w: key j is visible
    to it iff p - w < j <= p; keys j < k_start are masked; with n_valid,
    keys j >= n_valid[b] are masked for batch row b."""
    qi = q_off + torch.arange(t_q, device=device)[:, None]
    kj = torch.arange(t_k, device=device)[None, :]
    ok = torch.ones((t_q, t_k), dtype=torch.bool, device=device)
    if k_start:
        ok &= kj >= k_start
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
         mask: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, T, D] → [B, H, T_q, D] in v's dtype.

    mask: additive [T_q, T_k] / [B, T_q, T_k]; bias: additive per-head
    [H, T_q, T_k] (may hold -inf where a key is hidden, as long as every
    query sees one key). The logits are float32 products of the inputs
    (exact for bf16)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits += mask if mask.ndim == 2 else mask[:, None]
    if bias is not None:
        logits += bias
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def sdpa_rel_key(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dist_emb: torch.Tensor, left_max: int, right_max: int,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Shaw relative-key attention (the W2V-BERT conformer's; counterpart
    of codec_tpu/ops/attn.py::sdpa_rel_key). q, k, v: [B, H, T, D];
    dist_emb: [left_max + right_max + 1, D] → [B, H, T, D] in v's dtype.

    logits = (q·kᵀ + q·E[bucket]ᵀ) · scale, the scale applied after the
    add (HF Wav2Vec2Bert "relative_key"), bucket(tq, tk) = clamp(tk − tq,
    −left_max, right_max) + left_max; softmax in float32.

    codec_tpu gathers E[bucket] into [T, T, D] (256 MB a layer at T 1000,
    D 64 in f32, which the card would hold) and contracts q with it. Here
    q·Eᵀ is [B, H, T, L+R+1] and its [T, T] scores are gathered by bucket:
    the same dot products (each a D-long sum of the same terms), without
    the [T, T, D] tensor. Only the [B, H, T, T] logits are held."""
    t = q.shape[-2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    pos = torch.arange(t, device=q.device)
    bucket = (pos[None, :] - pos[:, None]).clamp(-left_max, right_max) \
        + left_max                                          # [T_q, T_k]
    qf = q.float()
    rel = torch.matmul(qf, dist_emb.float().t())            # [B, H, T, L+R+1]
    logits = torch.matmul(qf, k.float().transpose(-1, -2))
    logits += torch.take_along_dim(
        rel, bucket.expand(*rel.shape[:-2], t, t), dim=-1)
    w = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def mha(x: torch.Tensor, wq, wk, wv, wo, n_heads: int,
        rope_fn: Optional[Callable] = None, causal: bool = True,
        window: Optional[int] = None,
        n_valid: Optional[torch.Tensor] = None,
        attention: Optional[Callable] = None,
        bq=None, bk=None, bv=None, bo=None,
        n_kv_heads: Optional[int] = None) -> torch.Tensor:
    """Multi-head self-attention over [B, T, C], with grouped KV heads
    (n_kv_heads dividing n_heads: head h reads KV head h // rep) and
    optional biases added after each product.

    Linear weights are [out, in]; y = x @ w.T + b. `attention` replaces the
    causal attention function (default `attn_cuda.flash_sdpa_window`) with
    another of the same signature, e.g. its plain version, so a caller can
    compare the two on the same weights."""
    from .attn_cuda import flash_sdpa_window

    b, t, _ = x.shape
    n_kv = n_kv_heads or n_heads
    d = wq.shape[0] // n_heads

    def heads(w, bias, n):
        return torch.nn.functional.linear(x, w, bias).reshape(
            b, t, n, d).transpose(1, 2)

    q, k, v = heads(wq, bq, n_heads), heads(wk, bk, n_kv), heads(wv, bv, n_kv)
    if rope_fn is not None:
        q = rope_fn(q)
        k = rope_fn(k)
    if n_kv != n_heads:
        rep = n_heads // n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if causal and n_valid is None:
        attend = attention or flash_sdpa_window
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(),
                     window=window)
    else:
        m = attn_mask(t, t, causal=causal, window=window, n_valid=n_valid,
                      device=x.device)
        ctx = sdpa(q, k, v, mask=m)
    ctx = ctx.transpose(1, 2).reshape(b, t, n_heads * d)
    return torch.nn.functional.linear(ctx, wo, bo)
