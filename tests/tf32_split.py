"""A pure-torch emulation of the split-f32 products of the port's CUDA
kernels (codec_tpu_torch/csrc/tf32x3.cuh), for the CPU tests only.

An f32 value x is split into hi = rna(x) (TF32: 10 mantissa bits, rounded
to nearest, ties away from zero, as cvt.rna.tf32.f32) and lo; a product
takes three tensor-core passes, hi·hi + hi·lo + lo·hi, each operand read as
TF32 (its low 13 bits dropped). Products of TF32 values are exact; the
sums are taken in f64 here and rounded to f32 once, so what the emulation
keeps of the card's error is the split's: the dropped lo·lo term and the
rounding of the parts. Imports no JAX.
"""

import torch

_LOW = 0x1FFF            # the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (ties away from zero), as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~_LOW).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its low 13 bits
    dropped."""
    return torch.bitwise_and(x.float().contiguous().view(torch.int32),
                             ~_LOW).view(torch.float32)


def split(x: torch.Tensor, exact: bool = False):
    """(hi, lo): lo = rna(x - hi), or with exact=True lo = x - hi unrounded
    (hi + lo == x; the RVQ kernel keeps its residual so)."""
    hi = tf32_rna(x)
    lo = x.float() - hi
    return hi, (lo if exact else tf32_rna(lo))


def matmul_3x(a: torch.Tensor, b: torch.Tensor,
              exact_a: bool = False) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] in split f32 → f32."""
    a_hi, a_lo = split(a, exact_a)
    b_hi, b_lo = split(b)
    a_lo, b_lo = tf32_trunc(a_lo), tf32_trunc(b_lo)

    def mm(u, v):
        return torch.matmul(u.double(), v.double())

    return (mm(a_hi, b_hi) + (mm(a_hi, b_lo) + mm(a_lo, b_hi))).float()


def rvq_encode_split(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """The RVQ search with split-f32 scores, as csrc/rvq_encode.cu runs it:
    x [B, T, D] f32, codebooks [n_q, V, D] f32 → codes [B, T, n_q] int32;
    the residual update stays exact f32."""
    norms = torch.sum(torch.square(codebooks.float()), dim=-1)
    r, codes = x.float(), []
    for q in range(codebooks.shape[0]):
        scores = 2.0 * matmul_3x(r, codebooks[q].T, exact_a=True) - norms[q]
        idx = torch.argmax(scores, dim=-1)
        codes.append(idx.to(torch.int32))
        r = r - codebooks[q][idx]
    return torch.stack(codes, dim=-1)


def _band(t: int, window) -> torch.Tensor:
    i = torch.arange(t)
    ok = i[None, :] <= i[:, None]
    if window:
        ok &= i[None, :] > i[:, None] - window
    return ok


def flash_split(q, k, v, scale=None, window=None) -> torch.Tensor:
    """Causal sliding-window attention with csrc/flash_sdpa_window.cu's
    products: f32 inputs in split f32 for QK^T and PV; bf16 inputs with
    exact QK^T products and P = P_hi + P_lo in bf16 against exact V.
    q, k, v [B, H, T, D] → [B, H, T, D] in q's dtype."""
    t, d = q.shape[-2], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    f32 = q.dtype == torch.float32
    if f32:
        s = matmul_3x(q, k.transpose(-1, -2)) * scale
    else:
        s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float() * scale
    s = torch.where(_band(t, window), s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    p = p / p.sum(dim=-1, keepdim=True)
    if f32:
        out = matmul_3x(p, v)
    else:
        p_hi = p.to(torch.bfloat16)
        p_lo = (p - p_hi.float()).to(torch.bfloat16)
        out = (torch.matmul(p_hi.double(), v.double())
               + torch.matmul(p_lo.double(), v.double())).float()
    return out.to(q.dtype)
