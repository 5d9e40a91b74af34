"""Alias-free (anti-aliased) snake-beta activation, counterpart of
codec_tpu/ops/alias_act.py: BigVGAN's Activation1d as the BigCodec
acoustic encoder of XCodec2 runs it. Upsample 2× with a 12-tap FIR,
snake-beta at the doubled rate, downsample 2× with the same FIR.

codec_tpu, per channel of length t:
  up:   replicate-pad 5/5 → zero-stuff ×2 (lax's lhs_dilation=2) → pad
        11/11 → 12-tap cross-correlation with k → ×2 → crop 15/15 → 2t
  act:  x + sin²(max(alpha, 1e-9)·x)·inv_beta
  down: replicate-pad 5/6 → cross-correlation with k at stride 2 → t

The up step here is its polyphase form, with no zero-stuffed signal. With
xp the input replicate-padded 5/5, the cropped output is
  out[2s]     = 2·Σ_i xp[s + 2 + i]·k[2i]      (i = 0..5)
  out[2s + 1] = 2·Σ_i xp[s + 3 + i]·k[2i + 1]
(sample n of the stuffed correlation is Σ_j xp[j]·k[2j − n + 11], and the
crop starts at n = 15). Both phases read x replicate-padded 3/3 through a
7-tap window: one depthwise conv with two outputs a channel, taps
(k0, k2, .., k10, 0) and (0, k1, k3, .., k11), interleaved. It reads no
zero-pad sample and holds for any filter, symmetric or not; the tests hold
it to codec_tpu's at odd and even lengths.

The depthwise convs run without cuDNN in float16 on the card
(conv.no_cudnn_for_f16): the up step runs at t and the down step at 2t,
which reaches cuDNN's faulting lengths (~60 000 frames) in every block of
a 20 s encode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import no_cudnn_for_f16


def snake_beta_inv(x: torch.Tensor, alpha: torch.Tensor,
                   inv_beta: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x + sin²(max(alpha, eps)·x)·inv_beta, alpha and inv_beta broadcast
    against x (the converters pre-bake exp(alpha) and 1/beta)."""
    a = torch.clamp(alpha, min=eps)
    return x + torch.sin(a * x) ** 2 * inv_beta


def polyphase_up_taps(kernel: torch.Tensor) -> torch.Tensor:
    """The 12-tap FIR → the up step's two 7-tap phases [2, 7] (even output
    samples first), the ×2 gain folded in."""
    k = kernel.reshape(-1)
    z = k.new_zeros(1)
    return 2.0 * torch.stack([torch.cat([k[0::2], z]),
                              torch.cat([z, k[1::2]])])


def alias_free_snake_beta_cf(x: torch.Tensor, alpha: torch.Tensor,
                             inv_beta: torch.Tensor, kernel: torch.Tensor,
                             up_taps: torch.Tensor) -> torch.Tensor:
    """Channels-first: x [B, C, T]; alpha, inv_beta [C]; kernel [12] and
    its polyphase_up_taps (a model keeps them from load) → [B, C, T]."""
    b, c, t = x.shape
    w_up = up_taps.to(x.dtype).repeat(c, 1)[:, None]          # [2C, 1, 7]
    w_dn = kernel.reshape(1, 1, -1).to(x.dtype).expand(c, 1, -1)
    with no_cudnn_for_f16(x):
        h = F.conv1d(F.pad(x, (3, 3), mode="replicate"), w_up, groups=c)
        h = h.reshape(b, c, 2, t).transpose(2, 3).reshape(b, c, 2 * t)
        h = snake_beta_inv(h, alpha[:, None], inv_beta[:, None])
        return F.conv1d(F.pad(h, (5, 6), mode="replicate"), w_dn, stride=2,
                        groups=c)


def alias_free_snake_beta(x: torch.Tensor, alpha: torch.Tensor,
                          inv_beta: torch.Tensor,
                          kernel: torch.Tensor) -> torch.Tensor:
    """codec_tpu's layout: x [B, T, C] → [B, T, C]."""
    return alias_free_snake_beta_cf(x.transpose(1, 2), alpha, inv_beta,
                                    kernel, polyphase_up_taps(kernel)
                                    ).transpose(1, 2)
