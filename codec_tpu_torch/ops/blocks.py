"""Composite blocks of the iSTFT-head codecs (counterpart of
codec_tpu/ops/blocks.py): the Vocos ConvNeXt block, the diffusion pos-net
res and attention blocks, and the LSTM stack.

Activations are channels-last [B, T, C]; weights keep PyTorch's layouts
(conv [C_out, C_in/groups, K], linear [out, in]). Everything here is stock
torch: codec_tpu computes these blocks outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import act, conv, norms
from .attn import sdpa


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise conv with symmetric pad (K-1)//2. x [B, T, C], w [C, 1, K]
    (float16 on the card without cuDNN: conv.no_cudnn_for_f16)."""
    with conv.no_cudnn_for_f16(x):
        y = F.conv1d(x.transpose(1, 2), w, b, padding=(w.shape[-1] - 1) // 2,
                     groups=x.shape[-1])
    return y.transpose(1, 2)


def conv_tc(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    """A conv over channels-last x [B, T, C_in], w [C_out, C_in, K]."""
    return F.conv1d(x.transpose(1, 2), w, b, stride=stride,
                    padding=padding).transpose(1, 2)


def convnext_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   eps: float = 1e-6) -> torch.Tensor:
    """Vocos ConvNeXt block on [B, T, C]: depthwise conv → LN → pw1 →
    GELU(erf) → pw2 → γ → +x.

    p: dw_w [C, 1, K], dw_b, ln_w, ln_b, pw1_w [I, C], pw1_b, pw2_w [C, I],
    pw2_b, gamma (or None)."""
    h = depthwise_conv(x, p["dw_w"], p["dw_b"])
    h = norms.layer_norm(h, p["ln_w"], p["ln_b"], eps)
    h = act.gelu_erf(F.linear(h, p["pw1_w"], p["pw1_b"]))
    h = F.linear(h, p["pw2_w"], p["pw2_b"])
    if p.get("gamma") is not None:
        h = h * p["gamma"]
    return x + h


def diffusion_resblock(x: torch.Tensor, p: Dict[str, torch.Tensor],
                       n_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The pos-net ResnetBlock1D on [B, T, C]: GN → SiLU → conv k3 pad 1,
    twice, +x. p: n1_w, n1_b, c1_w [C, C, 3], c1_b, n2_w, n2_b, c2_w,
    c2_b."""
    h = act.silu(norms.group_norm(x, p["n1_w"], p["n1_b"], n_groups, eps))
    h = conv_tc(h, p["c1_w"], p["c1_b"], padding=1)
    h = act.silu(norms.group_norm(h, p["n2_w"], p["n2_b"], n_groups, eps))
    h = conv_tc(h, p["c2_w"], p["c2_b"], padding=1)
    return x + h


def diffusion_attn_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                         n_groups: int = 32, eps: float = 1e-6
                         ) -> torch.Tensor:
    """Single-head full (non-causal) attention with 1x1 projections on
    [B, T, C], through the plain `sdpa` (f32 logits). p: n_w, n_b, and
    {q,k,v,o}_w [C, C], {q,k,v,o}_b."""
    c = x.shape[-1]
    h = norms.group_norm(x, p["n_w"], p["n_b"], n_groups, eps)
    q, k, v = (F.linear(h, p[f"{n}_w"], p[f"{n}_b"])[:, None]
               for n in "qkv")
    ctx = sdpa(q, k, v, scale=c ** -0.5)[:, 0]
    return x + F.linear(ctx, p["o_w"], p["o_b"])


LSTM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def lstm_layer(w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
               b_hh: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One LSTM layer's weights as float32 views of one buffer, in the
    order torch's LSTM op reads them: cuDNN takes such a buffer as it is,
    where separate tensors are copied into one on every call."""
    parts = [w_ih, w_hh, b_ih, b_hh]
    flat = torch.cat([t.reshape(-1).float() for t in parts])
    out, at = {}, 0
    for key, t in zip(LSTM_KEYS, parts):
        out[key] = flat[at: at + t.numel()].view(t.shape)
        at += t.numel()
    return out


def lstm_stack(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
               skip: bool = True) -> torch.Tensor:
    """A stack of unidirectional LSTMs over [B, T, C] (gate order i, f, g,
    o), zero initial state, through torch's LSTM op (cuDNN on the card).
    A 16-bit x runs the recurrence in float32 (cuDNN's bfloat16 LSTM
    depends on its version) and returns x's dtype.

    layers: one dict per layer, w_ih [4H, In], w_hh [4H, H], b_ih, b_hh
    (`lstm_layer` lays them out as cuDNN takes them)."""
    y = x.float()
    for lw in layers:
        h0 = y.new_zeros((1, y.shape[0], lw["w_hh"].shape[1]))
        y = torch.lstm(y, (h0, h0), [lw[k].float() for k in LSTM_KEYS],
                       True, 1, 0.0, False, False, True)[0]
    y = y.to(x.dtype)
    return y + x if skip else y
