"""1-D convolution family (counterpart of codec_tpu/ops/conv.py).

The public functions keep the reference's layouts: activations are
channels-last [B, T, C]; conv weights are WIO [K, C_in, C_out]; convtr
weights are WIO pre-flipped along K (`prepare_convtr_weight`). The `_cf`
forms work channels-first ([B, C, T]) on PyTorch's own weight layouts
(Conv1d [C_out, C_in, K], ConvTranspose1d [C_in, C_out, K]); the models
run their conv stacks through them, with the weights converted once at load.

Causal padding as in the reference:
  pad_left  = (k-1)*dilation + 1 - stride
  pad_right = ceil(t/stride)*stride - t      (zeros)
so output frame i depends only on inputs < (i+1)*stride.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _causal_pads(t: int, k: int, stride: int, dilation: int) -> tuple:
    k_eff = (k - 1) * dilation + 1
    return k_eff - stride, -(-t // stride) * stride - t


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def conv1d_causal_cf(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    """Causal conv, channels-first. x: [B, C_in, T], w: [C_out, C_in, K]."""
    pad_left, pad_right = _causal_pads(x.shape[-1], w.shape[-1], stride,
                                       dilation)
    return F.conv1d(F.pad(x, (pad_left, pad_right)), w, b, stride=stride,
                    dilation=dilation)


def convtr1d_causal_cf(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, stride: int = 1,
                       dilation: int = 1) -> torch.Tensor:
    """Causal transposed conv, channels-first: the full transposed conv,
    then crop `k - stride` samples on the right → T*stride samples.
    x: [B, C_in, T], w: [C_in, C_out, K]."""
    y = F.conv_transpose1d(x, w, b, stride=stride, dilation=dilation)
    crop = max(0, w.shape[-1] - stride)
    return y[..., : y.shape[-1] - crop]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, dilation: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Standard conv. x: [B, T, C_in], w: [K, C_in, C_out]."""
    y = F.conv1d(_cf(x), w.permute(2, 1, 0), b, stride=stride,
                 padding=padding, dilation=dilation)
    return _cf(y)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Causal conv. x: [B, T, C_in], w: [K, C_in, C_out]."""
    return _cf(conv1d_causal_cf(_cf(x), w.permute(2, 1, 0), b, stride=stride,
                                dilation=dilation))


def convtr1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
             stride: int = 1, padding: int = 0,
             dilation: int = 1) -> torch.Tensor:
    """Transposed conv. x: [B, T, C_in], w: pre-flipped WIO [K, C_in, C_out].
    Output length (T-1)*stride + (K-1)*dilation + 1 - 2*padding."""
    y = F.conv_transpose1d(_cf(x), w.flip(0).permute(1, 2, 0), b,
                           stride=stride, padding=padding, dilation=dilation)
    return _cf(y)


def convtr1d_causal(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, stride: int = 1,
                    dilation: int = 1) -> torch.Tensor:
    """Causal transposed conv → [B, T*stride, C_out] (w as in convtr1d)."""
    return _cf(convtr1d_causal_cf(_cf(x), w.flip(0).permute(1, 2, 0), b,
                                  stride=stride, dilation=dilation))


def prepare_conv_weight(w_oik: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [C_out, C_in, K] → WIO [K, C_in, C_out]."""
    return w_oik.permute(2, 1, 0)


def prepare_convtr_weight(w_iok: torch.Tensor) -> torch.Tensor:
    """ConvTranspose1d weight [C_in, C_out, K] → pre-flipped WIO
    [K, C_in, C_out]."""
    return w_iok.flip(-1).permute(2, 0, 1)
