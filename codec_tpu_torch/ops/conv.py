"""1-D convolution family (counterpart of codec_tpu/ops/conv.py).

The public functions keep the reference's layouts: activations are
channels-last [B, T, C]; conv weights are WIO [K, C_in, C_out]; convtr
weights are WIO pre-flipped along K (`prepare_convtr_weight`). The `_cf`
forms work channels-first ([B, C, T]) on PyTorch's own weight layouts
(Conv1d [C_out, C_in, K], ConvTranspose1d [C_in, C_out, K]); the models
run their conv stacks through them, with the weights converted once at load.

Causal padding as in the reference:
  pad_left  = (k-1)*dilation + 1 - stride
  pad_right = ceil(t/stride)*stride - t
so output frame i depends only on inputs < (i+1)*stride. The pads are
zeros, or copies of the edge frames with pad_mode="replicate".
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_cudnn_for_f16(x: torch.Tensor):
    """cuDNN off while a float16 depthwise conv of x runs on the card, and
    back as it was after. cuDNN's f16 depthwise conv (cuDNN 9.2, H100) hits
    an illegal address: at SNAC's decoder block C256 T59904 in every run,
    and from about 60 000 frames (B x T) at every ConvNeXt width of the
    iSTFT-head codecs (C256-C768, k3 and k7); bf16 and f32 ran clean
    (tools/f16_probe.py). At 20 s requests it was no faster than
    PyTorch's own kernel (chip_smoke.py phase 8b)."""
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn and not (
        x.is_cuda and x.dtype == torch.float16)
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = cudnn


def _causal_pads(t: int, k: int, stride: int, dilation: int) -> tuple:
    k_eff = (k - 1) * dilation + 1
    return k_eff - stride, -(-t // stride) * stride - t


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def conv1d_causal_cf(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     dilation: int = 1, pad_mode: str = "zeros",
                     groups: int = 1) -> torch.Tensor:
    """Causal conv, channels-first. x: [B, C_in, T], w: [C_out,
    C_in/groups, K]; pad_mode "zeros" or "replicate"."""
    pad_left, pad_right = _causal_pads(x.shape[-1], w.shape[-1], stride,
                                       dilation)
    if pad_mode == "replicate":
        x = F.pad(x, (pad_left, pad_right), mode="replicate")
    elif pad_mode == "zeros":
        x = F.pad(x, (pad_left, pad_right))
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def convtr1d_causal_cf(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, stride: int = 1,
                       dilation: int = 1) -> torch.Tensor:
    """Causal transposed conv, channels-first: the full transposed conv,
    then crop `k - stride` samples on the right → T*stride samples.
    x: [B, C_in, T], w: [C_in, C_out, K]."""
    y = F.conv_transpose1d(x, w, b, stride=stride, dilation=dilation)
    crop = max(0, w.shape[-1] - stride)
    return y[..., : y.shape[-1] - crop]


# -- streaming (chunked) causal forms ----------------------------------------
# Counterparts of codec_tpu/ops/conv.py's conv1d_causal_stream family,
# channels-first on PyTorch's weight layouts: carries are [B, C, tail].
# Chunks whose length is a multiple of `stride` give, concatenated, the full
# causal call's output.

def conv1d_causal_stream_cf(x: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor], carry: torch.Tensor,
                            stride: int = 1, dilation: int = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked conv1d_causal_cf. x: [B, C_in, T] (T a multiple of stride),
    w: [C_out, C_in, K]; carry: [B, C_in, k_eff - stride], the last inputs
    seen (zeros at stream start: the causal left pad) → (y [B, C_out,
    T/stride], new carry)."""
    xc = torch.cat([carry, x], dim=-1)
    y = F.conv1d(xc, w, b, stride=stride, dilation=dilation)
    tail = _causal_pads(0, w.shape[-1], stride, dilation)[0]
    return y, xc[..., xc.shape[-1] - max(tail, 0):]


def conv1d_causal_stream_init_cf(batch: int, c_in: int, k: int,
                                 stride: int = 1, dilation: int = 1,
                                 dtype=torch.float32, device=None
                                 ) -> torch.Tensor:
    tail = _causal_pads(0, k, stride, dilation)[0]
    return torch.zeros((batch, c_in, max(tail, 0)), dtype=dtype,
                       device=device)


def convtr1d_causal_stream_cf(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor], carry: torch.Tensor,
                              stride: int = 1
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked convtr1d_causal_cf. x: [B, C_in, T], w: [C_in, C_out, K];
    carry: [B, C_out, K - stride], the overlap tail of earlier chunks,
    bias-free (zeros at stream start) → (y [B, C_out, T*stride], new
    carry). The bias lands once per emitted sample."""
    y = F.conv_transpose1d(x, w, None, stride=stride)
    t_out = x.shape[-1] * stride
    tail = max(0, w.shape[-1] - stride)
    if tail:
        y[..., :tail] += carry
    out = y[..., :t_out]
    if b is not None:
        out = out + b[:, None]
    return out, y[..., t_out:t_out + tail]


def convtr1d_causal_stream_init_cf(batch: int, c_out: int, k: int,
                                   stride: int = 1, dtype=torch.float32,
                                   device=None) -> torch.Tensor:
    return torch.zeros((batch, c_out, max(k - stride, 0)), dtype=dtype,
                       device=device)


def conv1d_causal_stream_replicate_cf(x: torch.Tensor, w: torch.Tensor,
                                      b: Optional[torch.Tensor],
                                      carry: torch.Tensor, first: bool,
                                      stride: int = 1, dilation: int = 1
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked conv1d_causal_cf(pad_mode="replicate"): on the first chunk
    (`first`, a host bool: the session knows its position) the left pad
    copies the chunk's first sample; later chunks carry real history."""
    tail = _causal_pads(0, w.shape[-1], stride, dilation)[0]
    if first and tail > 0:
        carry = x[..., :1].expand(-1, -1, tail)
    return conv1d_causal_stream_cf(x, w, b, carry, stride=stride,
                                   dilation=dilation)


def _grouped(x: torch.Tensor, groups: int):
    """The cuDNN guard of a grouped (depthwise) conv of channels-last x:
    no_cudnn_for_f16 where groups > 1, else nothing."""
    return no_cudnn_for_f16(x) if groups > 1 else contextlib.nullcontext()


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, dilation: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """Standard conv. x: [B, T, C_in], w: [K, C_in/groups, C_out] (a
    depthwise conv: [K, 1, C] with groups=C, run without cuDNN in float16
    on the card: no_cudnn_for_f16)."""
    with _grouped(x, groups):
        y = F.conv1d(_cf(x), w.permute(2, 1, 0), b, stride=stride,
                     padding=padding, dilation=dilation, groups=groups)
    return _cf(y)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1, pad_mode: str = "zeros",
                  groups: int = 1) -> torch.Tensor:
    """Causal conv. x: [B, T, C_in], w: [K, C_in/groups, C_out]; pad_mode
    "zeros" or "replicate". A grouped (depthwise) conv runs as conv1d's."""
    with _grouped(x, groups):
        return _cf(conv1d_causal_cf(_cf(x), w.permute(2, 1, 0), b,
                                    stride=stride, dilation=dilation,
                                    pad_mode=pad_mode, groups=groups))


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
