"""Inverse STFT of an iSTFT head (Vocos / Soprano style): counterpart of
codec_tpu/ops/istft.py.

The plain math: magnitude clip(exp(logmag), 1e2) and phase → spectrum,
`torch.fft.irfft` per frame (cuFFT on the card, pocketfft on the CPU),
window, overlap-add with `F.fold`, division by the window-square envelope
(floor 1e-11), trim. The complex math and the overlap-add run in float32
whatever the head's dtype (cuFFT has no bfloat16), and so does the
output: the samples are the model's last step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..dsp.audio import hann_periodic


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Frame t of [B, T, n] summed into samples [t*hop, t*hop + n) →
    [B, (T-1)*hop + n]. Any hop, also one that does not divide n."""
    b, t, n = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, (t - 1) * hop + n),
                 kernel_size=(1, n), stride=(1, hop))
    return out.reshape(b, -1)


def istft_from_head(head: torch.Tensor, hop: int, pad: Optional[int] = None,
                    window: Optional[torch.Tensor] = None,
                    skip_dc_nyquist: bool = False) -> torch.Tensor:
    """head [B, T, n_fft+2] (log-magnitudes ‖ phases) → pcm float32.

    Vocos style (default): periodic Hann, trim (n_fft-hop)/2 a side →
    T*hop samples. Soprano style: skip_dc_nyquist=True zeroes the DC and
    Nyquist bins and trims n_fft/2 → (T-1)*hop samples; `window` [n_fft]
    replaces the Hann window."""
    b, t, out_dim = head.shape
    n_bins = out_dim // 2
    n_fft = 2 * (n_bins - 1)
    if pad is None:
        pad = (n_fft // 2) if skip_dc_nyquist else (n_fft - hop) // 2
    logmag = head[..., :n_bins].float()
    phase = head[..., n_bins:].float()
    mag = torch.clamp(torch.exp(logmag), max=1e2)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    if skip_dc_nyquist:
        spec[..., 0] = 0
        spec[..., -1] = 0
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)            # [B, T, n_fft]
    if window is None:
        win = torch.from_numpy(hann_periodic(n_fft)).to(head.device)
    else:
        win = window.reshape(-1).float()
    y = overlap_add(frames * win, hop)
    env = overlap_add((win * win).expand(1, t, n_fft), hop)
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    total = (t - 1) * hop + n_fft
    return y[:, pad: total - pad]
