"""Audio DSP front-ends on the host, in NumPy (a copy of
codec_tpu/dsp/audio.py, which imports no JAX; the port keeps its own so
that it imports nothing of codec_tpu).

Mel filterbanks, W2V-BERT/SeamlessM4T log-mel features, Whisper log-mel
features (XY-Tokenizer's encoder takes `whisper_mel_padded`), and the
window helpers of the iSTFT-head codecs. They run in NumPy float64 where
parity demands it; the models take their outputs as tensors on the
device. tests/test_torch_istft.py holds every function equal to
codec_tpu's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def hann_periodic(n: int) -> np.ndarray:
    """scipy.get_window('hann', n, fftbins=True) / torch.hann_window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def hann_symmetric(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))).astype(np.float32)


def povey_window(n: int, power: float = 0.85) -> np.ndarray:
    """Kaldi 'povey' window: hann^0.85 over a symmetric support."""
    base = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return (base ** power).astype(np.float32)


# ---------------------------------------------------------------------------
# Mel filterbanks (matching transformers.audio_utils.mel_filter_bank)
# ---------------------------------------------------------------------------

def _hertz_to_mel(freq, mel_scale: str):
    freq = np.asarray(freq, np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "kaldi":
        return 1127.0 * np.log(1.0 + freq / 700.0)
    # slaney
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
                    mels)
    return mels


def _mel_to_hertz(mels, mel_scale: str):
    mels = np.asarray(mels, np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "kaldi":
        return 700.0 * (np.exp(mels / 1127.0) - 1.0)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    return np.where(log_region,
                    min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
                    freq)


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int,
                    min_frequency: float, max_frequency: float,
                    sampling_rate: int, norm: Optional[str] = None,
                    mel_scale: str = "htk",
                    triangularize_in_mel_space: bool = False) -> np.ndarray:
    """Triangular mel filterbank [n_freq, n_mels]
    (parity with transformers.audio_utils.mel_filter_bank)."""
    mel_min = _hertz_to_mel(min_frequency, mel_scale)
    mel_max = _hertz_to_mel(max_frequency, mel_scale)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_freqs, mel_scale)

    if triangularize_in_mel_space:
        fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
        fft_freqs = _hertz_to_mel(fft_bin_width * np.arange(num_frequency_bins), mel_scale)
        filter_freqs = mel_freqs
    else:
        fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))

    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2: num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        fb *= np.expand_dims(enorm, 0)
    return fb.astype(np.float32)


def slaney_mel_filterbank(sr: int, n_fft: int, n_mels: int,
                          fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """librosa.filters.mel(..., htk=False, norm='slaney') → [n_mels, n_freq]
    (reference: codec_runtime_slaney_mel_filterbank)."""
    if fmax is None:
        fmax = sr / 2.0
    fb = mel_filter_bank(n_fft // 2 + 1, n_mels, fmin, fmax, sr,
                         norm="slaney", mel_scale="slaney")
    return fb.T


# ---------------------------------------------------------------------------
# W2V-BERT / SeamlessM4T features
# ---------------------------------------------------------------------------

def w2v_bert_features(pcm: np.ndarray, n_mels: int = 80, n_fft: int = 512,
                      win: int = 400, hop: int = 160, sr: int = 16000,
                      preemphasis: float = 0.97, mel_floor: float = 1.192092955078125e-7,
                      stride: int = 2, mel_filters: Optional[np.ndarray] = None,
                      window: Optional[np.ndarray] = None) -> np.ndarray:
    """SeamlessM4TFeatureExtractor parity (reference:
    codec_runtime_w2v_bert_features, audio_dsp.cpp:96-240): per-frame
    scale 2^15, DC removal, in-frame preemphasis, Povey window, |DFT|^2,
    Kaldi mel, log, per-bin (time) zero-mean unit-var (ddof=1), stride-2
    stack. → [n_frames//stride, n_mels*stride]."""
    pcm = np.asarray(pcm, np.float64).reshape(-1)
    if mel_filters is None:
        mel_filters = mel_filter_bank(
            n_fft // 2 + 1, n_mels, min_frequency=20.0, max_frequency=sr // 2,
            sampling_rate=sr, norm=None, mel_scale="kaldi",
            triangularize_in_mel_space=True)          # [n_freq, n_mels]
    if window is None:
        window = povey_window(win)
    n = pcm.shape[0]
    if n < win:
        raise ValueError("input shorter than window")
    n_frames = (n - win) // hop + 1

    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = pcm[idx] * 32768.0                        # [T, win]
    frames = frames - frames.mean(axis=1, keepdims=True)
    # in-frame preemphasis: x[k] -= p*x[k-1] (orig values), x[0] *= (1-p)
    pre = frames.copy()
    pre[:, 1:] = frames[:, 1:] - preemphasis * frames[:, :-1]
    pre[:, 0] = frames[:, 0] * (1.0 - preemphasis)
    pre = pre * np.asarray(window, np.float64)

    buf = np.zeros((n_frames, n_fft))
    buf[:, :win] = pre
    spec = np.fft.rfft(buf, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)          # [T, n_freq]
    mel = power @ np.asarray(mel_filters, np.float64)  # [T, n_mels]
    log_mel = np.log(np.maximum(mel, mel_floor))

    if n_frames > 1:
        mu = log_mel.mean(axis=0, keepdims=True)
        var = log_mel.var(axis=0, ddof=1, keepdims=True)
        log_mel = (log_mel - mu) / np.sqrt(var + 1e-7)

    kept = n_frames - n_frames % stride
    out = log_mel[:kept].reshape(kept // stride, n_mels * stride)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Whisper log-mel
# ---------------------------------------------------------------------------

def whisper_mel_padded(pcm: np.ndarray, sr: int, n_fft: int, hop: int,
                       n_mels: int, pad_to_samples: int) -> Tuple[np.ndarray, int]:
    """XY-Tokenizer mel front-end (reference:
    codec_runtime_whisper_mel_features, audio_dsp.cpp:673+): zero-pad pcm to a
    multiple of pad_to_samples, Whisper-style centered log10 mel with global
    max-8 clip and (x+4)/4 scale. → ([n_mels, target/hop], n_frames)."""
    pcm = np.asarray(pcm, np.float64).reshape(-1)
    pad_to = max(1, pad_to_samples)
    target = -(-len(pcm) // pad_to) * pad_to
    if len(pcm) < target:
        pcm = np.pad(pcm, (0, target - len(pcm)))
    feats = whisper_log_mel(pcm, n_mels=n_mels, n_fft=n_fft, hop=hop, sr=sr)
    n_frames = target // hop
    return feats[:, :n_frames], n_frames


def whisper_log_mel(pcm: np.ndarray, n_mels: int = 80, n_fft: int = 400,
                    hop: int = 160, sr: int = 16000,
                    mel_filters: Optional[np.ndarray] = None,
                    window: Optional[np.ndarray] = None) -> np.ndarray:
    """WhisperFeatureExtractor parity (reference: audio_dsp.h:190-199):
    reflect-pad centered STFT (periodic Hann), |X|^2, Slaney mel, log10
    clipped at max-8, (x+4)/4. → [n_mels, n_frames].

    `window` overrides the periodic-Hann default (Chatterbox S3Tokenizer
    bakes its own; shorter-than-n_fft windows are zero-extended, matching
    chatterbox_s3t.cpp's win_length handling)."""
    pcm = np.asarray(pcm, np.float64).reshape(-1)
    if mel_filters is None:
        mel_filters = mel_filter_bank(
            n_fft // 2 + 1, n_mels, min_frequency=0.0, max_frequency=sr / 2.0,
            sampling_rate=sr, norm="slaney", mel_scale="slaney")  # [n_freq, n_mels]
    if window is None:
        window = hann_periodic(n_fft).astype(np.float64)
    else:
        window = np.asarray(window, np.float64).reshape(-1)
        if window.shape[0] < n_fft:
            window = np.pad(window, (0, n_fft - window.shape[0]))
    pad = n_fft // 2
    x = np.pad(pcm, (pad, pad), mode="reflect")
    n_frames = 1 + (x.shape[0] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * window
    spec = np.fft.rfft(frames, axis=1)
    power = np.abs(spec) ** 2                          # [T, n_freq]
    # HF drops the last frame of the stft (matches torch.stft center framing)
    power = power[:-1]
    mel = power @ np.asarray(mel_filters, np.float64)  # [T-1, n_mels]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)               # [n_mels, T-1]
