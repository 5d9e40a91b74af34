"""WAV read/write (PCM16 + float32), NumPy-based.

A copy of codec_tpu/io/wav.py (whose package imports JAX); the bytes it
writes are identical. Also accepts IEEE-float WAVs on read.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path, keep_i16: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file / bytes / file-like →
    (samples[n, channels] float32 in [-1, 1], sample_rate).

    keep_i16=True returns the raw int16 samples for PCM16 files (other
    formats still convert to float32) — callers that feed the device can
    then upload half the bytes and divide by 32768 in-graph."""
    if isinstance(raw := path, (bytes, bytearray)):
        raw = bytes(raw)
    elif hasattr(path, "read"):
        raw = path.read()
    else:
        raw = Path(path).read_bytes()
    if raw[0:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos:pos + 4]
        (chunk_sz,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8:pos + 8 + chunk_sz]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            data = body
        pos += 8 + chunk_sz + (chunk_sz & 1)
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2")
        if not keep_i16:
            x = x.astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit: {path}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels)
    else:
        x = x.reshape(-1, 1)
    return x, int(sample_rate)


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int) -> None:
    """Write samples as 16-bit PCM WAV: float32 in [-1,1] (converted
    here), or int16 passed through verbatim (e.g. PCM already converted
    in-graph by decode(pcm_format="i16")).

    `samples` is [n] or [n, channels]."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n_channels = x.shape[1]
    if x.dtype == np.int16:
        pcm = x.astype("<i2")
    else:
        x = x.astype(np.float32)
        pcm = np.clip(np.rint(x * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    byte_rate = sample_rate * n_channels * 2
    block_align = n_channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate, byte_rate, block_align, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    Path(path).write_bytes(hdr + data)


def to_mono(x: np.ndarray) -> np.ndarray:
    """Average channels → mono [n] (reference: codec_prepare_mono_f32, src/codec.cpp)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        return x
    return x.mean(axis=1)
