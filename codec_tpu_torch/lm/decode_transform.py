"""LM codes → codec quantizer codes decode transform.

Reference behavior: common/audio_lm.cpp — `init_decode_transform`
(:218-263) derives the transform from GGUF metadata, and
`audio_lm_decode_audio` (:1513-1580) applies it before codec_decode:

  * `audio_cb_offset` leading codebooks are pure text/control channels
    (Moshi-style residual_depth_ar with c0_input_modality="text") and are
    DROPPED — they are not audio quantizer levels.
  * `delay_pattern[q]` (over the full n_cb) is the per-codebook emission
    delay: codebook q's code for output frame t was emitted at input frame
    t + delay[q] (MOSS-TTSD [0,1,…,7]). The transform reverses that shift;
    the output is `n_frames_out = n_frames_in - max(delay)` unless the
    host flushed the delay tail and passes `n_frames_out` explicitly.
  * `cb0_speech_offset` maps MOSS-TTSD's merged text+speech cb0 vocab back
    into raw quantizer index space (HF processor `shifting_outputs()`:
    subtract speech_token_range[0] from the first *audio* codebook only).
  * pad / bos / eos sentinel codes the LM can emit are clamped into the
    valid quantizer range (the HF processor drops such frames; the
    reference clamps — mirrored here for parity).
  * the codec then decodes with n_q = n_cb - audio_cb_offset (fewer levels
    than the codec's native n_q is fine — MOSS-TTS-Realtime's codec has 32
    levels but the LM predicts only the first 16).

Merged-cb0 models additionally need composed prompt rows
(`prompt_needs_composed`, audio_lm.cpp:256-263): each prompt embedding is
compose_audio_embd([text_token, speech_pad, …, speech_pad]) — the sum of
the per-codebook embedding tables, exactly the HF processor's prompt grid
before the delay shift.

A copy of codec_tpu/lm/decode_transform.py (NumPy only), kept here
because importing codec_tpu imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .base import LmError


@dataclass(frozen=True)
class DecodeTransform:
    audio_cb_offset: int = 0
    cb0_speech_offset: int = 0
    delay_pattern: Tuple[int, ...] = ()   # over the FULL n_cb; () = no delay
    prompt_needs_composed: bool = False
    speech_pad_code: int = 0

    @property
    def is_identity(self) -> bool:
        return (self.audio_cb_offset == 0 and self.cb0_speech_offset == 0
                and not self.delay_pattern)

    def audio_delays(self, n_cb: int) -> Tuple[int, ...]:
        """Per-audio-codebook delays (indexed within the audio slice)."""
        n_q = n_cb - self.audio_cb_offset
        if not self.delay_pattern or len(self.delay_pattern) < n_cb:
            return (0,) * max(n_q, 0)
        return tuple(self.delay_pattern[self.audio_cb_offset + q]
                     for q in range(n_q))

    def max_delay(self, n_cb: int) -> int:
        d = self.audio_delays(n_cb)
        return max(d) if d else 0


def build_decode_transform(reader, lm_info=None) -> DecodeTransform:
    """Derive the transform from GGUF metadata + codec_lm_info
    (reference: init_decode_transform, common/audio_lm.cpp:218-263)."""
    if lm_info is None:
        return DecodeTransform()

    kind = reader.get_str("codec.lm.kind", "")
    audio_cb_offset = 0
    if kind == "residual_depth_ar":
        c0mod = reader.get_str("codec.lm.residual.c0_input_modality", "")
        audio_cb_offset = 1 if c0mod == "text" else 0

    cb0_speech_offset = reader.get_i32("codec.lm.cb0_speech_offset", 0)
    if cb0_speech_offset < 0:
        cb0_speech_offset = 0

    delays: Tuple[int, ...] = ()
    dp = tuple(getattr(lm_info, "delay_pattern", ()) or ())
    if dp and len(dp) >= lm_info.n_codebook > 0 and any(d != 0 for d in dp):
        delays = dp[: lm_info.n_codebook]

    needs_composed = cb0_speech_offset != 0
    speech_pad = reader.get_i32("codec.lm.speech_pad_token", 0) \
        if needs_composed else 0

    return DecodeTransform(
        audio_cb_offset=audio_cb_offset,
        cb0_speech_offset=cb0_speech_offset,
        delay_pattern=delays,
        prompt_needs_composed=needs_composed,
        speech_pad_code=speech_pad,
    )


def transform_lm_codes(codes: np.ndarray, tr: DecodeTransform,
                       codebook_size: int = 0,
                       n_frames_out: Optional[int] = None) -> np.ndarray:
    """Apply the codes→decode transform to an accumulated [T, n_cb] frame
    matrix (reference: audio_lm_decode_audio, common/audio_lm.cpp:1513-1580).

    Returns the [n_frames_out, n_q] int32 matrix to decode with
    n_q = n_cb - audio_cb_offset. `n_frames_out=None` uses the reference
    formula T - max(delay); a host that flushed the delay tail after cb0
    EOS passes the number of speech frames explicitly so the EOS row's cb0
    never lands in the output (HF shifting_outputs semantics)."""
    codes = np.asarray(codes, np.int32)
    if codes.ndim != 2:
        raise LmError(f"transform_lm_codes: codes must be [T, n_cb], "
                      f"got shape {codes.shape}")
    n_in, n_cb = codes.shape
    offset = tr.audio_cb_offset
    n_q = n_cb - offset
    if n_q <= 0:
        raise LmError("transform_lm_codes: audio_cb_offset >= n_codebook")

    delays = tr.audio_delays(n_cb)
    max_delay = max(delays) if delays else 0
    if n_frames_out is None:
        if max_delay > 0 and n_in <= max_delay:
            raise LmError("transform_lm_codes: too few frames to cover "
                          "delay_pattern")
        n_frames_out = n_in - max_delay
    elif n_frames_out < 0 or (delays and n_frames_out + max_delay > n_in):
        raise LmError(f"transform_lm_codes: n_frames_out={n_frames_out} "
                      f"needs {n_frames_out + max_delay} input frames, "
                      f"have {n_in}")
    if n_frames_out > n_in:
        raise LmError("transform_lm_codes: n_frames_out exceeds input frames")

    if tr.is_identity and n_frames_out == n_in:
        # RAW pass-through, including sentinels: the reference's rewrite
        # loop (and its clamp) only runs when offset/delay/remap is
        # active (audio_lm.cpp:1555 `if (offset > 0 || max_delay > 0 ||
        # cb0_speech_offset != 0)`); the codec's own decode clamps codes
        # into codebook range
        return codes

    out = np.empty((n_frames_out, n_q), np.int32)
    for q in range(n_q):
        d = delays[q] if delays else 0
        col = codes[d: d + n_frames_out, offset + q]
        if q == 0 and tr.cb0_speech_offset != 0:
            col = col - tr.cb0_speech_offset
        out[:, q] = col
    if codebook_size > 0:
        np.clip(out, 0, codebook_size - 1, out=out)
    return out
