"""audio_lm — generic audio-LM host hooks (counterpart of
codec_tpu/lm/audio_lm.py):
  - the modality bits of `codec.lm.modality.*`;
  - Type A audio-token-range detection (`codec.audio_token.{offset,count,
    eos_id}`) and Type B embed-override compose (`observe_token`);
  - the Type C/D frame observe and feedback compose of codebook-AR kinds;
  - the continuous-latent observe of CFM kinds (patches and the stop flag);
  - the end of a sequence: the codes→PCM decode transform and
    `decode_audio` through the codec, with `push_codes` for frames made
    elsewhere.

Reference behavior: common/audio_lm.cpp + common/codec_common.h. The host
owns the backbone decode loop and sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.gguf import GGUFReader
from .base import CodecLM, LmError, create_lm
from .decode_transform import (DecodeTransform, build_decode_transform,
                               transform_lm_codes)

MODALITY_TEXT_IN = 1
MODALITY_AUDIO_OUT = 2
MODALITY_AUDIO_IN = 4
MODALITY_TEXT_OUT = 8


class ObserveAction(Enum):
    PASSTHROUGH = 0        # ordinary text token; host continues as usual
    CONSUMED = 1           # audio code consumed; host keeps token decode path
    CONSUMED_EMBED = 2     # feed next_embed as inputs_embeds next step
    STOP = 3               # end of audio; host breaks and decodes


@dataclass
class AudioTokenRange:
    """Type A: the LLM's own vocabulary carries the codes as tokens
    [offset, offset + count) (code = token - offset); eos_id stops.
    offset -1: no range."""
    offset: int = -1
    count: int = 0
    eos_id: int = -1


class AudioLM:
    """Per-generation audio-LM context (reference: audio_lm_context)."""

    def __init__(self, reader: GGUFReader, codec=None,
                 lm: Optional[CodecLM] = None, device="cuda"):
        """`codec`: the CodecModel that decodes the codes. `lm`: share an
        existing CodecLM across contexts; by default it is loaded from the
        reader with its weights on `device`."""
        self.reader = reader
        self.codec = codec
        self.lm: Optional[CodecLM] = lm if lm is not None \
            else create_lm(reader, device=device)
        self.modality = 0
        for bit, key in ((MODALITY_TEXT_IN, "codec.lm.modality.text_in"),
                         (MODALITY_AUDIO_OUT, "codec.lm.modality.audio_out"),
                         (MODALITY_AUDIO_IN, "codec.lm.modality.audio_in"),
                         (MODALITY_TEXT_OUT, "codec.lm.modality.text_out")):
            if reader.get_bool(key, False):
                self.modality |= bit
        self.token_range = AudioTokenRange(
            offset=reader.get_i32("codec.audio_token.offset", -1),
            count=reader.get_i32("codec.audio_token.count", 0),
            eos_id=reader.get_i32("codec.audio_token.eos_id", -1))
        self.uses_embed_override = False
        self._embed_step_start = 0
        # codes→PCM decode transform (reference: init_decode_transform,
        # common/audio_lm.cpp:218-263)
        self.decode_transform: DecodeTransform = build_decode_transform(
            reader, self.lm.info if self.lm is not None else None)
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self.frames: List[List[int]] = []        # accumulated [T][n_cb] codes
        self.latents: List[np.ndarray] = []      # continuous patches
        self.next_embed: Optional[np.ndarray] = None
        self._embed_step = self._embed_step_start
        self.state = self.lm.new_state() if self.lm is not None else None

    # -- capabilities ------------------------------------------------------
    @property
    def n_codebook(self) -> int:
        return self.lm.info.n_codebook if self.lm else 1

    @property
    def hidden_dim(self) -> int:
        return self.lm.info.hidden_dim if self.lm else 0

    @property
    def is_continuous(self) -> bool:
        return bool(self.lm and self.lm.info.is_continuous)

    def lm_eos(self) -> Tuple[int, int]:
        """(the cb0 EOS code, the frames before it counts); (-1, 0) with no
        adaptor."""
        if self.lm is None:
            return -1, 0
        return self.lm.info.eos_code_c0, self.lm.info.eos_min_step

    # -- configuration -----------------------------------------------------
    def set_audio_token_range(self, offset: int, count: int,
                              eos_id: int) -> None:
        self.token_range = AudioTokenRange(offset, count, eos_id)

    def set_uses_embed_override(self, enabled: bool,
                                start_step: int = 0) -> None:
        """Type B: an in-range token is fed back as the LM's composed
        embedding (its step counter starts at `start_step`, and `reset()`
        returns to it)."""
        self.uses_embed_override = enabled
        self._embed_step_start = start_step
        self._embed_step = start_step

    # -- per-step hooks ----------------------------------------------------
    def observe_token(self, tok: int, last_hidden=None) -> ObserveAction:
        """Type A/B dispatch (reference: audio_lm_observe_token): the EOS
        id stops; a token in the range is a code, recorded as a frame of
        one and, with the embed override, composed into `next_embed`;
        anything else passes through."""
        tr = self.token_range
        if tr.eos_id >= 0 and tok == tr.eos_id:
            return ObserveAction.STOP
        if tr.offset < 0 or not (tr.offset <= tok < tr.offset + tr.count):
            return ObserveAction.PASSTHROUGH
        code = tok - tr.offset
        self.frames.append([code])
        if self.uses_embed_override and self.lm is not None:
            self.next_embed = self.lm.compose_next_embd([code],
                                                        self._embed_step)
            self._embed_step += 1
            return ObserveAction.CONSUMED_EMBED
        return ObserveAction.CONSUMED

    def observe_codes(self, codes: Sequence[int], last_hidden=None,
                      compose: bool = True) -> ObserveAction:
        """Type C/D frame observe (reference: audio_lm_observe_codes):
        record the frame, stop on the EOS frame, else compose the next
        backbone input into `next_embed`.

        `compose=False` skips the compose (a device gather and a copy to
        the host): callers whose feedback is composed on the device (the
        generation chunk) pass it, and only the embed step advances.
        `last_hidden` is accepted for the reference's signature and not
        read by the codebook kinds."""
        codes = list(codes)
        self.frames.append(codes)
        if self.state is not None and self.state.step_is_eos(codes):
            return ObserveAction.STOP
        if self.lm is None:
            return ObserveAction.CONSUMED
        if compose:
            self.next_embed = self.lm.compose_next_embd(codes,
                                                        self._embed_step)
        self._embed_step += 1
        return ObserveAction.CONSUMED_EMBED

    # -- continuous-latent hooks (CFM kinds) --------------------------------
    def set_continuous_params(self, cfg_value: float = 2.0,
                              n_timesteps: int = 10, min_len: int = -1) -> None:
        """reference: audio_lm_set_continuous_params. min_len >= 0
        overrides the stop head's guard for this context's state."""
        self._cfg_value = cfg_value
        self._n_timesteps = n_timesteps
        if min_len >= 0 and self.state is not None:
            self.lm.set_min_len(self.state, min_len)

    def text_prefill(self, hiddens: np.ndarray) -> None:
        """Prime the continuous kind's RALM over the prompt prefix
        (reference: audio_lm_text_prefill)."""
        if not self.is_continuous:
            raise ValueError("text_prefill requires a continuous-latent kind")
        self.lm.text_prefill(self.state, hiddens)

    def observe_hidden(self, hidden: np.ndarray, noise=None) -> ObserveAction:
        """Continuous-latent per-step observe: one step_generate; the patch
        joins `latents`, the feedback becomes `next_embed`."""
        if not self.is_continuous:
            raise ValueError("observe_hidden requires a continuous-latent kind")
        patch, stop, feedback = self.lm.step_generate(
            self.state, hidden, cfg_value=getattr(self, "_cfg_value", 2.0),
            n_timesteps=getattr(self, "_n_timesteps", 10), noise=noise)
        self.latents.append(np.asarray(patch).reshape(
            -1, self.lm.info.latent_dim))
        self.next_embed = feedback
        return ObserveAction.STOP if stop else ObserveAction.CONSUMED_EMBED

    # -- composed prompt rows (merged-cb0 models) ---------------------------
    @property
    def prompt_needs_composed(self) -> bool:
        """MOSS-TTSD-style merged-cb0 models: the host feeds composed prompt
        embeddings (reference: audio_lm_prompt_needs_composed_embd)."""
        return self.decode_transform.prompt_needs_composed

    def compose_prompt_embd(self, text_token: int) -> np.ndarray:
        """One composed prompt row: cb0 = the raw merged-vocab text token,
        cb1..N-1 = speech_pad (reference: audio_lm_compose_prompt_embd,
        audio_lm.cpp:1274-1305)."""
        if self.lm is None:
            raise LmError("compose_prompt_embd: no codec_lm adaptor")
        if self.n_codebook <= 0:
            raise LmError("compose_prompt_embd: n_codebook unknown")
        codes = [self.decode_transform.speech_pad_code] * self.n_codebook
        codes[0] = int(text_token)
        return self.lm.compose_audio_embd(codes)

    # -- end of sequence ---------------------------------------------------
    def codes_matrix(self) -> np.ndarray:
        if not self.frames:
            return np.zeros((0, self.n_codebook), np.int32)
        return np.asarray(self.frames, np.int32)

    def push_codes(self, codes) -> None:
        """Append [T, n_cb] frames made elsewhere to the accumulator
        (reference: audio_lm_push_codes, the offline and debug path)."""
        codes = np.asarray(codes, np.int32)
        if codes.ndim == 1:
            codes = codes[:, None]
        if self.frames and len(self.frames[0]) != codes.shape[1]:
            raise LmError(f"push_codes: width {codes.shape[1]} mismatches "
                          f"accumulated n_cb {len(self.frames[0])}")
        self.frames.extend(codes.tolist())

    def decode_audio(self, n_q: int = 0,
                     n_speech_frames: Optional[int] = None) -> np.ndarray:
        """The accumulated codes (or latents) through the codec (reference:
        audio_lm_decode_audio, common/audio_lm.cpp:1455-1600). Codebook
        kinds first apply the LM-codes→codec-codes transform (delay
        unshift, control-cb0 drop, merged-cb0 speech remap, sentinel clamp;
        decode_transform.py). `n_speech_frames`: the output length for a
        host that flushed the delay tail after the cb0 EOS (None: T minus
        the largest delay). `n_q` overrides the decode depth (0: the
        transform's width)."""
        if self.codec is None:
            raise ValueError("no codec attached for decode_audio")
        if self.is_continuous:
            return self.codec.decode_latent(np.concatenate(self.latents,
                                                           axis=0))
        codes = self.codes_matrix()
        if not len(codes):
            raise LmError("decode_audio: no codes accumulated")
        codes = transform_lm_codes(
            codes, self.decode_transform,
            codebook_size=getattr(self.codec, "codebook_size", 0),
            n_frames_out=n_speech_frames)
        if not len(codes):
            raise LmError("decode_audio: no frames left after the decode "
                          "transform")
        return self.codec.decode(codes, n_q=n_q)
