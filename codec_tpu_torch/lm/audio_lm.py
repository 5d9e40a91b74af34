"""audio_lm — generic audio-LM host hooks (counterpart of
codec_tpu/lm/audio_lm.py): the codes→PCM decode transform, the Type C/D
frame observe and feedback compose of codebook-AR kinds, and the
continuous-latent observe of CFM kinds (patches and the stop flag).

Reference behavior: common/audio_lm.cpp + common/codec_common.h. The host
owns the backbone decode loop and sampling. The modality bits and the Type
A/B token observe wait for the flows that use them.
"""

from __future__ import annotations

from enum import Enum
from typing import List, Optional, Sequence

import numpy as np

from ..io.gguf import GGUFReader
from .base import CodecLM, LmError, create_lm
from .decode_transform import DecodeTransform, build_decode_transform


class ObserveAction(Enum):
    PASSTHROUGH = 0        # ordinary text token; host continues as usual
    CONSUMED = 1           # audio code consumed; host keeps token decode path
    CONSUMED_EMBED = 2     # feed next_embed as inputs_embeds next step
    STOP = 3               # end of audio; host breaks and decodes


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
        self._embed_step = 0
        self.state = self.lm.new_state() if self.lm is not None else None

    # -- capabilities ------------------------------------------------------
    @property
    def n_codebook(self) -> int:
        return self.lm.info.n_codebook if self.lm else 1

    @property
    def is_continuous(self) -> bool:
        return bool(self.lm and self.lm.info.is_continuous)

    # -- per-step hooks ----------------------------------------------------
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
