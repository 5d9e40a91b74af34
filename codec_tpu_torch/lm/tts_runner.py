"""tts_runner — the host loop driving a backbone + codec_lm + codec
(counterpart of codec_tpu/lm/tts_runner.py).

Reference behavior: common/tts_runner.cpp. The backbone is any object with
the `Backbone` protocol below (the port's LlamaBackbone, or a test stub).
The runner feeds input embeddings, receives a hidden state per step,
samples with a caller-supplied sampler on the host, and drives the
codec_lm step machine.

Ported flow: run_codebook_ar (CSM / Qwen3-TTS / MOSS-TTSD, Type C/D) on
its host path, with the delay-tail flush and the EOS-frame drop. The
on-device sampling path, the chunked frame loop and GBNF grammars raise
"not ported yet", and so do the other flows (continuous, Chatterbox,
realtime streaming, LFM2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np

from .audio_lm import AudioLM, ObserveAction
from .decode_transform import transform_lm_codes


def _decode_transformed(audio_lm: AudioLM, codes: np.ndarray, n_q: int = 0,
                        n_speech_frames=None) -> Optional[np.ndarray]:
    """codes [T, n_cb] → PCM via the LM-codes→codec-codes transform
    (reference: audio_lm_decode_audio, common/audio_lm.cpp:1513-1580)."""
    out = transform_lm_codes(
        codes, audio_lm.decode_transform,
        codebook_size=getattr(audio_lm.codec, "codebook_size", 0),
        n_frames_out=n_speech_frames)
    if not len(out):
        return None
    return audio_lm.codec.decode(out, n_q=n_q)


class Backbone(Protocol):
    """Minimal host-LLM interface: one AR step on an input embedding."""

    def step(self, embed: np.ndarray) -> np.ndarray:
        """Feed one input embedding [hidden] → backbone hidden [hidden]."""
        ...


def greedy_sampler(cb_idx: int, logits: np.ndarray) -> int:
    return int(np.argmax(logits))


@dataclass
class SynthesisResult:
    codes: np.ndarray              # [T, n_cb]
    pcm: Optional[np.ndarray]      # decoded audio (None when not decoded)
    n_steps: int
    stopped_by_eos: bool


class SamplerChain:
    """llama-style chain: repetition penalty (ring buffer) → temperature →
    top_k → min_p → top_p → categorical (reference: SamplerChain,
    tts_runner.cpp:242-246 — llama samplers renormalize between stages).
    window<0 ⇒ unbounded history; 0 ⇒ no penalty."""

    def __init__(self, seed: int = 0xC0DEC1AB, temperature: float = 0.8,
                 top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0, repetition_window: int = -1,
                 seed_token: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.rep_pen = repetition_penalty
        self.rep_window = repetition_window
        self.history: List[int] = [] if seed_token is None else [seed_token]

    def __call__(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, np.float64).copy()
        if self.temperature <= 0.0:
            code = int(np.argmax(logits))
            self.history.append(code)
            return code
        hist = self.history if self.rep_window < 0 else \
            self.history[-self.rep_window:] if self.rep_window else []
        if self.rep_pen != 1.0 and hist:
            seen = np.unique(hist)
            pos = logits[seen] > 0
            logits[seen[pos]] /= self.rep_pen
            logits[seen[~pos]] *= self.rep_pen
        logits /= self.temperature
        if self.top_k > 0 and self.top_k < len(logits):
            kth = np.partition(logits, -self.top_k)[-self.top_k]
            logits[logits < kth] = -np.inf
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        if self.min_p > 0.0:
            probs[probs < self.min_p * probs.max()] = 0.0
            probs /= probs.sum()
        if self.top_p < 1.0:
            order = np.argsort(probs)[::-1]
            csum = np.cumsum(probs[order])
            cut = np.searchsorted(csum, self.top_p) + 1
            mask = np.zeros_like(probs)
            mask[order[:cut]] = 1.0
            probs *= mask
        probs /= probs.sum()
        code = int(self.rng.choice(len(probs), p=probs))
        self.history.append(code)
        return code


class RangeConstraint:
    """Masks every logit outside [start, end) plus `extra` ids (EOS) to
    -inf before delegating to the wrapped sampler (reference:
    tts_runner.h:64-73 keeps generated tokens inside the audio-token
    vocabulary)."""

    def __init__(self, sampler: Callable[[np.ndarray], int], start: int,
                 end: int, extra: Sequence[int] = ()):
        self.sampler = sampler
        self.start, self.end = int(start), int(end)
        self.extra = [int(e) for e in extra if e is not None and e >= 0]

    def __call__(self, logits: np.ndarray) -> int:
        masked = np.full_like(logits, -np.inf)
        masked[self.start: self.end] = logits[self.start: self.end]
        for e in self.extra:
            if e < len(logits):
                masked[e] = logits[e]
        return self.sampler(masked)


def prefill_prompt(backbone, prompt_embeds: Sequence[np.ndarray],
                   bucket: int = 0) -> np.ndarray:
    """Prompt prefill → last backbone hidden.

    `bucket > 0` runs ONE whole-prompt forward padded to a bucket multiple
    (LlamaBackbone.prefill); `bucket == 0` keeps the per-token step loop,
    the only option for opaque host LLMs. The two are the same math but
    not bit-identical (other contraction shapes), so comparisons pass the
    same `bucket` to both sides."""
    if not prompt_embeds:
        raise ValueError("prompt_embeds must contain at least one embedding")
    if bucket > 0 and len(prompt_embeds) > 1 and hasattr(backbone, "prefill"):
        return backbone.prefill(
            np.stack([np.asarray(e, np.float32) for e in prompt_embeds]),
            bucket=int(bucket))
    h = None
    for e in prompt_embeds:
        h = backbone.step(np.asarray(e, np.float32))
    return h


def run_codebook_ar(
    audio_lm: AudioLM,
    backbone: Backbone,
    prompt_embeds: Sequence[np.ndarray],
    max_steps: int = 1024,
    sampler: Callable[[int, np.ndarray], int] = greedy_sampler,
    decode: bool = True,
    n_q: int = 0,
    pi=None,
    on_device=None,
    grammar: str = "",
    prefill_bucket: int = 0,
) -> SynthesisResult:
    """Type C/D AR loop on the host (reference: run_codebook_ar,
    tts_runner.cpp:707).

    Per frame: backbone step → codec_lm step machine (begin → logits /
    sample / push × n_cb → finish) → EOS check → compose the next backbone
    input. `prefill_bucket > 0`: whole-prompt bucketed prefill (see
    `prefill_prompt`). `pi` (PromptInfo) with a cb0 speech range set
    range-constrains cb0 sampling (MOSS-TTSD). `on_device` and `grammar`
    are not ported yet and raise."""
    if audio_lm.lm is None:
        raise ValueError("model has no codec_lm adaptor")
    if on_device is not None:
        raise ValueError("on-device sampling is not ported yet")
    if grammar:
        raise ValueError("grammar-constrained sampling is not ported yet")
    if pi is not None and pi.cb0_speech_range_start >= 0 \
            and pi.cb0_speech_range_end > pi.cb0_speech_range_start:
        base = sampler
        rc = RangeConstraint(lambda lg: base(0, lg),
                             pi.cb0_speech_range_start,
                             pi.cb0_speech_range_end,
                             extra=(pi.eos_code_c0,))
        sampler = lambda cb, lg, _rc=rc, _b=base: \
            _rc(lg) if cb == 0 else _b(cb, lg)
    audio_lm.reset()
    st = audio_lm.state

    h = prefill_prompt(backbone, prompt_embeds, bucket=prefill_bucket)
    stopped = False
    steps = 0
    for _ in range(max_steps):
        st.step_begin(h)
        for _k in range(audio_lm.n_codebook):
            logits, cb_idx = st.step_logits()
            st.step_push_code(sampler(cb_idx, logits))
        codes = st.step_finish()
        steps += 1
        action = audio_lm.observe_codes(codes)
        if action is ObserveAction.STOP:
            stopped = True
            break
        h = backbone.step(audio_lm.next_embed)

    # Delay-tail flush (contract: include/codec_lm.h:387-401): on a
    # delay-pattern model the cb0 EOS leaves up to max(delay) in-flight
    # frames in the later codebooks. Step that many more frames with cb0
    # forced to the EOS sentinel so the trailing audio codes land; the
    # decode transform's unshift then reads them and the EOS rows never
    # reach the output.
    tr = audio_lm.decode_transform
    max_delay = tr.max_delay(audio_lm.n_codebook)
    n_speech = None
    eos_c0 = audio_lm.lm.info.eos_code_c0
    if stopped and max_delay > 0 and eos_c0 >= 0:
        n_speech = len(audio_lm.frames) - 1     # rows before the EOS frame
        last_codes = list(audio_lm.frames[-1])
        for _ in range(max_delay):
            emb = audio_lm.lm.compose_next_embd(last_codes,
                                                audio_lm._embed_step)
            audio_lm._embed_step += 1
            h = backbone.step(emb)
            st.step_begin(np.asarray(h, np.float32))
            for _k in range(audio_lm.n_codebook):
                logits, cb_idx = st.step_logits()
                code = eos_c0 if cb_idx == 0 else sampler(cb_idx, logits)
                st.step_push_code(code)
            last_codes = list(st.step_finish())
            audio_lm.frames.append(last_codes)
            steps += 1

    codes = audio_lm.codes_matrix()
    if stopped and eos_c0 >= 0 and max_delay == 0:
        codes = codes[:-1]                      # drop the EOS frame
    pcm = None
    if decode and audio_lm.codec is not None and len(codes):
        pcm = _decode_transformed(audio_lm, codes, n_q=n_q,
                                  n_speech_frames=n_speech)
    return SynthesisResult(codes=codes, pcm=pcm, n_steps=steps,
                           stopped_by_eos=stopped)
