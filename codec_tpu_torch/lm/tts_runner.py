"""tts_runner — the host loop driving a backbone + codec_lm + codec
(counterpart of codec_tpu/lm/tts_runner.py).

Reference behavior: common/tts_runner.cpp. The backbone is any object with
the `Backbone` protocol below (the port's LlamaBackbone, or a test stub).
The runner feeds input embeddings, receives a hidden state per step,
samples with a caller-supplied sampler on the host, and drives the
codec_lm step machine.

Ported flows: run_codebook_ar (CSM / Qwen3-TTS / MOSS-TTSD, Type C/D) on
its host path (with a GBNF grammar on cb0, lm/gbnf.py) and on the device
(`on_device`: the fused frame with in-graph sampling, one frame or a chunk
of K frames per device call, each a CUDA graph replay on the card;
lm/fused_gen.py), with the delay-tail flush and the EOS-frame drop;
run_codebook_ar_batch, B streams through one batched chunk;
run_continuous (BlueMagpie continuous-latent CFM), one step a call or K
steps a CUDA-graph chunk; and run_chatterbox (the Chatterbox T3 CFG loop:
one backbone per lane on the host, or both lanes as one batch in
CUDA-graph chunks); run_realtime_streaming (MOSS-TTS-Realtime's text⊕audio
interleave, with a per-codebook repetition penalty) and run_lfm2_sequential
(LFM2-Audio's text phase, then codebook-AR audio), each on the host path or
in K-frame CUDA-graph chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np
import torch

from ..ops.sample import OnDeviceSampling, gumbel, sample_logits
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


class T3Sampler(SamplerChain):
    """Chatterbox T3 preset: penalties (full history, BOS-seeded) → temp →
    min_p → top_p (reference: tts_runner.cpp:965-975)."""

    def __init__(self, seed: int = 0xC0DEC1AB, temperature: float = 0.8,
                 top_p: float = 1.0, min_p: float = 0.05,
                 repetition_penalty: float = 1.2,
                 seed_token: Optional[int] = None):
        super().__init__(seed=seed, temperature=temperature, top_k=0,
                         top_p=top_p, min_p=min_p,
                         repetition_penalty=repetition_penalty,
                         repetition_window=-1, seed_token=seed_token)


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


def _cb0_range(pi):
    """The c0 speech range of a PromptInfo as (start, end, eos) for the
    in-graph mask, or None."""
    if pi is not None and pi.cb0_speech_range_start >= 0 \
            and pi.cb0_speech_range_end > pi.cb0_speech_range_start:
        return (int(pi.cb0_speech_range_start), int(pi.cb0_speech_range_end),
                int(pi.eos_code_c0) if pi.eos_code_c0 is not None else -1)
    return None


def _device_sampler(on_device: OnDeviceSampling, gen: torch.Generator):
    """A host-loop sampler with the on-device chain, its Gumbel noise drawn
    from `gen` (the delay-tail flush continues the device path's noise
    stream)."""
    def sampler(cb, logits):
        lg = torch.as_tensor(np.asarray(logits, np.float32))
        noise = None
        if on_device.temperature > 0.0:
            noise = gumbel(lg.shape, gen, gen.device).to(lg.device)
        return int(sample_logits(
            lg, noise, temperature=on_device.temperature,
            top_k=on_device.top_k, top_p=on_device.top_p,
            min_p=on_device.min_p))
    return sampler


def _flush_delay_tail(audio_lm: AudioLM, backbone, sampler, steps: int):
    """Delay-tail flush (contract: include/codec_lm.h:387-401): on a
    delay-pattern model the cb0 EOS leaves up to max(delay) in-flight frames
    in the later codebooks. Step that many more frames with cb0 forced to
    the EOS sentinel so the trailing audio codes land; the decode
    transform's unshift then reads them and the EOS rows never reach the
    output. → (n_speech frames before the EOS frame, steps)."""
    st = audio_lm.state
    eos_c0 = audio_lm.lm.info.eos_code_c0
    n_speech = len(audio_lm.frames) - 1     # rows before the EOS frame
    last_codes = list(audio_lm.frames[-1])
    for _ in range(audio_lm.decode_transform.max_delay(audio_lm.n_codebook)):
        emb = audio_lm.lm.compose_next_embd(last_codes, audio_lm._embed_step)
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
    return n_speech, steps


def _finish(audio_lm: AudioLM, stopped: bool, steps: int, n_speech,
            decode: bool, n_q: int) -> SynthesisResult:
    """The code matrix (the EOS frame dropped when there is no delay tail)
    and its PCM."""
    codes = audio_lm.codes_matrix()
    eos_c0 = audio_lm.lm.info.eos_code_c0
    max_delay = audio_lm.decode_transform.max_delay(audio_lm.n_codebook)
    if stopped and eos_c0 >= 0 and max_delay == 0 and len(codes):
        codes = codes[:-1]                      # drop the EOS frame
    pcm = None
    if decode and audio_lm.codec is not None and len(codes):
        pcm = _decode_transformed(audio_lm, codes, n_q=n_q,
                                  n_speech_frames=n_speech)
    return SynthesisResult(codes=codes, pcm=pcm, n_steps=steps,
                           stopped_by_eos=stopped)


def run_codebook_ar(
    audio_lm: AudioLM,
    backbone: Backbone,
    prompt_embeds: Sequence[np.ndarray],
    max_steps: int = 1024,
    sampler: Callable[[int, np.ndarray], int] = greedy_sampler,
    decode: bool = True,
    n_q: int = 0,
    pi=None,
    on_device: Optional[OnDeviceSampling] = None,
    grammar: str = "",
    prefill_bucket: int = 0,
    token_pieces: Optional[Sequence[str]] = None,
) -> SynthesisResult:
    """Type C/D AR loop (reference: run_codebook_ar, tts_runner.cpp:707).

    Per frame: backbone step → codec_lm step machine (begin → logits /
    sample / push × n_cb → finish) → EOS check → compose the next backbone
    input. `prefill_bucket > 0`: whole-prompt bucketed prefill (see
    `prefill_prompt`). `pi` (PromptInfo) with a cb0 speech range set
    range-constrains cb0 sampling (MOSS-TTSD).

    `grammar` + `token_pieces`: a GBNF constraint on the cb0 sampler
    (reference: tts_runner.h:64-73, never on the audio-codebook heads;
    lm/gbnf.py's pushdown matcher); `token_pieces[i]` is token i's
    detokenized text. It takes precedence over the range constraint and
    forces the host sampling path (`on_device` is then not used).

    `on_device` (ops.sample.OnDeviceSampling): the whole frame (every
    codebook and its sampling, the cb0 range in-graph) runs on the device
    through the kind's `_build_frame`, `sampler` unused. With a backbone
    the chunk can run (supports_gen_chunk), K = chunk_frames whole frames
    per call (lm/fused_gen.py; K = 1 too), on CUDA one replay of a
    captured graph and one copy of the packed codes to the host; with any
    other backbone one frame per device call (fused_gen.FrameRunner) and
    the host's backbone step. The Gumbel noise comes from a
    torch.Generator seeded by on_device.seed, one [n_cb, W] draw a frame,
    so both paths draw the same stream."""
    if audio_lm.lm is None:
        raise ValueError("model has no codec_lm adaptor")
    if grammar and token_pieces is None:
        raise ValueError(
            "grammar requires token_pieces (the per-token detokenized "
            "strings); without them the constraint would be silently "
            "dropped")
    cb0_range = _cb0_range(pi)
    if grammar:
        from .gbnf import GrammarSampler

        base = sampler
        eog = (pi.eos_code_c0,) if pi is not None and pi.eos_code_c0 >= 0 \
            else ()
        gs = GrammarSampler(grammar, token_pieces,
                            lambda lg, _b=base: _b(0, lg), eog_tokens=eog)

        def sampler(cb, lg, _gs=gs, _b=base):
            if cb != 0:
                return _b(cb, lg)
            tok = _gs(lg)
            _gs.accept(tok)                  # cb0 picks are always pushed
            return tok
    elif cb0_range is not None:
        base = sampler
        rc = RangeConstraint(lambda lg: base(0, lg), cb0_range[0],
                             cb0_range[1], extra=(pi.eos_code_c0,))
        sampler = lambda cb, lg, _rc=rc, _b=base: \
            _rc(lg) if cb == 0 else _b(cb, lg)
    audio_lm.reset()
    st = audio_lm.state
    lm = audio_lm.lm
    device = on_device is not None and hasattr(lm, "_build_frame") \
        and not grammar
    gen = None
    if device:
        from .fused_gen import (chunk_ctx, frame_cached, gen_chunk_cached,
                                supports_gen_chunk)

        gen = torch.Generator(device=lm.device).manual_seed(on_device.seed)
        chain = dict(temperature=on_device.temperature,
                     top_k=on_device.top_k, top_p=on_device.top_p,
                     min_p=on_device.min_p)
        sampled = on_device.temperature > 0.0

    h = prefill_prompt(backbone, prompt_embeds, bucket=prefill_bucket)
    stopped = False
    steps = 0
    chunked = device and supports_gen_chunk(lm, backbone)
    tc = st.text_context if st.text_context is not None else 0
    if chunked:
        # K frames (LM frame + feedback compose + backbone step) per device
        # call; the frames past EOS are inert, one packed copy per chunk
        chunk_n = max(1, int(on_device.chunk_frames))
        n_cb = audio_lm.n_codebook
        runs = -(-max_steps // chunk_n) * chunk_n
        runner = gen_chunk_cached(
            lm, backbone, n_frames=chunk_n,
            ctx=chunk_ctx(backbone, backbone.pos + runs + 1),
            cb0_range=cb0_range, **chain)
        runner.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
        runner.pos.fill_(backbone.pos)
        runner.text_ctx.fill_(tc)
        pos = backbone.pos
        while steps < max_steps and not stopped:
            runner.base.fill_(st.frame_counter)
            drawn = gen.get_state() if sampled else None
            runner.draw_noise([gen if sampled else None])
            arr = runner.run().cpu().numpy()
            n_emit, pos = int(arr[-3]), int(arr[-1])
            if n_emit == 0:                      # no progress: bail out
                break
            frames = arr[: chunk_n * n_cb].reshape(chunk_n, n_cb)[:n_emit]
            used = 0
            for row in frames:
                codes = st.push_frame(row)
                steps += 1
                used += 1
                # compose=False: the chunk composes the feedback itself
                if audio_lm.observe_codes(
                        codes, compose=False) is ObserveAction.STOP:
                    stopped = True
                    break
                if steps >= max_steps:
                    break
            if sampled and used < chunk_n:
                # leave the generator where the per-frame path would: one
                # draw per frame taken (the delay-tail flush continues it)
                gen.set_state(drawn)
                runner.draw_noise([gen], frames=used)
        backbone.pos = pos                       # the chunk wrote its cache
        max_steps = 0                            # skip the per-frame loop
    frame = (frame_cached(lm, cb0_range=cb0_range, **chain)
             if device and not chunked else None)

    for _ in range(max_steps):
        if frame is not None:
            frame.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
            frame.text_ctx.fill_(tc)
            if sampled:
                frame.draw_noise(gen)
            codes = st.push_frame(frame.run()[0].tolist())
        else:
            st.step_begin(h)
            for _k in range(audio_lm.n_codebook):
                logits, cb_idx = st.step_logits()
                st.step_push_code(sampler(cb_idx, logits))
            codes = st.step_finish()
        steps += 1
        action = audio_lm.observe_codes(codes, last_hidden=h)
        if action is ObserveAction.STOP:
            stopped = True
            break
        h = backbone.step(audio_lm.next_embed)

    n_speech = None
    if stopped and audio_lm.decode_transform.max_delay(audio_lm.n_codebook) > 0 \
            and lm.info.eos_code_c0 >= 0:
        # the device path never used the host `sampler`; the flush frames'
        # codes reach the decoded tail, so keep its chain and noise stream
        n_speech, steps = _flush_delay_tail(
            audio_lm, backbone,
            _device_sampler(on_device, gen) if device else sampler, steps)
    return _finish(audio_lm, stopped, steps, n_speech, decode, n_q)


def run_continuous(
    audio_lm: AudioLM,
    backbone: Backbone,
    prompt_embeds: Sequence[np.ndarray],
    max_steps: int = 1024,
    prefill_hiddens=None,
    decode: bool = True,
    chunk_steps: int = 1,
    min_len: int = -1,
) -> SynthesisResult:
    """Continuous-latent flow (reference: run_continuous,
    tts_runner.cpp:450): the optional RALM text prefill over prompt
    hiddens, the prompt through the backbone one step a row, then per step:
    backbone hidden → step_generate (patch, stop, feedback embedding) →
    the feedback as the next backbone input. `min_len >= 0` overrides the
    GGUF's stop-head guard (the stop flag is ignored before that many
    patches; reference --min-len). The noise is the state's host
    generator's, as codec_tpu draws it.

    `chunk_steps > 1` with a backbone the chunk can run (weights, KV cache
    and config: LlamaBackbone) chains K whole steps (CFM step + stop gate
    + backbone step) per device call, on CUDA one replay of a captured
    graph (lm/fused_gen.py::build_continuous_chunk), after the first
    post-prefill step, which runs per step (it may be the primed one).
    Each chunk draws its K noises [K, P, D] from the state's generator, as
    codec_tpu does, so the latents are those of K single steps with the
    same noise.

    → SynthesisResult whose `codes` are the latents [n_steps · patch,
    latent_dim] and `pcm` their decode_latent."""
    if audio_lm.lm is None or not audio_lm.is_continuous:
        raise ValueError("run_continuous requires a continuous-latent codec_lm")
    audio_lm.reset()
    if min_len >= 0:
        audio_lm.lm.set_min_len(audio_lm.state, int(min_len))
    if prefill_hiddens is not None:
        audio_lm.text_prefill(np.asarray(prefill_hiddens, np.float32))
    h = None
    for e in prompt_embeds:
        h = backbone.step(np.asarray(e, np.float32))
    if h is None:
        raise ValueError("prompt_embeds must contain at least one embedding")
    lm = audio_lm.lm
    use_chunk = chunk_steps > 1 and hasattr(backbone, "params") \
        and hasattr(backbone, "kv") and hasattr(backbone, "cfg")

    # the first step always runs per step (it may be the primed one), as
    # codec_tpu's
    stopped = audio_lm.observe_hidden(h) is ObserveAction.STOP
    steps = 1
    if use_chunk and not stopped and steps < max_steps:
        from .base import LmError
        from .fused_gen import chunk_ctx, continuous_chunk_cached

        ks = audio_lm.state.kind_state
        k = int(chunk_steps)
        p, d, hb = lm.patch_size, lm.latent_dim, lm.h_barbet
        pd = p * d
        h = backbone.step(audio_lm.next_embed)
        runs = -(-(max_steps - steps) // k) * k
        runner = continuous_chunk_cached(
            lm, backbone, n_steps=k,
            n_timesteps=getattr(audio_lm, "_n_timesteps", 10),
            cfg_value=getattr(audio_lm, "_cfg_value", 2.0),
            ctx=chunk_ctx(backbone, backbone.pos + runs + 1))
        runner.load(ks, h, backbone.pos,
                    ks["min_len"] if ks["min_len"] >= 0 else lm.min_len)
        while steps < max_steps and not stopped:
            if ks["kv_pos"] >= lm.max_T:
                raise LmError("RALM KV cache full")
            runner.noise.copy_(torch.from_numpy(np.stack(
                [ks["rng"].standard_normal((p, d)) for _ in range(k)]
            ).astype(np.float32)))
            arr = runner.run().cpu().numpy()
            n_emit, done = int(arr[-3]), bool(arr[-2])
            backbone.pos = int(arr[-1])
            if n_emit == 0:
                break
            take = min(n_emit, max_steps - steps, lm.max_T - ks["kv_pos"])
            patches = arr[: k * pd].reshape(k, p, d)
            audio_lm.latents.extend(patches[i].copy() for i in range(take))
            steps += take
            ks["kv_pos"] += n_emit
            ks["patch_index"] += n_emit
            ks["fb_tslm"] = arr[k * pd: k * pd + hb].copy()
            audio_lm.next_embed = ks["fb_tslm"]
            stopped = done and take == n_emit
        runner.store(ks)
    while not use_chunk and steps < max_steps and not stopped:
        h = backbone.step(audio_lm.next_embed)
        stopped = audio_lm.observe_hidden(h) is ObserveAction.STOP
        steps += 1
    latents = (np.concatenate(audio_lm.latents, axis=0) if audio_lm.latents
               else np.zeros((0, audio_lm.lm.info.latent_dim), np.float32))
    pcm = None
    if decode and audio_lm.codec is not None and len(latents):
        pcm = audio_lm.codec.decode_latent(latents)
    return SynthesisResult(codes=latents, pcm=pcm, n_steps=steps,
                           stopped_by_eos=stopped)


def _observe_chunk(audio_lm: AudioLM, arr: np.ndarray, k: int, steps: int,
                   max_frames: int):
    """The frames of one packed single-stream chunk into the context: each
    recorded (compose=False: the chunk composed the feedback itself) until
    the EOS frame, which counts no step, or `max_frames` steps. →
    (n_emitted, frames taken, steps, stopped)."""
    st, n_cb = audio_lm.state, audio_lm.n_codebook
    n_emit = int(arr[-3])
    taken = 0
    for row in arr[: k * n_cb].reshape(k, n_cb)[:n_emit]:
        codes = st.push_frame(row)
        if audio_lm.observe_codes(codes, compose=False) is ObserveAction.STOP:
            return n_emit, taken, steps, True
        steps += 1
        taken += 1
        if steps >= max_frames:
            break
    return n_emit, taken, steps, False


def _chunk_sampling(lm, on_device: Optional[OnDeviceSampling], backbone):
    """The chunk length of an on-device request, 1 (the host path) without
    `on_device` or for a backbone the chunk cannot run (the host's Backbone
    protocol alone), and the Generator of its noise (None when greedy): a
    CPU one, so a request draws the same noise on every device (each chunk
    copies its K frames' draws to the card)."""
    from .fused_gen import supports_gen_chunk

    k = int(on_device.chunk_frames or 1) if on_device is not None else 1
    if k <= 1 or not supports_gen_chunk(lm, backbone):
        return 1, None
    gen = (torch.Generator().manual_seed(on_device.seed)
           if on_device.temperature > 0.0 else None)
    return k, gen


def run_realtime_streaming(
    audio_lm: AudioLM,
    backbone: Backbone,
    text_embd_fn: Callable[[int], np.ndarray],
    ctx_tokens: Sequence[int],
    text_tokens: Sequence[int],
    pi,
    max_frames: int = 1024,
    samplers: Optional[Sequence[Callable[[np.ndarray], int]]] = None,
    decode: bool = True,
    on_device: Optional[OnDeviceSampling] = None,
    prefill_bucket: int = 0,
) -> SynthesisResult:
    """MOSS-TTS-Realtime streaming interleave (reference:
    run_realtime_streaming, tts_runner.cpp:490). Each backbone input row is
    text_embd[token] + compose_audio_embd(codes): the context tokens with
    the audio channel padded (pi.audio_pad_code, composed like any code),
    the first pi.prefill_text_len spoken tokens likewise with the BOS code
    on cb0 of the last, then one spoken token per generated frame (then
    pi.text_pad_id once the text runs out). `samplers`: one host sampler a
    codebook (default: a SamplerChain each at pi's defaults, with its
    repetition penalty over pi.repetition_window codes).

    `on_device` with chunk_frames > 1 and a backbone the chunk can run:
    the frames run as K-frame device chunks (lm/fused_gen.py::
    build_stream_chunk; on CUDA one graph replay a chunk): the frame with
    the per-codebook repetition penalty of on_device.repetition_penalty
    over on_device.repetition_window codes, its history on the device, the
    text⊕audio compose and the backbone step; the host writes each chunk's
    K text tokens. `samplers` is then unused, and `text_embd_fn` must be
    the backbone's tok_embd lookup (the chunk reads the table). The noise
    comes from a CPU torch.Generator seeded by on_device.seed, one [n_cb,
    W] draw a frame."""
    if audio_lm.lm is None:
        raise ValueError("model has no codec_lm adaptor")
    audio_lm.reset()
    lm = audio_lm.lm
    n_cb = audio_lm.n_codebook
    pad_codes = [pi.audio_pad_code] * n_cb
    if samplers is None:
        samplers = [SamplerChain(temperature=pi.default_temperature,
                                 top_k=pi.default_top_k, top_p=pi.default_top_p,
                                 repetition_penalty=pi.default_repetition_penalty,
                                 repetition_window=pi.repetition_window)
                    for _ in range(n_cb)]

    def compose_row(text_tok: int, codes) -> np.ndarray:
        return (np.asarray(text_embd_fn(text_tok), np.float32)
                + lm.compose_audio_embd(codes))

    prefill_n = min(pi.prefill_text_len, len(text_tokens))
    pad_row = lm.compose_audio_embd(pad_codes)
    rows = [np.asarray(text_embd_fn(tok), np.float32) + pad_row
            for tok in list(ctx_tokens) + list(text_tokens[:prefill_n - 1])]
    if prefill_n:
        rows.append(compose_row(text_tokens[prefill_n - 1],
                                [pi.bos_code_c0] + pad_codes[1:]))
    if not rows:
        raise ValueError("empty context tokens")
    h = prefill_prompt(backbone, rows, bucket=prefill_bucket)

    st = audio_lm.state
    text_idx = prefill_n
    stopped = False
    steps = 0
    k, gen = _chunk_sampling(lm, on_device, backbone)
    if k > 1:
        from .fused_gen import chunk_ctx, gen_chunk_cached

        runs = -(-max_frames // k) * k
        runner = gen_chunk_cached(
            lm, backbone, n_frames=k,
            ctx=chunk_ctx(backbone, backbone.pos + runs + 1), stream=True,
            rep=(on_device.repetition_penalty, on_device.repetition_window),
            temperature=on_device.temperature, top_k=on_device.top_k,
            top_p=on_device.top_p, min_p=on_device.min_p)
        runner.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
        runner.pos.fill_(backbone.pos)
        runner.reset_hist()
        pos = backbone.pos
        while steps < max_frames and not stopped:
            runner.text_sched.copy_(torch.as_tensor(
                [text_tokens[text_idx + j] if text_idx + j < len(text_tokens)
                 else pi.text_pad_id for j in range(k)]))
            runner.base.fill_(st.frame_counter)
            if gen is not None:
                runner.draw_noise(gen)
            arr = runner.run().cpu().numpy()
            pos = int(arr[-1])
            n_emit, taken, steps, stopped = _observe_chunk(
                audio_lm, arr, k, steps, max_frames)
            if n_emit == 0:                      # no progress: bail out
                break
            text_idx += taken
        backbone.pos = pos                       # the chunk wrote its cache
        max_frames = 0                           # skip the per-frame loop

    for _ in range(max_frames):
        st.step_begin(np.asarray(h, np.float32))
        for _cb in range(n_cb):
            logits, cb_idx = st.step_logits()
            st.step_push_code(samplers[cb_idx](logits))
        codes = st.step_finish()
        if audio_lm.observe_codes(codes, compose=False) is ObserveAction.STOP:
            stopped = True
            break
        steps += 1
        text_tok = (text_tokens[text_idx] if text_idx < len(text_tokens)
                    else pi.text_pad_id)
        text_idx += 1
        h = backbone.step(compose_row(text_tok, codes))
    return _finish(audio_lm, stopped, steps, None, decode, 0)


def run_lfm2_sequential(
    audio_lm: AudioLM,
    backbone: Backbone,
    text_embd_table,
    prompt_tokens: Sequence[int],
    pi,
    max_frames: int = 1024,
    sampler: Optional[Callable[[np.ndarray], int]] = None,
    decode: bool = True,
    on_device: Optional[OnDeviceSampling] = None,
    prefill_bucket: int = 0,
) -> SynthesisResult:
    """LFM2-Audio sequential text→audio (reference: run_lfm2_sequential,
    tts_runner.cpp:609): the prompt through the backbone (a token a step,
    as codec_tpu, or `prefill_bucket` > 0: one padded forward,
    `prefill_prompt`),
    then the text phase free-runs on the tied-embedding logits
    table @ hidden (one product where the table lives; only the logits
    reach the host sampler) until pi.audio_start_id, or returns no codes at
    pi.text_end_id, for at most pi.max_text_tokens; then codebook-AR
    frames until EOS, the next backbone input the frame's compose
    (the compose table's rows). One sampler drives both phases.

    `text_embd_table` [vocab, hidden]: the backbone's tok_embd (a tensor on
    its device, or an array). `on_device` with chunk_frames > 1 and a
    backbone the chunk can run: the audio phase runs as K-frame device
    chunks (lm/fused_gen.py; on CUDA one graph replay a chunk), the compose
    table's device form as the feedback, the noise from a CPU
    torch.Generator seeded by on_device.seed; `sampler` drives only the
    text phase."""
    if audio_lm.lm is None:
        raise ValueError("model has no codec_lm adaptor")
    audio_lm.reset()
    lm = audio_lm.lm
    table = torch.as_tensor(text_embd_table)
    if sampler is None:
        sampler = SamplerChain(temperature=pi.default_temperature,
                               top_k=pi.default_top_k, top_p=pi.default_top_p)

    def row(tok: int) -> np.ndarray:
        return table[int(tok)].float().cpu().numpy()

    if not len(prompt_tokens):
        raise ValueError("empty prompt tokens")
    h = prefill_prompt(backbone, list(table[torch.as_tensor(
        list(prompt_tokens), device=table.device)].float().cpu().numpy()),
        bucket=prefill_bucket)

    for _ in range(pi.max_text_tokens):
        hd = torch.as_tensor(np.asarray(h, np.float32)).to(table.device,
                                                           table.dtype)
        tok = sampler((table @ hd).float().cpu().numpy())
        if tok == pi.audio_start_id:
            break
        if tok == pi.text_end_id:
            return SynthesisResult(codes=np.zeros((0, audio_lm.n_codebook),
                                                  np.int32),
                                   pcm=None, n_steps=0, stopped_by_eos=True)
        h = backbone.step(row(tok))
    h = backbone.step(row(pi.audio_start_id))

    st = audio_lm.state
    stopped = False
    steps = 0
    k, gen = _chunk_sampling(lm, on_device, backbone)
    if k > 1:
        from .fused_gen import chunk_ctx, gen_chunk_cached

        runs = -(-max_frames // k) * k
        runner = gen_chunk_cached(
            lm, backbone, n_frames=k,
            ctx=chunk_ctx(backbone, backbone.pos + runs + 1),
            temperature=on_device.temperature, top_k=on_device.top_k,
            top_p=on_device.top_p, min_p=on_device.min_p)
        runner.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
        runner.pos.fill_(backbone.pos)
        runner.text_ctx.fill_(0)
        pos = backbone.pos
        while steps < max_frames and not stopped:
            runner.base.fill_(st.frame_counter)
            runner.draw_noise([gen])
            arr = runner.run().cpu().numpy()
            pos = int(arr[-1])
            n_emit, _, steps, stopped = _observe_chunk(audio_lm, arr, k,
                                                       steps, max_frames)
            if n_emit == 0:                      # no progress: bail out
                break
        backbone.pos = pos                       # the chunk wrote its cache
        max_frames = 0                           # skip the per-frame loop

    for _ in range(max_frames):
        st.step_begin(np.asarray(h, np.float32))
        for _cb in range(audio_lm.n_codebook):
            logits, _ = st.step_logits()
            st.step_push_code(sampler(logits))
        codes = st.step_finish()
        if audio_lm.observe_codes(codes, compose=False) is ObserveAction.STOP:
            stopped = True
            break
        steps += 1
        h = backbone.step(lm.compose_audio_embd(codes))
    return _finish(audio_lm, stopped, steps, None, decode, 0)


def run_chatterbox(
    audio_lm: AudioLM,
    t3,
    backbones: Sequence[Backbone],
    text: str,
    max_frames: int = 1024,
    cfg_weight: float = 0.5,
    sampler: Optional[Callable[[np.ndarray], int]] = None,
    speaker_emb=None,
    ref_speech_tokens=None,
    ref_pcm=None,
    emotion: Optional[float] = None,
    decode: bool = True,
    on_device: Optional[OnDeviceSampling] = None,
    prefill_bucket: int = 0,
) -> SynthesisResult:
    """Chatterbox T3 flow (reference: run_chatterbox, tts_runner.cpp:876).

    `t3` is a ChatterboxT3; `backbones` holds one Backbone per CFG lane
    (the reference multiplexes lanes through llama seq-ids; here each lane
    owns a backbone with its own KV state, and may share weights with the
    others: LlamaBackbone.from_params). Per frame on the host: the speech
    head's logits per lane through the codec_lm step machine → CFG combine
    cond + w·(cond − uncond) → sample → stop on stop_speech_token → the
    next speech embedding fed to every lane. `cfg_weight` 0 runs one lane.

    `on_device` with backbones the chunk can run: the loop runs as K-frame
    device chunks (lm/fused_gen.py::build_chatterbox_chunk; on CUDA one
    graph replay a chunk): the lanes ride as one batch through the first
    backbone's weights, the T3 sampler chain (repetition penalty,
    temperature, top_k, min_p, top_p from `on_device`; greedy at
    temperature <= 0) runs in the graph on Gumbel noise drawn from a
    torch.Generator seeded by on_device.seed; `sampler` is then unused.
    `prefill_bucket` buckets each lane's prompt prefill either way."""
    text_ids = t3.tokenize(text)
    prompt = t3.build_prompt(text_ids, cfg_weight=cfg_weight,
                             speaker_emb=speaker_emb,
                             ref_speech_tokens=ref_speech_tokens,
                             ref_pcm=ref_pcm, emotion=emotion)
    n_seq = prompt.shape[0]
    if len(backbones) < n_seq:
        raise ValueError(f"chatterbox needs {n_seq} backbone lanes "
                         f"(cfg_weight={cfg_weight})")
    if sampler is None:
        sampler = T3Sampler(seed_token=t3.info.start_speech_token)

    hiddens = [prefill_prompt(backbones[s], list(prompt[s]),
                              bucket=prefill_bucket) for s in range(n_seq)]

    if on_device is not None and all(
            hasattr(b, "params") and hasattr(b, "kv") and hasattr(b, "cfg")
            for b in backbones[:n_seq]):
        return _run_chatterbox_chunked(
            audio_lm, t3, backbones[:n_seq], hiddens, on_device,
            max_frames=max_frames, cfg_weight=cfg_weight, decode=decode)

    def speech_logits(h):
        st = audio_lm.state
        st.step_begin(np.asarray(h, np.float32))
        logits, _ = st.step_logits()
        st.step_push_code(0)
        st.step_finish()
        return logits

    audio_lm.reset()
    codes: List[int] = []
    stopped = False
    steps = 0
    for step in range(max_frames):
        cond = speech_logits(hiddens[0])
        logits = cond
        if n_seq == 2:
            uncond = speech_logits(hiddens[1])
            logits = cond + cfg_weight * (cond - uncond)
        code = sampler(np.asarray(logits))
        steps += 1
        if code == t3.info.stop_speech_token:
            stopped = True
            break
        if code < t3.info.start_speech_token:
            codes.append(code)
        nb = t3.compose_speech_embd(code, step + 1)
        hiddens = [backbones[s].step(nb) for s in range(n_seq)]
    return _chatterbox_result(audio_lm, codes, steps, stopped, decode)


def _chatterbox_result(audio_lm, codes, steps, stopped, decode):
    codes_arr = np.asarray(codes, np.int32).reshape(-1, 1)
    pcm = None
    if decode and audio_lm.codec is not None and len(codes_arr):
        pcm = _decode_transformed(audio_lm, codes_arr)
    return SynthesisResult(codes=codes_arr, pcm=pcm, n_steps=steps,
                           stopped_by_eos=stopped)


def _run_chatterbox_chunked(audio_lm, t3, backbones, hiddens,
                            on_device: OnDeviceSampling, *,
                            max_frames: int, cfg_weight: float,
                            decode: bool) -> SynthesisResult:
    """The chunked device loop of run_chatterbox (contract there): the
    lanes' caches are copied once into the runner's [S, ...] cache; the
    sampler's unbounded repetition history is a [V] seen mask on the
    device, seeded with the BOS speech token (T3Sampler's seed_token)."""
    from .fused_gen import chatterbox_chunk_cached, chunk_ctx

    info = t3.info
    n_seq = len(backbones)
    k = max(2, int(on_device.chunk_frames))
    chain = (float(on_device.temperature), int(on_device.top_k),
             float(on_device.top_p), float(on_device.min_p))
    bb = backbones[0]
    pos = int(bb.pos)
    runs = -(-max_frames // k) * k
    ctx = chunk_ctx(bb, pos + runs + 1)
    runner = chatterbox_chunk_cached(
        audio_lm.lm, t3, bb, chain=chain,
        rep_pen=float(on_device.repetition_penalty), n_frames=k,
        n_seq=n_seq, cfg_weight=cfg_weight, ctx=ctx)
    for s, lane in enumerate(backbones):
        for dst, src in zip(runner.kvs, own_kvs(lane)):
            dst[s].copy_(src[..., :ctx, :])
    runner.h.copy_(torch.as_tensor(np.stack(
        [np.asarray(x, np.float32) for x in hiddens])))
    runner.pos.fill_(pos)
    runner.seen.zero_()
    runner.seen[info.start_speech_token] = True
    gen = (torch.Generator(device=runner.h.device).manual_seed(on_device.seed)
           if chain[0] > 0.0 else None)

    audio_lm.reset()
    codes: List[int] = []
    stopped = False
    steps = 0
    while not stopped and steps < max_frames:
        runner.step.fill_(steps)
        if gen is not None:
            runner.draw_noise(gen)
        arr = runner.run().cpu().numpy()
        n_emit = int(arr[k])
        if n_emit == 0:
            break
        for i in range(min(n_emit, max_frames - steps)):
            code = int(arr[i])
            steps += 1
            if code == info.stop_speech_token:
                stopped = True
                break
            if code < info.start_speech_token:
                codes.append(code)
    return _chatterbox_result(audio_lm, codes, steps, stopped, decode)


def run_chatterbox_batch(
    audio_lms: Sequence[AudioLM],
    t3,
    backbone,
    texts: Sequence[str],
    on_device: OnDeviceSampling,
    max_frames: int = 512,
    cfg_weight: float = 0.5,
    decode: bool = True,
    sampling: Optional[Sequence[OnDeviceSampling]] = None,
    prefill_bucket: int = 0,
    mesh=None,
    dp_axis: str = "dp",
) -> List[SynthesisResult]:
    """B Chatterbox T3 generations, each with its CFG lanes, through one
    chunk (lm/fused_gen.py::build_chatterbox_chunk_batched; on CUDA one
    graph replay a chunk) on shared weights: codec_tpu's
    run_chatterbox_batch. Stream i's codes are its single-stream chunked
    run's (`run_chatterbox(on_device=...)`) with seed `on_device.seed + i`:
    each stream prefills each lane into its KV slice on the host path, its
    seen mask starts with the start speech token, and its Gumbel noise
    comes from its own generator, a [K, V] draw a chunk while it runs.
    `sampling`: one chain a stream (data in the graph); the repetition
    penalty is `on_device`'s for every stream.

    `mesh`: the B streams split over mesh[dp_axis] (B a multiple of its
    size), codec_tpu's data-parallel streams: one chunk a share, each
    holding its B/n streams' lane caches, hiddens, seen masks and noise,
    on its own devices (a 2-D dp x tp mesh: its row of a backbone TP-split
    over the same mesh). The noise is drawn per stream as without a mesh
    and copied into its share; every share is replayed before any is
    read."""
    from .fused_gen import chatterbox_batch_cached, chunk_ctx, refuse_pp

    refuse_pp(backbone, "batched Chatterbox")
    b = len(audio_lms)
    if b == 0 or b != len(texts):
        raise ValueError("need one text per stream")
    if sampling is not None and len(sampling) != b:
        raise ValueError("sampling needs one OnDeviceSampling per stream")
    if not (hasattr(backbone, "params") and hasattr(backbone, "cfg")):
        raise ValueError("batched chatterbox needs a backbone with its "
                         "weights, KV cache and config (LlamaBackbone)")
    info = t3.info
    k = max(2, int(on_device.chunk_frames))
    n_seq = 2 if cfg_weight > 0.0 else 1
    per_stream = sampling if sampling is not None else [on_device] * b
    prompts = [t3.build_prompt(t3.tokenize(text), cfg_weight=cfg_weight)
               for text in texts]
    runs = -(-max_frames // k) * k
    ctx = chunk_ctx(backbone, max(p.shape[1] for p in prompts) + runs + 1)
    chunks = chatterbox_batch_cached(
        audio_lms[0].lm, t3, backbone, b=b,
        rep_pen=float(on_device.repetition_penalty), n_frames=k, n_seq=n_seq,
        cfg_weight=cfg_weight, ctx=ctx, mesh=mesh, dp_axis=dp_axis)
    hs, poss = [], []
    for i, prompt in enumerate(prompts):
        lanes = []
        for s in range(n_seq):
            backbone.reset()
            lanes.append(np.asarray(prefill_prompt(
                backbone, list(prompt[s]), bucket=prefill_bucket), np.float32))
            for dst, src in zip(chunks.kv(i), own_kvs(backbone)):
                dst[s].copy_(src[..., :ctx, :])
        hs.append(np.stack(lanes))
        poss.append(backbone.pos)
    chunks.put("h", np.stack(hs))
    chunks.put("pos", poss)
    chunks.put("chains", np.stack([o.chain_vec() for o in per_stream]))
    for runner in chunks.runners:
        runner.step.zero_()
        runner.seen.zero_()
        runner.seen[:, info.start_speech_token] = True
    gens = [torch.Generator(device=backbone.device).manual_seed(
        on_device.seed + i) if per_stream[i].temperature > 0.0 else None
        for i in range(b)]
    for alm in audio_lms:
        alm.reset()

    codes: List[List[int]] = [[] for _ in range(b)]
    stopped = [False] * b
    steps = [0] * b
    while any(not stopped[i] and steps[i] < max_frames for i in range(b)):
        done0 = [stopped[i] or steps[i] >= max_frames for i in range(b)]
        chunks.put("done", done0)
        chunks.draw_noise([None if done0[i] else gens[i] for i in range(b)])
        arr = chunks.run()
        n_emit = int(arr[k * b])
        if n_emit == 0:
            break
        rows = arr[: k * b].reshape(k, b)
        for f in range(n_emit):
            for i in range(b):
                if stopped[i] or steps[i] >= max_frames:
                    continue
                code = int(rows[f, i])
                steps[i] += 1
                if code == info.stop_speech_token:
                    stopped[i] = True
                elif code < info.start_speech_token:
                    codes[i].append(code)
    return [_chatterbox_result(audio_lms[i], codes[i], steps[i], stopped[i],
                               decode) for i in range(b)]


def own_kvs(backbone) -> list:
    """A backbone's own cache as a list, one tensor a share ([L, 2, n_kv of
    the share, max_ctx, D] each)."""
    return [backbone.kv] if getattr(backbone, "kv", None) is not None \
        else list(backbone.kvs)


def finalize_batch_stream(alm: AudioLM, backbone, kv_s, pos_s: int, gen_s,
                          on_device: OnDeviceSampling, *, stopped: bool,
                          steps: int, decode: bool = True,
                          n_q: int = 0) -> SynthesisResult:
    """Finish one stream of a batched generation: the post-EOS
    max(delay_pattern) flush through the host step machine off the
    stream's KV slot (contract: include/codec_lm.h:387-401), then the
    decode of the transformed code matrix.

    `kv_s` (a zero-arg callable giving the stream's caches, one [L, 2,
    n_kv of the share, ctx, D] a backbone share: DpChunks.kv) is put into
    the backbone's cache at position `pos_s` only when the flush runs;
    `gen_s` is the stream's noise generator, which the flush continues."""
    n_speech = None
    if stopped and alm.decode_transform.max_delay(alm.n_codebook) > 0 \
            and alm.lm.info.eos_code_c0 >= 0:
        for dst, src in zip(own_kvs(backbone), kv_s()):
            dst[..., : src.shape[-2], :].copy_(src)
        backbone.pos = int(pos_s)
        n_speech, steps = _flush_delay_tail(
            alm, backbone, _device_sampler(on_device, gen_s), steps)
    return _finish(alm, stopped, steps, n_speech, decode, n_q)


def run_codebook_ar_batch(
    audio_lms: Sequence[AudioLM],
    backbone,
    prompt_embeds_list: Sequence[Sequence[np.ndarray]],
    on_device: OnDeviceSampling,
    max_steps: int = 1024,
    decode: bool = True,
    n_q: int = 0,
    pi=None,
    prefill_bucket: int = 0,
    sampling: Optional[Sequence[OnDeviceSampling]] = None,
    mesh=None,
    dp_axis: str = "dp",
) -> List[SynthesisResult]:
    """B concurrent Type C/D generations on shared weights, the whole frame
    loop batched on the device (lm/fused_gen.py::build_gen_chunk_batched):
    one chunk steps every stream's frame, feedback compose and backbone
    step together, the packed products at m = B, on CUDA one graph replay
    a chunk. Each stream owns its AudioLM context (share one CodecLM:
    `AudioLM(reader, codec, lm=shared)`), KV cache slot, noise generator
    (seed + stream index, as the single-stream run with that seed draws)
    and EOS state; streams that stop early ride along frozen.

    Needs a backbone the chunk can run and a chunk-capable kind (raises
    otherwise); a TP or EP backbone steps over its shares. `pi`'s cb0
    range applies in-graph as in run_codebook_ar. `sampling`: one
    OnDeviceSampling per stream, their chains as data ([B, 4],
    `ops.sample.sample_logits_dyn`; one graph for any mix); `on_device`
    then gives only seed and chunk_frames. None: `on_device`'s chain for
    every stream.

    `mesh`: codec_tpu's data-parallel streams, B split over
    mesh[dp_axis] (a multiple of its size): one chunk a share, each with
    its B/n streams' caches, hiddens, positions and noise on the share's
    devices (the products at m = B/n), its frame on its own device. On a
    2-D mesh it composes with a backbone TP-split over the same mesh
    (`bb.set_mesh(mesh2d, axis="tp")`): streams over dp, every product's
    shares over its row's tp devices. The noise is drawn per stream as
    without a mesh and copied into its share; every share is replayed
    before any is read."""
    from .fused_gen import (chunk_ctx, gen_batch_cached, refuse_pp,
                            supports_gen_chunk)

    b = len(audio_lms)
    if b == 0 or b != len(prompt_embeds_list):
        raise ValueError("need one prompt per stream")
    if sampling is not None and len(sampling) != b:
        raise ValueError("sampling needs one OnDeviceSampling per stream")
    lm = audio_lms[0].lm
    if lm is None:
        raise ValueError("model has no codec_lm adaptor")
    for alm in audio_lms[1:]:
        if alm.lm is not lm:
            raise ValueError("streams must share one CodecLM "
                             "(AudioLM(reader, codec, lm=shared))")
    refuse_pp(backbone, "batched generation")
    if not supports_gen_chunk(lm, backbone):
        raise ValueError("batched generation needs a backbone with its "
                         "weights, KV cache and config (LlamaBackbone) and "
                         "a chunk-capable LM kind")
    chunk_n = max(2, int(on_device.chunk_frames))
    per_stream = sampling if sampling is not None else [on_device] * b

    if any(not len(embeds) for embeds in prompt_embeds_list):
        raise ValueError("every stream needs >= 1 prompt embedding")
    runs = -(-max_steps // chunk_n) * chunk_n
    ctx = chunk_ctx(backbone, max(len(e) for e in prompt_embeds_list) + runs + 1)
    chain = None if sampling is not None else (
        float(on_device.temperature), int(on_device.top_k),
        float(on_device.top_p), float(on_device.min_p))
    chunks = gen_batch_cached(lm, backbone, b=b, n_frames=chunk_n, ctx=ctx,
                              chain=chain, cb0_range=_cb0_range(pi),
                              mesh=mesh, dp_axis=dp_axis)
    if sampling is not None:
        chunks.put("chains", np.stack([o.chain_vec() for o in sampling]))
    # each stream's prompt prefill in the backbone's cache, then its slot
    hs, poss = [], []
    for s, embeds in enumerate(prompt_embeds_list):
        backbone.reset()
        hs.append(np.asarray(prefill_prompt(backbone, embeds,
                                            bucket=prefill_bucket),
                             np.float32))
        poss.append(backbone.pos)
        for dst, src in zip(chunks.kv(s), own_kvs(backbone)):
            dst.copy_(src[..., :ctx, :])
    chunks.put("h", np.stack(hs))
    chunks.put("pos", poss)
    for alm in audio_lms:
        alm.reset()
    states = [alm.state for alm in audio_lms]
    chunks.put("text_ctx", [st.text_context if st.text_context is not None
                            else 0 for st in states])
    gens = [torch.Generator(device=backbone.device).manual_seed(
        on_device.seed + s) for s in range(b)]

    n_cb = lm.info.n_codebook
    stopped = [False] * b
    steps = [0] * b
    pos = np.asarray(poss)
    base = states[0].frame_counter
    while any(not stopped[s] and steps[s] < max_steps for s in range(b)):
        # done0: the streams that stopped (or hit max_steps) stay frozen,
        # their KV and position at the frame they stopped at, which the
        # delay-tail flush below reads
        done0 = [stopped[s] or steps[s] >= max_steps for s in range(b)]
        chunks.put("done", done0)
        chunks.put("base", [base] * b)
        chunks.draw_noise([None if done0[s] or per_stream[s].temperature <= 0
                           else gens[s] for s in range(b)])
        arr = chunks.run()
        n_emit = int(arr[chunk_n * b * n_cb])
        pos = arr[-b:]
        if n_emit == 0:
            break
        rows = arr[: chunk_n * b * n_cb].reshape(chunk_n, b, n_cb)
        for i in range(n_emit):
            for s in range(b):
                if stopped[s] or steps[s] >= max_steps:
                    continue
                codes = states[s].push_frame(rows[i, s])
                steps[s] += 1          # the EOS frame counts, as in the
                if audio_lms[s].observe_codes(     # single-stream loop;
                        codes,                     # compose=False: the
                        compose=False) is ObserveAction.STOP:  # chunk
                    stopped[s] = True              # composes the feedback
        base += n_emit

    return [finalize_batch_stream(
        audio_lms[s], backbone, (lambda s=s: chunks.kv(s)), int(pos[s]),
        gens[s], per_stream[s], stopped=stopped[s], steps=steps[s],
        decode=decode, n_q=n_q) for s in range(b)]
