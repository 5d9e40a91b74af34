"""Continuous-batching TTS engine over the batched chunk (counterpart of
codec_tpu/serve/cont_batch.py).

Static batching (`lm/tts_runner.run_codebook_ar_batch`) fixes the request
set at launch: a stream that finishes rides frozen until the whole batch
drains, and a request that arrives mid-flight waits for the next batch.
This engine keeps one B-stream chunk (`lm/fused_gen.ChunkRunner` with
`batched=True` and the sampler chain as data; on CUDA one captured graph),
or with a mesh one chunk a data-parallel share of the slots, and treats
the batch dimension as B *slots*:

  - a slot is retired the moment its stream stops (EOS observed by the
    host state machine, or the request's max_steps): its delay tail is
    flushed, its codes decoded and its result delivered;
  - the next queued request is admitted into a free slot at the chunk
    boundary: its prompt is prefilled on the host path into the backbone's
    own cache, and the cache rows, hidden, position, text context, frame
    counter and chain are copied into the slot's part of the chunk's
    static buffers (plain copies, outside the graph);
  - empty slots ride into the chunk as done, their state held.

A request's codes are the single-stream chunked run's
(`run_codebook_ar(on_device=...)`) with the same seed, whatever slot it
lands in and whenever it is admitted: each slot owns its cache rows, its
hidden, its AudioLM state and its noise generator, seeded at admission,
from which it draws exactly what its single-stream run draws (K frames a
chunk while it runs, none while it is empty or stopped, the frames it took
of a chunk it stopped in, and the delay-tail flush continuing the same
generator).

The chunk attends `ctx` cache rows for every slot (by default the
backbone's max_ctx) under the position mask key_pos <= pos: rows at or
past a slot's position, stale ones from an earlier request included, get
exp(-1e30) = 0 exactly, so an admission copies the new prefill's rows
[..., :ctx, :] over the slot and zeroes nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..lm.audio_lm import AudioLM, ObserveAction
from ..ops.sample import OnDeviceSampling


class RequestCancelled(RuntimeError):
    """Raised by TtsRequest.wait() when the request was cancelled."""


class TtsRequest:
    """Handle for one queued synthesis. `wait()` blocks for the result
    (a `lm.tts_runner.SynthesisResult`) or re-raises the engine-side error
    for this request. `submitted_at` and `admitted_at` (time.monotonic();
    None until admitted) tell its wait in the queue and its prefill."""

    def __init__(self, audio_lm: AudioLM, prompt_embeds: Sequence,
                 seed: int, max_steps: int,
                 sampling: Optional[OnDeviceSampling] = None,
                 frame_cb=None):
        self.audio_lm = audio_lm
        self.prompt_embeds = list(prompt_embeds)
        self.seed = int(seed)
        self.max_steps = int(max_steps)
        self.sampling = sampling
        self.frame_cb = frame_cb
        self.result = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("synthesis not finished")
        if self.error is not None:
            raise self.error
        return self.result

    def cancel(self) -> bool:
        """Request cancellation: a queued request is dropped at the next
        admission scan; an active one is retired without decode at the
        next chunk boundary (a running chunk cannot be interrupted), its
        slot freed for the next queued request. `wait()` then raises
        RequestCancelled. Returns False if the request already finished
        (the result stands)."""
        if self._done.is_set():
            return False
        self._cancel.set()
        return True

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result=None, error=None) -> None:
        self.result, self.error = result, error
        self._done.set()


class ContinuousBatcher:
    """B-slot continuous-batching engine for plain codebook-AR kinds
    (CSM / Qwen3-TTS / MOSS-TTSD families).

    One `ContinuousBatcher` owns its chunk's static buffers and the
    backbone's cache between chunks (give it a backbone of its own, e.g.
    `LlamaBackbone.from_params` over shared weights, where other code
    steps the same one); drive `step()` from a single engine thread
    (serve's `--cont-batch` starts one) or call `drain()` inline for batch
    jobs. `submit()` is thread-safe. The sampler chain (temperature /
    top_k / top_p / min_p) is a per-slot row of the chunk's `chains` [B, 4]
    input (`ops.sample.sample_logits_dyn`), so each request may bring its
    own (`submit(sampling=...)`, engine `on_device` the default) in the
    one graph. The noise seed is per request.

    A step attends every slot's `ctx` = max_ctx cache rows (the
    backbone's whole cache, as codec_tpu's slot arrays hold it). On CUDA
    the graph is captured when the engine is built. A TP or EP backbone
    steps over its shares. `mesh`: codec_tpu's data-parallel slots, the B
    slots split over mesh[dp_axis] (B a multiple of its size): one chunk
    a share (`chunks`, fused_gen.DpChunks; `runner` is the first), each
    with its slots' caches, hiddens and noise on the share's devices; on
    a 2-D mesh each share runs over its row of a backbone TP-split over
    the same mesh. An admission writes its prefill into the share that owns
    the slot; a step replays every share before it reads any.
    """

    def __init__(self, backbone, shared_lm, *, n_slots: int = 4,
                 on_device: OnDeviceSampling, pi=None, decode: bool = True,
                 n_q: int = 0, mesh=None, dp_axis: str = "dp",
                 prefill_bucket: int = 0):
        from ..lm.fused_gen import (ChunkRunner, DpChunks, chunk_ctx,
                                    dp_groups, refuse_pp, supports_gen_chunk)
        from ..lm.tts_runner import _cb0_range

        refuse_pp(backbone, "the continuous-batching engine")
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if not supports_gen_chunk(shared_lm, backbone):
            raise ValueError("continuous batching needs a backbone with its "
                             "weights, KV cache and config (LlamaBackbone) "
                             "and a chunk-capable LM kind")
        groups = dp_groups(backbone, mesh, int(n_slots), dp_axis,
                           "continuous batching", "slots")
        self.backbone = backbone
        self.lm = shared_lm
        self.B = int(n_slots)
        self.K = max(2, int(on_device.chunk_frames))
        self.ods = on_device
        self.decode = decode
        self.n_q = int(n_q)
        self.n_cb = int(shared_lm.info.n_codebook)
        # prefill_bucket > 0: an admission prefills the whole prompt in one
        # forward padded to a multiple of it (lm/tts_runner.prefill_prompt)
        self.prefill_bucket = int(prefill_bucket)
        self.ctx = chunk_ctx(backbone, backbone.cfg.max_ctx)
        self.chunks = DpChunks(groups, lambda n, row, dev: ChunkRunner(
            shared_lm, backbone, None, self.K, _cb0_range(pi), batched=True,
            b=n, ctx=self.ctx, row=row, device=dev), self.n_cb)
        self.runner = self.chunks.runner
        self.chunks.put("chains", np.tile(on_device.chain_vec(), (self.B, 1)))

        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self.slots: List[Optional[TtsRequest]] = [None] * self.B
        self._steps = [0] * self.B
        self._stopped = [False] * self.B
        self._gens: List[Optional[torch.Generator]] = [None] * self.B
        self._pos = np.zeros(self.B, np.int64)
        if torch.device(backbone.device).type == "cuda":
            # capture the graphs now (every slot empty), not while other
            # threads of a server run device work
            self.chunks.put("done", [True] * self.B)
            self.chunks.run()

    # -- request side -------------------------------------------------------
    def submit(self, audio_lm: AudioLM, prompt_embeds: Sequence,
               seed: int = 0, max_steps: int = 512,
               sampling: Optional[OnDeviceSampling] = None,
               frame_cb=None) -> TtsRequest:
        """Queue one synthesis. `audio_lm` must share this engine's
        CodecLM (`AudioLM(reader, codec, lm=engine.lm)`); `prompt_embeds`
        is the prompt's embedding rows (composed for merged-cb0 models).

        `sampling` overrides the engine default chain (temperature / top_k
        / top_p / min_p) for this request only; its `seed` and
        `chunk_frames` are not read (the `seed` argument and the engine's K
        apply).

        `frame_cb(codes int32 [n_cb])` is called from the engine thread for
        every surviving frame as its chunk is read (the EOS frame and
        frames past max_steps excluded): keep it as cheap as a queue put;
        it feeds streaming vocoders (serve's /synthesize "stream")."""
        if audio_lm.lm is not self.lm:
            raise ValueError("request must share the engine CodecLM "
                             "(AudioLM(reader, codec, lm=engine.lm))")
        if not prompt_embeds:
            raise ValueError("every request needs >= 1 prompt embedding")
        req = TtsRequest(audio_lm, prompt_embeds, seed, max_steps,
                         sampling=sampling, frame_cb=frame_cb)
        with self._work:
            self._queue.append(req)
            self._work.notify()
        return req

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until a request is queued (engine-thread idle wait)."""
        with self._work:
            if self._queue or any(r is not None for r in self.slots):
                return True
            return self._work.wait(timeout)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def n_queued(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- engine side ----------------------------------------------------
    def _chain(self, req: TtsRequest) -> OnDeviceSampling:
        return req.sampling or self.ods

    def _admit_one(self, s: int, req: TtsRequest) -> None:
        """Prefill `req`'s prompt on the host path into the backbone's own
        cache, then copy its state into slot `s` of its share's buffers."""
        from ..lm.tts_runner import own_kvs, prefill_prompt

        (r, j), bb = self.chunks.at(s), self.backbone
        bb.reset()
        h = prefill_prompt(bb, req.prompt_embeds, bucket=self.prefill_bucket)
        req.audio_lm.reset()
        st = req.audio_lm.state
        for dst, src in zip(self.chunks.kv(s), own_kvs(bb)):
            dst.copy_(src[..., :self.ctx, :])
        r.h[j].copy_(torch.as_tensor(np.asarray(h, np.float32)))
        r.pos[j] = bb.pos
        r.text_ctx[j] = int(st.text_context or 0)
        r.chains[j].copy_(torch.as_tensor(self._chain(req).chain_vec()))
        self._pos[s] = bb.pos
        self._gens[s] = torch.Generator(device=bb.device).manual_seed(
            req.seed)
        self._steps[s] = 0
        self._stopped[s] = False
        self.slots[s] = req
        req.admitted_at = time.monotonic()

    def _admit(self) -> None:
        """Fill free slots from the queue. Cancelled queued requests are
        purged (and resolved) up front, even when no slot is free."""
        cancelled = []
        with self._lock:
            if any(r.cancelled for r in self._queue):
                keep = []
                while self._queue:
                    r = self._queue.popleft()
                    (cancelled if r.cancelled else keep).append(r)
                self._queue.extend(keep)
        for r in cancelled:
            r._finish(error=RequestCancelled("request cancelled while queued"))

        for s in range(self.B):
            if self.slots[s] is not None:
                continue
            req = None
            while req is None:
                with self._lock:
                    if not self._queue:
                        break
                    req = self._queue.popleft()
                if req is not None and req.cancelled:
                    req._finish(error=RequestCancelled(
                        "request cancelled while queued"))
                    req = None
            if req is None:
                break
            try:
                self._admit_one(s, req)
            except BaseException as e:               # noqa: BLE001
                self.slots[s] = None
                req._finish(error=e)

    def step(self) -> int:
        """Admissions + one K-frame chunk + retirements. Returns the number
        of active slots after retirement (0 = engine idle)."""
        from ..lm.fused_gen import capture_lock

        with capture_lock.shared():
            return self._step()

    def _step(self) -> int:
        from ..lm.tts_runner import finalize_batch_stream

        self._admit()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            return 0
        sampled = {s: self._chain(self.slots[s]).temperature > 0.0
                   for s in active}
        drawn = {s: self._gens[s].get_state() for s in active if sampled[s]}
        c = self.chunks
        c.put("done", [self.slots[s] is None for s in range(self.B)])
        c.put("base", [self.slots[s].audio_lm.state.frame_counter
                       if self.slots[s] is not None else 0
                       for s in range(self.B)])
        c.draw_noise([self._gens[s] if s in drawn else None
                      for s in range(self.B)])
        arr = c.run()
        n_emit = int(arr[self.K * self.B * self.n_cb])
        pos_after = arr[-self.B:]
        rows = arr[: self.K * self.B * self.n_cb].reshape(
            self.K, self.B, self.n_cb)

        used = dict.fromkeys(active, 0)
        cb_err: dict = {}
        for i in range(n_emit):
            for s in active:
                req = self.slots[s]
                if s in cb_err or self._stopped[s] \
                        or self._steps[s] >= req.max_steps:
                    continue
                codes = req.audio_lm.state.push_frame(rows[i, s])
                self._steps[s] += 1
                used[s] += 1
                # compose=False: the chunk composes the feedback itself
                if req.audio_lm.observe_codes(
                        codes, compose=False) is ObserveAction.STOP:
                    self._stopped[s] = True
                elif req.frame_cb is not None:
                    try:
                        req.frame_cb(np.asarray(codes, np.int32))
                    except BaseException as e:        # noqa: BLE001
                        # a broken callback fails its request, not the
                        # engine: the slot retires below
                        cb_err[s] = e
        for s in active:
            self._pos[s] = int(pos_after[s])
            if s in drawn and used[s] < self.K:
                # leave the generator where the single-stream run leaves
                # it: one draw a frame taken (the delay-tail flush goes on)
                self._gens[s].set_state(drawn[s])
                c.draw_noise([self._gens[s] if i == s else None
                              for i in range(self.B)], frames=used[s])

        n_left = 0
        for s in active:
            req = self.slots[s]
            if req.cancelled:
                # retired without flush or decode; the next admission
                # copies its state over the slot
                req._finish(error=RequestCancelled(
                    "request cancelled mid-generation"))
                self.slots[s] = None
                continue
            if s in cb_err:
                req._finish(error=cb_err[s])
                self.slots[s] = None
                continue
            if not self._stopped[s] and self._steps[s] < req.max_steps:
                n_left += 1
                continue
            try:
                result = finalize_batch_stream(
                    req.audio_lm, self.backbone,
                    (lambda s=s: c.kv(s)), int(self._pos[s]),
                    self._gens[s], self._chain(req),
                    stopped=self._stopped[s], steps=self._steps[s],
                    decode=self.decode, n_q=self.n_q)
                req._finish(result=result)
            except BaseException as e:               # noqa: BLE001
                req._finish(error=e)
            self.slots[s] = None
        return n_left

    def drain(self) -> None:
        """Step until every queued and active request has finished (inline
        driving for batch jobs and tests)."""
        while True:
            n = self.step()
            if n == 0:
                with self._lock:
                    if not self._queue:
                        return

    def fail_all(self, err: BaseException) -> None:
        """Resolve every active and queued request with `err` (an
        engine-level failure): handles unblock instead of hanging to their
        wait timeout, slots free for the next admissions."""
        for s in range(self.B):
            req, self.slots[s] = self.slots[s], None
            if req is not None:
                req._finish(error=err)
        with self._lock:
            queued, self._queue = list(self._queue), type(self._queue)()
        for req in queued:
            req._finish(error=err)


class EngineThread(threading.Thread):
    """Owns a ContinuousBatcher: steps while there is work, sleeps on the
    submit condition otherwise. `stop()` finishes the step in flight
    first."""

    def __init__(self, batcher: ContinuousBatcher):
        super().__init__(name="tts-cont-batch", daemon=True)
        self.batcher = batcher
        # not `_stop`: that would shadow threading.Thread._stop()
        self._stop_flag = threading.Event()

    def run(self) -> None:
        while not self._stop_flag.is_set():
            try:
                n = self.batcher.step()
            except BaseException as e:                # noqa: BLE001
                # a step failure must not kill the thread silently (every
                # handle would hang to its wait timeout): fail the requests
                # in flight, log, keep serving
                import traceback

                traceback.print_exc()
                self.batcher.fail_all(e)
                n = 0
            if n == 0 and self.batcher.n_queued == 0:
                self.batcher.wait_for_work(timeout=0.1)

    def stop(self, timeout: float = 30.0) -> None:
        self._stop_flag.set()
        with self.batcher._work:
            self.batcher._work.notify_all()
        self.join(timeout)
