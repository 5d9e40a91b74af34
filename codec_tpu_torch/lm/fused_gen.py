"""On-device chunked AR generation for codebook-AR TTS (counterpart of
codec_tpu/lm/fused_gen.py's generation chunks).

A chunk runs K whole frames on the device: the fused depth-AR frame with
in-graph sampling (lm/residual_depth_ar.py::_build_frame) → the EOS gate →
the feedback compose → one backbone step (lm/backbone.py::backbone_step),
and packs the codes and the bookkeeping into one int32 tensor that the host
reads with one copy. The realtime-streaming chunk (`build_stream_chunk`)
adds a per-codebook repetition-penalty history and a text token per frame
to the feedback. On CUDA a chunk is captured once as a CUDA graph over
static buffers (hidden, positions, done flags, Gumbel noise, frame counters
and the KV cache) and replayed; on the CPU it runs eagerly.

codec_tpu's chunk is a `lax.while_loop` that leaves at EOS. A graph always
runs its K frames, so EOS is data here: once a stream is done its hidden
and position are held (`torch.where`), its later frames write their KV row
at the held position, which the next real step there overwrites (as
codec_tpu's batched chunk does for finished streams), and its code rows
are zeros. The counts in the packed result are codec_tpu's: the frames up
to and including the EOS frame, the position after the last feedback step.

The backbone step of every chunk goes through a StepGroup
(lm/backbone.py): the whole backbone on one device, or one row of a TP or
EP backbone's shares (backbone_step_split), each share's layers and kv
heads with their own caches (`kvs`, one a share). Data-parallel streams
(`dp_groups`) run one chunk a share, on the share's devices with the LM's
weights there (CodecLM.on_device), behind one batch's interface
(`DpChunks`). A group spread over several cards is
refused (`step_group`): a capture across cards is not built.

Packed layouts (codec_tpu's):
  single stream: codes [K, n_cb] ++ [n_emitted, stopped, pos_after]
  B streams:     codes [K, B, n_cb] ++ [n_iter] ++ done [B] ++ pos_after [B]
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sample import gumbel
from ..parallel.mesh import physical
from ..runtime.model import CodecError
from .backbone import StepGroup

_CTX_STEP = 64     # the attended cache rows are a multiple of this
_KEEP = 4          # runners kept per backbone, frames per LM


def _kept(owner, attr: str, key, make: Callable):
    """owner.<attr>[key], made by make() when absent. At most _KEEP are
    kept, the least recently used dropped first: its graph (a batch's
    graphs, one a data-parallel share), the graph's memory pool and, for a
    batch, its KV go with it."""
    cache = owner.__dict__.setdefault(attr, OrderedDict())
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    while len(cache) >= _KEEP:
        cache.popitem(last=False)
    cache[key] = made = make()
    return made


def _chunk_loop(lm, bb_cfg, chain, n_frames: int, cb0_range,
                clamp_pos: bool) -> Callable:
    """The K-frame loop shared by both chunk forms: loop(step, kvs, pos,
    base_frame, h, noise, text_ctx, done, chains, ctx) → (codes [K, B,
    n_cb], n_live [K, B] bool (the stream was not done when the frame
    began), done [B], h' [B, hidden], pos' [B]). `step` is the backbone's
    StepGroup, `kvs` its caches (one a share)."""
    frame = lm._build_frame(chain, cb0_range=cb0_range)
    compose = lm.compose_embd_fn()
    info = lm.info
    eos_code, eos_min = int(info.eos_code_c0), int(info.eos_min_step)
    max_pos = int(bb_cfg.max_ctx) - 1

    def loop(step, kvs, pos, base_frame, h, noise, text_ctx, done, chains,
             ctx: int):
        rows, live = [], []
        for i in range(n_frames):
            codes = frame(h, noise[i], text_ctx, chains)           # [B, n_cb]
            if eos_code >= 0:
                is_eos = (codes[:, 0] == eos_code) & (base_frame + i >= eos_min)
            else:
                is_eos = torch.zeros_like(done)
            emb = compose(codes).to(step.dtype)
            h2 = step(kvs, pos, emb, ctx)
            live.append(~done)
            rows.append(torch.where(done[:, None], 0, codes))
            done = done | is_eos
            h = torch.where(done[:, None], h, h2.float())
            nxt = pos + 1
            if clamp_pos:
                nxt = nxt.clamp(max=max_pos)
            pos = torch.where(done, pos, nxt)
        return torch.stack(rows), torch.stack(live), done, h, pos

    return loop


def build_gen_chunk(lm, bb_cfg, chain: Optional[Tuple[float, int, float, float]],
                    n_frames: int, cb0_range=None) -> Callable:
    """The single-stream chunk: chunk(step (the backbone's StepGroup), kvs
    (its caches, each [1, L, 2, n_kv, >= ctx, D]), pos [1], base_frame [1],
    h [1, hidden] f32, noise [K, 1, n_cb, W] f32, text_ctx [1], ctx) → (packed
    int32 [K·n_cb + 3], h', pos'). `kvs` are updated in place; packed =
    codes.flatten() ++ [n_emitted, stopped, pos_after], rows past
    n_emitted zero; `pos_after` is the position after the last feedback
    step (the EOS frame takes none, as the host loop breaks before
    `backbone.step`)."""
    loop = _chunk_loop(lm, bb_cfg, chain, n_frames, cb0_range,
                       clamp_pos=False)

    def chunk(step, kvs, pos, base_frame, h, noise, text_ctx, ctx: int):
        done = torch.zeros_like(pos, dtype=torch.bool)
        codes, live, done, h, pos = loop(step, kvs, pos, base_frame, h,
                                         noise, text_ctx, done, None, ctx)
        meta = torch.stack([live.sum(), done[0].long(), pos[0]])
        packed = torch.cat([codes.reshape(-1), meta]).to(torch.int32)
        return packed, h, pos

    return chunk


def build_gen_chunk_batched(lm, bb_cfg,
                            chain: Optional[Tuple[float, int, float, float]],
                            n_frames: int, cb0_range=None) -> Callable:
    """B streams through one chunk, as one batch of tensors (the products
    at m = B): chunk(step (the backbone's StepGroup), kvs (its caches, each
    [B, L, 2, n_kv, >= ctx, D]), pos [B], base_frame [B], h [B, hidden],
    noise [K, B, n_cb, W], text_ctx [B], done0 [B] bool, chains [B, 4] or None, ctx) → (packed int32 [K·B·n_cb +
    1 + 2B], h', pos') with packed = codes[K, B, n_cb].flatten() ++
    [n_iter] ++ done[B] ++ pos_after[B]. Positions stop at max_ctx - 1.

    `done0` carries the streams that already stopped (or empty slots) into
    the chunk: they stay frozen, so a delay-tail flush later reads the KV
    state of the frame they stopped at. `n_iter` counts the frames until
    every stream is done. `chain=None` builds the chunk whose sampler chain
    is data, `chains` [B, 4] (`ops.sample.sample_logits_dyn`)."""
    loop = _chunk_loop(lm, bb_cfg, chain, n_frames, cb0_range,
                       clamp_pos=True)

    def chunk(step, kvs, pos, base_frame, h, noise, text_ctx, done0, chains,
              ctx: int):
        codes, live, done, h, pos = loop(step, kvs, pos, base_frame, h,
                                         noise, text_ctx, done0, chains, ctx)
        n_iter = live.any(dim=1).sum()[None]
        packed = torch.cat([codes.reshape(-1), n_iter, done.long(), pos])
        return packed.to(torch.int32), h, pos

    return chunk


class CaptureLock:
    """Keeps a CUDA graph capture apart from the process's other device
    work. A capture (global capture mode) fails, or is spoiled, when
    another thread allocates device memory, synchronizes or copies to the
    host while it runs; so a capture holds this lock `exclusive()`, and
    device work that may run on other threads at the same time (a server's
    handlers, the continuous-batching engine's steps) holds it `shared()`.
    Shared holders run together; a waiting capture keeps new shared
    holders out (a thread that already holds it may take it again), and a
    thread may take `exclusive()` over its own shared hold."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0                  # shared holds, every thread's
        self._writer = None               # the thread holding exclusive()
        self._waiting = 0                 # threads waiting for exclusive()
        self._mine = threading.local()

    def _held(self) -> int:
        return getattr(self._mine, "n", 0)

    def _may_share(self, me) -> bool:
        if self._writer is not None:
            return self._writer == me
        return not self._waiting or self._held() > 0

    @contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            while not self._may_share(me):
                self._cond.wait()
            self._shared += 1
            self._mine.n = self._held() + 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                self._mine.n -= 1
                self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                outer = True
            else:
                outer = False
                self._waiting += 1
                while self._writer is not None \
                        or self._shared > self._held():
                    self._cond.wait()
                self._waiting -= 1
                self._writer = me
        try:
            yield
        finally:
            if not outer:
                with self._cond:
                    self._writer = None
                    self._cond.notify_all()


capture_lock = CaptureLock()


class Graphed:
    """fn() over static tensors, captured once as a CUDA graph.

    `run()` calls fn eagerly on a CPU device; on CUDA the first call warms
    fn up on a side stream (its kernels are built and cuBLAS initialised),
    puts back the tensors in `restore` that the warm-up changed, captures
    fn, and replays; later calls replay. The output is the graph's own
    tensor, valid until the next replay. A failed capture raises. The
    warm-up and the capture hold `capture_lock` exclusive; both run with
    `device` current, so each data-parallel share's graph lives on its
    own card."""

    def __init__(self, fn: Callable, device: torch.device, restore=()):
        self.fn, self.device, self.restore = fn, device, restore
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None

    def eager(self):
        with torch.inference_mode():
            return self.fn()

    def run(self):
        if self.device.type != "cuda":
            return self.eager()
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        return self.out

    def _capture(self) -> None:
        with capture_lock.exclusive():
            saved = [t.clone() for t in self.restore]
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.eager()
            current.wait_stream(side)
            for t, s in zip(self.restore, saved):
                t.copy_(s)
            graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(graph):
                self.out = self.fn()
            self.graph = graph


class ChunkRunner:
    """One chunk's static buffers and its graph: B streams, K frames,
    `ctx` attended cache rows, on the backbone's StepGroup (`row` of a TP
    or EP backbone's shares, or the whole backbone on `device`: a
    data-parallel share's). The host writes `h`, `pos`, `text_ctx` once,
    and per chunk `base`, `done` and `noise`; `run()` advances `h` and
    `pos` in place and returns the packed result (see the module
    docstring). `kvs` are the caches the chunk updates, one a share: the
    backbone's own (single stream) or ones owned here, [B, L, 2, n_kv of
    the share, ctx, D]; `kv` is the first (the whole cache unsharded)."""

    def __init__(self, lm, backbone, chain, n_frames: int, cb0_range,
                 batched: bool, b: int, ctx: int, row: int = 0,
                 device=None):
        group = step_group(backbone, "a generation chunk", row, device)
        cfg, dev = backbone.cfg, group.device
        lm = lm.on_device(dev)
        self.device = dev
        self.k = n_frames
        self.n_cb = lm.info.n_codebook
        self.width = lm.noise_width()
        self.h = torch.zeros((b, cfg.hidden), dtype=torch.float32, device=dev)
        self.pos = torch.zeros((b,), dtype=torch.long, device=dev)
        self.base = torch.zeros((b,), dtype=torch.long, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.text_ctx = torch.zeros((b,), dtype=torch.long, device=dev)
        self.noise = torch.zeros((n_frames, b, self.n_cb, self.width),
                                 dtype=torch.float32, device=dev)
        self.chains = (torch.zeros((b, 4), dtype=torch.float32, device=dev)
                       if chain is None else None)
        if batched:
            self.kvs = group.new_kv((b,), ctx)
            chunk = build_gen_chunk_batched(lm, cfg, chain, n_frames,
                                            cb0_range)

            def step():
                packed, h, pos = chunk(group, self.kvs, self.pos, self.base,
                                       self.h, self.noise, self.text_ctx,
                                       self.done, self.chains, ctx)
                self.h.copy_(h)
                self.pos.copy_(pos)
                return packed
        else:
            self.kvs = group.own_kv()
            chunk = build_gen_chunk(lm, cfg, chain, n_frames, cb0_range)

            def step():
                packed, h, pos = chunk(group, self.kvs, self.pos, self.base,
                                       self.h, self.noise, self.text_ctx, ctx)
                self.h.copy_(h)
                self.pos.copy_(pos)
                return packed
        self.kv = self.kvs[0]
        self.graphed = Graphed(step, torch.device(dev), restore=(
            self.h, self.pos, *(k[..., :ctx, :] for k in self.kvs)))

    def draw_noise(self, generators, frames: int = 0) -> None:
        """Fresh Gumbel noise for stream s's frames from generators[s], one
        [n_cb, W] draw a frame (the per-frame path draws the same), or none
        where generators[s] is None (greedy, or a stream that is done).
        Each draw is on the generator's device, then copied in. `frames`:
        draw only the first so many frames' rows (default K)."""
        for s, gen in enumerate(generators):
            if gen is not None:
                self.noise[:frames or self.k, s] = torch.stack(
                    [gumbel((self.n_cb, self.width), gen, gen.device)
                     for _ in range(frames or self.k)])

    def run(self) -> torch.Tensor:
        return self.graphed.run()


def init_rep_hist(lm, window: int, device=None):
    """A fresh repetition-penalty history for a streaming chunk's carry:
    (a -1-filled ring [n_cb, window] int32, slot pointer [1] int64 0) for
    window > 0, or a seen-mask [n_cb, max vocab] bool for window <= 0."""
    n_cb = int(lm.info.n_codebook)
    device = device or lm.device
    if window > 0:
        return (torch.full((n_cb, int(window)), -1, dtype=torch.int32,
                           device=device),
                torch.zeros((1,), dtype=torch.long, device=device))
    return torch.zeros((n_cb, max(lm.info.codebook_sizes)), dtype=torch.bool,
                       device=device)


def _hist_leaves(hist) -> tuple:
    """A repetition history's tensors (the ring and its pointer, or the
    seen mask)."""
    return tuple(hist) if isinstance(hist, tuple) else (hist,)


def build_stream_chunk(lm, bb_cfg, chain: Tuple[float, int, float, float],
                       rep: Tuple[float, int], n_frames: int) -> Callable:
    """K frames of the realtime streaming interleave in one device call
    (codec_tpu/lm/fused_gen.py::build_stream_chunk; host loop
    lm/tts_runner.run_realtime_streaming). Per frame: the repetition-
    penalized frame (`lm._build_frame(chain, rep=rep)`, its history carried
    from frame to frame) → the EOS gate → the backbone input
    tok_embd[text_sched[i]] + compose(codes), the text side of the
    interleave scheduled by the host → one backbone step.

    chunk(step (the backbone's StepGroup), kvs (its caches, each [1, L, 2,
    n_kv, >= ctx, D]), pos [1], base_frame [1], h [1, hidden] f32, noise
    [K, 1, n_cb, W] f32, hist, text_sched [K] int64, ctx) → (packed int32
    [K·n_cb + 3], h', pos', hist'); kvs are written in place. packed =
    codes.flatten() ++ [n_emitted, stopped, pos_after], codec_tpu's
    layout. The EOS frame's codes enter the
    history, as codec_tpu's loop keeps its frame's history; after it the
    hidden, the position and the history are held, the code rows are
    zeros, and the held steps write the backbone cache slot at the held
    position, which nothing reads (the run ends there)."""
    frame = lm._build_frame(chain, rep=rep)
    compose = lm.compose_embd_fn()
    info = lm.info
    eos_code, eos_min = int(info.eos_code_c0), int(info.eos_min_step)
    k_frames = int(n_frames)

    def chunk(step, kvs, pos, base_frame, h, noise, hist, text_sched,
              ctx: int):
        tok_embd = step.params["tok_embd"]
        text_ctx = torch.zeros_like(pos)
        done = torch.zeros_like(pos, dtype=torch.bool)
        rows, live = [], []
        for i in range(k_frames):
            codes, new_hist = frame(h, noise[i], text_ctx, hist)
            if eos_code >= 0:
                is_eos = (codes[:, 0] == eos_code) & (base_frame + i >= eos_min)
            else:
                is_eos = torch.zeros_like(done)
            # a [1] index: a 0-d one would be read on the host
            emb = (tok_embd[text_sched[i:i + 1]].float()
                   + compose(codes)).to(step.dtype)
            h2 = step(kvs, pos, emb, ctx)
            live.append(~done)
            rows.append(torch.where(done[:, None], 0, codes))
            hist = (tuple(torch.where(done, a, b) for a, b in
                          zip(hist, new_hist)) if isinstance(hist, tuple)
                    else torch.where(done, hist, new_hist))
            done = done | is_eos
            h = torch.where(done[:, None], h, h2.float())
            pos = torch.where(done, pos, pos + 1)
        meta = torch.stack([torch.stack(live).sum(), done[0].long(), pos[0]])
        packed = torch.cat([torch.stack(rows).reshape(-1), meta])
        return packed.to(torch.int32), h, pos, hist

    return chunk


class StreamRunner:
    """The realtime-streaming chunk's static buffers and its graph (one
    stream, K frames, `ctx` attended cache rows): the hidden `h` [1,
    hidden] and position `pos` [1], written once a request; the frame
    counter `base` [1], the text schedule `text_sched` [K] int64 and the
    Gumbel `noise` [K, 1, n_cb, W], written before each replay; the
    repetition history `hist` (init_rep_hist's form, reset by
    `reset_hist`). `run()` advances h, pos and hist in place and returns
    the packed result; `kv` is the backbone's cache."""

    def __init__(self, lm, backbone, chain, rep, n_frames: int, ctx: int):
        group = step_group(backbone, "a stream chunk")
        cfg, dev = backbone.cfg, group.device
        lm = lm.on_device(dev)
        self.k = int(n_frames)
        self.n_cb = lm.info.n_codebook
        self.width = lm.noise_width()
        self.h = torch.zeros((1, cfg.hidden), dtype=torch.float32, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.long, device=dev)
        self.base = torch.zeros((1,), dtype=torch.long, device=dev)
        self.text_sched = torch.zeros((self.k,), dtype=torch.long, device=dev)
        self.noise = torch.zeros((self.k, 1, self.n_cb, self.width),
                                 dtype=torch.float32, device=dev)
        self.hist = init_rep_hist(lm, int(rep[1]), dev)
        self._fresh = tuple(t.clone() for t in _hist_leaves(self.hist))
        self.kvs = group.own_kv()
        self.kv = self.kvs[0]
        chunk = build_stream_chunk(lm, cfg, chain, rep, self.k)

        def step():
            packed, h, pos, hist = chunk(group, self.kvs, self.pos, self.base,
                                         self.h, self.noise, self.hist,
                                         self.text_sched, ctx)
            self.h.copy_(h)
            self.pos.copy_(pos)
            for buf, t in zip(_hist_leaves(self.hist), _hist_leaves(hist)):
                buf.copy_(t)
            return packed

        self.graphed = Graphed(step, torch.device(dev), restore=(
            self.h, self.pos, *_hist_leaves(self.hist),
            *(k[..., :ctx, :] for k in self.kvs)))

    def reset_hist(self) -> None:
        """An empty repetition history (a request's start)."""
        for buf, t in zip(_hist_leaves(self.hist), self._fresh):
            buf.copy_(t)

    def draw_noise(self, gen, frames: int = 0) -> None:
        """Fresh Gumbel noise from `gen`, one [n_cb, W] draw a frame on the
        generator's device, copied in (the first `frames` frames only,
        default K)."""
        n = frames or self.k
        self.noise[:n, 0] = torch.stack(
            [gumbel((self.n_cb, self.width), gen, gen.device)
             for _ in range(n)])

    def run(self) -> torch.Tensor:
        return self.graphed.run()


def chunk_ctx(backbone, need: int) -> int:
    """The cache rows a chunk attends: `need` rounded up to a multiple of
    64 (so requests of similar lengths share a capture), at most max_ctx."""
    return min(int(backbone.cfg.max_ctx), -(-int(need) // _CTX_STEP) * _CTX_STEP)


def _kv_key(backbone):
    """The address of a backbone's own cache (every share's on a mesh)."""
    if getattr(backbone, "kv", None) is not None:
        return backbone.kv.data_ptr()
    return tuple(k.data_ptr() for k in backbone.kvs)


def gen_chunk_cached(lm, backbone, *, n_frames: int, ctx: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, min_p: float = 0.0,
                     cb0_range=None, stream: bool = False,
                     rep: Optional[Tuple[float, int]] = None):
    """The single-stream ChunkRunner of this (sampler chain, K,
    cb0_range, ctx, LM) on this backbone, or with `stream` the
    StreamRunner of this (chain, rep = (penalty, window), default (1.0,
    0), K, ctx, LM): built once and kept on the backbone (its graph holds
    the backbone's weights and KV cache). The key also holds the KV
    cache's address and the TF32 settings the graph was captured under.
    The backbone keeps the _KEEP runners used last (a new sampler chain or
    length bucket past them drops the oldest, its graph with it);
    `reset()` keeps them, so the next request of the same shape replays
    without a capture. A batch of streams: gen_batch_cached."""
    if stream and cb0_range is not None:
        raise ValueError("the stream chunk is one stream with no cb0 range")
    chain = (float(temperature), int(top_k), float(top_p), float(min_p))
    rep = (float(rep[0]), int(rep[1])) if rep is not None else (1.0, 0)
    key = (id(lm), chain, int(n_frames), cb0_range, int(ctx), stream,
           rep if stream else None, _kv_key(backbone), *_settings(backbone))
    if stream:
        def make():
            return StreamRunner(lm, backbone, chain, rep, int(n_frames),
                                int(ctx))
    else:
        def make():
            return ChunkRunner(lm, backbone, chain, int(n_frames), cb0_range,
                               False, 1, int(ctx))
    # the LM rides along so that id(lm) is not reused while the entry lives
    return _kept(backbone, "_gen_chunks", key, lambda: (lm, make()))[1]


def _settings(backbone) -> tuple:
    """The rest of a runner's key: the backbone's config and the TF32
    settings its graph is captured under."""
    return (repr(backbone.cfg), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class DpChunks:
    """A batched chunk over B streams built as one runner a data-parallel
    share (dp_groups: `rows` of the streams each; one runner of all B
    without a mesh), behind one runner's interface over the B streams:
    `put(name, values)` writes values[s] into stream s's row of buffer
    `name` in the share holding it, `draw_noise(gens)` takes a generator a
    stream, `kv(s)` gives stream s's caches, and `run()` replays every
    share before it reads any and returns the unsharded chunk's packed
    result. `width`: a frame's codes a stream (n_cb; 1 for Chatterbox)."""

    def __init__(self, groups, make: Callable, width: int):
        self.rows = [rows for rows, _, _ in groups]
        self.runners = [make(rows.stop - rows.start, row, dev)
                        for rows, row, dev in groups]
        self.runner = self.runners[0]
        self.width = int(width)

    def at(self, s: int):
        """(the runner holding stream s, its index there)."""
        for rows, r in zip(self.rows, self.runners):
            if rows.start <= s < rows.stop:
                return r, s - rows.start
        raise IndexError(s)

    def kv(self, s: int) -> list:
        """Stream s's caches, one a backbone share (views)."""
        r, j = self.at(s)
        return [k[j] for k in r.kvs]

    def put(self, name: str, values) -> None:
        values = np.asarray(values)
        for rows, r in zip(self.rows, self.runners):
            getattr(r, name).copy_(torch.as_tensor(values[rows]))

    def draw_noise(self, gens, **kw) -> None:
        """gens[s] (None: no draw) draws stream s's noise in its share."""
        for rows, r in zip(self.rows, self.runners):
            r.draw_noise(list(gens[rows]), **kw)

    def run(self) -> np.ndarray:
        """The packed result, codes [K, B, width] ++ [n_iter] ++ one [B]
        vector a per-stream output (done, pos, ...), as one chunk over the
        B streams gives it: the shares' codes and vectors joined in stream
        order, n_iter the largest share's."""
        outs = [r.run() for r in self.runners]
        arrs = [o.cpu().numpy() for o in outs]
        if len(arrs) == 1:
            return arrs[0]
        k = self.runner.k
        codes, n_iter, vecs = [], 0, []
        for a, rows in zip(arrs, self.rows):
            b = rows.stop - rows.start
            n = k * b * self.width
            codes.append(a[:n].reshape(k, b, self.width))
            n_iter = max(n_iter, int(a[n]))
            vecs.append(a[n + 1:].reshape(-1, b))
        return np.concatenate([np.concatenate(codes, axis=1).reshape(-1),
                               np.asarray([n_iter], arrs[0].dtype),
                               np.concatenate(vecs, axis=1).reshape(-1)])


def _dp_cached(backbone, key, mesh, b: int, dp_axis: str, what: str,
               make: Callable, width: int, rides) -> DpChunks:
    """The DpChunks of b streams over mesh[dp_axis] under `key`, kept on
    the backbone (`_batch_chunks`: the _KEEP used last, each with every
    share's runner); `rides` (the LM, T3) and the mesh stay with the
    entry, so their ids in the key are not reused while it lives."""
    groups = dp_groups(backbone, mesh, int(b), dp_axis, what)
    full = (key, int(b), id(mesh), dp_axis, *_settings(backbone))
    return _kept(backbone, "_batch_chunks", full, lambda: (
        rides, mesh, DpChunks(groups, make, width)))[2]


def gen_batch_cached(lm, backbone, *, b: int, n_frames: int, ctx: int,
                     chain: Optional[Tuple[float, int, float, float]] = None,
                     cb0_range=None, mesh=None,
                     dp_axis: str = "dp") -> DpChunks:
    """The batched ChunkRunners of b streams (this chain, or with None
    the chain as data; K, cb0_range, ctx, LM), one a share of
    mesh[dp_axis] (dp_groups), as a DpChunks kept on the backbone."""
    key = ("gen", id(lm), chain, int(n_frames), cb0_range, int(ctx))

    def make(n, row, dev):
        return ChunkRunner(lm, backbone, chain, int(n_frames), cb0_range,
                           True, n, int(ctx), row, dev)
    return _dp_cached(backbone, key, mesh, b, dp_axis, "batched generation",
                      make, lm.info.n_codebook, lm)


class FrameRunner:
    """The per-frame path's frame over static buffers, for a backbone the
    chunk cannot run (the host's Backbone protocol alone: its step stays
    on the host), captured as a CUDA graph on the card: `h` [1, hidden],
    `noise` [1, n_cb, W], `text_ctx` [1] in; `run()` → codes [1, n_cb]."""

    def __init__(self, lm, chain, cb0_range):
        dev = lm.device
        info = lm.info
        self.h = torch.zeros((1, info.hidden_dim), dtype=torch.float32,
                             device=dev)
        self.noise = torch.zeros((1, info.n_codebook, lm.noise_width()),
                                 dtype=torch.float32, device=dev)
        self.text_ctx = torch.zeros((1,), dtype=torch.long, device=dev)
        frame = lm._build_frame(chain, cb0_range=cb0_range)
        self.graphed = Graphed(lambda: frame(self.h, self.noise,
                                             self.text_ctx), dev)

    def draw_noise(self, gen) -> None:
        self.noise[0] = gumbel(self.noise.shape[1:], gen, self.noise.device)

    def run(self) -> torch.Tensor:
        return self.graphed.run()


def frame_cached(lm, *, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 cb0_range=None) -> FrameRunner:
    """The FrameRunner of this chain and cb0_range, kept on the LM (the
    _KEEP used last)."""
    chain = (float(temperature), int(top_k), float(top_p), float(min_p))
    key = (chain, cb0_range, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    return _kept(lm, "_frame_runners", key,
                 lambda: FrameRunner(lm, chain, cb0_range))


def supports_gen_chunk(lm: Any, backbone: Any) -> bool:
    """The chunked loop needs a frame and a compose on the LM kind (and
    its `gen_chunk_ok()`, false where the feedback depends on the step)
    and a backbone whose weights, KV cache and config it can run itself
    (the tts_runner Backbone protocol alone, an opaque host LLM, cannot be
    chained on the device). A pipeline-staged backbone (set_mesh_pp)
    stands down, as codec_tpu's does: it generates through the host
    per-frame loop, whose prefill and step run the pipeline. A TP or EP
    backbone runs the chunk over its shares (backbone_step_split)."""
    return (hasattr(lm, "_build_frame") and hasattr(lm, "compose_embd_fn")
            and getattr(lm, "gen_chunk_ok", lambda: True)()
            and hasattr(backbone, "params") and hasattr(backbone, "cfg")
            and (hasattr(backbone, "kv") or hasattr(backbone, "kvs"))
            and getattr(backbone, "mesh_kind", None) != "pp")


def dp_groups(backbone: Any, mesh, b: int, dp_axis: str = "dp",
              what: str = "batched generation", unit: str = "streams"):
    """The data-parallel shares of b streams (or slots) over mesh[dp_axis]
    (parallel/mesh.py::dp_share; ValueError where b is not a multiple of
    the axis size) as [(their rows, StepGroup row, device)]: an unsharded
    backbone replicated on each share's device, or a TP/EP backbone's own
    row for each share (its set_mesh mesh must be this one: a 2-D dp x tp
    mesh). mesh None: one share of every stream on the backbone's own
    group."""
    from ..parallel.mesh import dp_share

    if mesh is None:
        return [(slice(0, b), 0, None)]
    n = int(mesh.shape[dp_axis])
    dp_share(mesh, b, 0, dp_axis, what, unit)
    kind = getattr(backbone, "mesh_kind", None)
    if kind is not None and getattr(backbone, "mesh", None) is not mesh:
        raise ValueError(f"{what} DP over a --{kind} backbone: shard the "
                         f"backbone over the same 2-D mesh "
                         f"(set_mesh(mesh, axis='tp'))")
    per = b // n
    out = []
    for j in range(n):
        _, devs = dp_share(mesh, b, j * per, dp_axis, what, unit)
        rows = slice(j * per, (j + 1) * per)
        out.append((rows, j, None) if kind else (rows, 0, devs[0]))
    return out


def refuse_pp(backbone: Any, what: str) -> None:
    """CodecError for a pipeline-staged backbone, which `what` (a chunk or
    a batched run) cannot step."""
    if getattr(backbone, "mesh_kind", None) == "pp":
        raise CodecError(f"{what} over a --pp backbone is not ported: a "
                         f"pipeline-staged backbone generates through the "
                         f"host per-frame loop")


def step_group(backbone: Any, what: str, row: int = 0,
               device=None) -> StepGroup:
    """The StepGroup `what` (a chunk or a batched run) steps the backbone
    on: `row` of a TP or EP backbone's shares, or an unsharded backbone
    on `device` (its own by default). CodecError for a --pp backbone,
    which codec_tpu too runs only through the host per-frame loop, and
    for a group whose shares sit on more than one card: a graph captured
    across cards would join each other card's stream to the capture
    through events, which is not built (name one card per group, as
    devices=["cuda:0"] * n does, or run the host path)."""
    refuse_pp(backbone, what)
    group = StepGroup(backbone, row, device)
    cards = {physical(d) for d in group.devices}
    if len(cards) > 1:
        raise CodecError(f"{what} over a backbone whose shares sit on "
                         f"{len(cards)} cards ({sorted(map(str, cards))}): a "
                         f"CUDA graph across cards is not built; name one "
                         f"card per share group or run the host path (no "
                         f"--on-device)")
    return group


# -- the continuous-latent chunk (BlueMagpie / VoxCPM) -------------------------

def build_continuous_chunk(lm, bb_cfg, n_steps: int, sched, cfg_value: float) -> Callable:
    """K steps of the continuous-latent (CFM) flow in one device call
    (codec_tpu/lm/fused_gen.py::build_continuous_chunk): per step one CFM
    step (`lm._generate` at primed=False: 9 Euler steps × 2 LocDiT passes
    + the RALM KV step + the feedbacks) → the stop gate (the stop head's
    argmax, taken only once patch_index > min_len, as step_generate's host
    gate) → one backbone step on the fb_tslm feedback.

    chunk(step (the backbone's StepGroup), bb_kvs (its caches, each [1, L,
    2, n_kv, >= ctx, D]), pos [1], h [1, hidden], kv (the RALM cache),
    kv_pos [1], patch_index [1], min_len [1], prev_patch [P, D],
    prev_fb_lm [h_vox], noise [K, P, D], ctx) → (packed f32 [K·P·D +
    h_barbet + 3], h', pos', kv_pos', patch_index', prev_patch',
    prev_fb_lm'); bb_kvs and kv are written in place. packed =
    patches.flatten() ++ the last step's fb_tslm ++ [n_emitted, stopped,
    pos_after], codec_tpu's layout.

    codec_tpu's loop leaves at the stop; a graph runs all K steps, so the
    stop is data: once stopped, the hidden, the positions, patch_index and
    the carried patch and feedback are held (`torch.where`), the later
    steps' patch rows are zeros and their cache writes land at the held
    slots (the run ends there)."""
    k_steps = int(n_steps)
    max_slot = int(lm.max_T) - 1

    def chunk(step, bb_kvs, pos, h, kv, kv_pos, patch_index, min_len,
              prev_patch, prev_fb_lm, noise, ctx: int):
        done = torch.zeros_like(pos, dtype=torch.bool)
        fb_last = None
        rows, live = [], []
        for i in range(k_steps):
            patch, fb_lm, packed = lm._generate(
                kv, kv_pos.clamp(max=max_slot), h[0], prev_fb_lm, prev_patch,
                noise[i], sched, cfg_value)
            pd = patch.numel()
            stop_lg, fb_tslm = packed[pd:pd + 2], packed[pd + 2:]
            stop = (stop_lg[1] > stop_lg[0]) & (patch_index > min_len)
            live.append(~done)
            rows.append(torch.where(done, 0.0, patch.reshape(-1)))
            fb_last = fb_tslm if fb_last is None else torch.where(
                done, fb_last, fb_tslm)
            prev_patch = torch.where(done, prev_patch, patch)
            prev_fb_lm = torch.where(done, prev_fb_lm, fb_lm)
            kv_pos = torch.where(done, kv_pos, kv_pos + 1)
            patch_index = torch.where(done, patch_index, patch_index + 1)
            done = done | stop
            h2 = step(bb_kvs, pos, fb_tslm[None].to(step.dtype), ctx)
            h = torch.where(done[:, None], h, h2.float())
            pos = torch.where(done, pos, pos + 1)
        meta = torch.stack([torch.stack(live).sum(), done[0].long(),
                            pos[0]]).float()
        packed = torch.cat([torch.stack(rows).reshape(-1), fb_last, meta])
        return packed, h, pos, kv_pos, patch_index, prev_patch, prev_fb_lm

    return chunk


class ContinuousRunner:
    """The continuous chunk's static buffers and its graph: the backbone
    hidden `h` [1, hidden] and position `pos` [1], the CFM state (the RALM
    cache `kv`, `kv_pos`, `patch_index`, `min_len`, `prev_patch`,
    `prev_fb_lm`) and the host-drawn `noise` [K, P, D]. `load` copies a
    state's kind_state in, `store` copies it back; `run()` advances the
    buffers in place and returns the packed result."""

    def __init__(self, lm, backbone, n_steps: int, n_timesteps: int,
                 cfg_value: float, ctx: int):
        group = step_group(backbone, "a continuous chunk")
        dev = group.device
        lm = lm.on_device(dev)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.k = int(n_steps)
        self.h = zeros(1, backbone.cfg.hidden)
        self.pos = zeros(1, dtype=torch.long)
        self.kv = zeros(lm.n_ralm, 2, lm.n_kv, lm.max_T, lm.head_dim)
        self.kv_pos = zeros(1, dtype=torch.long)
        self.patch_index = zeros(1, dtype=torch.long)
        self.min_len = zeros(1, dtype=torch.long)
        self.prev_patch = zeros(lm.patch_size, lm.latent_dim)
        self.prev_fb_lm = zeros(lm.h_vox)
        self.noise = zeros(self.k, lm.patch_size, lm.latent_dim)
        chunk = build_continuous_chunk(lm, backbone.cfg, self.k,
                                       lm.schedule(int(n_timesteps)),
                                       float(cfg_value))
        bb_kvs = group.own_kv()
        state = (self.pos, self.kv_pos, self.patch_index, self.prev_patch,
                 self.prev_fb_lm)

        def step():
            packed, h, *rest = chunk(group, bb_kvs, self.pos, self.h, self.kv,
                                     self.kv_pos, self.patch_index,
                                     self.min_len, self.prev_patch,
                                     self.prev_fb_lm, self.noise, ctx)
            self.h.copy_(h)
            for buf, new in zip(state, rest):
                buf.copy_(new)
            return packed

        self.graphed = Graphed(step, torch.device(dev), restore=(
            self.h, *state, self.kv, *(k[..., :ctx, :] for k in bb_kvs)))

    def load(self, ks, h, pos: int, min_len: int) -> None:
        """A CFM state (kind_state) after its first step, the backbone
        hidden that the next step reads, the backbone's position."""
        self.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
        self.pos.fill_(int(pos))
        self.kv.copy_(ks["kv"])
        self.kv_pos.fill_(int(ks["kv_pos"]))
        self.patch_index.fill_(int(ks["patch_index"]))
        self.min_len.fill_(int(min_len))
        self.prev_patch.copy_(ks["prev_patch"])
        self.prev_fb_lm.copy_(ks["prev_fb_lm"])

    def store(self, ks) -> None:
        """The device half of the CFM state back into a kind_state."""
        ks["kv"].copy_(self.kv)
        ks["prev_patch"] = self.prev_patch.clone()
        ks["prev_fb_lm"] = self.prev_fb_lm.clone()

    def run(self) -> torch.Tensor:
        return self.graphed.run()


def continuous_chunk_cached(lm, backbone, *, n_steps: int, n_timesteps: int,
                            cfg_value: float, ctx: int) -> ContinuousRunner:
    """The ContinuousRunner of this (K, Euler steps, CFG value, ctx, LM) on
    this backbone, built once and kept on the backbone (the _KEEP used
    last; its graph holds the backbone's weights and KV cache, whose
    address is in the key with the TF32 settings)."""
    key = (id(lm), int(n_steps), int(n_timesteps), float(cfg_value), int(ctx),
           _kv_key(backbone), *_settings(backbone))
    return _kept(backbone, "_cont_chunks", key, lambda: (lm, ContinuousRunner(
        lm, backbone, n_steps, n_timesteps, cfg_value, ctx)))[1]


# -- the Chatterbox T3 chunk -----------------------------------------------------

def build_chatterbox_chunk(bb_cfg, chain: Tuple[float, int, float, float],
                           rep_pen: float, n_frames: int, *, n_seq: int,
                           cfg_weight: float, stop_token: int, n_pos: int) -> Callable:
    """K frames of the Chatterbox T3 CFG loop in one device call
    (codec_tpu/lm/fused_gen.py::build_chatterbox_chunk; host loop
    lm/tts_runner.run_chatterbox). Per frame: the speech head on both
    lanes' hiddens → cond + w·(cond − uncond) → the T3 sampler chain
    (repetition penalty over the unbounded history, a [V] seen mask, then
    temperature → top_k → min_p → top_p with host-drawn Gumbel noise;
    greedy argmax at temperature <= 0) → the stop on `stop_token` → the
    speech embedding of the code plus the position row step + 1 (none
    past the table, as codec_tpu clips it) → one backbone step of the
    lanes as a batch of `n_seq` (the products at m = n_seq).

    chunk(bstep (the backbone's StepGroup), head [V, hidden], speech_emb [V,
    hidden], pos_emb [P, hidden], kvs (its caches, each [S, L, 2, n_kv, >=
    ctx, D]), pos [S], step [1], h [S, hidden] f32, noise [K, V], seen
    [V] bool, ctx) → (packed int32 [K + 4], h', pos', step', seen'); kvs
    are written in place. packed = codes ++
    [n_emitted, stopped, pos_after, step_after]: rows past the stop are
    zeros, and after it the hiddens, positions, step and seen mask are
    held (the stop is data, as in the codebook chunks)."""
    from ..ops.sample import apply_repetition_penalty, sample_logits

    k_frames, cfg_w, stop = int(n_frames), float(cfg_weight), int(stop_token)
    greedy = chain[0] <= 0.0
    use_pen = (not greedy) and rep_pen != 1.0

    def chunk(bstep, head, speech_emb, pos_emb, kvs, pos, step, h, noise,
              seen, ctx: int):
        done = torch.zeros_like(step, dtype=torch.bool)
        codes, live = [], []
        idx = torch.arange(seen.shape[0], device=seen.device)
        for i in range(k_frames):
            lg = F.linear(h, head)                               # [S, V]
            # [1, V]: the code stays a [1] tensor (a 0-d index would be
            # read on the host)
            logits = (lg[:1] + cfg_w * (lg[:1] - lg[1:]) if n_seq == 2
                      else lg[:1])
            if greedy:
                code = torch.argmax(logits, dim=-1)
            else:
                pl = apply_repetition_penalty(logits, seen, rep_pen) \
                    if use_pen else logits
                code = sample_logits(pl, noise[i:i + 1],
                                     temperature=chain[0], top_k=chain[1],
                                     top_p=chain[2], min_p=chain[3])
            live.append(~done)
            codes.append(torch.where(done, 0, code))
            seen = seen | ((idx == code) & ~done)
            done = done | (code == stop)
            nxt = step + 1
            emb = speech_emb[code] + torch.where(
                nxt[:, None] < n_pos, pos_emb[nxt.clamp(0, n_pos - 1)], 0.0)
            h2 = bstep(kvs, pos, emb.expand(n_seq, -1).to(bstep.dtype), ctx)
            h = torch.where(done, h, h2.float())
            pos = torch.where(done, pos, pos + 1)
            step = torch.where(done, step, nxt)
        meta = torch.stack([torch.stack(live).sum(), done[0].long(), pos[0],
                            step[0]])
        packed = torch.cat([torch.stack(codes).reshape(-1), meta])
        return packed.to(torch.int32), h, pos, step, seen

    return chunk


def build_chatterbox_chunk_batched(bb_cfg, n_frames: int, *, n_seq: int,
                                   cfg_weight: float, stop_token: int,
                                   n_pos: int, rep_pen: float = 1.2) -> Callable:
    """B Chatterbox generations, each with its S CFG lanes, in one device
    call (codec_tpu/lm/fused_gen.py::build_chatterbox_chunk_batched): the
    single-stream chunk's frame per stream, the B·S lanes through one
    backbone step as one batch of rows (the products at m = B·S). The
    sampler chain is data, one row a stream (`chains` [B, 4],
    `sample_logits_dyn`); the repetition penalty is a build-time constant
    (T3's preset), applied to a stream only where its temperature is > 0,
    as the host SamplerChain does.

    chunk(bstep (the backbone's StepGroup), head [V, hidden], speech_emb,
    pos_emb, kvs (its caches, each [B, S, L, 2, n_kv, >= ctx, D]), pos
    [B], step [B], h [B, S, hidden] f32, noise [K, B, V], seen [B, V]
    bool, done0 [B] bool, chains [B, 4], ctx) → (packed int32 [K·B + 1 +
    3B], h', pos', step', seen'); kvs are written in place.
    packed = codes[K, B].flatten() ++ [n_iter] ++ done[B] ++ pos[B] ++
    step[B], codec_tpu's layout. A stream in `done0`, or one that stopped,
    keeps its hiddens, position, step and seen mask, and its code rows are
    zeros; its lanes still run the step, writing the cache row at the held
    position, which its next real step overwrites."""
    from ..ops.sample import apply_repetition_penalty, sample_logits_dyn

    k_frames, cfg_w, stop = int(n_frames), float(cfg_weight), int(stop_token)
    rep_pen = float(rep_pen)

    def chunk(bstep, head, speech_emb, pos_emb, kvs, pos, step, h, noise,
              seen, done0, chains, ctx: int):
        b, hidden = h.shape[0], h.shape[-1]
        rows_kv = [kv.flatten(0, 1) for kv in kvs]   # [B·S, L, ...], views
        idx = torch.arange(seen.shape[-1], device=seen.device)
        pen_on = chains[:, 0:1] > 0.0
        done = done0
        codes, live = [], []
        for i in range(k_frames):
            lg = F.linear(h.reshape(b * n_seq, hidden), head).reshape(
                b, n_seq, -1)                                   # [B, S, V]
            logits = (lg[:, 0] + cfg_w * (lg[:, 0] - lg[:, 1]) if n_seq == 2
                      else lg[:, 0])
            if rep_pen != 1.0:
                logits = torch.where(pen_on, apply_repetition_penalty(
                    logits, seen, rep_pen), logits)
            code = sample_logits_dyn(logits, noise[i], chains)  # [B]
            live.append(~done)
            codes.append(torch.where(done, 0, code))
            seen = seen | ((idx == code[:, None]) & ~done[:, None])
            done = done | (code == stop)
            nxt = step + 1
            emb = speech_emb[code] + torch.where(
                (nxt < n_pos)[:, None], pos_emb[nxt.clamp(0, n_pos - 1)], 0.0)
            h2 = bstep(rows_kv, pos.repeat_interleave(n_seq),
                       emb.repeat_interleave(n_seq, dim=0).to(bstep.dtype),
                       ctx)
            h = torch.where(done[:, None, None], h,
                            h2.float().reshape(b, n_seq, hidden))
            pos = torch.where(done, pos, pos + 1)
            step = torch.where(done, step, nxt)
        n_iter = torch.stack(live).any(dim=1).sum()[None]
        packed = torch.cat([torch.stack(codes).reshape(-1), n_iter,
                            done.long(), pos, step])
        return packed.to(torch.int32), h, pos, step, seen

    return chunk


class ChatterboxRunner:
    """The Chatterbox chunk's static buffers and its graph: both lanes' KV
    caches as [S, L, 2, n_kv, ctx, D] tensors (`kvs`, one a backbone
    share, owned here; the host copies each lane's prefill in; `kv` the
    first), their hiddens `h` [S, hidden] and position `pos` [S], the
    frame index `step` [1], the sampler's `seen` mask [V] and the
    host-drawn Gumbel `noise` [K, V]. `run()` advances them in place and
    returns the packed result.

    With `b` > 0, the B-stream form (build_chatterbox_chunk_batched): each
    of `kvs` [B, S, L, 2, n_kv, ctx, D], `h` [B, S, hidden], `pos` and
    `step` [B], `seen` [B, V], `noise` [K, B, V], and the host's `done` [B]
    and `chains` [B, 4]; `chain` is then unused. `row` / `device`: the
    backbone's StepGroup (a data-parallel share's), where the LM's head
    and T3's tables are read too (their copies on that card)."""

    def __init__(self, lm, t3, backbone, chain, rep_pen: float,
                 n_frames: int, n_seq: int, cfg_weight: float, ctx: int,
                 b: int = 0, row: int = 0, device=None):
        group = step_group(backbone, "a Chatterbox chunk", row, device)
        cfg, dev = backbone.cfg, group.device
        head = lm.on_device(dev).heads[0]
        speech_emb, pos_emb = t3.speech_tables(physical(dev))
        stop_token = t3.info.stop_speech_token

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.device = dev
        self.k, self.vocab, self.b = int(n_frames), int(head.shape[0]), int(b)
        lead = (self.b, n_seq) if b else (n_seq,)
        self.kvs = group.new_kv(lead, ctx)
        self.kv = self.kvs[0]
        self.h = zeros(*lead, cfg.hidden)
        self.pos = zeros(b or n_seq, dtype=torch.long)
        self.step = zeros(b or 1, dtype=torch.long)
        self.seen = zeros(*((b,) if b else ()), self.vocab, dtype=torch.bool)
        self.noise = zeros(self.k, *((b,) if b else ()), self.vocab)
        n_pos = int(pos_emb.shape[0])
        state = (self.h, self.pos, self.step, self.seen)
        if b:
            self.done = zeros(b, dtype=torch.bool)
            self.chains = zeros(b, 4)
            chunk = build_chatterbox_chunk_batched(
                cfg, self.k, n_seq=n_seq, cfg_weight=cfg_weight,
                stop_token=stop_token, n_pos=n_pos, rep_pen=rep_pen)
            extra = (self.done, self.chains)
        else:
            chunk = build_chatterbox_chunk(
                cfg, chain, rep_pen, self.k, n_seq=n_seq,
                cfg_weight=cfg_weight, stop_token=stop_token, n_pos=n_pos)
            extra = ()

        def run():
            packed, *new = chunk(group, head, speech_emb, pos_emb, self.kvs,
                                 self.pos, self.step, self.h, self.noise,
                                 self.seen, *extra, ctx)
            for buf, t in zip(state, new):
                buf.copy_(t)
            return packed

        self.graphed = Graphed(run, torch.device(dev),
                               restore=(*state, *self.kvs))

    def draw_noise(self, gen) -> None:
        """Fresh Gumbel noise for the K frames, one [K, V] draw from `gen`;
        in the B-stream form `gen` is one generator a stream (or None:
        that stream draws nothing), each drawing what its single-stream
        chunk draws."""
        if not self.b:
            self.noise.copy_(gumbel((self.k, self.vocab), gen,
                                    self.noise.device))
            return
        for s, g in enumerate(gen):
            if g is not None:
                self.noise[:, s] = gumbel((self.k, self.vocab), g, g.device)

    def run(self) -> torch.Tensor:
        return self.graphed.run()


def chatterbox_chunk_cached(lm, t3, backbone, *, chain, rep_pen: float,
                            n_frames: int, n_seq: int, cfg_weight: float,
                            ctx: int) -> ChatterboxRunner:
    """The single-stream ChatterboxRunner of this (sampler chain, penalty,
    K, lanes, CFG weight, ctx, T3) on this backbone (whose weights both
    lanes share), kept on the backbone (the _KEEP used last)."""
    key = (id(lm), id(t3), tuple(chain), float(rep_pen), int(n_frames),
           int(n_seq), float(cfg_weight), int(ctx), *_settings(backbone))
    return _kept(backbone, "_cbx_chunks", key, lambda: (
        lm, t3, ChatterboxRunner(lm, t3, backbone, chain, rep_pen, n_frames,
                                 n_seq, cfg_weight, ctx)))[2]


def chatterbox_batch_cached(lm, t3, backbone, *, b: int, rep_pen: float,
                            n_frames: int, n_seq: int, cfg_weight: float,
                            ctx: int, mesh=None,
                            dp_axis: str = "dp") -> DpChunks:
    """The B-stream ChatterboxRunners of b streams (their chains data),
    one a share of mesh[dp_axis] (dp_groups), as a DpChunks kept on the
    backbone."""
    key = ("cbx", id(lm), id(t3), float(rep_pen), int(n_frames), int(n_seq),
           float(cfg_weight), int(ctx))

    def make(n, row, dev):
        return ChatterboxRunner(lm, t3, backbone, None, rep_pen, n_frames,
                                n_seq, cfg_weight, ctx, b=n, row=row,
                                device=dev)
    return _dp_cached(backbone, key, mesh, b, dp_axis, "batched chatterbox",
                      make, 1, (lm, t3))
