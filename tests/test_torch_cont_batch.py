"""The port's continuous-batching engine (codec_tpu_torch/serve/
cont_batch.py) on the CPU, mirroring tests/test_cont_batch.py.

Contract: every request's codes equal the single-stream chunked run
(`run_codebook_ar(on_device=...)`) with the same seed, whatever slot it
lands in, whenever it is admitted and whatever the other slots do.
Sampled codes are held against the port's own single-stream run (the
port's noise comes from a torch.Generator, codec_tpu's from JAX keys);
greedy codes also against codec_tpu's ContinuousBatcher on the same
files. Codes must be equal outright.

Fixtures are tests/test_torch_fused.py's: a tiny Mimi with a
residual_depth_ar adaptor over a Q8_0 llama backbone of hidden 256
(max_ctx 96, so a step attends 96 cache rows against the single-stream
run's 64), and the same codec file with an EOS code greedy decoding emits
(and a delay-pattern copy of it). On the CPU the chunk runs eagerly; the
captured graph is held on the card by chip_smoke.py phase 9f.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.ops.sample import OnDeviceSampling as JaxSampling
from codec_tpu.serve.cont_batch import ContinuousBatcher as JaxBatcher
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.ops.sample import OnDeviceSampling
from codec_tpu_torch.serve.cont_batch import (ContinuousBatcher,
                                              EngineThread, RequestCancelled)
from test_torch_fused import (PROMPT, PROMPTS, SAMPLED, _engine, _run,  # noqa: F401
                              engines, eos_files, files)

ODS = dict(SAMPLED, chunk_frames=3)
PROMPT_SET = [PROMPT] + PROMPTS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lane(eng):
    """A backbone of the engine's own over the fixture's weights."""
    bb = eng["bb"]
    return LlamaBackbone.from_params(bb.cfg, bb.params, bb.dtype, bb.qmm)


def _batcher(eng, n_slots=2, ods=ODS, **kw):
    return ContinuousBatcher(_lane(eng), eng["lm"], n_slots=n_slots,
                             on_device=OnDeviceSampling(**ods), decode=False,
                             **kw)


def _submit(batcher, eng, ids, seed, max_steps, **kw):
    alm = AudioLM(eng["reader"], codec=eng["codec"], lm=eng["lm"])
    return batcher.submit(alm, list(eng["bb"].embed_tokens(ids)), seed=seed,
                          max_steps=max_steps, **kw)


def _single(eng, ids, seed, max_steps, ods=ODS, bucket=0):
    return _run(eng, dict(ods, seed=seed), max_steps=max_steps, ids=ids,
                bucket=bucket)


def _same(got, want):
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos)


def test_more_requests_than_slots_match_single_streams(engines):
    """4 requests through a 2-slot engine: the first pair drains, the
    second is admitted into the freed slots; all four equal their
    single-stream runs."""
    port, _ = engines
    batcher = _batcher(port)
    handles = [_submit(batcher, port, PROMPT_SET[i], 20 + i, 5)
               for i in range(4)]
    batcher.drain()
    for i, hd in enumerate(handles):
        _same(hd.wait(timeout=0), _single(port, PROMPT_SET[i], 20 + i, 5))


def test_mid_flight_admission_matches(engines):
    """A request admitted while another is mid-generation (their frame
    counters differ) still equals its single-stream run: each slot's
    base, noise generator and cache rows are its own."""
    port, _ = engines
    batcher = _batcher(port)
    h0 = _submit(batcher, port, PROMPT_SET[0], 3, 7)
    assert batcher.step() == 1            # stream 0 has emitted 3 frames
    h1 = _submit(batcher, port, PROMPT_SET[1], 4, 5)
    batcher.drain()
    _same(h0.wait(timeout=0), _single(port, PROMPT_SET[0], 3, 7))
    _same(h1.wait(timeout=0), _single(port, PROMPT_SET[1], 4, 5))


def test_greedy_matches_jax_engine(engines):
    """Greedy: 3 requests through 2 slots equal codec_tpu's
    ContinuousBatcher on the same files, and the single-stream runs."""
    port, ref = engines
    greedy = dict(chunk_frames=3)
    batcher = _batcher(port, ods=greedy)
    jb = JaxBatcher(ref["bb"], ref["lm"], n_slots=2,
                    on_device=JaxSampling(**greedy), decode=False)
    got = [_submit(batcher, port, p, 0, 6) for p in PROMPT_SET[:3]]
    want = [jb.submit(JaxAudioLM(ref["reader"], codec=ref["codec"],
                                 lm=ref["lm"]),
                      list(ref["bb"].embed_tokens(p)), seed=0, max_steps=6)
            for p in PROMPT_SET[:3]]
    batcher.drain()
    jb.drain()
    for p, g, w in zip(PROMPT_SET, got, want):
        _same(g.wait(timeout=0), w.wait(timeout=0))
        _same(g.wait(timeout=0), _single(port, p, 0, 6, ods=greedy))


@pytest.mark.parametrize("name,ods", [("eos", dict(chunk_frames=4)),
                                      ("delay", dict(SAMPLED, chunk_frames=4))])
def test_staggered_eos_slot_reuse(eos_files, name, ods):
    """The EOS file stops streams at their own frames, mid-chunk; retired
    slots are refilled and every request equals its single-stream run
    (greedy: and codec_tpu's engine). The delay-pattern copy, sampled:
    the delay-tail flush continues each slot's generator where its
    single-stream run leaves it."""
    files_, _ = eos_files
    model = files_[name]
    port = _engine(model, model.parent / "bb.gguf", True)
    batcher = _batcher(port, ods=ods)
    prompts = PROMPT_SET + [[7, 7, 8], [90, 91]]
    handles = [_submit(batcher, port, p, 5 + i, 10)
               for i, p in enumerate(prompts)]
    batcher.drain()
    got = [hd.wait(timeout=0) for hd in handles]
    for i, p in enumerate(prompts):
        _same(got[i], _single(port, p, 5 + i, 10, ods=ods))
    assert any(r.stopped_by_eos for r in got)
    assert len({r.n_steps for r in got}) > 1, "no staggered stop"
    if name == "eos":
        ref = _engine(model, model.parent / "bb.gguf", False)
        jb = JaxBatcher(ref["bb"], ref["lm"], n_slots=2,
                        on_device=JaxSampling(**ods), decode=False)
        want = [jb.submit(JaxAudioLM(ref["reader"], lm=ref["lm"]),
                          list(ref["bb"].embed_tokens(p)), max_steps=10)
                for p in prompts]
        jb.drain()
        for g, w in zip(got, want):
            _same(g, w.wait(timeout=0))


def test_engine_thread_concurrent_submissions(engines):
    """EngineThread steps the batcher while requests arrive from several
    threads; every handle resolves to its single-stream result."""
    port, _ = engines
    batcher = _batcher(port)
    eng = EngineThread(batcher)
    eng.start()
    out = {}

    def worker(i):
        out[i] = _submit(batcher, port, PROMPT_SET[i], 30 + i, 4).wait(
            timeout=300)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    eng.stop()
    assert sorted(out) == [0, 1, 2] and not eng.is_alive()
    for i in range(3):
        _same(out[i], _single(port, PROMPT_SET[i], 30 + i, 4))


def test_per_request_sampling_params(engines):
    """Requests with different chains share the engine (the chain is a
    per-slot row of the chunk's input) and each equals the single-stream
    run with that chain (sampled top-k, greedy, top-p, min-p)."""
    port, _ = engines
    batcher = _batcher(port)
    chains = [dict(temperature=0.8, top_k=5), dict(),
              dict(temperature=1.3, top_p=0.7),
              dict(temperature=0.5, min_p=0.2)]
    handles = [_submit(batcher, port, PROMPT_SET[i], 40 + i, 5,
                       sampling=OnDeviceSampling(**chains[i], chunk_frames=3))
               for i in range(4)]
    batcher.drain()
    for i, hd in enumerate(handles):
        _same(hd.wait(timeout=0), _single(port, PROMPT_SET[i], 40 + i, 5,
                                          ods=dict(chains[i], chunk_frames=3)))


def test_bucketed_prefill_admission_matches(engines):
    """prefill_bucket: an admission prefills the whole prompt in one
    bucket-padded forward; codes equal the single-stream run with the
    same bucket (the padded forward is not the per-token loop bit for
    bit, so like is held against like)."""
    port, _ = engines
    batcher = _batcher(port, prefill_bucket=4)
    prompts = [[5, 9, 200], [44, 2, 17, 80, 9], [250, 1, 3, 4, 5, 6, 7]]
    handles = [_submit(batcher, port, p, 60 + i, 5)
               for i, p in enumerate(prompts)]
    batcher.drain()
    for i, hd in enumerate(handles):
        _same(hd.wait(timeout=0), _single(port, prompts[i], 60 + i, 5,
                                          bucket=4))


def test_stale_rows_are_never_read(engines):
    """The chunk attends a slot's ctx rows under the position mask, so the
    rows at or past a slot's position (an earlier request's) are never
    read: poisoning them with large values changes no code."""
    port, _ = engines
    batcher = _batcher(port)
    h = _submit(batcher, port, PROMPT_SET[1], 9, 6)
    batcher._admit()
    pos = int(batcher.runner.pos[0])
    batcher.runner.kv[0, ..., pos:, :] = 1e4
    batcher.drain()
    _same(h.wait(timeout=0), _single(port, PROMPT_SET[1], 9, 6))


def test_cancellation(engines):
    """A queued request cancelled is dropped at the admission scan, an
    active one retired at the next chunk boundary: both raise
    RequestCancelled, and the others, one admitted into the freed slot
    included, equal their single-stream runs."""
    port, _ = engines
    batcher = _batcher(port)
    h0 = _submit(batcher, port, PROMPT_SET[0], 70, 6)
    h1 = _submit(batcher, port, PROMPT_SET[1], 71, 6)
    hq = _submit(batcher, port, PROMPT_SET[2], 72, 6)
    assert hq.cancel() is True
    assert batcher.step() == 2
    assert hq.done
    with pytest.raises(RequestCancelled):
        hq.wait(timeout=0)
    assert h1.cancel() is True
    batcher.step()
    with pytest.raises(RequestCancelled):
        h1.wait(timeout=0)
    h3 = _submit(batcher, port, PROMPT_SET[3], 73, 4)
    batcher.drain()
    _same(h0.wait(timeout=0), _single(port, PROMPT_SET[0], 70, 6))
    _same(h3.wait(timeout=0), _single(port, PROMPT_SET[3], 73, 4))
    assert h0.cancel() is False
    assert batcher.n_active == 0 and batcher.n_queued == 0


def test_submit_validation(engines):
    from codec_tpu_torch.lm import create_lm

    port, _ = engines
    batcher = _batcher(port)
    other = create_lm(port["reader"], device="cpu")
    with pytest.raises(ValueError, match="share the engine CodecLM"):
        batcher.submit(AudioLM(port["reader"], lm=other),
                       list(port["bb"].embed_tokens(PROMPT)))
    with pytest.raises(ValueError, match="prompt embedding"):
        batcher.submit(AudioLM(port["reader"], lm=port["lm"]), [])
    assert batcher.ctx == port["bb"].cfg.max_ctx
    with pytest.raises(TimeoutError):
        _submit(batcher, port, PROMPT, 0, 4).wait(timeout=0.01)


def test_mesh_is_not_ported(engines):
    """mesh= splits the slots over its dp axis (its requests:
    tests/test_torch_parallel_graphs.py); slots that do not divide over
    it, and no slot at all, raise ValueError."""
    from codec_tpu_torch.parallel.mesh import make_mesh

    port, _ = engines
    two = make_mesh(2, devices=["cpu"] * 2)
    assert len(_batcher(port, n_slots=4, mesh=two).chunks.runners) == 2
    with pytest.raises(ValueError, match="3 slots not divisible"):
        _batcher(port, n_slots=3, mesh=two)
    with pytest.raises(ValueError, match="at least one slot"):
        _batcher(port, n_slots=0)


def test_frame_cb_error_fails_only_that_request(engines):
    """A frame callback that raises fails its request and frees its slot;
    the other stream is untouched and the slot admits new work; a working
    callback sees every surviving frame."""
    port, _ = engines
    batcher = _batcher(port)

    def bad_cb(codes):
        raise RuntimeError("consumer broke")
    seen = []
    h_bad = _submit(batcher, port, PROMPT_SET[0], 80, 6, frame_cb=bad_cb)
    h_ok = _submit(batcher, port, PROMPT_SET[1], 81, 6, frame_cb=seen.append)
    batcher.drain()
    with pytest.raises(RuntimeError, match="consumer broke"):
        h_bad.wait(timeout=0)
    got = h_ok.wait(timeout=0)
    _same(got, _single(port, PROMPT_SET[1], 81, 6))
    np.testing.assert_array_equal(np.stack(seen), got.codes)
    h2 = _submit(batcher, port, PROMPT_SET[2], 82, 4)
    batcher.drain()
    _same(h2.wait(timeout=0), _single(port, PROMPT_SET[2], 82, 4))


def test_engine_thread_survives_step_failure(engines):
    """A step() failure resolves every handle in flight with the error
    (fail_all) and the thread goes on serving the next request."""
    port, _ = engines
    batcher = _batcher(port)
    real_step = batcher.step
    armed = threading.Event()
    armed.set()

    def step():
        if armed.is_set() and (batcher.n_active or batcher.n_queued):
            armed.clear()
            raise RuntimeError("injected engine failure")
        return real_step()

    batcher.step = step
    eng = EngineThread(batcher)
    eng.start()
    h0 = _submit(batcher, port, PROMPT_SET[0], 90, 4)
    with pytest.raises(RuntimeError, match="injected engine failure"):
        h0.wait(timeout=300)
    got = _submit(batcher, port, PROMPT_SET[1], 91, 4).wait(timeout=300)
    eng.stop()
    assert not eng.is_alive()
    _same(got, _single(port, PROMPT_SET[1], 91, 4))


def test_decoded_result_matches_single_stream(engines):
    """decode=True: a request's PCM is the single-stream run's decode of
    the same codes, bit for bit (the same codec call)."""
    port, _ = engines
    batcher = ContinuousBatcher(_lane(port), port["lm"], n_slots=2,
                                on_device=OnDeviceSampling(**ODS))
    h = _submit(batcher, port, PROMPT_SET[2], 5, 5)
    batcher.drain()
    got = h.wait(timeout=0)
    want = _single(port, PROMPT_SET[2], 5, 5)
    np.testing.assert_array_equal(got.pcm, want.pcm)
    assert dataclasses.is_dataclass(got)
