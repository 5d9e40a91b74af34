"""The CUDA-graph paths on a device mesh on the CPU: the generation chunks
over a TP or EP backbone's shares (lm/backbone.py::backbone_step_split,
fused_gen.StepGroup), data-parallel streams in run_codebook_ar_batch,
run_chatterbox_batch and the continuous-batching engine, the dp x tp 2-D
mesh, and the server's --dp; the counterparts of tests/test_parallel.py's,
tests/test_cont_batch.py's, tests/test_chatterbox_t3.py's and
tests/test_serve.py's tests of this slice.

As in tests/test_torch_parallel.py, a mesh names the CPU several times
(`devices=["cpu"] * n`, the counterpart of codec_tpu's 8 virtual CPU
devices), and the chunks run eagerly. Greedy codes are held stream for
stream to the port unsharded and to codec_tpu's sharded run on its
8-device mesh on the same files; sampled codes to the port unsharded (the
port draws its noise from a torch.Generator, codec_tpu from JAX keys).
Where codec_tpu's test reads the compiled HLO for collectives, the port's
counts the device moves and host reads inside a step. The servers'
responses are held byte for byte to the port's unsharded server (their
codes are the runners', held to codec_tpu above). On the card chip_smoke.py
phase 12 captures these paths as CUDA graphs.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import create_backbone as jax_create_backbone
from codec_tpu.models.bench_lm_init import write_rda_gguf
from codec_tpu.ops.sample import OnDeviceSampling as JaxSampling
from codec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codec_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from codec_tpu.serve.cont_batch import ContinuousBatcher as JaxBatcher
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.lm import create_lm, fused_gen, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import StepGroup, create_backbone
from codec_tpu_torch.ops.sample import OnDeviceSampling
from codec_tpu_torch.parallel.mesh import dp_share, make_mesh, make_mesh_2d
from codec_tpu_torch.serve import CodecHTTPServer
from codec_tpu_torch.serve.cont_batch import ContinuousBatcher
from test_torch_cont_batch import ODS, PROMPT_SET, _lane, _same, _single
from test_torch_fused import engines, files  # noqa: F401
from test_torch_parallel import MOE_CFG, TP_CFG

N_DEV = 8
GREEDY = dict(chunk_frames=3)
SAMPLED = dict(temperature=0.8, top_k=5, seed=4, chunk_frames=3)


def cpu_mesh(n=N_DEV, axis="dp"):
    return make_mesh(n, axis=axis, devices=["cpu"] * n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """codec_tpu's tests' residual_depth_ar adaptor of hidden 32
    (bench_lm_init.write_rda_gguf) and backbones of hidden 32 that split 8
    ways: a dense llama (8 heads, 8 kv heads, ffn 64) and a Qwen3-MoE (8
    experts, top 2), written by the port's writer; both packages read
    them."""
    from codec_tpu_torch.models.lm_init import write_random_backbone_gguf

    d = tmp_path_factory.mktemp("graphs")
    rda = write_rda_gguf(d / "rda.gguf", h=32, dh=32, n_cb=4, vocab=64,
                         layers=2, heads=2, kv=1, hdim=16, inter=64)
    bbs = {name: write_random_backbone_gguf(d / f"{name}.gguf", seed=5,
                                            qtype="F32", cfg=cfg,
                                            rope_scaling=None)
           for name, cfg in (("tp", TP_CFG), ("moe", MOE_CFG))}
    reader = GGUFReader(rda)
    return dict(rda=rda, reader=reader, lm=create_lm(reader, device="cpu"),
                jreader=JaxReader(str(rda)), **bbs)


def _bb(tiny, name, kind=None, n=N_DEV, mesh=None):
    bb = create_backbone(tiny[name], max_ctx=32, device="cpu")
    if kind == "tp":
        bb.set_mesh(mesh or cpu_mesh(n, "tp"), axis="tp")
    elif kind == "ep":
        bb.set_mesh_ep(cpu_mesh(n, "ep"))
    return bb


def _jax_bb(tiny, name, kind=None, mesh=None):
    bb = jax_create_backbone(str(tiny[name]), max_ctx=32)
    if kind == "tp":
        bb.set_mesh(mesh or jax_make_mesh(N_DEV, axis="tp"), axis="tp")
    elif kind == "ep":
        bb.set_mesh_ep(jax_make_mesh(N_DEV, axis="ep"))
    return bb


def _one(tiny, bb, ods=GREEDY, port=True):
    """run_codebook_ar on the device path (chunks of 3), 5 frames."""
    prompt = [np.full(32, 0.1, np.float32)]
    if port:
        return tts_runner.run_codebook_ar(
            AudioLM(tiny["reader"], lm=tiny["lm"]), bb, prompt, max_steps=5,
            decode=False, on_device=OnDeviceSampling(**ods))
    return jax_runner.run_codebook_ar(
        JaxAudioLM(tiny["jreader"]), bb, prompt, max_steps=5, decode=False,
        on_device=JaxSampling(**ods))


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(32) * 0.3).astype(np.float32)]
            for _ in range(n)]


def _batch(tiny, bb, prompts, ods, mesh=None, port=True):
    if port:
        return tts_runner.run_codebook_ar_batch(
            [AudioLM(tiny["reader"], lm=tiny["lm"]) for _ in prompts], bb,
            prompts, OnDeviceSampling(**ods), max_steps=5, decode=False,
            mesh=mesh)
    shared = jax_create_lm(tiny["jreader"])
    return jax_runner.run_codebook_ar_batch(
        [JaxAudioLM(tiny["jreader"], lm=shared) for _ in prompts], bb,
        prompts, JaxSampling(**ods), max_steps=5, decode=False, mesh=mesh)


def _codes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        assert g.n_steps == w.n_steps


class _Moves(TorchFunctionMode):
    """Records every device move (`to` a device or another tensor's,
    `cpu`, `cuda`) and host read (`item`, `tolist`, `numpy`) of the
    torch calls run under it."""

    CALLS = {torch.Tensor.cpu, torch.Tensor.cuda, torch.Tensor.item,
             torch.Tensor.tolist, torch.Tensor.numpy}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        moves = func in self.CALLS or (func is torch.Tensor.to and (
            "device" in kwargs or any(isinstance(a, (torch.device, str,
                                                     torch.Tensor))
                                      for a in args[1:])))
        if moves:
            self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# data parallelism: the batched frame and chunk, one share a device
# ---------------------------------------------------------------------------

def test_dp_batched_lm_frame_sharded_no_collectives(tiny):
    """The batched frame over an 8-way dp mesh: each share's rows on its
    own device's LM (CodecLM.on_device), codes equal the single-stream
    frames and codec_tpu's batched frame sharded over its 8 devices; no
    device move and no host read inside a share's frame, nor inside a
    share's whole chunk (frame, compose, backbone step) in place of the
    HLO's collectives."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    lm = tiny["lm"]
    mesh = cpu_mesh()
    rng = np.random.default_rng(0)
    h = rng.standard_normal((N_DEV, lm.info.hidden_dim)).astype(np.float32)
    noise = torch.zeros((N_DEV, lm.info.n_codebook, lm.noise_width()))
    tc = torch.zeros(N_DEV, dtype=torch.long)
    greedy = (0.0, 0, 1.0, 0.0)
    got = []
    with torch.inference_mode(), _Moves() as moves:
        for s in range(N_DEV):
            _, devs = dp_share(mesh, N_DEV, s)
            share_lm = lm.on_device(devs[0])
            assert share_lm is lm          # a device named again: one copy
            got.append(share_lm._build_frame(greedy)(
                torch.from_numpy(h[s:s + 1]), noise[s:s + 1], tc[s:s + 1]))
    assert moves.seen == []
    got = torch.cat(got).numpy()
    frame = lm._build_frame(greedy)
    with torch.inference_mode():
        for s in range(N_DEV):
            np.testing.assert_array_equal(got[s], frame(
                torch.from_numpy(h[s:s + 1]), noise[s:s + 1], tc[s:s + 1])[0])
    jlm = jax_create_lm(tiny["jreader"])
    jmesh = jax_make_mesh(N_DEV)
    sh = NamedSharding(jmesh, P("dp"))
    keys = jax.random.split(jax.random.PRNGKey(3), N_DEV)
    out = jlm.fused_frame_batched()(jax.device_put(jnp.asarray(h), sh),
                                    jax.device_put(keys, sh),
                                    jax.device_put(jnp.zeros(N_DEV,
                                                             jnp.int32), sh))
    assert len(out.sharding.device_set) == N_DEV
    np.testing.assert_array_equal(got, np.asarray(out))
    # each share's whole chunk on its own device: no move, no host read
    bb = _bb(tiny, "tp")
    chunks = fused_gen.gen_batch_cached(lm, bb, b=4, n_frames=2, ctx=32,
                                        mesh=cpu_mesh(2))
    assert [(r.start, r.stop) for r in chunks.rows] == [(0, 2), (2, 4)]
    for runner in chunks.runners:
        assert runner.h.shape[0] == 2 and runner.h.device == torch.device(
            "cpu")
        with _Moves() as moves:
            runner.graphed.eager()
        assert moves.seen == []
    # the same record over a TP step sees its moves to the shares
    tp = _bb(tiny, "tp", "tp", n=2)
    runner = fused_gen.gen_batch_cached(lm, tp, b=2, n_frames=2,
                                        ctx=32).runner
    with _Moves() as moves:
        runner.graphed.eager()
    assert "to" in moves.seen


# ---------------------------------------------------------------------------
# TP and EP inside the chunks
# ---------------------------------------------------------------------------

def test_tp_gen_chunk_matches_unsharded(tiny):
    """run_codebook_ar's chunks over an 8-way TP backbone: the codes of the
    unsharded chunked run and of codec_tpu's TP chunk; the step reduced
    its partial products (two a layer)."""
    want = _one(tiny, _bb(tiny, "tp"))
    tp = _bb(tiny, "tp", "tp")
    got = _one(tiny, tp)
    _codes_equal([got], [want])
    assert got.n_steps == 5 and tp.reductions > 0
    runner = next(iter(tp._gen_chunks.values()))[1]
    assert len(runner.kvs) == N_DEV and runner.kvs[0].shape[3] == 1
    _codes_equal([got], [_one(tiny, _jax_bb(tiny, "tp", "tp"), port=False)])


def test_ep_gen_chunk_matches_unsharded(tiny):
    """The chunks over an 8-way EP Qwen3-MoE backbone (one expert a share,
    each share gathering all k chosen slots, clamped into it): the codes of
    the unsharded chunked run and of codec_tpu's EP chunk."""
    want = _one(tiny, _bb(tiny, "moe"))
    ep = _bb(tiny, "moe", "ep")
    got = _one(tiny, ep)
    _codes_equal([got], [want])
    _codes_equal([got], [_one(tiny, _jax_bb(tiny, "moe", "ep"),
                              port=False)])


def test_tp_batched_gen_matches_unsharded(tiny):
    """Three streams through one batched chunk over an 8-way TP backbone:
    sampled codes equal the unsharded batch stream for stream; greedy
    codes also codec_tpu's TP batch."""
    prompts = _prompts(3, 13)
    _codes_equal(_batch(tiny, _bb(tiny, "tp", "tp"), prompts, SAMPLED),
                 _batch(tiny, _bb(tiny, "tp"), prompts, SAMPLED))
    got = _batch(tiny, _bb(tiny, "tp", "tp"), prompts, GREEDY)
    _codes_equal(got, _batch(tiny, _bb(tiny, "tp"), prompts, GREEDY))
    _codes_equal(got, _batch(tiny, _jax_bb(tiny, "tp", "tp"), prompts,
                             GREEDY, port=False))


def test_dp_batched_gen_matches_unsharded(tiny):
    """Four streams data-parallel over a 2-way dp mesh (one chunk a share
    of two streams): sampled and greedy codes equal the unsharded batch;
    greedy codes also codec_tpu's dp run."""
    prompts = _prompts(4, 15)
    bb = _bb(tiny, "tp")
    sampled = dict(SAMPLED, seed=9)
    _codes_equal(_batch(tiny, bb, prompts, sampled, mesh=cpu_mesh(2)),
                 _batch(tiny, bb, prompts, sampled))
    got = _batch(tiny, bb, prompts, GREEDY, mesh=cpu_mesh(2))
    _codes_equal(got, _batch(tiny, bb, prompts, GREEDY))
    _codes_equal(got, _batch(tiny, _jax_bb(tiny, "tp"), prompts, GREEDY,
                             mesh=jax_make_mesh(2), port=False))


def test_dp_share_weights_one_copy_a_card(tiny):
    """An unsharded backbone's step groups on another card read one copy
    of its weights there, made once (the meta device stands for a second
    card): two groups, as two runners of a share build them, and a lane's
    hold the same tensors; on the backbone's own card, its own."""
    bb = _bb(tiny, "tp")
    own = StepGroup(bb, 0, "cpu")
    assert own.params is bb.params
    first, second = StepGroup(bb, 0, "meta"), StepGroup(bb, 0, "meta")
    q = first.params["layers"][0]["q"]
    assert q.device.type == "meta" and q is not bb.params["layers"][0]["q"]
    assert second.params["layers"][0]["q"] is q
    assert StepGroup(bb.lane(), 0, "meta").params is first.params


def test_dp_tp_batched_gen_2d_mesh(tiny):
    """dp 4 x tp 2 on one 2-D mesh: four streams split over dp, each dp
    row's backbone shares over its tp devices; sampled codes equal the
    unsharded batch, greedy codes also codec_tpu's 2-D run, and the
    engine's slots on the same mesh give the batch's codes; three streams
    are not divisible by the dp size."""
    prompts = _prompts(4, 14)
    mesh = make_mesh_2d(4, 2, devices=["cpu"] * 8)
    bb = _bb(tiny, "tp", "tp", mesh=mesh)
    assert len(bb.share_rows) == 4 and bb.row_devices[3] == list(
        mesh.devices[3])
    # the rows share the weights of the device they name again
    assert bb.share_rows[2][1]["layers"][0]["q"] is \
        bb.share_rows[0][1]["layers"][0]["q"]
    sampled = dict(temperature=0.7, top_k=4, seed=6, chunk_frames=3)
    _codes_equal(_batch(tiny, bb, prompts, sampled, mesh=mesh),
                 _batch(tiny, _bb(tiny, "tp"), prompts, sampled))
    got = _batch(tiny, bb, prompts, GREEDY, mesh=mesh)
    _codes_equal(got, _batch(tiny, _bb(tiny, "tp"), prompts, GREEDY))
    jmesh = jax_make_mesh_2d(4, 2)
    _codes_equal(got, _batch(tiny, _jax_bb(tiny, "tp", "tp", mesh=jmesh),
                             prompts, GREEDY, mesh=jmesh, port=False))
    # the engine composes the same way: its slots over dp, each share over
    # its row's tp shares (a lane of the backbone: its own caches); stream
    # s's codes are the batch's with seed 6 + s
    engine = ContinuousBatcher(bb.lane(), tiny["lm"], n_slots=4,
                               on_device=OnDeviceSampling(**sampled),
                               decode=False, mesh=mesh)
    handles = [engine.submit(AudioLM(tiny["reader"], lm=tiny["lm"]), p,
                             seed=6 + s, max_steps=5)
               for s, p in enumerate(prompts)]
    engine.drain()
    _codes_equal([h.wait(timeout=0) for h in handles],
                 _batch(tiny, bb, prompts, sampled, mesh=mesh))
    with pytest.raises(ValueError, match="not divisible"):
        _batch(tiny, bb, prompts[:3], GREEDY, mesh=mesh)
    with pytest.raises(ValueError, match="same 2-D mesh"):
        _batch(tiny, _bb(tiny, "tp", "tp", n=2), prompts, GREEDY,
               mesh=cpu_mesh(2))


# ---------------------------------------------------------------------------
# the stream and continuous chunks over a TP backbone
# ---------------------------------------------------------------------------

def test_tp_stream_chunk_matches_unsharded(tmp_path_factory):
    """MOSS-TTS-Realtime's stream chunk (run_realtime_streaming, chunks of
    3, the repetition penalty over a window of 3) over a 2-way TP backbone
    (tests/test_torch_realtime.py's files, loaded dense): greedy and
    sampled codes equal the unsharded chunked run."""
    from codec_tpu_torch.lm.prompt_info import build_prompt_info
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf)
    from test_torch_realtime import BB, CTX, TEXT, _write

    tmp = tmp_path_factory.mktemp("rt_tp")
    bb_path = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=6, qtype="Q8_0", cfg=BB, rope_scaling=None,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    reader = GGUFReader(_write(tmp, "rt.gguf"))
    alm = AudioLM(reader, device="cpu")
    pi = build_prompt_info(reader, alm.lm.info)

    def run(bb, **ods):
        bb.reset()
        return tts_runner.run_realtime_streaming(
            alm, bb, lambda t: bb.embed_tokens([t])[0], CTX, TEXT, pi,
            max_frames=6, decode=False, on_device=OnDeviceSampling(
                chunk_frames=3, repetition_penalty=1.3, repetition_window=3,
                **ods))

    one = create_backbone(bb_path, device="cpu")
    tp = create_backbone(bb_path, device="cpu")
    tp.set_mesh(cpu_mesh(2, "tp"), axis="tp")
    for ods in (dict(), dict(temperature=0.8, top_k=5, seed=2)):
        _codes_equal([run(tp, **ods)], [run(one, **ods)])
    runner = next(iter(tp._gen_chunks.values()))[1]
    assert isinstance(runner, fused_gen.StreamRunner) and len(runner.kvs) == 2


def test_tp_continuous_chunk_matches_unsharded(tmp_path_factory):
    """BlueMagpie's continuous chunk (run_continuous, chunks of 4 steps)
    over a 2-way TP backbone (tests/test_torch_cfm.py's files): latents
    within 1e-4 of the unsharded chunked run's peak, the same steps and
    stop."""
    import codec_tpu_torch
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf)
    from codec_tpu_torch.models.lm_tts_init import write_bluemagpie_tts_gguf
    from test_torch_cfm import BB, BM, CFM

    tmp = tmp_path_factory.mktemp("bm_tp")
    model = write_bluemagpie_tts_gguf(tmp / "bm_tts.gguf", seed=7, cfm=CFM,
                                      codec_cfg=BM, decoder_dim=32)
    bb_path = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=8, qtype="F32", cfg=BB, rope_scaling=None,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    reader = GGUFReader(model)
    codec = codec_tpu_torch.load_model(model, device="cpu")
    lm = create_lm(reader, device="cpu")
    ids = list(np.random.default_rng(9).integers(0, BB.vocab_size, 6))

    def run(bb):
        bb.reset()
        alm = AudioLM(reader, codec=codec, lm=lm)
        alm.set_continuous_params(n_timesteps=6)
        return tts_runner.run_continuous(alm, bb, list(bb.embed_tokens(ids)),
                                         max_steps=8, min_len=8,
                                         chunk_steps=4, decode=False)

    want = run(create_backbone(bb_path, device="cpu"))
    tp = create_backbone(bb_path, device="cpu")
    tp.set_mesh(cpu_mesh(2, "tp"), axis="tp")
    got = run(tp)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos) \
        == (8, False)
    assert got.codes.shape == want.codes.shape
    err = np.abs(got.codes - want.codes).max()
    assert err <= 1e-4 * np.abs(want.codes).max()
    assert isinstance(next(iter(tp._cont_chunks.values()))[1],
                      fused_gen.ContinuousRunner)


# ---------------------------------------------------------------------------
# the engine's slots and batched Chatterbox over dp
# ---------------------------------------------------------------------------

def test_dp_sharded_engine_matches(engines):
    """A 2-slot engine over a 2-way dp mesh (one chunk a share of one
    slot): three sampled requests equal their single-stream runs; greedy
    ones codec_tpu's dp engine on the same files."""
    port, ref = engines
    batcher = ContinuousBatcher(_lane(port), port["lm"], n_slots=2,
                                on_device=OnDeviceSampling(**ODS),
                                decode=False, mesh=cpu_mesh(2))
    runners = batcher.chunks.runners
    assert len(runners) == 2 and batcher.runner is runners[0]
    assert [r.h.shape[0] for r in runners] == [1, 1]

    def submit(b, i, ids):
        return b.submit(AudioLM(port["reader"], lm=port["lm"]),
                        list(port["bb"].embed_tokens(ids)), seed=50 + i,
                        max_steps=5)
    handles = [submit(batcher, i, PROMPT_SET[i]) for i in range(3)]
    batcher.drain()
    for i, hd in enumerate(handles):
        _same(hd.wait(timeout=0), _single(port, PROMPT_SET[i], 50 + i, 5))
    greedy = ContinuousBatcher(_lane(port), port["lm"], n_slots=2,
                               on_device=OnDeviceSampling(chunk_frames=3),
                               decode=False, mesh=cpu_mesh(2))
    handles = [submit(greedy, i, PROMPT_SET[i]) for i in range(3)]
    greedy.drain()
    jref = JaxBatcher(ref["bb"], ref["lm"], n_slots=2,
                      on_device=JaxSampling(chunk_frames=3), decode=False,
                      mesh=jax_make_mesh(2))
    jhandles = [jref.submit(JaxAudioLM(ref["reader"], lm=ref["lm"]),
                            list(ref["bb"].embed_tokens(PROMPT_SET[i])),
                            seed=50 + i, max_steps=5) for i in range(3)]
    jref.drain()
    _codes_equal([h.wait(timeout=0) for h in handles],
                 [h.wait(timeout=0) for h in jhandles])


def test_dp_slots_divisibility(engines):
    port, _ = engines
    with pytest.raises(ValueError, match="not\\s+divisible"):
        ContinuousBatcher(_lane(port), port["lm"], n_slots=3,
                          on_device=OnDeviceSampling(**ODS),
                          mesh=cpu_mesh(2))


def test_run_chatterbox_batch_dp(tmp_path_factory):
    """Batched Chatterbox with its streams over a 2-way dp mesh: sampled
    codes equal the unsharded batched run, greedy ones also codec_tpu's
    dp run; an odd stream count is not divisible."""
    from codec_tpu.lm import chatterbox_t3 as jt3
    from codec_tpu_torch.lm import chatterbox_t3 as t3m
    from codec_tpu_torch.models import chatterbox_init as cbi
    from codec_tpu_torch.models.lm_init import write_random_backbone_gguf
    from test_torch_chatterbox import BB, T3, VE
    from test_torch_s3g import SMALL, WIDTHS

    tmp = tmp_path_factory.mktemp("cbx_dp")
    model = cbi.write_chatterbox_tts_gguf(
        tmp / "cbx.gguf", seed=3, t3=T3, ve=VE,
        cfg=dataclasses.replace(SMALL, codebook_size=T3.start_speech),
        **WIDTHS)
    bb_path = write_random_backbone_gguf(tmp / "bb.gguf", seed=4,
                                         qtype="F32", cfg=BB,
                                         rope_scaling=cbi.T3_ROPE_SCALING)
    reader = GGUFReader(model)
    t3 = t3m.ChatterboxT3(reader, "cpu")
    lm = create_lm(reader, device="cpu")
    texts = ["hello there", "ok"]
    sampled = dict(temperature=0.8, min_p=0.05, repetition_penalty=1.2,
                   repetition_window=-1, seed=21, chunk_frames=3)

    def run(ods, mesh=None, n=2):
        return tts_runner.run_chatterbox_batch(
            [AudioLM(reader, lm=lm) for _ in texts[:n]], t3,
            create_backbone(bb_path, max_ctx=128, device="cpu"), texts[:n],
            OnDeviceSampling(**ods), max_frames=5, cfg_weight=0.5,
            decode=False, mesh=mesh)

    _codes_equal(run(sampled, cpu_mesh(2)), run(sampled))
    greedy = dict(chunk_frames=3)
    got = run(greedy, cpu_mesh(2))
    _codes_equal(got, run(greedy))
    jreader = JaxReader(str(model))
    shared = jax_create_lm(jreader)
    want = jax_runner.run_chatterbox_batch(
        [JaxAudioLM(jreader, lm=shared) for _ in texts], jt3.ChatterboxT3(
            jreader), jax_create_backbone(str(bb_path), max_ctx=128), texts,
        JaxSampling(**greedy), max_frames=5, cfg_weight=0.5, decode=False,
        mesh=jax_make_mesh(2))
    _codes_equal(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        run(greedy, cpu_mesh(2), n=1)


# ---------------------------------------------------------------------------
# the server's --dp
# ---------------------------------------------------------------------------

def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(srv, path, obj):
    import http.client
    import json

    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
    conn.request("POST" if obj is not None else "GET", path,
                 body=None if obj is None else json.dumps(obj))
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_synthesize_batch_dp_tp_server(files):  # noqa: F811
    """`codec-serve-torch --dp 2 --tp 2`: one 2-D mesh, the backbone
    TP-split over it, /synthesize_batch's streams over dp; its WAVs equal
    the unsharded server's; /health and /stats report the mesh."""
    import json

    _, model, bb = files
    kw = dict(port=0, backbone_path=str(bb), device="cpu")
    req = {"texts": ["hello there", "more words"], "seed": 5,
           "max_frames": 4}
    one = _serve(CodecHTTPServer(str(model), **kw))
    try:
        status, body = _post(one, "/synthesize_batch", req)
        assert status == 200
        want = json.loads(body)
    finally:
        one.shutdown()
    srv = _serve(CodecHTTPServer(str(model), backbone_mesh=("tp", 2), dp=2,
                                 **kw))
    try:
        assert dict(srv.batch_mesh.shape) == {"dp": 2, "tp": 2}
        assert srv.backbone.mesh is srv.batch_mesh
        status, body = _post(srv, "/synthesize_batch", req)
        assert status == 200
        got = json.loads(body)
        assert got["wavs"] == want["wavs"]
        assert got["n_frames"] == want["n_frames"] == [4, 4]
        for path in ("/health", "/stats"):
            status, body = _post(srv, path, None)
            assert json.loads(body)["dp_mesh"] == {"dp": 2, "tp": 2}
    finally:
        srv.shutdown()


def test_cont_batch_dp_server_matches(files):  # noqa: F811
    """`--dp 2 --cont-batch 2`: the engine's slots over a 2-way dp mesh,
    /synthesize byte-equal to the unsharded engine's, greedy and with a
    request's own sampler chain."""
    _, model, bb = files
    kw = dict(port=0, backbone_path=str(bb), quant_exec=True, cont_batch=2,
              chunk_frames=8, device="cpu")
    reqs = ({"text": "hello there", "seed": 3, "max_frames": 6},
            {"text": "hello there", "seed": 3, "max_frames": 6,
             "temperature": 1.3, "top_k": 4})
    one = _serve(CodecHTTPServer(str(model), **kw))
    try:
        want = [_post(one, "/synthesize", r) for r in reqs]
    finally:
        one.shutdown()
    srv = _serve(CodecHTTPServer(str(model), dp=2, **kw))
    try:
        assert len(srv._cont_batcher.chunks.runners) == 2
        got = [_post(srv, "/synthesize", r) for r in reqs]
    finally:
        srv.shutdown()
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200]
    assert [b for _, b in got] == [b for _, b in want]


def test_dp_with_pp_or_ep_raises(files):  # noqa: F811
    """--dp beside --pp or --ep raises codec_tpu's ValueError."""
    _, model, bb = files
    for kind in ("pp", "ep"):
        with pytest.raises(ValueError, match="--dp composes with --tp only"):
            CodecHTTPServer(str(model), port=0, backbone_path=str(bb),
                            backbone_mesh=(kind, 2), dp=2, device="cpu")


def test_chip_smoke_graphs_phase_on_cpu(tmp_path_factory, monkeypatch):
    """chip_smoke.py's phase 12 end to end at small widths on the CPU: DP
    and dp x tp batches, TP and EP gen chunks, the TP stream and
    continuous chunks, DP batched Chatterbox and both --dp servers, each
    against its unsharded run (the launch counts are those the card is
    held to: the plain versions count nothing here)."""
    from pathlib import Path

    from codec_tpu_torch.lm.prompt_info import build_prompt_info
    from codec_tpu_torch.models import chatterbox_init as cbi
    from codec_tpu_torch.models import lm_tts_init as lti
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf,
                                                write_random_backbone_ggufs,
                                                write_random_csm_gguf)
    from test_torch_cfm import BB as BM_BB
    from test_torch_cfm import BM, CFM
    from test_torch_chatterbox import BB as CBX_BB
    from test_torch_chatterbox import T3, VE
    from test_torch_fused import BB, DEPTH, MIMI
    from test_torch_realtime import BB as RT_BB
    from test_torch_realtime import _write
    from test_torch_s3g import SMALL as S3G_SMALL
    from test_torch_s3g import WIDTHS

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    tmp = tmp_path_factory.mktemp("smoke12")
    spm = spm_model_b64(byte_fallback_vocab())
    model = write_random_csm_gguf(tmp / "csm.gguf", seed=2, mimi_cfg=MIMI,
                                  num_filters=8, dcfg=DEPTH)
    q4 = write_random_backbone_ggufs({"Q4_K": tmp / "bb_Q4_K.gguf"}, seed=1,
                                     cfg=BB, spm_b64=spm)["Q4_K"]
    moe = write_random_backbone_gguf(
        tmp / "moe.gguf", seed=3, qtype="Q4_K", rope_scaling=None,
        cfg=dataclasses.replace(MOE_CFG, hidden=256, head_dim=64,
                                ffn_dim=256, moe_ffn_dim=32, max_ctx=96))
    h = 256                                  # Q4_K wants widths of 256
    cbx = cbi.write_chatterbox_tts_gguf(
        tmp / "cbx.gguf", seed=3, t3=dataclasses.replace(T3, hidden=h),
        ve=dataclasses.replace(VE, hidden_dim=h),
        cfg=dataclasses.replace(S3G_SMALL, codebook_size=T3.start_speech),
        **WIDTHS)
    cbx_bb = write_random_backbone_ggufs(
        {"Q4_K": tmp / "t3_Q4_K.gguf"}, seed=4,
        cfg=dataclasses.replace(CBX_BB, hidden=h, n_layers=1, head_dim=64,
                                ffn_dim=512),
        rope_scaling=cbi.T3_ROPE_SCALING)["Q4_K"]
    rt_reader = GGUFReader(_write(tmp, "rt.gguf"))
    rt_lm = create_lm(rt_reader, device="cpu")
    rt_bb = create_backbone(write_random_backbone_gguf(
        tmp / "rt_bb.gguf", seed=6, qtype="Q8_0", cfg=RT_BB,
        rope_scaling=None, spm_b64=spm), quantized=True, device="cpu")
    bm_reader = GGUFReader(lti.write_bluemagpie_tts_gguf(
        tmp / "bm.gguf", seed=7, cfm=CFM, codec_cfg=BM, decoder_dim=32))
    bm_bb = create_backbone(write_random_backbone_gguf(
        tmp / "bm_bb.gguf", seed=8, qtype="F32", cfg=BM_BB,
        rope_scaling=None, spm_b64=spm), device="cpu")
    none = dict.fromkeys(("flash_sdpa_window", "q8_0_matmul", "q4_k_matmul",
                          "rvq_encode_fused"), 0)
    flows = {"rt": (rt_lm, rt_reader, build_prompt_info(rt_reader,
                                                        rt_lm.info),
                    [1, 2, 3, 4, 5, 6, 7], rt_bb),
             "bm": (create_lm(bm_reader, device="cpu"), bm_reader,
                    [5, 9, 30, 7, 12, 2], bm_bb)}
    got, times = cs.graphs_phase(
        "CPU", lambda: None, lambda: dict(none), none,
        {"csm": model, "Q4_K": q4, "cbx": cbx, "cbx_bb": cbx_bb},
        create_backbone(moe, quantized=True, device="cpu"), flows,
        dev="cpu", sizes=dict(streams=4, frames=3, prompt=5, chunk=2,
                              cbx_streams=2, slots=2, bm_patches=3))
    assert got == none
    assert set(times) == {"dp_batch", "dp_tp_batch", "tp_chunk", "ep_chunk",
                          "tp_stream_chunk", "tp_continuous_chunk",
                          "dp_chatterbox", "serve_dp_tp_batch",
                          "serve_dp_engine"}
