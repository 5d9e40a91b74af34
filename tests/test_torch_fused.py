"""The port's on-device sampling, fused frame and generation chunks
(codec_tpu_torch/ops/sample.py, lm/residual_depth_ar.py, lm/fused_gen.py,
lm/tts_runner.py's on-device paths) against codec_tpu on the CPU.

Randomness is data in the port: its samplers take Gumbel noise where
codec_tpu's take a PRNG key, and jax.random.categorical(key, lg) is
argmax(jax.random.gumbel(key, lg.shape) + lg). So each sampled comparison
feeds the port the noise of the key splits codec_tpu makes (per frame
`key, sub = split(key)`, per codebook `split(sub, n_cb)`), and asks for
equal codes. Greedy codes must be equal outright. Runners draw their noise
from a torch.Generator, so sampled runs are held against the port's own
per-frame path and single streams, greedy runs against codec_tpu.

Fixtures are those of tests/test_torch_tts.py: the port's writers, a tiny
Mimi with a residual_depth_ar adaptor over a backbone hidden of 256, a
Q8_0 llama backbone, both packages loading the same files. On the CPU the
chunks run eagerly; the CUDA graphs are held on the card by chip_smoke.py
and tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import fused_gen as jax_fused_gen
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu.ops import sample as jax_sample
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.lm import create_lm, fused_gen, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone, StepGroup, backbone_step
from codec_tpu_torch.lm.base import LmError, LmStateError
from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                            spm_model_b64,
                                            write_random_backbone_gguf,
                                            write_random_csm_gguf)
from codec_tpu_torch.ops import sample
from codec_tpu_torch.ops.sample import OnDeviceSampling
from test_torch_tts import BB, DEPTH, MIMI, _assert_close_pcm, _rda_gguf

SAMPLED = dict(temperature=0.8, top_k=5)
PROMPT = [3, 17, 42, 99, 150, 7]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the samplers against codec_tpu.ops.sample
# ---------------------------------------------------------------------------

def _logits(seed, shape=(3, 97)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2


def _jax_rows(fn, lg):
    return np.stack([np.asarray(fn(jnp.asarray(row))) for row in lg])


@pytest.mark.parametrize("k", [0, 1, 5, 96, 97])
def test_top_k_matches(k):
    lg = _logits(1)
    got = sample._apply_top_k(torch.from_numpy(lg), k).numpy()
    np.testing.assert_array_equal(got, _jax_rows(
        lambda r: jax_sample._apply_top_k(r, k), lg))


@pytest.mark.parametrize("min_p", [0.0, 0.05, 0.5])
def test_min_p_matches(min_p):
    lg = _logits(2)
    got = sample._apply_min_p(torch.from_numpy(lg), min_p).numpy()
    np.testing.assert_array_equal(got, jax_sample._apply_min_p(
        jnp.asarray(lg), min_p))


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5, 0.05])
def test_top_p_matches(top_p):
    lg = _logits(3)
    got = sample._apply_top_p(torch.from_numpy(lg), top_p).numpy()
    np.testing.assert_array_equal(got, jax_sample._apply_top_p(
        jnp.asarray(lg), top_p))


@pytest.mark.parametrize("rng_args", [(10, 40, ()), (0, 97, ()),
                                      (5, 20, (60, -1, None, 200))])
def test_mask_outside_range_matches(rng_args):
    lg = _logits(4)
    got = sample.mask_outside_range(torch.from_numpy(lg), *rng_args).numpy()
    np.testing.assert_array_equal(got, jax_sample.mask_outside_range(
        jnp.asarray(lg), *rng_args))


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_repetition_penalty_and_seen_mask_match(penalty):
    lg = _logits(5, (97,))
    ring = np.array([3, -1, 50, 3, 96, -1], np.int32)
    seen = sample.seen_mask_from_ring(torch.from_numpy(ring), 97)
    want_seen = jax_sample.seen_mask_from_ring(jnp.asarray(ring), 97)
    np.testing.assert_array_equal(seen.numpy(), want_seen)
    got = sample.apply_repetition_penalty(torch.from_numpy(lg), seen, penalty)
    np.testing.assert_array_equal(got.numpy(), jax_sample.apply_repetition_penalty(
        jnp.asarray(lg), want_seen, penalty))


def _gumbel(key, width):
    return np.array(jax.random.gumbel(key, (width,), jnp.float32))


CHAINS = [dict(), dict(temperature=0.7), dict(temperature=1.1, top_k=7),
          dict(temperature=0.9, top_p=0.8), dict(temperature=1.0, min_p=0.1),
          dict(temperature=0.6, top_k=20, top_p=0.9, min_p=0.02)]


@pytest.mark.parametrize("chain", CHAINS)
def test_sample_logits_matches_categorical(chain):
    """sample_logits(lg, gumbel(key)) == codec_tpu's sample_logits(lg, key),
    over 12 keys, and the traced-chain form gives the same."""
    lg = _logits(6, (97,))
    row = OnDeviceSampling(**chain).chain_vec()
    for s in range(12):
        key = jax.random.PRNGKey(s)
        want = int(jax_sample.sample_logits(jnp.asarray(lg), key, **chain))
        want_dyn = int(jax_sample.sample_logits_dyn(jnp.asarray(lg), key,
                                                    jnp.asarray(row)))
        noise = torch.from_numpy(_gumbel(key, 97))
        got = sample.sample_logits(torch.from_numpy(lg), noise, **chain)
        got_dyn = sample.sample_logits_dyn(torch.from_numpy(lg), noise,
                                           torch.from_numpy(row))
        assert int(got) == want == want_dyn == int(got_dyn)


def test_gumbel_draws_follow_the_generator():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = sample.gumbel((4, 9), g1, "cpu")
    b = torch.cat([sample.gumbel((9,), g2, "cpu") for _ in range(4)])
    assert torch.equal(a.reshape(-1), b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the fused frame against codec_tpu's fused_frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["csm", "qk_norm_gqa"])
def rda(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("rda") / f"{request.param}.gguf"
    _rda_gguf(path, request.param)
    return create_lm(GGUFReader(path), device="cpu"), \
        jax_create_lm(JaxReader(str(path)))


def _frame_noise(key, lm, n_frames, n_cb):
    """The port's noise [K, n_cb, W] of codec_tpu's key splits for K
    frames, and the key after them."""
    c = lm._fused_consts()
    widths = [c.c0_width] + [c.head_width] * (n_cb - 1)
    out = np.zeros((n_frames, n_cb, lm.noise_width()), np.float32)
    for i in range(n_frames):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, n_cb)
        for k in range(n_cb):
            out[i, k, :widths[k]] = _gumbel(keys[k], widths[k])
    return out, key


def _chain(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0):
    return (float(temperature), int(top_k), float(top_p), float(min_p))


def _frame(lm, cb0_range=None, **chain):
    """The port's frame (`_build_frame`) for one stream, called as
    codec_tpu's fused_frame: fn(h [hidden], noise [n_cb, W], text_ctx=0)
    → codes [n_cb]."""
    frame = lm._build_frame(_chain(**chain), cb0_range=cb0_range)

    def fn(h, noise, text_ctx=0):
        with torch.inference_mode():
            return frame(torch.as_tensor(h, dtype=torch.float32)[None],
                         torch.as_tensor(noise, dtype=torch.float32)[None],
                         torch.tensor([int(text_ctx)]))[0]
    return fn


@pytest.mark.parametrize("chain", [dict(), SAMPLED,
                                   dict(temperature=1.2, top_p=0.8)])
def test_fused_frame_matches_jax(rda, chain):
    lm, jlm = rda
    n_cb, hidden = lm.info.n_codebook, lm.info.hidden_dim
    rng = np.random.default_rng(11)
    fn, jfn = _frame(lm, **chain), jlm.fused_frame(**chain)
    for s in range(4):
        h = rng.standard_normal(hidden).astype(np.float32)
        key = jax.random.PRNGKey(100 + s)
        # the runner's per-frame path: key, sub = split(key); frame(sub)
        noise, _ = _frame_noise(key, lm, 1, n_cb)
        want = np.asarray(jfn(h, jax.random.split(key)[1], np.int32(0)))
        got = fn(h, noise[0]).numpy()
        np.testing.assert_array_equal(got, want)


def test_fused_frame_greedy_matches_host(rda):
    lm, _ = rda
    fn = _frame(lm)
    rng = np.random.default_rng(12)
    for _ in range(3):
        h = rng.standard_normal(lm.info.hidden_dim).astype(np.float32)
        st = lm.new_state()
        st.step_begin(h)
        for _k in range(lm.info.n_codebook):
            logits, _cb = st.step_logits()
            st.step_push_code(int(np.argmax(logits)))
        assert fn(h, np.zeros((lm.info.n_codebook, lm.noise_width()))).tolist() \
            == st.step_finish()


def test_fused_frame_range_matches_jax(rda):
    lm, jlm = rda
    rng = np.random.default_rng(13)
    cb = (10, 30, 45)
    fn = _frame(lm, cb0_range=cb, **SAMPLED)
    jfn = jlm.fused_frame(cb0_range=cb, **SAMPLED)
    for s in range(4):
        h = rng.standard_normal(lm.info.hidden_dim).astype(np.float32)
        key = jax.random.PRNGKey(200 + s)
        noise, _ = _frame_noise(key, lm, 1, lm.info.n_codebook)
        got = fn(h, noise[0]).numpy()
        assert 10 <= got[0] < 30 or got[0] == 45
        np.testing.assert_array_equal(
            got, np.asarray(jfn(h, jax.random.split(key)[1], np.int32(0))))


@pytest.mark.parametrize("chain", [dict(), SAMPLED])
def test_batched_frame_matches_single_frames(rda, chain):
    lm, _ = rda
    b, n_cb = 3, lm.info.n_codebook
    rng = np.random.default_rng(14)
    h = rng.standard_normal((b, lm.info.hidden_dim)).astype(np.float32)
    noise = sample.gumbel((b, n_cb, lm.noise_width()),
                          torch.Generator().manual_seed(3), "cpu")
    with torch.inference_mode():
        got = lm._build_frame(_chain(**chain))(
            torch.from_numpy(h), noise, torch.zeros(b, dtype=torch.long))
    one = _frame(lm, **chain)
    for s in range(b):
        assert got[s].tolist() == one(h[s], noise[s]).tolist()


def test_compose_embd_fn_matches_host(rda):
    lm, _ = rda
    codes = np.array([[1, 2, 3, 4], [19, 0, 7, 11]])
    got = lm.compose_embd_fn()(torch.from_numpy(codes)).numpy()
    for row, want in zip(codes, got):
        np.testing.assert_array_equal(lm.compose_audio_embd(list(row)), want)


def test_push_frame_validates(rda):
    lm, _ = rda
    st = lm.new_state()
    with pytest.raises(LmError):
        st.push_frame([0] * (lm.info.n_codebook - 1))
    with pytest.raises(LmError):
        st.push_frame([lm.info.codebook_sizes[0]] + [0] * (lm.info.n_codebook - 1))
    st.step_begin(np.zeros(lm.info.hidden_dim, np.float32))
    with pytest.raises(LmStateError):
        st.push_frame([0] * lm.info.n_codebook)
    st = lm.new_state()
    assert st.push_frame([1] * lm.info.n_codebook) == [1] * lm.info.n_codebook
    assert st.frame_counter == 1


# ---------------------------------------------------------------------------
# the chunks and the runners against codec_tpu (CSM fixture + backbone)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
    model = write_random_csm_gguf(tmp / "csm.gguf", seed=2, mimi_cfg=MIMI,
                                  num_filters=8, dcfg=DEPTH)
    bb = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=1, qtype="Q8_0", cfg=BB,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    return tmp, model, bb


def _engine(model, bb_path, port: bool):
    if port:
        reader = GGUFReader(model)
        return dict(port=True, reader=reader,
                    codec=codec_tpu_torch.load_model(model, device="cpu"),
                    lm=create_lm(reader, device="cpu"),
                    bb=LlamaBackbone(bb_path, quantized=True, device="cpu"))
    reader = JaxReader(str(model))
    return dict(port=False, reader=reader,
                codec=codec_tpu.load_model(str(model)),
                lm=jax_create_lm(reader),
                bb=JaxBackbone(str(bb_path), quantized=True))


@pytest.fixture(scope="module")
def engines(files):
    _, model, bb = files
    return _engine(model, bb, True), _engine(model, bb, False)


@pytest.fixture(scope="module")
def eos_files(files, engines):
    """The CSM file again with eos_code_c0 = a c0 code greedy decoding
    emits first at frame >= 2, and a delay-pattern copy of it."""
    tmp, _, bb = files
    codes = _run(engines[0], dict(chunk_frames=1), max_steps=10).codes[:, 0]
    k = next(k for k in range(2, len(codes)) if codes[k] not in codes[:k])
    out = {}
    for name, delays in (("eos", [0, 0, 0, 0]), ("delay", [0, 1, 1, 1])):
        out[name] = write_random_csm_gguf(
            tmp / f"csm_{name}.gguf", seed=2, mimi_cfg=MIMI, num_filters=8,
            dcfg=DEPTH, eos_code_c0=int(codes[k]), delay_pattern=delays)
    return out, k


def _run(eng, ods, max_steps=6, ids=PROMPT, bucket=0):
    alm_cls, run, cls = ((AudioLM, tts_runner.run_codebook_ar,
                          OnDeviceSampling) if eng["port"] else
                         (JaxAudioLM, jax_runner.run_codebook_ar,
                          jax_sample.OnDeviceSampling))
    bb = eng["bb"]
    bb.reset()
    alm = alm_cls(eng["reader"], codec=eng["codec"], lm=eng["lm"])
    return run(alm, bb, list(bb.embed_tokens(ids)), max_steps=max_steps,
               on_device=None if ods is None else cls(**ods),
               prefill_bucket=bucket)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_on_device_greedy_matches_jax_and_host(engines, chunk):
    port, ref = engines
    got = _run(port, dict(chunk_frames=chunk))
    want = _run(ref, dict(chunk_frames=chunk))
    host = _run(port, None)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.codes, host.codes)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps, want.stopped_by_eos)
    _assert_close_pcm(got.pcm, want.pcm)


@pytest.mark.parametrize("chain", [SAMPLED, dict(temperature=1.0, top_p=0.7,
                                                 min_p=0.05)])
def test_sampled_chunks_match_per_frame(engines, chain):
    """The chunked path draws the per-frame path's noise stream: the same
    codes at K = 1, 3 (not dividing max_steps) and 4."""
    port, _ = engines
    runs = [_run(port, dict(chain, chunk_frames=k, seed=9)) for k in (1, 3, 4)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.codes, runs[0].codes)
    assert not np.array_equal(runs[0].codes, _run(port, None).codes)


class _HostOnly:
    """The tts_runner Backbone protocol alone (step on the host), over a
    LlamaBackbone: a backbone the chunk cannot run."""

    def __init__(self, bb):
        self.bb = bb

    def step(self, embed):
        return self.bb.step(embed)


@pytest.mark.parametrize("chain", [dict(), SAMPLED])
def test_protocol_backbone_takes_the_frame_runner(engines, chain):
    """A backbone the chunk cannot run takes one graphed frame a step and
    the host's backbone step (FrameRunner): the codes of the chunk at
    K = 1 and 4 on the same backbone."""
    port, _ = engines
    bb = port["bb"]
    host = _HostOnly(bb)
    assert not fused_gen.supports_gen_chunk(port["lm"], host)
    bb.reset()
    alm = AudioLM(port["reader"], codec=port["codec"], lm=port["lm"])
    got = tts_runner.run_codebook_ar(
        alm, host, list(bb.embed_tokens(PROMPT)), max_steps=6,
        on_device=OnDeviceSampling(**chain, seed=9))
    assert port["lm"]._frame_runners
    for k in (1, 4):
        np.testing.assert_array_equal(
            got.codes, _run(port, dict(chain, chunk_frames=k, seed=9)).codes)


def test_gen_chunk_cache_keeps_the_last_runners(engines):
    """The backbone keeps the _KEEP runners used last: a hit returns the
    same runner and makes it the newest, a miss past _KEEP drops the
    oldest."""
    port, _ = engines
    lm, bb = port["lm"], port["bb"]
    bb.__dict__.pop("_gen_chunks", None)
    get = lambda t: fused_gen.gen_chunk_cached(  # noqa: E731
        lm, bb, n_frames=2, ctx=64, temperature=t, top_k=5)
    first = [get(t) for t in (0.5, 0.6, 0.7, 0.8)]
    assert get(0.5) is first[0]
    get(0.9)                                    # drops 0.6, the oldest now
    assert len(bb._gen_chunks) == fused_gen._KEEP
    assert get(0.5) is first[0] and get(0.7) is first[2]
    assert get(0.6) is not first[1]


def _prefilled(eng, ids=PROMPT):
    bb = eng["bb"]
    bb.reset()
    embeds = list(bb.embed_tokens(ids))
    h = None
    for e in embeds:
        h = bb.step(np.asarray(e, np.float32))
    return bb, np.asarray(h, np.float32)


def _port_chunk(eng, chain, k, noise, h, base=0, ctx=64):
    lm, bb = eng["lm"], eng["bb"]
    chunk = fused_gen.build_gen_chunk(lm, bb.cfg, chain, k)
    with torch.inference_mode():
        packed, h2, pos = chunk(
            StepGroup(bb), [bb.kv[None]], torch.tensor([bb.pos]),
            torch.tensor([base]), torch.from_numpy(h)[None],
            torch.from_numpy(noise)[:, None], torch.tensor([0]), ctx)
    return packed.numpy(), h2, pos


def _jax_chunk(eng, chain, k, key, h, base=0):
    lm, bb = eng["lm"], eng["bb"]
    fn = jax_fused_gen.gen_chunk_cached(
        lm, bb, n_frames=k, temperature=chain[0], top_k=chain[1],
        top_p=chain[2], min_p=chain[3])
    packed, h2, kv, key = fn(bb.params, bb.kv, np.int32(bb.pos),
                             np.int32(base), jnp.asarray(h), key, np.int32(0))
    return np.asarray(packed), np.asarray(h2)


@pytest.mark.parametrize("chain", [(0.0, 0, 1.0, 0.0), (0.8, 5, 1.0, 0.0),
                                   (1.0, 0, 0.8, 0.02)])
def test_chunk_packed_matches_jax(engines, chain):
    """One 4-frame chunk from the same hidden, the port fed codec_tpu's
    noise: packed codes and meta equal, hiddens close."""
    port, ref = engines
    bb, h = _prefilled(port)
    _prefilled(ref)
    key = jax.random.PRNGKey(5)
    noise, _ = _frame_noise(key, port["lm"], 4, DEPTH.n_codebook)
    got, h2, pos = _port_chunk(port, chain, 4, noise, h)
    want, jh2 = _jax_chunk(ref, chain, 4, key, h)
    np.testing.assert_array_equal(got, want)
    assert int(pos[0]) == len(PROMPT) + 4
    np.testing.assert_allclose(h2[0].numpy(), jh2, rtol=1e-4, atol=1e-4)


def test_chunk_eos_mid_chunk_matches_jax(eos_files):
    """EOS inside a chunk: n_emitted, stopped and pos_after equal
    codec_tpu's packed meta; the codes up to EOS equal, the rows after it
    zero in the port (unwritten in codec_tpu)."""
    files, frame = eos_files
    model = files["eos"]
    bb_file = model.parent / "bb.gguf"
    port, ref = _engine(model, bb_file, True), _engine(model, bb_file, False)
    _, h = _prefilled(port)
    _prefilled(ref)
    k = frame + 3
    chain = (0.0, 0, 1.0, 0.0)
    noise = np.zeros((k, DEPTH.n_codebook, port["lm"].noise_width()), np.float32)
    got, _, _ = _port_chunk(port, chain, k, noise, h)
    want, _ = _jax_chunk(ref, chain, k, jax.random.PRNGKey(0), h)
    n_cb = DEPTH.n_codebook
    assert list(got[-3:]) == list(want[-3:]) == [frame + 1, 1,
                                                 len(PROMPT) + frame]
    np.testing.assert_array_equal(got[: (frame + 1) * n_cb],
                                  want[: (frame + 1) * n_cb])
    assert not got[(frame + 1) * n_cb: k * n_cb].any()


@pytest.mark.parametrize("name", ["eos", "delay"])
def test_runner_eos_and_delay_flush_match_jax(eos_files, name):
    files, frame = eos_files
    model = files[name]
    bb_file = model.parent / "bb.gguf"
    port, ref = _engine(model, bb_file, True), _engine(model, bb_file, False)
    for chunk in (1, 4):
        got = _run(port, dict(chunk_frames=chunk), max_steps=10)
        want = _run(ref, dict(chunk_frames=chunk), max_steps=10)
        assert got.stopped_by_eos and want.stopped_by_eos
        assert got.n_steps == want.n_steps == frame + 1 + (name == "delay")
        np.testing.assert_array_equal(got.codes, want.codes)
        _assert_close_pcm(got.pcm, want.pcm)


def test_backbone_step_matches_host_step(engines):
    """Two streams at different positions through backbone_step == each
    stream's host step, and the cache rows written at each position (f32
    sums over two rows, in another order than one row's)."""
    port, _ = engines
    bb = port["bb"]
    caches, hs, xs = [], [], []
    for s, ids in enumerate((PROMPT, PROMPT[:3])):
        bb.reset()
        for e in bb.embed_tokens(ids):
            bb.step(e)
        caches.append(bb.kv.clone())
        x = np.random.default_rng(s).standard_normal(BB.hidden).astype(np.float32)
        xs.append(x)
        hs.append(bb.step(x))
        caches[-1] = (caches[-1], bb.kv.clone())
    kv = torch.stack([c[0] for c in caches])
    with torch.inference_mode():
        got = backbone_step(bb.params, kv, torch.tensor([6, 3]),
                            torch.from_numpy(np.stack(xs)), bb.cfg, 64, bb.qmm)
    np.testing.assert_allclose(got.numpy(), np.stack(hs), rtol=1e-5, atol=1e-5)
    for s in range(2):
        torch.testing.assert_close(kv[s], caches[s][1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# batched generation
# ---------------------------------------------------------------------------

def _alms(eng, n):
    cls = AudioLM if eng["port"] else JaxAudioLM
    return [cls(eng["reader"], codec=eng["codec"], lm=eng["lm"])
            for _ in range(n)]


def _batch(eng, prompts, ods, max_steps=6, sampling=None):
    run, cls = ((tts_runner.run_codebook_ar_batch, OnDeviceSampling)
                if eng["port"] else (jax_runner.run_codebook_ar_batch,
                                     jax_sample.OnDeviceSampling))
    bb = eng["bb"]
    embeds = [list(bb.embed_tokens(p)) for p in prompts]
    return run(_alms(eng, len(prompts)), bb, embeds, cls(**ods),
               max_steps=max_steps,
               sampling=None if sampling is None else [cls(**s) for s in sampling])


PROMPTS = [[5, 9, 200, 31], [44, 2, 17, 80, 9, 100], [250, 1, 3]]


def test_batch_greedy_matches_jax_and_single_streams(engines):
    port, ref = engines
    got = _batch(port, PROMPTS, dict(chunk_frames=3))
    want = _batch(ref, PROMPTS, dict(chunk_frames=3))
    for s, p in enumerate(PROMPTS):
        np.testing.assert_array_equal(got[s].codes, want[s].codes)
        one = _run(port, dict(chunk_frames=3), ids=p)
        np.testing.assert_array_equal(got[s].codes, one.codes)
        assert got[s].n_steps == want[s].n_steps == 6
        _assert_close_pcm(got[s].pcm, want[s].pcm)


def test_batch_sampled_matches_single_streams(engines):
    """Stream s of a sampled batch is the single-stream run with seed +
    s; per-stream chains as data give each stream its own chain."""
    port, _ = engines
    ods = dict(SAMPLED, chunk_frames=3, seed=21)
    got = _batch(port, PROMPTS, ods)
    chains = [SAMPLED, dict(), dict(temperature=1.0, top_p=0.8)]
    mixed = _batch(port, PROMPTS, dict(chunk_frames=3, seed=21),
                   sampling=chains)
    for s, p in enumerate(PROMPTS):
        one = _run(port, dict(ods, seed=21 + s), ids=p)
        np.testing.assert_array_equal(got[s].codes, one.codes)
        one = _run(port, dict(chains[s], chunk_frames=3, seed=21 + s), ids=p)
        np.testing.assert_array_equal(mixed[s].codes, one.codes)


def test_batch_staggered_eos_matches_jax(eos_files):
    """The EOS file stops stream 0 at its own frame while the others go
    on: every stream equals codec_tpu's batch and its single-stream run,
    and the batched chunk's packed meta equals codec_tpu's."""
    files, frame = eos_files
    model = files["eos"]
    bb_file = model.parent / "bb.gguf"
    port, ref = _engine(model, bb_file, True), _engine(model, bb_file, False)
    prompts = [PROMPT] + PROMPTS
    got = _batch(port, prompts, dict(chunk_frames=4), max_steps=10)
    want = _batch(ref, prompts, dict(chunk_frames=4), max_steps=10)
    steps = set()
    for s, p in enumerate(prompts):
        np.testing.assert_array_equal(got[s].codes, want[s].codes)
        assert (got[s].n_steps, got[s].stopped_by_eos) == \
            (want[s].n_steps, want[s].stopped_by_eos)
        one = _run(port, dict(chunk_frames=4), ids=p, max_steps=10)
        np.testing.assert_array_equal(got[s].codes, one.codes)
        steps.add(got[s].n_steps)
    assert got[0].stopped_by_eos and got[0].n_steps == frame + 1
    assert len(steps) > 1                  # the streams stop apart


def test_batched_chunk_packed_matches_jax(eos_files):
    files, frame = eos_files
    model = files["eos"]
    bb_file = model.parent / "bb.gguf"
    port, ref = _engine(model, bb_file, True), _engine(model, bb_file, False)
    prompts = [PROMPT, PROMPTS[0]]
    hs, kvs, jkvs, pos = [], [], [], []
    for p in prompts:
        bb, h = _prefilled(port, p)
        hs.append(h)
        kvs.append(bb.kv.clone())
        pos.append(bb.pos)
        jbb, _ = _prefilled(ref, p)
        jkvs.append(jbb.kv)
    k, b = frame + 2, len(prompts)
    lm, bb = port["lm"], port["bb"]
    chunk = fused_gen.build_gen_chunk_batched(lm, bb.cfg, (0.0, 0, 1.0, 0.0),
                                              k)
    done0 = torch.tensor([False, False])
    with torch.inference_mode():
        got, _, _ = chunk(StepGroup(bb), [torch.stack(kvs)], torch.tensor(pos),
                          torch.zeros(b, dtype=torch.long),
                          torch.from_numpy(np.stack(hs)),
                          torch.zeros((k, b, 4, lm.noise_width())),
                          torch.zeros(b, dtype=torch.long),
                          done0, None, 64)
    jfn = jax_fused_gen.gen_chunk_cached(ref["lm"], ref["bb"], n_frames=k,
                                         batched=True)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32))
    want, _, _, _ = jfn(ref["bb"].params, jnp.stack(jkvs),
                        jnp.asarray(pos, jnp.int32), np.int32(0),
                        jnp.asarray(np.stack(hs)), keys,
                        jnp.zeros(b, jnp.int32), jnp.zeros(b, bool))
    got, want = got.numpy(), np.asarray(want)
    meta = k * b * 4
    np.testing.assert_array_equal(got[meta:], want[meta:])
    assert got[meta + 1] == 1                      # stream 0 stopped
    rows, wrows = got[:meta].reshape(k, b, 4), want[:meta].reshape(k, b, 4)
    np.testing.assert_array_equal(rows[: frame + 1, 0], wrows[: frame + 1, 0])
    np.testing.assert_array_equal(rows[:, 1], wrows[:, 1])


def test_batch_rejects_what_jax_rejects(engines):
    port, _ = engines
    lm2 = create_lm(port["reader"], device="cpu")
    alms = [AudioLM(port["reader"], codec=port["codec"], lm=port["lm"]),
            AudioLM(port["reader"], codec=port["codec"], lm=lm2)]
    e = [list(port["bb"].embed_tokens(PROMPT))] * 2
    with pytest.raises(ValueError, match="share one CodecLM"):
        tts_runner.run_codebook_ar_batch(alms, port["bb"], e,
                                         OnDeviceSampling(chunk_frames=2))
    with pytest.raises(ValueError, match="one prompt per stream"):
        tts_runner.run_codebook_ar_batch(alms[:1], port["bb"], e,
                                         OnDeviceSampling(chunk_frames=2))


def test_init_rep_hist_matches_jax(engines):
    port, ref = engines
    ring, ptr = fused_gen.init_rep_hist(port["lm"], 5)
    jring, jptr = jax_fused_gen.init_rep_hist(ref["lm"], 5)
    np.testing.assert_array_equal(ring.numpy(), jring)
    assert ptr == int(jptr)
    np.testing.assert_array_equal(fused_gen.init_rep_hist(port["lm"], -1).numpy(),
                                  jax_fused_gen.init_rep_hist(ref["lm"], -1))


def test_cli_on_device_matches_reference(files, tmp_path, monkeypatch, capsys):
    import os

    from codec_tpu.cli.tts_cli import main as jax_main
    from codec_tpu_torch.cli.tts_cli import main
    from codec_tpu.io.wav import read_wav as jax_read_wav
    from codec_tpu_torch.io.wav import read_wav

    _, model, bb = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "4", "--quant-exec",
            "--on-device", "--chunk-frames", "3", "--temp", "0"]
    assert main(args + ["--out", str(tmp_path / "port.wav"),
                        "--device", "cpu"]) == 0
    assert "backbone AR done: 4 steps" in capsys.readouterr().out
    monkeypatch.delenv("CODEC_QUANT_EXEC", raising=False)
    try:
        assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    finally:
        os.environ.pop("CODEC_QUANT_EXEC", None)
    got, _ = read_wav(tmp_path / "port.wav")
    want, _ = jax_read_wav(tmp_path / "ref.wav")
    assert got.shape == want.shape == (4 * MIMI.hop_size, 1)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
