"""The port's continuous_latent_cfm kind (codec_tpu_torch/lm/
continuous_cfm.py) and the BlueMagpie continuous flow (lm/tts_runner.py::
run_continuous, tts-cli-torch) against codec_tpu on the CPU.

Fixtures: tests/test_continuous_cfm.py's tiny CFM (its TorchCFM tensors,
written with the port's GGUFWriter), and a small BlueMagpie file from the
port's writer (models/lm_tts_init.py: the small AudioVAE of
tests/test_torch_bluemagpie.py with a CFM adaptor, host_arch barbet) over
an f32 llama-style backbone of hidden 64 with the byte-fallback SPM
vocabulary. The same NumPy noise goes to both packages.

Bounds: the schedule and its sinusoids bit for bit; patches and feedback
within 1e-4 x peak, stop flags equal (f32 on both sides; a patch goes
through 5 to 9 Euler steps of two LocDiT passes); PCM corr > 0.9999. The
FSQ round(tanh(x)·9)/9 meets the tanh ulps XLA and torch disagree on
(tests/fsq_ties.py): where a step's FSQ digits differ, each differing
digit must be a near-tie (within 1e-3 of a half in f64 on codec_tpu's
side), and the comparison stops at that step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.cli.tts_cli import main as jax_main
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import continuous_cfm as jcfm
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu_torch.cli.tts_cli import main
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import continuous_cfm as cfm
from codec_tpu_torch.lm import create_lm, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.lm.base import LmError
from codec_tpu_torch.models.bluemagpie_init import BLUEMAGPIE
from codec_tpu_torch.models.lm_init import (byte_fallback_vocab, spm_model_b64,
                                            write_random_backbone_gguf)
from codec_tpu_torch.models.lm_tts_init import (MINICPM4_0_5B, CfmConfig,
                                                write_bluemagpie_tts_gguf)

from test_continuous_cfm import (D, FSQ, HB, HD, HDIM, HE, HV, NH, NKV,
                                 NL_DIT, NL_ENC, NL_RALM, P, TorchCFM)

# the AudioVAE of tests/test_torch_bluemagpie.py (latent 8, hop 6)
BM = dataclasses.replace(BLUEMAGPIE, latent_dim=8, decoder_rates=(2, 3),
                         encoder_rates=(2, 2), decode_hop=6, encode_hop=4)
CFM = CfmConfig(hidden=64, h_vox=32, h_enc=16, h_dit=16, latent_dim=8,
                patch_size=2, n_heads=2, n_kv=1, head_dim=8, n_locenc=1,
                n_locdit=2, n_ralm=2, ffn_mult=2, rope_rows=64)
BB = dataclasses.replace(MINICPM4_0_5B, hidden=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, ffn_dim=128,
                         vocab_size=300, max_ctx=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_continuous_cfm.py's tiny_cfm, both packages."""
    path = tmp_path_factory.mktemp("cfm") / "cfm.gguf"
    w = GGUFWriter(path, "bluemagpie_audiovae")
    w.add_uint32("codec.sample_rate", 48000)
    w.add_bool("codec.has_decoder", True)
    w.add_bool("codec.lm.has_adaptor", True)
    w.add_string("codec.lm.kind", "continuous_latent_cfm")
    for key, val in (("hidden_dim", HB), ("h_vox", HV), ("h_enc", HE),
                     ("h_dit", HD), ("latent_dim", D), ("patch_size", P),
                     ("n_locenc", NL_ENC), ("n_locdit", NL_DIT),
                     ("n_ralm", NL_RALM), ("n_heads", NH), ("n_kv", NKV),
                     ("head_dim", HDIM), ("fsq_scale", FSQ), ("min_len", 0)):
        w.add_uint32(f"codec.lm.{key}", val)
    for name, tensor in TorchCFM().t.items():
        w.add_tensor(name, tensor.numpy())
    w.write()
    return (create_lm(GGUFReader(path), device="cpu"),
            jax_create_lm(JaxReader(str(path))))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bmtts")
    model = write_bluemagpie_tts_gguf(tmp / "bm_tts.gguf", seed=7, cfm=CFM,
                                      codec_cfg=BM, decoder_dim=32)
    bb = write_random_backbone_gguf(tmp / "bb.gguf", seed=8, qtype="F32",
                                    cfg=BB, rope_scaling=None,
                                    spm_b64=spm_model_b64(byte_fallback_vocab()))
    return model, bb


@pytest.fixture(scope="module")
def engines(files):
    model, bb = files
    reader, jreader = GGUFReader(model), JaxReader(str(model))
    port = dict(port=True, reader=reader, lm=create_lm(reader, device="cpu"),
                codec=codec_tpu_torch.load_model(model, device="cpu"),
                bb=LlamaBackbone(bb, device="cpu"))
    ref = dict(port=False, reader=jreader, lm=jax_create_lm(jreader),
               codec=codec_tpu.load_model(str(model)), bb=JaxBackbone(str(bb)))
    return port, ref


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * peak, f"max abs err {err} vs peak {peak}"


def _corr(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.corrcoef(a, b)[0, 1]


def _fsq_same(lm, ref, h) -> bool:
    """True when the step on hidden `h` gives the same FSQ digits in both
    packages; else every differing digit must be a near-tie on codec_tpu's
    side (the comparison then stops)."""
    ht = torch.from_numpy(np.asarray(h, np.float32))
    with torch.inference_mode():
        x = lm._lin(lm.w["fsq_in"], lm._tslm_adapter(ht))
        got = torch.round(torch.tanh(x) * lm.fsq_scale).numpy()
    import jax.numpy as jnp

    rx = ref._lin(ref.w["fsq_in"], ref._tslm_adapter(jnp.asarray(h)))
    v = np.tanh(np.asarray(rx, np.float64)) * ref.fsq_scale
    want = np.asarray(jnp.round(jnp.tanh(rx) * ref.fsq_scale))
    bad = np.flatnonzero(got != want)
    frac = np.abs(v - np.floor(v) - 0.5)
    assert (frac[bad] < 1e-3).all(), f"FSQ digits {bad} differ: not near-ties"
    return not len(bad)


def test_schedule_and_sinusoidal_bit_equal():
    for n in (1, 2, 3, 4, 6, 9, 10, 16, 32):
        (t, dt), (rt, rdt) = cfm.sway_schedule(n), jcfm.sway_schedule(n)
        assert t.dtype == np.float64 and len(t) == len(dt)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(dt, rdt)
        for v in list(t) + [0.0]:
            for dim in (16, 1024):
                np.testing.assert_array_equal(cfm.sinusoidal(v, dim),
                                              jcfm.sinusoidal(v, dim))
    assert len(cfm.sway_schedule(10)[0]) == 9            # the 4% zero-init skip


def test_info_and_params_from_jax(tiny, engines):
    for lm, ref in (tiny, (engines[0]["lm"], engines[1]["lm"])):
        assert dataclasses.asdict(lm.info) == dataclasses.asdict(ref.info)
        for a in ("h_barbet", "h_vox", "h_enc", "h_dit", "n_locenc",
                  "n_locdit", "n_ralm", "n_heads", "n_kv", "head_dim",
                  "fsq_scale", "min_len", "eps", "max_T"):
            assert getattr(lm, a) == getattr(ref, a), a
        want = cfm.params_from_jax(ref.w)
        got_l, want_l = _leaves(lm.w), _leaves(want)
        assert sorted(want) == sorted(lm.w) and len(got_l) == len(want_l) > 40
        for a, b in zip(got_l, want_l):
            assert (a is None and b is None) or torch.equal(a, b)
    assert engines[0]["lm"].info.hidden_dim == CFM.hidden


@pytest.mark.parametrize("prefill", [True, False], ids=["primed", "cold"])
def test_step_generate_matches(tiny, prefill):
    """text_prefill (the primed first step reads its rows) or none, then
    free steps with fixed noise: patches, stop flags, feedback, the RALM
    position."""
    lm, ref = tiny
    rng = np.random.default_rng(0)
    prefix = (rng.standard_normal((3, HB)) * 0.5).astype(np.float32)
    hs = (rng.standard_normal((5, HB)) * 0.5).astype(np.float32)
    noises = rng.standard_normal((5, P, D)).astype(np.float32)
    st, rst = lm.new_state(), ref.new_state()
    if prefill:
        lm.text_prefill(st, prefix)
        ref.text_prefill(rst, prefix)
    compared = 0
    for i in range(5):
        if not (prefill and i == 0) and not _fsq_same(lm, ref, hs[i]):
            break
        patch, stop, fb = lm.step_generate(st, hs[i], cfg_value=2.0,
                                           n_timesteps=6, noise=noises[i])
        rpatch, rstop, rfb = ref.step_generate(rst, hs[i], cfg_value=2.0,
                                               n_timesteps=6, noise=noises[i])
        assert patch.shape == (P, D) and fb.shape == (HB,)
        _close(patch, rpatch)
        _close(fb, rfb)
        np.testing.assert_array_equal(lm.step_feedback_embd(st), fb)
        assert stop == rstop
        assert st.kind_state["kv_pos"] == rst.kind_state["kv_pos"]
        compared += 1
    assert compared >= 4
    assert st.kind_state["kv_pos"] == 3 * prefill + compared - prefill


def test_teacher_forcing_and_min_len(tiny):
    lm, ref = tiny
    rng = np.random.default_rng(1)
    prefix = rng.standard_normal((2, HB)).astype(np.float32)
    teacher = rng.standard_normal((P, D)).astype(np.float32)
    noise = rng.standard_normal((2, P, D)).astype(np.float32)
    h = (rng.standard_normal(HB) * 0.5).astype(np.float32)
    outs = []
    for m in (lm, ref):
        st = m.new_state()
        m.text_prefill(st, prefix)
        m.set_teacher_patch(st, teacher)
        m.set_min_len(st, 5)
        a = m.step_generate(st, h, noise=noise[0], n_timesteps=4)
        np.testing.assert_array_equal(np.asarray(st.kind_state["prev_patch"]),
                                      teacher)
        b = m.step_generate(st, h, noise=noise[1], n_timesteps=4)
        assert not a[1] and not b[1]                 # under min_len
        outs.append((a, b))
    (a, b), (ra, rb) = outs
    _close(a[0], ra[0])
    _close(a[2], ra[2])          # the feedback of the teacher patch
    assert _fsq_same(lm, ref, h)
    _close(b[0], rb[0])
    _close(b[2], rb[2])


def test_errors(tiny, engines):
    lm, _ = tiny
    st = lm.new_state()
    st.kind_state["kv_pos"] = lm.max_T
    with pytest.raises(LmError, match="KV cache full"):
        lm.step_generate(st, np.zeros(HB, np.float32))
    with pytest.raises(LmError, match="exceeds RALM KV capacity"):
        lm.text_prefill(lm.new_state(), np.zeros((lm.max_T + 1, HB), np.float32))
    port = engines[0]
    alm = AudioLM(port["reader"], codec=port["codec"], lm=port["lm"])
    # a backbone with only the host step cannot be chained: chunk_steps
    # then runs one step a call
    port["bb"].reset()
    one = tts_runner.run_continuous(alm, _Rec(port["bb"]),
                                    [np.zeros(CFM.hidden)], max_steps=3,
                                    min_len=3, chunk_steps=4, decode=False)
    port["bb"].reset()
    want = tts_runner.run_continuous(alm, port["bb"], [np.zeros(CFM.hidden)],
                                     max_steps=3, min_len=3, decode=False)
    np.testing.assert_array_equal(one.codes, want.codes)
    with pytest.raises(LmError, match="continuous kinds"):
        alm.state.step_is_eos([1])


class _Rec:
    """A backbone that records the hiddens it returns."""

    def __init__(self, bb):
        self.bb, self.hs = bb, []

    def step(self, e):
        h = self.bb.step(e)
        self.hs.append(np.asarray(h, np.float32))
        return h


def _continuous(eng, ids, **kw):
    alm_cls, run = ((AudioLM, tts_runner.run_continuous) if eng["port"]
                    else (JaxAudioLM, jax_runner.run_continuous))
    eng["bb"].reset()
    alm = alm_cls(eng["reader"], codec=eng["codec"], lm=eng["lm"])
    alm.set_continuous_params(n_timesteps=kw.pop("timesteps", 10))
    # the chunk needs the backbone itself (its hiddens are not recorded)
    rec = _Rec(eng["bb"]) if kw.get("chunk_steps", 1) == 1 else eng["bb"]
    res = run(alm, rec, list(eng["bb"].embed_tokens(ids)), **kw)
    eng["last_state"] = alm.state.kind_state
    return res, getattr(rec, "hs", None)


@pytest.mark.parametrize("case", ["guarded", "stop_head"])
def test_run_continuous_matches(engines, case):
    """run_continuous end to end through the AudioVAE decode: latents
    patch by patch (FSQ near-tie rule on the recorded hiddens), steps,
    the stop, and the PCM."""
    port, ref = engines
    ids = list(np.random.default_rng(9).integers(0, BB.vocab_size, 6))
    kw = dict(max_steps=8, timesteps=6,
              min_len=8 if case == "guarded" else -1)
    got, hs = _continuous(port, ids, **dict(kw))
    want, _ = _continuous(ref, ids, **dict(kw))
    # the steps before the first FSQ near-tie (the hidden of step k is the
    # backbone's k-th output from the prompt's last row on)
    steps = min(got.n_steps, want.n_steps)
    tie = next((k for k, h in enumerate(hs[len(ids) - 1:][:steps])
                if not _fsq_same(port["lm"], ref["lm"], h)), None)
    rows = (steps if tie is None else tie) * CFM.patch_size
    _close(got.codes[:rows], want.codes[:rows])
    if tie is not None:
        return
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps, want.stopped_by_eos)
    if case == "guarded":
        assert got.n_steps == 8 and not got.stopped_by_eos
    assert got.codes.shape == (got.n_steps * CFM.patch_size, CFM.latent_dim)
    assert got.pcm.shape == want.pcm.shape == (got.codes.shape[0] * 6,)
    assert _corr(got.pcm, want.pcm) > 0.9999


@pytest.mark.parametrize("case", ["guarded", "stop_head"])
def test_chunk_equals_single_steps_and_codec_tpu(engines, case):
    """run_continuous(chunk_steps=4) (the first step per step, then chunks
    of K = 4 steps, eagerly on the CPU) against the port's single steps
    with the same noise (bit for bit) and codec_tpu's chunked run
    (build_continuous_chunk): latents, steps, the stop (the stop head's
    stop lands inside a chunk), and the state after it."""
    port, ref = engines
    ids = list(np.random.default_rng(9).integers(0, BB.vocab_size, 6))
    kw = dict(max_steps=9, timesteps=6,
              min_len=9 if case == "guarded" else -1)
    one, hs = _continuous(port, ids, **dict(kw))
    st_one = port["last_state"]
    got, _ = _continuous(port, ids, chunk_steps=4, **dict(kw))
    st_got = port["last_state"]
    want, _ = _continuous(ref, ids, chunk_steps=4, **dict(kw))
    np.testing.assert_array_equal(got.codes, one.codes)
    assert (got.n_steps, got.stopped_by_eos) == (one.n_steps,
                                                 one.stopped_by_eos)
    for key in ("kv_pos", "patch_index"):
        assert st_got[key] == st_one[key]
    np.testing.assert_array_equal(st_got["fb_tslm"], st_one["fb_tslm"])
    for key in ("prev_patch", "prev_fb_lm"):
        assert torch.equal(st_got[key], st_one[key]), key
    # the RALM cache up to the position (the held steps after a stop write
    # the next slot, which nothing reads)
    n = st_one["kv_pos"]
    assert torch.equal(st_got["kv"][..., :n, :], st_one["kv"][..., :n, :])
    steps = min(got.n_steps, want.n_steps)
    tie = next((k for k, h in enumerate(hs[len(ids) - 1:][:steps])
                if not _fsq_same(port["lm"], ref["lm"], h)), None)
    rows = (steps if tie is None else tie) * CFM.patch_size
    _close(got.codes[:rows], want.codes[:rows])
    if tie is None:
        assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                     want.stopped_by_eos)
    if case == "guarded":
        assert got.n_steps == 9 and not got.stopped_by_eos
    else:
        assert got.stopped_by_eos and (got.n_steps - 1) % 4 != 0


def test_chunk_runner_packed_layout(engines):
    """One chunk of K = 4 from a state after its first step: codec_tpu's
    packed layout (patches, the last step's fb_tslm, [n_emitted, stopped,
    pos_after]), n_emitted = 4 without a stop, the runner's buffers
    advanced in place, and a second runner of the same key the same
    object."""
    from codec_tpu_torch.lm.fused_gen import continuous_chunk_cached

    port, _ = engines
    lm, bb = port["lm"], port["bb"]
    bb.reset()
    alm = AudioLM(port["reader"], codec=port["codec"], lm=lm)
    alm.set_continuous_params(n_timesteps=4)
    h = None
    for e in bb.embed_tokens([5, 9, 11]):
        h = bb.step(e)
    lm.set_min_len(alm.state, 100)
    alm.observe_hidden(h)
    h = bb.step(alm.next_embed)
    kw = dict(n_steps=4, n_timesteps=4, cfg_value=2.0, ctx=64)
    runner = continuous_chunk_cached(lm, bb, **kw)
    assert continuous_chunk_cached(lm, bb, **kw) is runner
    ks = alm.state.kind_state
    runner.load(ks, h, bb.pos, 100)
    rng = np.random.default_rng(3)
    runner.noise.copy_(torch.from_numpy(rng.standard_normal(
        (4, CFM.patch_size, CFM.latent_dim)).astype(np.float32)))
    arr = runner.run().numpy()
    pd = CFM.patch_size * CFM.latent_dim
    assert arr.shape == (4 * pd + CFM.hidden + 3,)
    assert list(arr[-3:]) == [4, 0, bb.pos + 4]
    assert int(runner.kv_pos[0]) == ks["kv_pos"] + 4
    assert int(runner.patch_index[0]) == ks["patch_index"] + 4
    np.testing.assert_array_equal(runner.prev_patch.numpy().ravel(),
                                  arr[3 * pd: 4 * pd])


def test_cli_synthesize_matches_reference(files, tmp_path, capsys):
    """tts-cli-torch synthesize on the BlueMagpie file with --min-len and
    --timesteps, against codec_tpu's CLI; --on-device (the continuous
    chunk) gives the same PCM."""
    model, bb = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "5", "--min-len", "5",
            "--timesteps", "4"]
    assert main(args + ["--out", str(tmp_path / "port.wav"), "--device",
                        "cpu"]) == 0
    assert "continuous AR done: 5 steps" in capsys.readouterr().out
    assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    got, sr = read_wav(tmp_path / "port.wav")
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    assert sr == jsr == 48000 and got.shape == want.shape == (5 * 2 * 6, 1)
    assert _corr(got, want) > 0.9999
    assert main(args + ["--out", str(tmp_path / "x.wav"), "--device", "cpu",
                        "--on-device", "--chunk-frames", "2"]) == 0
    assert "continuous AR done: 5 steps" in capsys.readouterr().out
    dev, _ = read_wav(tmp_path / "x.wav")
    np.testing.assert_array_equal(dev, got)
