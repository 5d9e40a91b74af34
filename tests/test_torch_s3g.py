"""The port's Chatterbox S3Gen (codec_tpu_torch.models.chatterbox_s3g)
against codec_tpu's on the CPU: a small random GGUF from the port's writer
(models/s3g_init.py) at the widths of tests/test_chatterbox_s3g_parity.py's
Mirror (8 mels, speaker 12, conformer 32 wide in 2 heads of 16, 2 + 1
layers, CFM 24 channels, time embedding 48, 2 mid stages of 1
transformer, HiFT 16 → 8 → 4 → 2, a 2-token prompt), loaded by both
packages, the same NumPy inputs from a seed.

Tolerances, f32 against f32: mish, espnet_rel_pos_emb and sdpa_rel_pos
1e-5 relative; the flow encoder, one CFM estimator call and HiFT 1e-4 ×
peak; the whole decode corr > 0.99999 and max abs err ≤ 1e-4 × peak (the
10 Euler steps and exp() in the head leave about 1e-6 × peak here). The
NSF phase is summed in float64 in the port, in float32 in codec_tpu: at
these lengths (under 10 000 samples) the two agree to rounding.
codec_tpu's 16-bit S3Gen raises (a float32 time embedding meets 16-bit
conv weights), so the port's bf16 and f16 decodes are held to its own f32
decode (corr > 0.999).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import chatterbox_s3g as js3g
from codec_tpu.ops import act as jact
from codec_tpu.ops import attn as jattn
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFWriter
from codec_tpu_torch.models import chatterbox_s3g as s3g
from codec_tpu_torch.models.s3g_init import S3G, write_random_s3g_gguf
from codec_tpu_torch.ops import act, attn

SMALL = dataclasses.replace(S3G, mel_dim=8, spk_dim=12, enc_hidden=32,
                            attn_heads=2, attn_head_dim=16, enc_layers=2,
                            enc_up_layers=1, cfm_mid_blocks=2,
                            cfm_transformers=1)
WIDTHS = dict(ff=64, cfm_ch=24, ted=48, cfm_ff=64, hift_ch=(16, 8, 4, 2),
              prompt_tokens=2)
V = 6561


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("s3g") / "s3g.gguf"
    write_random_s3g_gguf(path, seed=0, cfg=SMALL, **WIDTHS)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _held(got, want, rel=1e-4):
    """max abs err <= rel x peak."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(want).all()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * peak, (
        np.abs(got - want).max(), peak)


def _decode_held(got, want):
    """ROADMAP's decode gate: corr > 0.99999, max abs err <= 1e-4 x peak."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.corrcoef(got, want)[0, 1] > 0.99999
    _held(got, want)


def _speech(n, seed):
    return np.random.default_rng(seed).integers(0, V, (n, 1)).astype(np.int32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == j.arch == "chatterbox_s3g"
    assert p.cfg == s3g.S3GConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size",
              "latent_dim", "has_encoder", "has_decoder", "causal_time",
              "prompt_token_len", "prompt_feat_frames"):
        assert getattr(p, a) == getattr(j, a), a
    np.testing.assert_array_equal(p.prompt_token, j.prompt_token)
    assert p.prompt_feat_frames == 4 and not p.has_encoder


def test_load_matches_params_from_jax(tiny):
    got = _leaves(tiny["port"].params)
    want = _leaves(s3g.params_from_jax(tiny["jax"].params))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mish_matches_jax():
    x = np.concatenate([_randn(1000, 1, 3.0),
                        np.array([-100., -30., -1e-3, 0., 1e-3, 15., 30.,
                                  100.], np.float32)])
    got = act.mish(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jact.mish)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("t,d", [(1, 32), (7, 32), (60, 64)])
def test_espnet_rel_pos_emb_matches_jax(t, d):
    got = attn.espnet_rel_pos_emb(t, d).numpy()
    want = np.asarray(jattn.espnet_rel_pos_emb(t, d))
    assert got.shape == want.shape == (2 * t - 1, d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # row t-1 is relative position 0: sin 0, cos 1 interleaved
    np.testing.assert_array_equal(got[t - 1], np.tile([0.0, 1.0], d // 2))


@pytest.mark.parametrize("b,h,t,d", [(1, 2, 9, 16), (2, 3, 17, 8)])
def test_sdpa_rel_pos_matches_jax(b, h, t, d):
    q, k, v = (_randn((b, h, t, d), s) for s in (1, 2, 3))
    p = _randn((1, h, 2 * t - 1, d), 4)
    u, w = _randn((h, d), 5, 0.3), _randn((h, d), 6, 0.3)
    got = attn.sdpa_rel_pos(*(torch.from_numpy(a) for a in (q, k, v, p, u,
                                                              w))).numpy()
    want = np.asarray(jattn.sdpa_rel_pos(*(jnp.asarray(a) for a in (
        q, k, v, p, u, w))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_flow_encoder_matches_jax(tiny):
    j, p = tiny["jax"], tiny["port"]
    tok = np.random.default_rng(7).integers(0, V, (2, 6)).astype(np.int32)
    got = s3g.s3g_flow_encode_fn(p.params, torch.from_numpy(
        tok.astype(np.int64)), p.cfg).numpy()
    want = jax.jit(js3g.s3g_flow_encode_fn, static_argnums=(2,))(
        j.params, jnp.asarray(tok), j.cfg)
    assert got.shape == (2, 12, SMALL.mel_dim)
    _held(got, want)


def test_cfm_estimator_matches_jax(tiny):
    j, p = tiny["jax"], tiny["port"]
    x, mu, cond = (_randn((2, 11, SMALL.mel_dim), s) for s in (8, 9, 10))
    spks = _randn((2, SMALL.mel_dim), 11)
    t_v = np.float32(0.4)
    got_te = s3g._cfm_time_emb(p.params, float(t_v), 4 * SMALL.mel_dim,
                               1000.0)
    want_te = js3g._cfm_time_emb(j.params, jnp.asarray(t_v),
                                 4 * SMALL.mel_dim, 1000.0)
    _held(got_te.numpy(), want_te, rel=1e-5)
    got = s3g.s3g_cfm_estimator_fn(p.params, *(torch.from_numpy(a) for a in (
        x, mu, spks, cond)), got_te, p.cfg).numpy()
    want = jax.jit(js3g.s3g_cfm_estimator_fn, static_argnums=(6,))(
        j.params, *(jnp.asarray(a) for a in (x, mu, spks, cond)), want_te,
        j.cfg)
    assert got.shape == x.shape
    _held(got, want)


def test_hift_matches_jax(tiny):
    """HiFT on a given mel with given NSF phases and noise."""
    j, p = tiny["jax"], tiny["port"]
    mel = _randn((1, 9, SMALL.mel_dim), 12, 2.0)
    phase = np.concatenate([[0.0], np.random.default_rng(13).uniform(
        -np.pi, np.pi, 8)]).astype(np.float32)
    noise = _randn((1, 9 * 480, 9), 14)
    got = s3g.s3g_hift_fn(p.params, *(torch.from_numpy(a) for a in (
        mel, phase, noise)), p.cfg).numpy()
    want = jax.jit(js3g.s3g_hift_fn, static_argnums=(4,))(
        j.params, *(jnp.asarray(a) for a in (mel, phase, noise)), j.cfg)
    assert got.shape == (1, 9 * 480) and np.abs(got).max() > 0
    _held(got, want)


def test_source_stft_pads_with_zeros_not_reflection(tiny):
    s = _randn((1, 40), 15)
    win = s3g._hann("cpu")
    got = s3g._source_stft(torch.from_numpy(s), win).numpy()
    want = js3g._source_stft(jnp.asarray(s), jnp.asarray(win.numpy()))
    assert got.shape == (1, 40 // 4 + 1, 18)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,form", [(4, "t1"), (9, "t"), (6, "1t1")])
def test_decode_matches_jax(tiny, n, form):
    codes = _speech(n, 20 + n)
    if form == "t":
        codes = codes[:, 0]
    elif form == "1t1":
        codes = codes[None]
    got, want = tiny["port"].decode(codes), tiny["jax"].decode(codes)
    assert got.shape == ((2 * (2 + n) - 4) * 480,)
    _decode_held(got, want)
    assert np.all(got[:480] == 0.0)                # the trim: 20 ms of zeros


def test_decode_drops_out_of_range_ids_and_i16(tiny):
    codes = np.array([[-1], [5], [6561], [77], [9000], [3]], np.int32)
    p, j = tiny["port"], tiny["jax"]
    got = p.decode(codes)
    _decode_held(got, j.decode(codes))
    np.testing.assert_array_equal(got, p.decode(codes[[1, 3, 5]]))
    i16 = p.decode(codes, pcm_format="i16")
    want16 = j.decode(codes, pcm_format="i16")
    assert i16.dtype == np.int16 and i16.shape == want16.shape
    assert np.abs(i16.astype(np.int32) - want16.astype(np.int32)).max() <= 1


def _kv_only(path, **flags):
    wr = GGUFWriter(path, "chatterbox_s3g")
    for k, v in flags.items():
        wr.add_bool(f"chatterbox_s3g.{k}", v)
    wr.write()


def test_errors_match_jax(tiny, tmp_path):
    p, j = tiny["port"], tiny["jax"]
    for name, flags, msg in (
            ("mf", dict(meanflow=True, has_builtin_conditioning=True),
             "meanflow"),
            ("nc", dict(has_builtin_conditioning=False), "builtin")):
        _kv_only(tmp_path / f"{name}.gguf", **flags)
        with pytest.raises(CodecError, match=msg):
            codec_tpu_torch.load_model(tmp_path / f"{name}.gguf",
                                       device="cpu")
        with pytest.raises(ValueError, match=msg):
            codec_tpu.load_model(tmp_path / f"{name}.gguf")
    for attr, val, codes, msg in (
            ("prompt_token_len", 0, np.zeros((0, 1), np.int32),
             "empty token sequence"),
            ("prompt_feat_frames", 20, _speech(3, 1),
             "prompt_feat_frames exceeds")):
        for m, err in ((p, CodecError), (j, ValueError)):
            keep = getattr(m, attr)
            setattr(m, attr, val)
            try:
                with pytest.raises(err, match=msg):
                    m.decode(codes)
            finally:
                setattr(m, attr, keep)
    # the prompt alone: no speech frames, an empty PCM on both
    assert p.decode(np.zeros((0, 1), np.int32)).shape == \
        j.decode(np.zeros((0, 1), np.int32)).shape == (0,)
    # a batch of two rows: codec_tpu runs them as one sequence, the port
    # raises
    two = np.stack([_speech(3, 2), _speech(3, 3)])
    with pytest.raises(CodecError, match="batch of 2"):
        p.decode(two)
    assert j.decode(two).shape == ((2 * (2 + 6) - 4) * 480,)


def test_decode_async_and_many_raise_as_jax(tiny):
    """S3Gen overrides decode only: decode_async and decode_many reach the
    base class's _decode_impl, which raises NotImplementedError in both
    packages."""
    codes = _speech(3, 4)
    for m in (tiny["port"], tiny["jax"]):
        with pytest.raises(NotImplementedError):
            m.decode_async(codes)
        with pytest.raises(NotImplementedError):
            m.decode_many([codes])


def test_aliases_match_jax():
    from codec_tpu.models.registry import get_model_class as jget
    from codec_tpu_torch.models.registry import get_model_class, known_archs

    for alias in ("chatterbox_s3g", "chatterbox-s3g", "s3g"):
        assert get_model_class(alias) is s3g.ChatterboxS3G
        assert jget(alias).__name__ == "ChatterboxS3G"
        assert alias in known_archs()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_decode(tiny, dtype):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype=dtype,
                                     device="cpu")
    assert p16.params["md"][0]["t"][0]["q_w"].dtype == getattr(torch, dtype)
    codes = _speech(5, 30)
    got, want = p16.decode(codes), tiny["port"].decode(codes)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.999
    with pytest.raises(TypeError, match="same dtypes"):
        codec_tpu.load_model(tiny["path"], compute_dtype=dtype).decode(codes)


def test_cli_decode_matches_jax(tiny, tmp_path):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav

    np.save(tmp_path / "c.npy", _speech(5, 40))
    for tag, fn, extra in (("p", main, ["--device", "cpu"]), ("j", jmain, [])):
        assert fn(["decode", "--model", str(tiny["path"]), "--codes",
                   str(tmp_path / "c.npy"), "--out",
                   str(tmp_path / f"{tag}.wav"), *extra]) == 0
    (x, sr_p), (y, sr_j) = (read_wav(tmp_path / f"{t}.wav", keep_i16=True)
                            for t in "pj")
    assert sr_p == sr_j == 24000 and x.shape == y.shape == (
        (2 * 7 - 4) * 480, 1)
    assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1


def test_nsf_phase_sums_in_float64():
    """θ = 2π·cumsum over 480 000 samples (20 s): the port's float64 sum,
    rounded once, is within half a float32 ulp of the exact sum; a
    float32 running sum is off by far more."""
    f = np.random.default_rng(16).uniform(0.0, 0.05, (1, 480000, 1))
    f = f.astype(np.float32)
    exact = 2.0 * math.pi * np.cumsum(f.astype(np.float64), axis=1)
    got = s3g.nsf_phase(torch.from_numpy(f)).numpy()
    assert got.dtype == np.float32
    assert np.all(np.abs(got - exact) <= np.spacing(got) / 2 + 1e-9)
    f32 = (2.0 * np.float32(math.pi) * np.cumsum(f, axis=1)).astype(
        np.float32)
    assert np.abs(f32 - exact).max() > 10 * np.abs(got - exact).max()


# ---------------------------------------------------------------------------
# Full width (FULL_S3G) against codec_tpu: a 10 s prompt and 1 s of speech

@pytest.mark.slow
def test_fullsize_decode_matches_jax(tmp_path):
    path = tmp_path / "s3g_full.gguf"
    write_random_s3g_gguf(path, seed=0)
    codes = _speech(25, 50)
    got = codec_tpu_torch.load_model(path, device="cpu").decode(codes)
    want = codec_tpu.load_model(path).decode(codes)
    assert got.shape == (50 * 480,)
    _decode_held(got, want)
