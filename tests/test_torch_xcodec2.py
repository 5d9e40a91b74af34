"""The port's XCodec2 (codec_tpu_torch.models.xcodec2) and its new ops
(ops/alias_act.py, ops/attn.py::sdpa_rel_key) against codec_tpu's on the
CPU: small random GGUFs from the port's writer (models/xcodec2_init.py;
tests/test_xcodec2_parity.py's small widths, encoder and decoder in one
file), loaded by both packages, the same codes and PCM from a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. Encode codes
equal, or differing only in FSQ digits at a rounding boundary
(tests/fsq_ties.py).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import xcodec2 as jx2
from codec_tpu.ops import alias_act as jalias
from codec_tpu.ops import attn as jattn
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import neucodec as neu
from codec_tpu_torch.models import xcodec2 as x2
from codec_tpu_torch.models.xcodec2_init import (XCODEC2, kaiser_sinc_filter,
                                                 write_random_x2_gguf)
from codec_tpu_torch.ops import alias_act, attn
from fsq_ties import assert_fsq_codes, digits

# the decoder of tests/test_neucodec_parity.py (hidden 32, vq 24, 2 layers
# of 2 heads x 16, MLP 64) at XCodec2's hop 320 with n_fft 640; the
# encoder of tests/test_xcodec2_parity.py: BigCodec ngf 2 (→ 64 → 32), two
# conformer layers of 32 (2 heads x 16, FFN 64, relative keys 4 / 2,
# depthwise k7), 8 mels x stride 2 (n_fft 64, window 64, hop 160)
DEC = dataclasses.replace(XCODEC2, vq_dim=24, hidden_dim=32, num_layers=2,
                          num_heads=2, head_dim=16)
ENC = x2.X2EncConfig(w2v_layers=2, w2v_hidden=32, w2v_heads=2,
                     w2v_head_dim=16, w2v_left_max=4, w2v_right_max=2,
                     w2v_dw_kernel=7, w2v_input_dim=16, mel_n_fft=64,
                     mel_win=64, mel_hop=160, mel_n_mels=8, mel_stride=2)
N_FFT, MLP, HOP = 640, 64, 320
V = 4 ** 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, encoder=True, **widths):
    write_random_x2_gguf(path, seed=0, cfg=DEC, n_fft=N_FFT, mlp=MLP,
                         encoder=encoder, enc_cfg=ENC,
                         **({"ngf": 2, "w2v_ffn": 64, **widths} if encoder
                            else {}))
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("x2") / "x2.gguf")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _held(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _pcm(n, seed, batch=None, scale=0.3):
    shape = (n,) if batch is None else (batch, n)
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == j.arch == "xcodec2"
    assert p.cfg == neu.NeuConfig(**vars(j.cfg)) == DEC
    assert p.enc_cfg == x2.X2EncConfig(**vars(j.enc_cfg))
    for a in ("sample_rate", "encode_sample_rate", "hop_size", "n_q",
              "codebook_size", "latent_dim", "has_encoder", "has_decoder",
              "causal_time"):
        assert getattr(p, a) == getattr(j, a), a
    assert (p.sample_rate, p.encode_sample_rate, p.latent_dim) == (16000,
                                                                   16000, 32)
    np.testing.assert_array_equal(p._mel_filters, j._mel_filters)
    np.testing.assert_array_equal(p._mel_window, j._mel_window)


def test_load_matches_params_from_jax(tiny):
    j, p = tiny["jax"], tiny["port"]
    for want, got in ((neu.params_from_jax(j.params), p.params),
                      (x2.params_from_jax(j.enc_params), p.enc_params)):
        assert sorted(want) == sorted(got)
        flat_w, flat_g = _leaves(want), _leaves(got)
        assert len(flat_w) == len(flat_g) > 30
        for a, b in zip(flat_w, flat_g):
            assert (a is None and b is None) or torch.equal(a, b)
    enc = p.enc_params
    assert enc["enc_blocks"][4]["down_w"].shape == (64, 32, 10)
    assert enc["w2v_layers"][0]["dw_w"].shape == (32, 1, 7)
    assert enc["alias_up"].shape == (2, 7)


def test_filter_is_bigvgans():
    """The writer's FIR: BigVGAN's 12-tap Kaiser sinc (symmetric, sum 1,
    its beta for half-width 0.3)."""
    k = kaiser_sinc_filter()
    assert k.shape == (12,) and np.allclose(k, k[::-1])
    assert abs(k.sum() - 1) < 1e-6
    t = np.arange(-6, 6) + 0.5
    want = np.kaiser(12, 0.1102 * (2.285 * 5 * np.pi * 1.2 + 7.95 - 8.7)) \
        * 0.5 * np.sinc(0.5 * t)
    np.testing.assert_allclose(k, want / want.sum(), rtol=1e-6)


@pytest.mark.parametrize("t", [1, 4, 25])
def test_decode_matches_jax(tiny, t):
    codes = _codes((t, 1), t)
    got, want = tiny["port"].decode(codes), tiny["jax"].decode(codes)
    assert got.shape == want.shape == (HOP * t,)
    _held(got, want)


def test_batched_clipped_and_async_decodes(tiny):
    p = tiny["port"]
    codes = _codes((2, 7, 1), 3)
    codes[0, 0, 0], codes[1, 5, 0] = -2, V + 99
    got = p.decode(codes)
    _held(got, tiny["jax"].decode(codes))
    np.testing.assert_array_equal(p.decode_async(codes).result(), got)
    for o, s in zip(p.decode_many([codes[0], codes[1], codes[1, :4]]),
                    (codes[0], codes[1], codes[1, :4])):
        np.testing.assert_allclose(o, p.decode(s), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_decode_matches_jax(tiny, dtype):
    """bf16 and f16 decodes at corr > 0.99 against codec_tpu's f32 decode
    (its own 16-bit decode of the NeuCodec decoder raises: ROADMAP Queue
    3) and the port's f32."""
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype=dtype,
                                     device="cpu")
    assert p16.enc_params["w2v_layers"][0]["q_w"].dtype == getattr(torch,
                                                                  dtype)
    codes = _codes((2, 9, 1), 5)
    got, want = p16.decode(codes), tiny["jax"].decode(codes)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    assert np.corrcoef(got.ravel(), tiny["port"].decode(codes).ravel()
                       )[0, 1] > 0.99


@pytest.mark.parametrize("t", [1, 2, 7, 8, 33, 64])
@pytest.mark.parametrize("symmetric", [True, False])
def test_alias_free_snake_beta_matches_jax(t, symmetric):
    """The polyphase up step against codec_tpu's zero-stuffed correlation,
    at odd and even lengths, also with a filter that is not symmetric
    (where a flipped tap would show)."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    a = (rng.standard_normal(5) * 0.2 + 1).astype(np.float32)
    ib = (rng.standard_normal(5) * 0.1 + 1).astype(np.float32)
    k = (kaiser_sinc_filter() if symmetric
         else rng.standard_normal(12).astype(np.float32) * 0.3)
    want = np.asarray(jalias.alias_free_snake_beta(_j(x), _j(a), _j(ib),
                                                   _j(k)))
    got = alias_act.alias_free_snake_beta(_t(x), _t(a), _t(ib), _t(k))
    assert got.shape == want.shape == (2, t, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_snake_beta_inv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4)).astype(np.float32) * 3
    a = np.array([1.0, 0.0, -0.5, 2.0], np.float32)       # clamped at 1e-9
    ib = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jalias.snake_beta_inv(_j(x), _j(a), _j(ib)))
    np.testing.assert_allclose(
        alias_act.snake_beta_inv(_t(x), _t(a), _t(ib)).numpy(), want,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,left,right", [(9, 4, 2), (3, 4, 2), (1, 4, 2),
                                          (80, 64, 8)])
def test_sdpa_rel_key_matches_jax(t, left, right):
    """Gathered q·Eᵀ scores against codec_tpu's [T, T, D] gather, with T
    shorter and longer than the clamp range."""
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((2, 3, t, 16)).astype(np.float32)
               for _ in range(3))
    e = rng.standard_normal((left + right + 1, 16)).astype(np.float32)
    want = np.asarray(jattn.sdpa_rel_key(_j(q), _j(k), _j(v), _j(e), left,
                                         right))
    got = attn.sdpa_rel_key(_t(q), _t(k), _t(v), _t(e), left, right)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _boundary_latent(n, seed):
    """Latents whose twice-bounded value lies within ~1e-7 of a rounding
    boundary (−1.5, −0.5, 0.5; 1.5 lies outside the bound's range)."""
    half_l = 3.0 * (1 + 1e-3) / 2.0
    shift = math.atanh(0.5 / half_l)
    inv = lambda y: np.arctanh((y + 0.5) / half_l) - shift   # noqa: E731
    b = np.random.default_rng(seed).choice([-1.5, -0.5, 0.5], (n, 8))
    return inv(inv(b)).astype(np.float32)


def test_fsq_quantize_matches_jax():
    """Random latents over every level: codes bit for bit. Latents placed
    on a rounding boundary: XLA's f32 tanh and torch's differ by an ulp on
    about half of all inputs, so there each digit must equal codec_tpu's
    wherever the two f32 bounded values are equal (the same rounding, half
    to even), and may differ only where they are not and lie within 1e-6
    of the half. Exact halves round as jnp.round does."""
    z = np.random.default_rng(2).standard_normal((500, 8)).astype(
        np.float32) * 2
    want = np.asarray(jx2.fsq_quantize_x2(_j(z), 8))
    got = x2.fsq_quantize_x2(_t(z), 8).numpy()
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 400
    zb = _boundary_latent(300, 3)
    gd = digits(x2.fsq_quantize_x2(_t(zb), 8).numpy())
    wd = digits(np.asarray(jx2.fsq_quantize_x2(_j(zb), 8)))
    pb, jb = x2.fsq_bounded(_t(zb)).numpy(), _jax_bounded(zb)
    assert (pb == jb).mean() > 0.2
    np.testing.assert_array_equal(gd[pb == jb], wd[pb == jb])
    off = gd != wd
    assert off.any()
    near = np.abs(jb - np.floor(jb) - 0.5)
    assert (near[off] < 1e-6).all()
    halves = np.array([-1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(halves)).numpy(),
                                  np.asarray(jnp.round(_j(halves))))


def _jax_bounded(z):
    half_l = (jx2.FSQ_LEVEL - 1) * (1.0 + 1e-3) / 2.0
    shift = math.atanh(0.5 / half_l)

    def bound(x):
        return half_l * jnp.tanh(x + shift) - 0.5

    return np.asarray(bound(bound(_j(z))))


def test_conformer_layer_matches_jax(tiny):
    lw = tiny["port"].enc_params["w2v_layers"][1]
    jl = tiny["jax"].enc_params["w2v_layers"][1]
    x = _pcm(2 * 23 * 32, 4, scale=1.0).reshape(2, 23, 32)
    want = np.asarray(jx2._conformer_layer(_j(x), jl, tiny["jax"].enc_cfg))
    with torch.inference_mode():
        got = x2._conformer_layer(_t(x), lw, tiny["port"].enc_cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [3200, 3517, 640])
def test_acoustic_matches_jax(tiny, n):
    pcm = _pcm(n, n, batch=2)
    want = np.asarray(jx2.x2_acoustic_fn(tiny["jax"].enc_params, _j(pcm)))
    with torch.inference_mode():
        got = x2.x2_acoustic_fn(tiny["port"].enc_params, _t(pcm)).numpy()
    assert got.shape == want.shape and want.shape[1] >= n // HOP
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_semantic_matches_jax(tiny):
    """The host mel (the port's dsp copy) equals codec_tpu's bit for bit;
    the conformer stack and the semantic convs on it."""
    from codec_tpu.dsp.audio import w2v_bert_features

    j, pcm = tiny["jax"], _pcm(3200, 5)
    mel = tiny["port"].mel(pcm)[None]
    ec = j.enc_cfg
    np.testing.assert_array_equal(mel[0], w2v_bert_features(
        pcm, n_mels=ec.mel_n_mels, n_fft=ec.mel_n_fft, win=ec.mel_win,
        hop=ec.mel_hop, sr=j.encode_sample_rate,
        preemphasis=ec.mel_preemphasis, mel_floor=ec.mel_floor,
        stride=ec.mel_stride, mel_filters=j._mel_filters,
        window=j._mel_window))
    want = np.asarray(jx2.x2_semantic_fn(tiny["jax"].enc_params, _j(mel),
                                         tiny["jax"].enc_cfg))
    with torch.inference_mode():
        got = x2.x2_semantic_fn(tiny["port"].enc_params, _t(mel),
                                tiny["port"].enc_cfg).numpy()
    assert got.shape == want.shape == (1, 10, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _latent(model, row):
    """The port's f32 latent (before the bound) of one encode row."""
    mel = model.mel(row)
    n = min(len(row) // HOP, mel.shape[0])
    with torch.inference_mode():
        return x2.x2_encode_latent_fn(model.enc_params, _t(row[None]),
                                      _t(mel[None]), n, model.enc_cfg)[0]


# whole hops, a ragged tail, two hops (mel frames bound T), many hops
@pytest.mark.parametrize("n", [3200, 3517, 640, 9600 + 77])
def test_encode_matches_jax(tiny, n):
    p, j = tiny["port"], tiny["jax"]
    pcm = _pcm(n, n + 1)
    got, want = p.encode(pcm), j.encode(pcm)
    assert got.shape == want.shape and got.dtype == np.int32
    assert got.shape[0] == min(n // HOP, p.mel(pcm).shape[0])
    assert_fsq_codes(got, want, _latent(p, pcm))


def test_batched_int16_encode_and_round_trip(tiny):
    p, j = tiny["port"], tiny["jax"]
    pcm = _pcm(1600, 9, batch=2)
    got = p.encode(pcm)
    assert got.shape == (2, 5, 1)
    for i in range(2):
        assert_fsq_codes(got[i], j.encode(pcm[i]), _latent(p, pcm[i]))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    assert_fsq_codes(p.encode(i16), j.encode(i16),
                     _latent(p, i16.astype(np.float32) / 32768))
    assert len(np.unique(got)) > 4
    out = p.decode(got[1])
    assert out.shape == (5 * HOP,) and np.isfinite(out).all()


def test_bfloat16_encode_runs(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    codes = p16.encode(_pcm(1600, 10))
    assert codes.shape == (5, 1) and codes.dtype == np.int32
    assert 0 <= codes.min() and codes.max() < V


def test_bias_free_convs_load_and_encode(tmp_path):
    """The BigCodec convs' biases are optional in both loaders."""
    f = _write(tmp_path / "nobias.gguf", biases=False)
    assert f["port"].enc_params["conv0_b"] is None
    assert f["port"].enc_params["enc_blocks"][0]["units"][0]["c1_b"] is None
    pcm = _pcm(1280, 11)
    assert_fsq_codes(f["port"].encode(pcm), f["jax"].encode(pcm),
                     _latent(f["port"], pcm))


def test_errors_match_jax(tmp_path, tiny):
    f = _write(tmp_path / "dec.gguf", encoder=False)
    assert not f["port"].has_encoder
    for kind, n_q, want in ((f, 0, "no encoder"), (tiny, 2, "n_q")):
        msgs = []
        for m in (kind["jax"], kind["port"]):
            with pytest.raises(Exception) as e:
                m.encode(_pcm(640, 1), n_q=n_q)
            assert type(e.value).__name__ == "CodecError"
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and want in msgs[1]
    with pytest.raises(CodecError, match="n_q"):
        tiny["port"].decode(_codes((3, 1), 1), n_q=2)


def test_cli_encodes_at_16khz(tiny, tmp_path, capsys):
    """codec-cli-torch encode takes XCodec2's 16 kHz WAV (its encode rate)
    and refuses a 24 kHz one; the codes are the model's, and decode writes
    the 16 kHz WAV."""
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    pcm = _pcm(HOP * 6, 12)
    write_wav(tmp_path / "in16.wav", pcm, 16000)
    write_wav(tmp_path / "in24.wav", pcm, 24000)
    args = ["--model", str(tiny["path"]), "--device", "cpu", "--dtype",
            "float32"]
    assert main(["encode", "--in", str(tmp_path / "in16.wav"), "--codes",
                 str(tmp_path / "c.npy"), *args]) == 0
    codes = np.load(tmp_path / "c.npy")
    i16 = np.clip(np.rint(pcm * 32767.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(codes, tiny["port"].encode(i16))
    assert main(["encode", "--in", str(tmp_path / "in24.wav"), "--codes",
                 str(tmp_path / "d.npy"), *args]) == 1
    assert "input sample rate 24000 != model 16000" in capsys.readouterr().err
    assert main(["decode", "--codes", str(tmp_path / "c.npy"), "--out",
                 str(tmp_path / "o.wav"), *args]) == 0
    y, sr = read_wav(tmp_path / "o.wav")
    assert sr == 16000 and y.shape == (codes.shape[0] * HOP, 1)
