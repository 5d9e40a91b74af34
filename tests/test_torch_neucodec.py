"""The port's NeuCodec and DistillNeuCodec (codec_tpu_torch.models.neucodec)
against codec_tpu's on the CPU: small random GGUFs from the port's writer
(models/neucodec_init.py; the widths of tests/test_neucodec_parity.py's
and tests/test_neucodec_encode_parity.py's small mirrors, the encoder
under its hashed wire names), loaded by both packages, the same codes and
PCM from a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. Encode codes
equal, or differing only in FSQ digits at a rounding boundary
(tests/fsq_ties.py). bf16 and f16 decodes: corr > 0.99 against codec_tpu's
same dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import neucodec as jneu
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import neucodec as neu
from codec_tpu_torch.models.neucodec_init import (NEUCODEC, fsq_codebook,
                                                  write_random_neu_gguf)
from fsq_ties import assert_fsq_codes

# tests/test_neucodec_parity.py's decoder: hidden 32, vq 24, 2 layers of 2
# heads x 16, MLP 64, n_fft 128, hop 32; FSQ 4^8 (the implicit codebook)
DEC = dataclasses.replace(NEUCODEC, hop_size=32, vq_dim=24, hidden_dim=32,
                          num_layers=2, num_heads=2, head_dim=16)
N_FFT, MLP = 128, 64
# tests/test_neucodec_encode_parity.py's encoder: distill width 8 (2 heads
# of 2), windows 8 / 4, HuBERT 8 x 2 layers, feature convs (10, 4, 8) at
# strides (10, 4, 8): 320 samples a frame
ENC = neu.NeuEncConfig(hubert_hidden=8, hubert_heads=2, hubert_intermediate=16,
                       hubert_layers=2, hubert_pos_k=4, hubert_pos_groups=2,
                       hubert_conv_dim=(8, 8, 8),
                       hubert_conv_kernel=(10, 4, 8),
                       hubert_conv_stride=(10, 4, 8), distill_heads=2,
                       down_window=8, local_window=4)
WIDTHS = dict(dim=8, branch=2, first=4, dpb=6, fsq_out=12, sem_out=12)
V = 4 ** 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, encoder, **kw):
    write_random_neu_gguf(path, seed=0, cfg=DEC, n_fft=N_FFT, mlp=MLP,
                          encoder=encoder, enc_cfg=kw.pop("enc_cfg", ENC),
                          **{**WIDTHS, **kw} if encoder else {})
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("neu")
    return {"base": _write(d / "neu.gguf", False),
            "distill": _write(d / "dneu.gguf", True)}


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


def _pcm(n, seed, batch=None):
    shape = (n,) if batch is None else (batch, n)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind", ["base", "distill"])
def test_config_and_attrs_match(files, kind):
    j, p = files[kind]["jax"], files[kind]["port"]
    assert p.arch == j.arch == {"base": "neucodec",
                                "distill": "distill_neucodec"}[kind]
    assert p.cfg == neu.NeuConfig(**vars(j.cfg)) == DEC
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time", "encoder_type"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.encode_sample_rate == getattr(j, "encode_sample_rate", 0) == 0
    if kind == "distill":
        # the eps as the file's f32 KV holds it
        assert p.enc_cfg == neu.NeuEncConfig(**vars(j.enc_cfg)) == \
            dataclasses.replace(ENC, hubert_ln_eps=float(np.float32(1e-5)))


def test_file_holds_hashed_encoder_names(files):
    """The writer stores the encoder under the converter's hashed names;
    both loaders find them through the plain-name-first lookup."""
    r = files["distill"]["port"].reader
    names = r.tensor_names()
    assert any(n.startswith("nce.") for n in names)
    assert not any(n.startswith("neucodec.encode.") for n in names)
    assert max(len(n) for n in names) <= 63
    want = "neucodec.encode.fc_prior.w"
    assert jneu.neu_encode_name(want) == neu.neu_encode_name(want)
    np.testing.assert_array_equal(neu._neu_get(r, want),
                                  np.asarray(jneu._neu_get(r, want)))
    np.testing.assert_array_equal(r.get("neucodec.decode.codebook"),
                                  fsq_codebook(8))


@pytest.mark.parametrize("kind", ["base", "distill"])
def test_load_matches_params_from_jax(files, kind):
    j, p = files[kind]["jax"], files[kind]["port"]
    trees = [(neu.params_from_jax(j.params), p.params)]
    if kind == "distill":
        trees.append((neu.encode_params_from_jax(j.enc_params), p.enc_params))
    for want, got in trees:
        assert sorted(want) == sorted(got)
        flat_w, flat_g = _leaves(want), _leaves(got)
        assert len(flat_w) == len(flat_g) > 30
        for a, b in zip(flat_w, flat_g):
            assert (a is None and b is None) or torch.equal(a, b)
    assert p.params["embed_w"].shape == (32, 32, 7)       # [C_out, C_in, K]
    assert p.params["window"] is None


@pytest.mark.parametrize("t", [1, 7, 40])
def test_decode_matches_jax(files, t):
    codes = _codes((t, 1), t)
    got = files["base"]["port"].decode(codes)
    want = files["base"]["jax"].decode(codes)
    assert got.shape == want.shape == (32 * t,)
    _held(got, want)


def test_distill_decoder_is_the_base_decoder(files):
    """A seed writes the same decoder into both files: equal samples."""
    codes = _codes((9, 1), 2)
    np.testing.assert_array_equal(files["distill"]["port"].decode(codes),
                                  files["base"]["port"].decode(codes))


def test_decode_head_matches_jax(files):
    codes = _codes((2, 11, 1), 3)
    p, j = files["base"]["port"], files["base"]["jax"]
    want = np.asarray(jneu.neu_decode_head_fn(j.params, jnp.asarray(codes),
                                              j.cfg))
    with torch.inference_mode():
        got = neu.neu_decode_head_fn(p.params, _t(codes.astype(np.int64)),
                                     p.cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_batched_clipped_and_async_decodes(files):
    p = files["base"]["port"]
    codes = _codes((2, 9, 1), 4)
    codes[0, 0, 0], codes[1, 5, 0] = -3, V + 7
    got = p.decode(codes)
    _held(got, files["base"]["jax"].decode(codes))
    np.testing.assert_array_equal(p.decode_async(codes).result(), got)
    for o, s in zip(p.decode_many([codes[0], codes[1], codes[1, :5]]),
                    (codes[0], codes[1], codes[1, :5])):
        np.testing.assert_allclose(o, p.decode(s), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_decode_matches_jax(files, dtype):
    """bf16 and f16 decodes against codec_tpu's decode at corr > 0.99.
    codec_tpu's own 16-bit NeuCodec decode raises (its f32 attention
    weights promote the residual stream, and the post ResNets' conv then
    meets 16-bit weights: ROADMAP Queue 3), so the reference is its f32
    decode, and the port's f32 beside it."""
    path = files["base"]["path"]
    p16 = codec_tpu_torch.load_model(path, compute_dtype=dtype, device="cpu")
    assert p16.params["layers"][0]["fc1"].dtype == getattr(torch, dtype)
    codes = _codes((2, 12, 1), 5)
    got, want = p16.decode(codes), files["base"]["jax"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    assert np.corrcoef(got.ravel(), files["base"]["port"].decode(
        codes).ravel())[0, 1] > 0.99


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("k", [1, 5, 45])
@pytest.mark.parametrize("t", [40, 3])
def test_pool1d_same_matches_jax(op, k, t):
    """The pools on |x| (what the encoder pools; max_pool1d's −inf pad and
    codec_tpu's zero pad agree there), also shorter than the kernel."""
    x = np.abs(_pcm(2 * t * 3, k + t)).reshape(2, t, 3)
    want = np.asarray(jneu._pool1d_same(jnp.asarray(x), k, op))
    got = neu._pool1d_same(_t(x), k, op).numpy()
    assert got.shape == want.shape == (2, t, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_grn_matches_jax():
    x, g, b = _pcm(60, 1).reshape(2, 5, 6), _pcm(6, 2), _pcm(6, 3)
    want = np.asarray(jneu._grn(*(jnp.asarray(a) for a in (x, g, b))))
    np.testing.assert_allclose(neu._grn(_t(x), _t(g), _t(b)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t,window", [(13, 8), (10, 4), (9, 3), (5, 600),
                                      (20, 2)])
def test_position_bias_and_local_mask_match_jax(files, t, window):
    """dynamic_pos_bias over the window's distances and the block-causal
    local_attn_bias: the same finite values and the same hidden keys."""
    dpb = files["distill"]["port"].enc_params["down_dpb"]
    bias = neu.dynamic_pos_bias(dpb, window)
    want_bias = np.asarray(jneu.dynamic_pos_bias(
        {k: jnp.asarray(v.numpy()) for k, v in dpb.items()}, window))
    assert bias.shape == want_bias.shape == (2, window)
    np.testing.assert_allclose(bias.numpy(), want_bias, rtol=1e-5, atol=1e-6)
    got = neu.local_attn_bias(bias, t, window).numpy()
    want = np.asarray(jneu.local_attn_bias(jnp.asarray(want_bias), t, window))
    assert got.shape == want.shape == (2, t, t)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert np.isfinite(got[:, np.arange(t), np.arange(t)]).all()


def test_sdpa_bias_matches_jax():
    """sdpa with a per-head additive bias holding −inf, against codec_tpu's
    sdpa(bias=)."""
    from codec_tpu.ops import attn as jattn
    from codec_tpu_torch.ops import attn

    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 3, 9, 4)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((3, 9, 9)).astype(np.float32)
    bias[:, np.triu_indices(9, 1)[0], np.triu_indices(9, 1)[1]] = -np.inf
    want = np.asarray(jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                                 bias=jnp.asarray(bias)))
    got = attn.sdpa(_t(q), _t(k), _t(v), bias=_t(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unit_and_local_transformer_match_jax(files):
    ep = files["distill"]["port"].enc_params
    jp = files["distill"]["jax"].enc_params
    x = _pcm(2 * 17 * 8, 7).reshape(2, 17, 8) * 3
    want = np.asarray(jneu._base_unit_fwd(jnp.asarray(x), jp["units"][0]))
    got = neu._base_unit_fwd(_t(x), ep["units"][0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    bias = neu.dynamic_pos_bias(ep["down_dpb"], 8)
    want = np.asarray(jneu._local_trans_fwd(
        jnp.asarray(x), jp["down_trans"], jnp.asarray(bias.numpy()), 8, 2))
    got = neu._local_trans_fwd(_t(x), ep["down_trans"], bias, 8, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [3200, 960])
def test_distill_acoustic_matches_jax(files, n):
    ep = files["distill"]["port"].enc_params
    jp = files["distill"]["jax"].enc_params
    pcm = _pcm(n, n)[None]
    want = np.asarray(jneu.neu_distill_acoustic_fn(jp, jnp.asarray(pcm), ENC))
    with torch.inference_mode():
        got = neu.neu_distill_acoustic_fn(ep, _t(pcm), ENC).numpy()
    assert got.shape == want.shape == (1, n // 320, 12)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def odd_pos(tmp_path_factory):
    """A distill file whose positional conv has an odd kernel (5): nothing
    dropped after it."""
    enc = dataclasses.replace(ENC, hubert_pos_k=5)
    return _write(tmp_path_factory.mktemp("neu_odd") / "dneu5.gguf", True,
                  enc_cfg=enc)


@pytest.mark.parametrize("pos_k", [4, 5])
def test_hubert_matches_jax(files, odd_pos, pos_k):
    f = files["distill"] if pos_k == 4 else odd_pos
    p, j = f["port"], f["jax"]
    assert p.enc_cfg.hubert_pos_k == pos_k
    sem = _pcm(3200 + 320, 8)[None]
    want = np.asarray(jneu.neu_hubert_fn(j.enc_params, jnp.asarray(sem),
                                         j.enc_cfg))
    with torch.inference_mode():
        got = neu.neu_hubert_fn(p.enc_params, _t(sem), p.enc_cfg).numpy()
    assert got.shape == want.shape == (1, 11, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _latent(model, row):
    """The port's f32 latent (before the bound) of one encode row."""
    (row_pad, sem), = neu.encode_rows(row[None])
    with torch.inference_mode():
        return neu.neu_encode_latent_fn(model.enc_params, _t(row_pad[None]),
                                        _t(sem[None]), model.enc_cfg)[0]


# ragged, aligned (a whole 320 of padding), under one frame, empty-ish
@pytest.mark.parametrize("n", [3517, 3200, 100, 1])
def test_encode_matches_jax(files, n):
    p, j = files["distill"]["port"], files["distill"]["jax"]
    pcm = _pcm(n, n + 1)
    got, want = p.encode(pcm), j.encode(pcm)
    assert got.shape == want.shape == (n // 320 + 1, 1)
    assert got.dtype == np.int32
    assert_fsq_codes(got, want, _latent(p, pcm))


def test_batched_int16_encode_and_round_trip(files):
    p, j = files["distill"]["port"], files["distill"]["jax"]
    pcm = _pcm(1280, 9, batch=2)
    got = p.encode(pcm)
    assert got.shape == (2, 5, 1)
    for i in range(2):
        assert_fsq_codes(got[i], j.encode(pcm[i]), _latent(p, pcm[i]))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    assert_fsq_codes(p.encode(i16), j.encode(i16),
                     _latent(p, i16.astype(np.float32) / 32768))
    assert len(np.unique(got)) > 4
    out = p.decode(got[0])
    assert out.shape == (5 * 32,) and np.isfinite(out).all()


def test_bfloat16_encode_runs(files):
    p16 = codec_tpu_torch.load_model(files["distill"]["path"],
                                     compute_dtype="bfloat16", device="cpu")
    assert not p16.exact_encode
    codes = p16.encode(_pcm(1600, 10))
    assert codes.shape == (6, 1) and codes.dtype == np.int32
    assert 0 <= codes.min() and codes.max() < V


def test_encode_errors_match_jax(files):
    """The base file's encode raises codec_tpu's message, as does an n_q
    outside {0, 1}."""
    for kind, n_q, want in (("base", 0, "only distill implemented"),
                            ("distill", 2, "n_q must be 0 or 1")):
        msgs = []
        for m in (files[kind]["jax"], files[kind]["port"]):
            with pytest.raises(Exception) as e:
                m.encode(_pcm(640, 1), n_q=n_q)
            assert type(e.value).__name__ == "CodecError"
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and want in msgs[1]
    with pytest.raises(CodecError):
        files["base"]["port"].encode(_pcm(640, 1))


def test_cli_checks_a_distill_encode_at_24khz_like_codec_tpu(files, tmp_path,
                                                             capsys):
    """Neither package reads codec.encode_sample_rate for NeuCodec, so both
    CLIs check an encode's WAV against sample_rate (24 kHz), though the
    encoder works on 16 kHz PCM: a 16 kHz WAV is refused by both, a 24 kHz
    one taken by both, with the same codes."""
    from codec_tpu.cli import codec_cli as jcli
    from codec_tpu_torch.cli import codec_cli as cli
    from codec_tpu_torch.io.wav import write_wav

    f = files["distill"]
    assert f["port"].reader.get_i32("codec.encode_sample_rate") == 16000
    pcm = _pcm(960, 12)
    write_wav(tmp_path / "in16.wav", pcm, 16000)
    write_wav(tmp_path / "in24.wav", pcm, 24000)
    with pytest.raises(SystemExit, match="16000 != model 24000"):
        jcli._read_pcm(f["jax"], tmp_path / "in16.wav")
    with pytest.raises(CodecError, match="16000 != model 24000"):
        cli._read_pcm(f["port"], tmp_path / "in16.wav")
    x_j = jcli._read_pcm(f["jax"], tmp_path / "in24.wav")
    x_p = cli._read_pcm(f["port"], tmp_path / "in24.wav")
    np.testing.assert_array_equal(x_j, x_p)
    args = ["--model", str(f["path"]), "--device", "cpu", "--dtype", "float32"]
    assert cli.main(["encode", "--in", str(tmp_path / "in16.wav"), "--codes",
                     str(tmp_path / "c.npy"), *args]) == 1
    assert "16000 != model 24000" in capsys.readouterr().err
    assert cli.main(["encode", "--in", str(tmp_path / "in24.wav"), "--codes",
                     str(tmp_path / "c.npy"), *args]) == 0
    codes = np.load(tmp_path / "c.npy")
    assert_fsq_codes(codes, f["jax"].encode(x_j),
                     _latent(f["port"], x_p.astype(np.float32) / 32768))
    assert cli.main(["decode", "--codes", str(tmp_path / "c.npy"), "--out",
                     str(tmp_path / "o.wav"), *args]) == 0


def test_aliases_resolve_as_in_codec_tpu():
    """Every arch string codec_tpu registers for NeuCodec, DistillNeuCodec
    and XCodec2 loads the port's class of the same name."""
    from codec_tpu.models import registry as jreg
    from codec_tpu_torch.models import registry

    names = {"NeuCodec", "DistillNeuCodec", "XCodec2"}
    aliases = [a for a in jreg.known_archs()
               if jreg.get_model_class(a).__name__ in names]
    assert sorted(aliases) == ["distill-neucodec", "distill_neucodec",
                               "neucodec", "x-codec2", "x_codec2", "xcodec2"]
    for a in aliases:
        assert registry.get_model_class(a).__name__ \
            == jreg.get_model_class(a).__name__
        assert a in codec_tpu_torch.known_archs()
