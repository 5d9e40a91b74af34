"""The port's XY-Tokenizer (codec_tpu_torch.models.xy_tokenizer) against
codec_tpu's on the CPU: one small random GGUF with its encoder (the port's
writer, the wire names both loaders read; the widths of
tests/test_xy_tokenizer_parity.py), loaded by both packages, the same
codes and PCM from a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. Encode codes
equal, or differing only at f64 near-ties (tests/encode_ties.py). The
search runs through rvq_encode_fused, whose plain version runs here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import xy_tokenizer as jxy
from codec_tpu_torch import CodecError
from codec_tpu_torch.dsp.audio import whisper_mel_padded
from codec_tpu_torch.models import xy_tokenizer as xy
from codec_tpu_torch.models.xy_init import write_random_xy_gguf
from encode_ties import assert_codes, euclid_margin, f64

# tests/test_xy_tokenizer_parity.py's widths: 16 mels (n_fft 64, hop 32),
# width 32, 2 heads, 1 layer a module, latent 128, 2 codebooks of 32 x 16,
# Vocos 32 x 1 block, n_fft 96, hop 24. Encode: 256 samples a code (the
# PCM padded to a multiple); decode: 192 samples a code. The post-RVQ table
# has 4 rows: a decode window of 4 codes
SMALL = xy.XyConfig(encoder_downsample_rate=256, decoder_upsample_rate=192,
                    latent_dim=128, codebook_dim=16, codebook_size=32, n_q=2,
                    mel_n_mels=16, mel_n_fft=64, mel_hop=32, n_layers=1,
                    adapter_layers=1, d_model=32, n_heads=2, vocos_blocks=1,
                    vocos_n_fft=96, vocos_hop=24)
WIDTHS = dict(ffn_dim=64, vocos_dim=32, vocos_intermediate=64, enc_pos=64,
              post_pos=4, dec_pos=80)
V, CHUNK = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("xy") / "tiny_xy.gguf"
    write_random_xy_gguf(path, seed=0, cfg=SMALL, encoder=True, **WIDTHS)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _assert_close_pcm(got, want):
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
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "xy_tokenizer"
    assert p.cfg == xy.XyConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "encode_sample_rate", "hop_size", "n_q",
              "codebook_size", "latent_dim", "has_encoder", "has_decoder",
              "causal_time", "chunk_codes"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.encode_sample_rate == 16000 and p.sample_rate == 24000
    assert p.chunk_codes == CHUNK


def test_load_matches_params_from_jax(tiny):
    want = xy.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    assert sorted(want) == sorted(got)
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 100
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got["up_conv_w"].shape == (128, 32, 4)          # [C_in, C_out, K]
    assert got["sem_enc"]["conv1_w"].shape == (32, 16, 3)
    assert got["search"]["norms"].shape == (2, V)


# within one window, exactly one, across windows (4 + 4 + 3 codes)
@pytest.mark.parametrize("t", [1, 3, CHUNK, 2 * CHUNK, 11])
def test_decode_matches_jax(tiny, t):
    codes = _codes((t, 2), t)
    got, want = tiny["port"].decode(codes), tiny["jax"].decode(codes)
    windows = -(-t // CHUNK)
    assert got.shape == want.shape == (192 * t + 24 * windows,)
    _assert_close_pcm(got, want)


def test_batched_clipped_and_async_decodes(tiny):
    p = tiny["port"]
    codes = _codes((2, 9, 2), 3)
    codes[0, 0, 0], codes[1, 5, 1] = -2, 99
    got = p.decode(codes)
    _assert_close_pcm(got, tiny["jax"].decode(codes))
    np.testing.assert_array_equal(p.decode_async(codes).result(), got)
    for o, s in zip(p.decode_many([codes[0], codes[1], codes[1, :5]]),
                    (codes[0], codes[1], codes[1, :5])):
        np.testing.assert_allclose(o, p.decode(s), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_valid", [None, 5, 12, 1])
def test_whisper_layer_matches_jax(tiny, n_valid):
    """The layer with its key mask and query-row zeroing (n_valid) and
    without, against codec_tpu's."""
    lw = tiny["port"].params["sem_enc"]["layers"][0]
    x = _pcm(12 * 32, 4).reshape(1, 12, 32) * 10
    jl = {k: jnp.asarray(v.numpy()) for k, v in lw.items()}
    want = np.asarray(jxy._whisper_layer(jnp.asarray(x), jl, 2, n_valid))
    got = xy.whisper_layer(torch.from_numpy(x), lw, 2, n_valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _margin(model, pcm, want, got):
    """near-tie margin_fn for one row: the port's latent (from the same
    mel) in f64."""
    cfg = model.cfg
    mel, n_frames = whisper_mel_padded(pcm, 16000, cfg.mel_n_fft, cfg.mel_hop,
                                       cfg.mel_n_mels,
                                       cfg.encoder_downsample_rate)
    n_valid = min(n_frames, len(pcm) // cfg.mel_hop)
    with torch.inference_mode():
        lat = f64(xy.xy_encode_latent_fn(
            model.params, torch.from_numpy(np.ascontiguousarray(mel.T[None])),
            cfg, n_valid)[0])
    cb = f64(model.params["cb"])
    return lambda fr, q: euclid_margin(lat[fr], cb, want[fr, :q], got[fr, q],
                                       want[fr, q])


# a ragged tail, whole windows, under one code (no frame valid), 2.5 codes
@pytest.mark.parametrize("n", [256 * 3 + 100, 256 * 10, 100, 640])
def test_encode_matches_jax(tiny, n):
    pcm = _pcm(n, n)
    got, want = tiny["port"].encode(pcm), tiny["jax"].encode(pcm)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.shape == ((n // 32 // 2) // 4, 2)
    assert_codes(got, want, _margin(tiny["port"], pcm, want, got))


def test_batched_and_int16_encode(tiny):
    p = tiny["port"]
    pcm = _pcm(256 * 6, 5, batch=2)
    got = p.encode(pcm)
    assert got.shape == (2, 6, 2)
    for i in range(2):
        want = tiny["jax"].encode(pcm[i])
        assert_codes(got[i], want, _margin(p, pcm[i], want, got[i]))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    want = tiny["jax"].encode(i16)
    got16 = p.encode(i16)
    assert_codes(got16, want, _margin(p, i16.astype(np.float32) / 32768,
                                      want, got16))
    assert len(np.unique(got)) > 4
    pcm_out = p.decode(p.encode(_pcm(256 * 4, 6)))        # the round trip
    assert pcm_out.shape == (192 * 4 + 24,) and np.isfinite(pcm_out).all()


def test_bfloat16_decode_and_encode(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["acoust_dec"]["layers"][0]["qw"].dtype == torch.bfloat16
    codes = _codes((6, 2), 7)
    got, want = p16.decode(codes), tiny["port"].decode(codes)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    c16 = p16.encode(_pcm(256 * 5, 8))
    assert c16.shape == (5, 2) and c16.dtype == np.int32



def _f16_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _f16_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_float16_decode_matches_jax(tiny):
    """f16 decode (across a decode window) against codec_tpu's f16 and the
    port's f32 at the bf16 tests' bound (corr > 0.99); the weights f16,
    none bf16."""
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype="float16")
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="f16",
                                     device="cpu")
    dtypes = {t.dtype for t in _f16_leaves(p16.params)
              if t.is_floating_point()}
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    codes = _codes((CHUNK + 3, 2), 17)
    got = p16.decode(codes)
    want, f32 = j16.decode(codes), tiny["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99


def test_decode_only_file_has_no_encoder(tmp_path):
    write_random_xy_gguf(tmp_path / "d.gguf", seed=0, cfg=SMALL, **WIDTHS)
    p = codec_tpu_torch.load_model(tmp_path / "d.gguf", device="cpu")
    assert not p.has_encoder and "search" not in p.params
    with pytest.raises(CodecError, match="no encoder"):
        p.encode(_pcm(512, 1))


def test_cli_encodes_at_the_encode_rate(tiny, tmp_path, capsys):
    """codec-cli-torch encode takes XY-Tokenizer's 16 kHz input and refuses
    a 24 kHz one (its output rate) with a CodecError, exit 1."""
    from codec_tpu_torch.cli.codec_cli import _read_pcm, main
    from codec_tpu_torch.io.wav import write_wav

    pcm = _pcm(256 * 5, 9)
    write_wav(tmp_path / "in16.wav", pcm, 16000)
    write_wav(tmp_path / "in24.wav", pcm, 24000)
    args = ["--model", str(tiny["path"]), "--device", "cpu", "--dtype",
            "float32"]
    assert main(["encode", "--in", str(tmp_path / "in16.wav"), "--codes",
                 str(tmp_path / "c.npy"), *args]) == 0
    codes = np.load(tmp_path / "c.npy")
    assert codes.shape == (5, 2)
    i16 = np.clip(np.rint(pcm * 32767.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(codes, tiny["port"].encode(i16))
    assert main(["encode", "--in", str(tmp_path / "in24.wav"), "--codes",
                 str(tmp_path / "d.npy"), *args]) == 1
    assert "input sample rate 24000 != model 16000" in capsys.readouterr().err
    with pytest.raises(CodecError):
        _read_pcm(tiny["port"], tmp_path / "in24.wav")
    assert main(["e2e", "--in", str(tmp_path / "in16.wav"), "--out",
                 str(tmp_path / "o.wav"), *args]) == 0
