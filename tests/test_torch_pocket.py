"""The port's Pocket-Mimi (codec_tpu_torch.models.pocket_mimi) against
codec_tpu's on the CPU: a small random GGUF with its encoder (the port's
writer, the wire names both loaders read; the widths of
tests/test_pocket_mimi_parity.py with a 12-frame context, so the window is
shorter than the transformer's T), loaded by both packages, the same
latents and PCM from a NumPy seed.

Bounds: decode_latent and encode_latent max abs err <= 1e-4 x peak (and
decode corr > 0.99999); stream chunks within 2e-5 of decode_latent (the
bound tests/test_pocket_mimi_parity.py holds codec_tpu's stream to) and of
codec_tpu's PocketStreamingDecoder. The attention runs through
flash_sdpa_window's plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import pocket_mimi as pm
from codec_tpu_torch.models.pocket_init import (POCKET_TTS,
                                                write_random_pocket_gguf)

# latent 8, outer 32, 2 layers of 2 heads x 16 (ffn 64), context 12, the
# SEANet 32 → 16 → 8 → 8 over strides 2/2/2, resample stride 4: hop 32
SMALL = dataclasses.replace(POCKET_TTS, latent_dim=8, outer_dim=32,
                            tf_heads=2, tf_head_dim=16, tf_context=12,
                            decoder_ratios=(2, 2, 2),
                            encoder_ratios=(2, 2, 2), resample_stride=4,
                            hop_size=32)
WIDTHS = dict(channels=(32, 16, 8, 8), ffn=64)
HOP, LAT = 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("pm") / "tiny_pm.gguf"
    write_random_pocket_gguf(path, seed=0, cfg=SMALL, **WIDTHS)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _latent(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)


def _pcm(n, seed, batch=None):
    shape = (n,) if batch is None else (batch, n)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _assert_close(got, want, corr=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"
    if corr:
        c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert c > 0.99999, f"corr={c}"


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "pocket_mimi"
    assert p.cfg == pm.PocketMimiConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "hop_size", "n_q", "latent_dim", "has_encoder",
              "has_decoder"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.cfg.resample_stride == 4 and p.n_q == 0
    tcfg = p.cfg.transformer()
    assert (tcfg.hidden, tcfg.n_heads, tcfg.head_dim, tcfg.window,
            tcfg.norm_eps) == (32, 2, 16, 12, 1e-5)


def test_load_matches_params_from_jax(tiny):
    want = pm.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    assert sorted(want) == sorted(got)
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 50
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got["upsample"]["w"].shape == (32, 32, 8)         # dense, [C_in, C_out, K]
    assert got["upsample"]["b"] is None and got["out_proj"]["b"] is None
    assert got["downsample"]["w"].shape == (8, 32, 8)
    assert got["dec"]["stages"][0]["tr"]["w"].shape == (32, 16, 4)
    assert sorted(got["dtr"][0]) == sorted(
        codec_tpu_torch.models.mimi._LAYER_KEYS)


# T·4 transformer frames: 4 (under the 12-frame window), 24 and 36 (past it)
@pytest.mark.parametrize("t", [1, 6, 9])
def test_decode_latent_matches_jax(tiny, t):
    z = _latent((t, LAT), t)
    got, want = tiny["port"].decode_latent(z), tiny["jax"].decode_latent(z)
    assert got.shape == want.shape == (t * HOP,)
    _assert_close(got, want)


# a hop multiple, a ragged tail, under one hop, one sample: the n_valid path
@pytest.mark.parametrize("n", [HOP * 5, HOP * 5 + 13, 17, 1])
def test_encode_latent_matches_jax(tiny, n):
    pcm = _pcm(n, n)
    got, want = tiny["port"].encode_latent(pcm), tiny["jax"].encode_latent(pcm)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (-(-n // HOP), LAT)
    _assert_close(got, want, corr=n > HOP)


def test_encode_latent_masks_past_the_true_length(tiny):
    """A ragged input is not the same as its zero-padded hop multiple: the
    frames past the true length are zeroed before each strided conv and
    replaced by the last true frame before the downsample."""
    p = tiny["port"]
    pcm = _pcm(HOP * 3 + 5, 4)
    padded = np.pad(pcm, (0, HOP - 5))
    ragged, full = p.encode_latent(pcm), p.encode_latent(padded)
    np.testing.assert_allclose(ragged[:3], full[:3], rtol=1e-5, atol=1e-6)
    assert np.abs(ragged[3] - full[3]).max() > 1e-4


def test_batched_int16_and_i16_output(tiny):
    p, j = tiny["port"], tiny["jax"]
    z = _latent((2, 7, LAT), 3)
    got = p.decode_latent(z)
    _assert_close(got, j.decode_latent(z))
    for i in range(2):
        _assert_close(got[i], p.decode_latent(z[i]))
    a, b = p.decode_latent(z[0], pcm_format="i16"), j.decode_latent(
        z[0], pcm_format="i16")
    assert a.dtype == np.int16
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    pcm = _pcm(HOP * 4 + 3, 5, batch=2)
    mu = p.encode_latent(pcm)
    _assert_close(mu, j.encode_latent(pcm))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    _assert_close(p.encode_latent(i16), j.encode_latent(i16))


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_stream_matches_decode_latent_and_jax(tiny, chunk):
    p, j = tiny["port"], tiny["jax"]
    t = 11                                  # 44 transformer frames: past w
    z = _latent((t, LAT), 20 + chunk)
    want = p.decode_latent(z)
    s, sj = p.streaming_decoder(), j.streaming_decoder()
    outs = [s.push(z[i:i + chunk]) for i in range(0, t, chunk)]
    got = np.concatenate(outs)
    assert [len(o) for o in outs] == [
        HOP * len(range(i, min(i + chunk, t))) for i in range(0, t, chunk)]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-5
    got_j = np.concatenate([sj.push(z[i:i + chunk])
                            for i in range(0, t, chunk)])
    assert np.abs(got - got_j).max() < 2e-5


def test_stream_batch_and_reset(tiny):
    p = tiny["port"]
    z = _latent((2, 6, LAT), 30)
    s = p.streaming_decoder(batch=2)
    first = np.concatenate([s.push(z[:, i:i + 2]) for i in range(0, 6, 2)],
                           axis=1)
    assert first.shape == (2, 6 * HOP)
    assert np.abs(first - p.decode_latent(z)).max() < 2e-5
    s.reset()
    assert s.state["pos"] == 0
    again = np.concatenate([s.push(z[:, i:i + 3]) for i in range(0, 6, 3)],
                           axis=1)
    assert np.abs(again - first).max() < 2e-5
    for bad in (z[0, :2], z[:, :2, :5], np.zeros((2, 0, LAT), np.float32)):
        with pytest.raises(CodecError):
            s.push(bad)
    with pytest.raises(CodecError, match="batch"):
        p.streaming_decoder(batch=0)


def _f16_leaves(tree):
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def test_float16_and_bfloat16(tiny):
    """f16 decode_latent against codec_tpu's f16 and the port's f32, bf16
    against f32 (the bf16 tests' bound, corr > 0.99); the f16 stream
    against the f16 decode_latent."""
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype="float16")
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="f16",
                                     device="cpu")
    dtypes = {t.dtype for t in _f16_leaves(p16.params) if t.is_floating_point()}
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    z = _latent((8, LAT), 16)
    got = p16.decode_latent(z)
    want, f32 = j16.decode_latent(z), tiny["port"].decode_latent(z)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99
    s = p16.streaming_decoder()
    streamed = np.concatenate([s.push(z[i:i + 1]) for i in range(8)])
    assert np.corrcoef(streamed, got)[0, 1] > 0.99
    b16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert b16.params["dtr"][0]["q_w"].dtype == torch.bfloat16
    assert np.corrcoef(b16.decode_latent(z), f32)[0, 1] > 0.99
    mu = b16.encode_latent(_pcm(HOP * 3, 17))
    assert mu.shape == (3, LAT) and mu.dtype == np.float32


def test_codec_errors_match_jax(tiny, tmp_path):
    p, j = tiny["port"], tiny["jax"]
    for call, arg in (("decode", np.zeros((4, 1), np.int32)),
                      ("encode", np.zeros(HOP, np.float32))):
        with pytest.raises(CodecError) as got:
            getattr(p, call)(arg)
        with pytest.raises(ValueError) as want:
            getattr(j, call)(arg)
        assert str(got.value) == str(want.value)
    for call in (lambda: p.decode_latent(np.zeros((5, LAT + 1), np.float32)),
                 lambda: p.decode_latent(np.zeros((0, LAT), np.float32)),
                 lambda: p.decode_many([np.zeros((4, 1), np.int32)]),
                 lambda: p.decode_async(np.zeros((4, 1), np.int32)),
                 lambda: p.encode_latent(np.zeros(0, np.float32))):
        with pytest.raises(CodecError):
            call()
    with pytest.raises(CodecError, match="latent_dim mismatch"):
        p.decode_latent(np.zeros((5, LAT + 1), np.float32))
    dec_only = tmp_path / "dec.gguf"
    write_random_pocket_gguf(dec_only, seed=1, cfg=SMALL, encoder=False,
                             **WIDTHS)
    d = codec_tpu_torch.load_model(dec_only, device="cpu")
    assert not d.has_encoder and d.has_decoder
    assert not codec_tpu.load_model(dec_only).has_encoder
    with pytest.raises(CodecError, match="has no encoder"):
        d.encode_latent(_pcm(HOP, 1))


def test_cli(tiny, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    path = str(tiny["path"])
    assert main(["info", "--model", path]) == 0
    out = capsys.readouterr().out
    assert "architecture: pocket_mimi" in out and "codec.latent_dim = 8" in out
    z = _latent((6, LAT), 7)
    np.save(tmp_path / "z.npy", z)
    assert main(["decode-latent", "--model", path, "--latent",
                 str(tmp_path / "z.npy"), "--out", str(tmp_path / "o.wav"),
                 "--device", "cpu", "--dtype", "float32"]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 24000 and x.shape == (6 * HOP, 1)
    np.save(tmp_path / "c.npy", np.zeros((4, 1), np.int32))
    assert main(["decode", "--model", path, "--codes",
                 str(tmp_path / "c.npy"), "--out", str(tmp_path / "p.wav"),
                 "--device", "cpu"]) == 1
    write_wav(tmp_path / "in.wav", _pcm(HOP * 2, 11), 24000)
    assert main(["encode", "--model", path, "--in", str(tmp_path / "in.wav"),
                 "--codes", str(tmp_path / "e.npy"), "--device", "cpu"]) == 1
    assert "use encode_latent" in capsys.readouterr().err
