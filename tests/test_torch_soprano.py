"""The port's Soprano decoder (codec_tpu_torch.models.soprano) against
codec_tpu's on the CPU: small random GGUFs (the port's writer, the wire
names both loaders read), loaded by both packages, the same latents from a
NumPy seed. f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak.
"""

import dataclasses

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import soprano
from codec_tpu_torch.models.soprano_init import (SOPRANO_1_1,
                                                 random_soprano_params,
                                                 write_random_soprano_gguf)

# the widths of tests/test_soprano_parity.py: latent 24, width 32,
# intermediate 48, 2 layers, upscale 4, hop 64, n_fft 256, depthwise k7
SMALL = dataclasses.replace(SOPRANO_1_1, latent_dim=24, decoder_dim=32,
                            intermediate_dim=48, num_layers=2, hop_size=64,
                            n_fft=256, dw_kernel=7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(path):
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("sop") / "tiny_sop.gguf"
    write_random_soprano_gguf(path, seed=0, cfg=SMALL)
    return _pair(path)


def _latent(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)


def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "soprano"
    assert p.cfg == soprano.SopranoConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "hop_size", "n_q", "latent_dim", "has_encoder",
              "has_decoder", "causal_time", "n_fft", "win_length"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.n_fft == 256 and not p.has_encoder


def test_load_matches_params_from_jax(tiny):
    want = soprano.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    assert sorted(want) == sorted(got)
    for k in got:
        if k == "cnx":
            for a, b in zip(want[k], got[k]):
                assert all(torch.equal(a[n], b[n]) for n in b)
        else:
            assert torch.equal(want[k], got[k]), k
    assert got["window"].shape == (256,)
    assert got["cnx"][0]["dw_w"].shape == (32, 1, 7)


@pytest.mark.parametrize("t", [1, 2, 7, 30])
def test_decode_latent_matches_jax(tiny, t):
    lat = _latent((t, SMALL.latent_dim), t)
    got = tiny["port"].decode_latent(lat)
    want = tiny["jax"].decode_latent(lat)
    assert got.shape == want.shape == (SMALL.upscale * (t - 1) * 64,)
    if t > 1:
        _assert_close_pcm(got, want)


def test_batched_decode_latent_and_i16(tiny):
    p = tiny["port"]
    lat = _latent((3, 9, SMALL.latent_dim), 3)
    got = p.decode_latent(lat)
    _assert_close_pcm(got, tiny["jax"].decode_latent(lat))
    for i in range(3):
        np.testing.assert_allclose(got[i], p.decode_latent(lat[i]),
                                   rtol=1e-5, atol=1e-6)
    a = p.decode_latent(lat[0], pcm_format="i16")
    b = tiny["jax"].decode_latent(lat[0], pcm_format="i16")
    assert a.dtype == np.int16
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_upsample_matches_jax():
    from codec_tpu.models import soprano as jsop

    lat = _latent((2, 6, 5), 4)
    for up in (1, 3, 4):
        want = np.asarray(jsop.soprano_upsample_linear(lat, up))
        got = soprano.soprano_upsample_linear(torch.from_numpy(lat), up)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_hann_default_and_short_kernel(tmp_path):
    """A file without the window tensor (periodic Hann) and with a k3
    depthwise kernel, as Soprano 1.1's."""
    cfg = dataclasses.replace(SMALL, dw_kernel=3, n_fft=128, hop_size=32)
    params = random_soprano_params(cfg, seed=2)
    del params["sop.decode.istft.window"]
    from codec_tpu.io.gguf import GGUFWriter

    w = GGUFWriter(tmp_path / "s.gguf", "soprano")
    for key, val in (("codec.sample_rate", 32000), ("codec.hop_size", 32),
                     ("codec.n_fft", 128), ("codec.latent_dim", 24),
                     ("soprano.decoder_dim", 32),
                     ("soprano.intermediate_dim", 48),
                     ("soprano.num_layers", 2), ("soprano.upscale", 4),
                     ("soprano.dw_kernel", 3)):
        w.add_uint32(key, val)
    for name, arr in params.items():
        w.add_tensor(name, arr)
    w.write()
    pair = _pair(tmp_path / "s.gguf")
    assert pair["port"].params["window"] is None
    lat = _latent((11, 24), 5)
    _assert_close_pcm(pair["port"].decode_latent(lat),
                      pair["jax"].decode_latent(lat))


def test_token_decode_and_bad_latents_raise(tiny):
    p = tiny["port"]
    for call in (lambda: p.decode(np.zeros((4, 1), np.int32)),
                 lambda: p.decode_many([np.zeros((4, 1), np.int32)]),
                 lambda: p.decode_async(np.zeros((4, 1), np.int32)),
                 lambda: p.decode_latent(np.zeros((5, 23), np.float32)),
                 lambda: p.decode_latent(np.zeros((0, 24), np.float32)),
                 lambda: p.encode(np.zeros(640, np.float32))):
        with pytest.raises(CodecError):
            call()
    with pytest.raises(ValueError, match="token inputs"):
        tiny["jax"].decode(np.zeros((4, 1), np.int32))


def test_bfloat16_decode_latent(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["cnx"][0]["pw1_w"].dtype == torch.bfloat16
    lat = _latent((8, 24), 6)
    got, want = p16.decode_latent(lat), tiny["port"].decode_latent(lat)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99



def _f16_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _f16_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_float16_decode_latent_matches_jax(tiny):
    """f16 `decode_latent` against codec_tpu's f16 and the port's f32 at
    the bf16 tests' bound (corr > 0.99); the weights f16, none bf16."""
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype="float16")
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="f16",
                                     device="cpu")
    dtypes = {t.dtype for t in _f16_leaves(p16.params)
              if t.is_floating_point()}
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    lat = _latent((8, 24), 16)
    got = p16.decode_latent(lat)
    want, f32 = j16.decode_latent(lat), tiny["port"].decode_latent(lat)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99


def test_cli_decode_latent(tiny, tmp_path):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav

    lat = _latent((6, 24), 7)
    np.save(tmp_path / "z.npy", lat)
    assert main(["decode-latent", "--model", str(tiny["path"]), "--latent",
                 str(tmp_path / "z.npy"), "--out", str(tmp_path / "o.wav"),
                 "--device", "cpu", "--dtype", "float32"]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 32000 and x.shape == (4 * 5 * 64, 1)
    assert main(["decode", "--model", str(tiny["path"]), "--codes",
                 str(tmp_path / "z.npy"), "--out", str(tmp_path / "p.wav"),
                 "--device", "cpu"]) == 1
