"""The port's BlueMagpie AudioVAE (codec_tpu_torch.models.bluemagpie)
against codec_tpu's on the CPU: small random GGUFs from the port's writer
(models/bluemagpie_init.py) near the widths of
tests/test_bluemagpie_parity.py's small mirror (latent 8, decoder 32 → 16
→ 8 over rates (2, 3), encoder 8 → 16 → 32 over (2, 2)), loaded by both
packages, the same latents and PCM from a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. bf16 and
f16: corr > 0.99 against codec_tpu's same dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import bluemagpie as jbm
from codec_tpu.ops import conv as jconv
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import bluemagpie as bm
from codec_tpu_torch.models.bluemagpie_init import (BLUEMAGPIE,
                                                    write_random_bm_gguf)
from codec_tpu_torch.ops import conv

LAT = 8
# an odd rate, so the ConvTranspose crop's 2·⌈s/2⌉ − (s mod 2) is held
SMALL = dataclasses.replace(BLUEMAGPIE, latent_dim=LAT, decoder_rates=(2, 3),
                            encoder_rates=(2, 2), decode_hop=6, encode_hop=4)
WIDTHS = dict(decoder_dim=32, encoder_dim=8)
DEC_HOP, ENC_HOP = 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("bm") / "bm.gguf"
    write_random_bm_gguf(path, seed=0, cfg=SMALL, encoder=True, **WIDTHS)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


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


def _latent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pcm(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == j.arch == "bluemagpie_audiovae"
    assert p.cfg == bm.BmVaeConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "encode_sample_rate", "hop_size", "n_q",
              "latent_dim", "has_encoder", "has_decoder", "causal_time",
              "expected_channels"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.encode_sample_rate == 16000 and p.n_q == 0


def test_load_matches_params_from_jax(tiny):
    got = _leaves(tiny["port"].params)
    want = _leaves(bm.params_from_jax(tiny["jax"].params))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("t,batch", [(1, None), (7, None), (12, 2)])
def test_decode_latent_matches_jax(tiny, t, batch):
    shape = (t, LAT) if batch is None else (batch, t, LAT)
    z = _latent(shape, 10 + t)
    got, want = tiny["port"].decode_latent(z), tiny["jax"].decode_latent(z)
    assert got.shape == want.shape == shape[:-2] + (t * DEC_HOP,)
    _held(got, want)


@pytest.mark.parametrize("n", [ENC_HOP * 9, ENC_HOP * 9 + 1, 3])
def test_encode_latent_matches_jax(tiny, n):
    pcm = _pcm((2, n), 20 + n)
    got, want = tiny["port"].encode_latent(pcm), tiny["jax"].encode_latent(pcm)
    assert got.shape == want.shape == (2, -(-n // ENC_HOP), LAT)
    _held(got, want)


def test_int16_i16_and_round_trip(tiny):
    p = tiny["port"]
    pcm = _pcm(ENC_HOP * 5, 7)
    i16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_allclose(p.encode_latent(i16),
                               tiny["jax"].encode_latent(i16), rtol=1e-5,
                               atol=1e-6)
    z = p.encode_latent(pcm)
    out = p.decode_latent(z, pcm_format="i16")
    assert out.dtype == np.int16 and out.shape == (5 * DEC_HOP,)
    np.testing.assert_array_equal(
        out, np.clip(np.rint(p.decode_latent(z) * 32767), -32768, 32767))


@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_causal_conv_matches_jax(stride, dilation):
    """ops/conv.py::conv1d_causal with groups (a depthwise conv) and
    conv1d with groups, channels-last, against codec_tpu's."""
    rng = np.random.default_rng(stride * 10 + dilation)
    x = rng.standard_normal((2, 17, 6)).astype(np.float32)
    w = rng.standard_normal((5, 1, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = conv.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride=stride,
                             dilation=dilation, groups=6)
    want = jconv.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, dilation=dilation, groups=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got = conv.conv1d(torch.from_numpy(x), torch.from_numpy(w), padding=2,
                      dilation=dilation, groups=6)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), padding=2,
                        dilation=dilation, groups=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unit_matches_jax(tiny):
    """The causal depthwise unit (snake → dilated k7 depthwise → snake → 1x1
    → + x) against codec_tpu's _unit."""
    j, p = tiny["jax"], tiny["port"]
    x = _latent((2, 8, 29), 3)
    for d, uj, up in zip(bm.RES_DILATIONS, j.params["dec_blocks"][1]["units"],
                         p.params["dec_blocks"][1]["units"]):
        got = bm._unit(torch.from_numpy(x), up, d).numpy()
        want = np.asarray(jbm._unit(jnp.asarray(x.transpose(0, 2, 1)), uj, d))
        _held(got, want.transpose(0, 2, 1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_matches_jax(tiny, dtype):
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype=dtype)
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype=dtype,
                                     device="cpu")
    assert p16.params["dec_out"]["w"].dtype == getattr(torch, dtype)
    z = _latent((2, 9, LAT), 30)
    got, want = p16.decode_latent(z), j16.decode_latent(z)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    assert np.corrcoef(got.ravel(), tiny["port"].decode_latent(z).ravel()
                       )[0, 1] > 0.99
    pcm = _pcm(ENC_HOP * 6, 31)
    mu, mj = p16.encode_latent(pcm), j16.encode_latent(pcm)
    assert mu.dtype == np.float32 and mu.shape == mj.shape == (6, LAT)
    assert np.corrcoef(mu.ravel(), np.asarray(mj, np.float32).ravel()
                       )[0, 1] > 0.99


def test_errors_and_aliases_match_jax(tiny, tmp_path):
    from codec_tpu.models.registry import get_model_class as jget
    from codec_tpu_torch.models.registry import get_model_class

    for alias in ("bluemagpie_audiovae", "bluemagpie-audiovae"):
        assert get_model_class(alias) is bm.BlueMagpieAudioVAE
        assert jget(alias).__name__ == "BlueMagpieAudioVAE"
    p, j = tiny["port"], tiny["jax"]
    for call, arg in (("decode", np.zeros((4, 1), np.int32)),
                      ("encode", np.zeros(ENC_HOP, np.float32))):
        with pytest.raises(CodecError) as got:
            getattr(p, call)(arg)
        with pytest.raises(ValueError) as want:
            getattr(j, call)(arg)
        assert str(got.value) == str(want.value)
    with pytest.raises(CodecError, match="latent_dim mismatch"):
        p.decode_latent(np.zeros((5, LAT + 1), np.float32))
    for call in (lambda: p.decode_latent(np.zeros((0, LAT), np.float32)),
                 lambda: p.encode_latent(np.zeros(0, np.float32))):
        with pytest.raises(CodecError):
            call()
    path = tmp_path / "dec.gguf"
    write_random_bm_gguf(path, seed=0, cfg=SMALL, **WIDTHS)
    d = codec_tpu_torch.load_model(path, device="cpu")
    assert not d.has_encoder and not codec_tpu.load_model(path).has_encoder
    z = _latent((4, LAT), 5)
    np.testing.assert_array_equal(d.decode_latent(z), p.decode_latent(z))
    with pytest.raises(CodecError, match="has no encoder"):
        d.encode_latent(_pcm(ENC_HOP, 1))


def test_cli_decode_latent_matches_codec_cli(tiny, tmp_path, capsys):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav

    path = str(tiny["path"])
    np.save(tmp_path / "z.npy", _latent((6, LAT), 7))
    for tag, fn, extra in (("p", main, ["--device", "cpu"]), ("j", jmain, [])):
        assert fn(["decode-latent", "--model", path, "--latent",
                   str(tmp_path / "z.npy"), "--out",
                   str(tmp_path / f"{tag}.wav"), *extra]) == 0
    (x, sr), (y, _) = (read_wav(tmp_path / f"{t}.wav", keep_i16=True)
                       for t in "pj")
    assert sr == 48000 and x.shape == y.shape == (6 * DEC_HOP, 1)
    assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
    np.save(tmp_path / "c.npy", np.zeros((4, 1), np.int32))
    assert main(["decode", "--model", path, "--codes",
                 str(tmp_path / "c.npy"), "--out", str(tmp_path / "q.wav"),
                 "--device", "cpu"]) == 1
    assert "use decode_latent" in capsys.readouterr().err
