"""The port's NeMo nano codec (codec_tpu_torch.models.nemo_nano) against
codec_tpu's on the CPU: small random GGUFs from the port's writer
(models/nemo_init.py) at the widths of tests/test_nemo_parity.py's small
mirror (encoder 4 channels doubling, decoder 64 halving, FSQ 2 groups of
levels (5, 4)) over three of its five rates (hop 36, a third of the graph
codec_tpu compiles), loaded by both packages, the same codes and PCM from
a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. Codes
equal, or differing only in FSQ digits at a rounding boundary
(tests/fsq_ties.py's rule for mixed-radix levels). bf16 and f16 decodes:
corr > 0.99 against codec_tpu's same dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import nemo_nano as jnemo
from codec_tpu.ops import act as jact
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import nemo_nano as nemo
from codec_tpu_torch.models.nemo_init import (NEMO_NANO, fsq_constants,
                                              write_random_nemo_gguf)
from codec_tpu_torch.ops import act
from fsq_ties import assert_level_codes, level_digits

LEVELS = (5, 4)
# three of the five rates (hop 36): every stage kind at a third of the
# graph codec_tpu compiles
N_Q, V, HOP = 2, 20, 36
SMALL = dataclasses.replace(NEMO_NANO, hop_size=HOP, n_q=N_Q, codebook_size=V,
                            codebook_dim=2, latent_dim=4,
                            down_rates=(2, 3, 6), up_rates=(6, 3, 2))
WIDTHS = dict(levels=LEVELS, enc_base=4, dec_base=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("nemo") / "nemo.gguf"
    write_random_nemo_gguf(path, seed=0, cfg=SMALL, encoder=True, **WIDTHS)
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


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _pcm(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == j.arch == "nemo_nano_codec"
    assert p.cfg == nemo.NemoConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time",
              "expected_channels"):
        assert getattr(p, a) == getattr(j, a), a
    assert not p.causal_time and p.expected_channels == 1
    assert p.encode_sample_rate == getattr(j, "encode_sample_rate", 0) == 0


def test_load_matches_params_from_jax(tiny):
    got = _leaves(tiny["port"].params)
    want = _leaves(nemo.params_from_jax(tiny["jax"].params))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_fsq_constants_are_the_converters():
    """The writer's FSQ constants and codebook are what the converter
    computes (codec_tpu/convert/nemo_nano.py), at the full levels."""
    c = fsq_constants((9, 8, 8, 7))
    np.testing.assert_array_equal(c["scale"], [4, 4, 4, 3])
    np.testing.assert_array_equal(c["dim_base"], [1, 9, 72, 576])
    np.testing.assert_array_equal(c["out_offset"], [0, 0.5, 0.5, 0])
    assert c["codebook"].shape == (4032, 4)
    np.testing.assert_array_equal(
        level_digits(np.arange(4032), (9, 8, 8, 7)),
        np.rint(c["codebook"] * c["scale"] + c["scale"]).astype(np.int64))


@pytest.mark.parametrize("t,batch", [(1, None), (3, None), (4, 2)])
def test_decode_matches_jax(tiny, t, batch):
    shape = (t, N_Q) if batch is None else (batch, t, N_Q)
    codes = _codes(shape, 10 + t)
    got, want = tiny["port"].decode(codes), tiny["jax"].decode(codes)
    assert got.shape == want.shape == shape[:-2] + (t * HOP,)
    _held(got, want)


def test_decode_clips_and_reads_every_group(tiny):
    """Codes out of range clip; a decode reads every FSQ group and raises
    for n_q below it (codec_tpu's reads group 0 in place of each missing
    group and returns other audio), an encode returns every group whatever
    n_q asks, as codec_tpu's."""
    p, j = tiny["port"], tiny["jax"]
    codes = _codes((3, N_Q), 4)
    wild = codes.copy()
    wild[0, 0], wild[2, 1] = -3, V + 2
    np.testing.assert_array_equal(p.decode(wild),
                                  p.decode(np.clip(wild, 0, V - 1)))
    doubled = codes.copy()
    doubled[:, 1] = doubled[:, 0]
    _held(j.decode(codes, n_q=1), p.decode(doubled))
    for call in (lambda: p.decode(codes, n_q=1),
                 lambda: p.decode(codes[:, :1]),
                 lambda: p.decode_many([codes[:, :1]])):
        with pytest.raises(CodecError, match="reads all 2 FSQ groups"):
            call()


def _x1(p, pcm):
    """The FSQ's value before the round, f64, [B, T, G, d]."""
    with torch.inference_mode():
        z = nemo.nemo_encode_latent_fn(p.params, torch.from_numpy(pcm),
                                       p.cfg).double().numpy()
    f = {k: v.double().numpy() for k, v in p.params["fsq"].items()}
    b, t, _ = z.shape
    zg = z.reshape(b, t, p.cfg.n_q, -1)
    return np.tanh(zg + f["in_shift"]) * f["out_scale"] - f["out_offset"]


SHORTEST = next(n for n in range(1, HOP) if nemo.encode_frames(SMALL, n))


@pytest.mark.parametrize("n", [HOP * 2, HOP * 3 + 11, SHORTEST])
def test_encode_matches_jax(tiny, n):
    """Raw lengths on both sides (the frames the strided replicate convs
    give: 3·hop + 11 samples give 3, the shortest input 1)."""
    pcm = _pcm((2, n), 20 + n)
    got, want = tiny["port"].encode(pcm), tiny["jax"].encode(pcm)
    assert got.shape == want.shape == (2, nemo.encode_frames(SMALL, n), N_Q)
    assert got.shape[1] == max(n // HOP, 1)
    x1 = _x1(tiny["port"], pcm)
    for b in range(2):
        assert_level_codes(got[b], want[b], x1[b], LEVELS)


def test_encode_int16_n_q_and_round_trip(tiny):
    p = tiny["port"]
    pcm = _pcm(HOP * 2, 7)
    i16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(p.encode(i16), tiny["jax"].encode(i16))
    codes = p.encode(pcm)
    np.testing.assert_array_equal(p.encode(pcm, n_q=1), codes)
    np.testing.assert_array_equal(p.encode(pcm, n_q=1),
                                  tiny["jax"].encode(pcm, n_q=1))
    back = p.decode(codes)
    assert back.shape == (2 * HOP,) and np.isfinite(back).all()


def test_half_snake_leaky_relu_and_fsq_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 37)).astype(np.float32) * 2
    alpha = np.abs(rng.standard_normal(4)).astype(np.float32)
    alpha[1] = 0.0                                  # clamped at 1e-9
    got = nemo._half_snake(torch.from_numpy(x), torch.from_numpy(alpha))
    want = jnemo._half_snake(jnp.asarray(x.transpose(0, 2, 1)),
                             jnp.asarray(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(
        0, 2, 1), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        act.leaky_relu(torch.from_numpy(x), 0.01).numpy(),
        np.asarray(jact.leaky_relu(jnp.asarray(x), 0.01)))
    c = fsq_constants(LEVELS)
    fsq_t = {k: torch.from_numpy(c[k]) for k in nemo.FSQ_KEYS}
    fsq_j = {k: jnp.asarray(c[k]) for k in nemo.FSQ_KEYS}
    z = rng.standard_normal((2, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        nemo.fsq_encode(torch.from_numpy(z), fsq_t, 2, 2).numpy(),
        np.asarray(jnemo.fsq_encode(jnp.asarray(z), fsq_j, 2, 2)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_decode_matches_jax(tiny, dtype):
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype=dtype)
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype=dtype,
                                     device="cpu")
    assert p16.params["dec_up"][0]["w"].dtype == getattr(torch, dtype)
    assert p16.params["fsq"]["scale"].dtype == torch.float32
    codes = _codes((2, 3, N_Q), 30)
    got, want = p16.decode(codes), j16.decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    assert np.corrcoef(got.ravel(), tiny["port"].decode(codes).ravel()
                       )[0, 1] > 0.99
    c = p16.encode(_pcm(HOP * 2, 31))
    assert c.shape == (2, N_Q) and c.min() >= 0 and c.max() < V


def test_errors_and_aliases_match_jax(tiny, tmp_path):
    from codec_tpu.models.registry import get_model_class as jget
    from codec_tpu_torch.models.registry import get_model_class

    for alias in ("nemo_nano_codec", "nemo-nano-codec", "nemo"):
        assert get_model_class(alias) is nemo.NemoNanoCodec
        assert jget(alias).__name__ == "NemoNanoCodec"
    path = tmp_path / "dec.gguf"
    write_random_nemo_gguf(path, seed=0, cfg=SMALL, **WIDTHS)
    d, jd = codec_tpu_torch.load_model(path, device="cpu"), \
        codec_tpu.load_model(path)
    assert not d.has_encoder and not jd.has_encoder
    codes = _codes((2, N_Q), 5)
    np.testing.assert_array_equal(d.decode(codes), tiny["port"].decode(codes))
    with pytest.raises(CodecError, match="has no encoder"):
        d.encode(_pcm(HOP, 1))
    p = tiny["port"]
    # shorter than a stage's kernel: codec_tpu fails in a pad, the port
    # raises CodecError
    short = _pcm(SHORTEST - 1, 3)
    with pytest.raises(ValueError):
        tiny["jax"].encode(short)
    with pytest.raises(CodecError, match="too short"):
        p.encode(short)
    for call in (lambda: p.decode(np.zeros((0, N_Q), np.int32)),
                 lambda: p.encode(np.zeros(0, np.float32)),
                 lambda: p.encode(_pcm(HOP, 2), n_q=N_Q + 1),
                 lambda: p.decode_latent(np.zeros((2, 4), np.float32))):
        with pytest.raises(CodecError):
            call()


def test_cli_matches_codec_cli(tiny, tmp_path):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    path = str(tiny["path"])
    write_wav(tmp_path / "in.wav", _pcm(HOP * 3, 40), 22050)
    for tag, fn, extra in (("p", main, ["--device", "cpu"]), ("j", jmain, [])):
        assert fn(["e2e", "--model", path, "--in", str(tmp_path / "in.wav"),
                   "--out", str(tmp_path / f"{tag}.wav"), *extra]) == 0
        assert fn(["encode", "--model", path, "--in",
                   str(tmp_path / "in.wav"), "--codes",
                   str(tmp_path / f"{tag}.npy"), *extra]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  np.load(tmp_path / "j.npy"))
    (x, sr), (y, _) = (read_wav(tmp_path / f"{t}.wav", keep_i16=True)
                       for t in "pj")
    assert sr == 22050 and x.shape == y.shape == (3 * HOP, 1)
    assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
