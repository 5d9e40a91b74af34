"""The port's Chatterbox S3Tokenizer (codec_tpu_torch.models.chatterbox_s3t)
against codec_tpu's on the CPU: a small random GGUF from the port's writer
(models/s3t_init.py) at the widths of tests/test_chatterbox_s3t_parity.py's
small mirror (8 mels, n_fft 64, width 16 in 2 heads, 2 layers, FSMN
kernel 5), loaded by both packages, the same PCM from a NumPy seed.

The log-mel must equal codec_tpu's bit for bit (the same f64 host code).
Tokens equal, or each differing ternary digit where the quantizer's
bounded value lies within 1e-3 of a rounding boundary (±0.5); bf16 and
f16 encodes: at least 80% of the tokens equal to codec_tpu's same dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import chatterbox_s3t as js3t
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import chatterbox_s3t as s3t
from codec_tpu_torch.models.s3t_init import S3T, write_random_s3t_gguf

SMALL = dataclasses.replace(S3T, n_mels=8, hidden=16, n_heads=2, n_layers=2,
                            fsmn_kernel=5, n_fft=64, win_length=64)
V = 6561


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("s3t") / "s3t.gguf"
    write_random_s3t_gguf(path, seed=0, cfg=SMALL)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _pcm(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(
        np.float32)


def assert_ternary_tokens(got, want, q):
    """Tokens [T, 1] equal, or at most max(2, digits / 50) ternary
    digits differ, each where the reference's bounded value q [T, 8] lies
    within 1e-3 of ±0.5. → how many differ."""
    assert got.shape == want.shape and got.dtype == np.int32
    gd, wd = ((np.asarray(c).reshape(-1, 1) // 3 ** np.arange(8)) % 3
              for c in (got, want))
    bad = np.argwhere(gd != wd)
    assert len(bad) <= max(2, gd.size // 50), f"{len(bad)} digits differ"
    for fr, d in bad:
        assert abs(abs(q[fr, d]) - 0.5) < 1e-3, (fr, d, q[fr, d])
    return len(bad)


def _q(model, pcm):
    """The reference side's bounded value [T, 8] of one row (f64)."""
    mel = torch.from_numpy(model.log_mel(pcm)[None])
    with torch.inference_mode():
        return s3t.s3t_latent_fn(model.params, mel.to(model.compute_dtype),
                                 model.cfg)[0].double().numpy()


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == j.arch == "chatterbox_s3t"
    assert p.cfg == s3t.S3TConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "encode_sample_rate", "hop_size", "n_q",
              "codebook_size", "latent_dim", "has_encoder", "has_decoder",
              "causal_time", "expected_channels", "n_fft", "win_length",
              "n_mels"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.encode_sample_rate == 16000 and not p.has_decoder


def test_load_matches_params_from_jax(tiny):
    got = _leaves(tiny["port"].params)
    want = _leaves(s3t.params_from_jax(tiny["jax"].params))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("n", [2560, 2561, 100])
def test_log_mel_equals_jax(tiny, n):
    pcm = _pcm(n, n)
    got, want = tiny["port"].log_mel(pcm), tiny["jax"].log_mel(pcm)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (-(-n // 640) * 4, SMALL.n_mels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch", [(2560, None), (2561, None), (640, None),
                                     (3000, 2)])
def test_encode_matches_jax(tiny, n, batch):
    p, j = tiny["port"], tiny["jax"]
    pcm = _pcm((n,) if batch is None else (batch, n), 10 + n)
    got, want = p.encode(pcm), j.encode(pcm)
    lead = () if batch is None else (batch,)
    assert got.shape == want.shape == lead + (-(-n // 640), 1)
    for g, w, row in zip(got.reshape(-1, *got.shape[-2:]),
                         want.reshape(-1, *want.shape[-2:]),
                         pcm.reshape(-1, n)):
        assert_ternary_tokens(g, w, _q(p, row))


def test_block_matches_jax(tiny):
    """One FSMN/RoPE block: non-causal attention, k without a bias, the
    FSMN depthwise conv on the pre-RoPE v."""
    j, p = tiny["jax"], tiny["port"]
    x = np.random.default_rng(3).standard_normal((2, 11, 16)).astype(
        np.float32)
    cos, sin = s3t.rope.rope_cos_sin(torch.arange(11), 8, SMALL.rope_theta)
    got = s3t._s3t_block(torch.from_numpy(x), p.params["layers"][0], cos, sin,
                         p.cfg).numpy()
    block = jax.jit(js3t._s3t_block, static_argnums=(2,))
    want = np.asarray(block(jnp.asarray(x), j.params["layers"][0], j.cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int16_and_values(tiny):
    p = tiny["port"]
    pcm = _pcm(3200, 7)
    i16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(p.encode(i16), tiny["jax"].encode(i16))
    toks = p.encode(pcm)
    assert toks.dtype == np.int32 and toks.min() >= 0 and toks.max() < V


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_encode_matches_jax(tiny, dtype):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype=dtype,
                                     device="cpu")
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype=dtype)
    assert p16.params["layers"][0]["q_w"].dtype == getattr(torch, dtype)
    pcm = _pcm(6400, 31)
    got, want = p16.encode(pcm), j16.encode(pcm)
    assert got.shape == want.shape == (10, 1)
    assert (got == want).mean() >= 0.8


def test_errors_and_aliases_match_jax(tiny, tmp_path):
    from codec_tpu.models.registry import get_model_class as jget
    from codec_tpu_torch.models.registry import get_model_class

    for alias in ("chatterbox_s3t", "chatterbox-s3t", "s3t"):
        assert get_model_class(alias) is s3t.ChatterboxS3T
        assert jget(alias).__name__ == "ChatterboxS3T"
    p, j = tiny["port"], tiny["jax"]
    for call in (lambda m: m.encode(_pcm(640, 1), n_q=2),
                 lambda m: m.encode(np.zeros(0, np.float32)),
                 lambda m: m.decode(np.zeros((4, 1), np.int32))):
        with pytest.raises(CodecError) as got:
            call(p)
        with pytest.raises(ValueError) as want:
            call(j)
        assert str(got.value) == str(want.value)
    assert p.encode(_pcm(640, 2), n_q=1).shape == (1, 1)


def test_cli_encodes_at_16khz(tiny, tmp_path, capsys):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import write_wav

    path = str(tiny["path"])
    write_wav(tmp_path / "in16.wav", _pcm(3200, 40), 16000)
    write_wav(tmp_path / "in24.wav", _pcm(3200, 40), 24000)
    for tag, fn, extra in (("p", main, ["--device", "cpu"]), ("j", jmain, [])):
        assert fn(["encode", "--model", path, "--in",
                   str(tmp_path / "in16.wav"), "--codes",
                   str(tmp_path / f"{tag}.npy"), *extra]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  np.load(tmp_path / "j.npy"))
    assert main(["encode", "--model", path, "--in",
                 str(tmp_path / "in24.wav"), "--codes",
                 str(tmp_path / "q.npy"), "--device", "cpu"]) == 1
    assert "input sample rate 24000 != model 16000" in capsys.readouterr().err
