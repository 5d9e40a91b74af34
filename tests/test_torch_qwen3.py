"""The port's Qwen3-TTS-Tokenizer (codec_tpu_torch.models.qwen3_tts) and
`ops/attn.py::mha` with grouped KV heads and biases, against codec_tpu's on
the CPU: small random GGUFs (the port's writer, the wire names both loaders
read), loaded by both packages, the same codes and PCM from a NumPy seed.

Two files: grouped KV heads (4 heads, 2 KV heads), q/k/v/o biases and a
window of 3 frames (< T), with the Mimi encoder; and full causal attention
(window 0) without grouping or biases, decode only. f32 bound: correlation
> 0.99999, max abs err <= 1e-4 x peak. Encode codes equal, or differing
only at f64 near-ties (tests/encode_ties.py). The attention runs through
flash_sdpa_window's plain version, the search through rvq_encode_fused's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.ops import attn as jattn
from codec_tpu.ops import rope as jrope
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import qwen3_tts as q3
from codec_tpu_torch.models.qwen3_tts_init import (QWEN3_ENCODER,
                                                   QWEN3_TTS_12HZ,
                                                   write_random_q3t_gguf)
from codec_tpu_torch.ops import attn, rope
from encode_ties import assert_codes, mimi_margin

HOP, V = 1920, 64
# tests/test_qwen3_tts_parity.py's small widths, grouped: 4 codebooks of
# 64 x 16, latent and hidden 32, 4 heads over 2 KV heads x 8, intermediate
# 64, decoder 64 → 4 channels over rates 8/6/5/4; the encoder a Mimi of
# hidden 64, 2 layers of 2 heads x 32, 8 filters
SMALL = dataclasses.replace(QWEN3_TTS_12HZ, n_q=4, codebook_size=V,
                            codebook_dim=16, latent_dim=32, hidden=32,
                            n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
                            intermediate=64, decoder_dim=64, window=3)
FULL_CAUSAL = dataclasses.replace(SMALL, n_kv_heads=4, window=None)
ENC = dataclasses.replace(QWEN3_ENCODER, n_q=4, codebook_size=V,
                          codebook_dim=16, hidden=64, n_layers=2, n_heads=2,
                          head_dim=32, intermediate=128)


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
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("q3t")
    write_random_q3t_gguf(tmp / "gqa.gguf", seed=0, cfg=SMALL, enc_cfg=ENC,
                          num_filters=8)
    write_random_q3t_gguf(tmp / "causal.gguf", seed=1, cfg=FULL_CAUSAL,
                          encoder=False, biases=False)
    return {"gqa": _pair(tmp / "gqa.gguf"),
            "causal": _pair(tmp / "causal.gguf")}


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _pcm(n, seed, batch=None):
    shape = (n,) if batch is None else (batch, n)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


# -- mha: grouped KV heads and biases ----------------------------------------

@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("biases", [False, True])
@pytest.mark.parametrize("n_kv", [4, 2])
def test_mha_matches_jax(n_kv, biases, window):
    """ops/attn.mha against codec_tpu's attn.mha (4 heads x 8, KV heads 4
    or 2, with and without q/k/v/o biases, full causal and a window < T),
    RoPE NEOX on both sides."""
    rng = np.random.default_rng(10 * n_kv + biases)
    t, c, h, d = 12, 32, 4, 8

    def rnd(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = rnd(2, t, c, s=1.0)
    w = {"wq": rnd(h * d, c), "wk": rnd(n_kv * d, c), "wv": rnd(n_kv * d, c),
         "wo": rnd(c, h * d)}
    b = ({"bq": rnd(h * d), "bk": rnd(n_kv * d), "bv": rnd(n_kv * d),
          "bo": rnd(c)} if biases else {})
    want = jattn.mha(jnp.asarray(x), *(jnp.asarray(w[k]) for k in w),
                     n_heads=h, n_kv_heads=n_kv, causal=True, window=window,
                     rope_fn=lambda z: jrope.apply_rope(z, neox=True),
                     **{k: jnp.asarray(v) for k, v in b.items()})
    got = attn.mha(torch.from_numpy(x), *(torch.from_numpy(w[k]) for k in w),
                   n_heads=h, n_kv_heads=n_kv, causal=True, window=window,
                   rope_fn=lambda z: rope.apply_rope(z, neox=True),
                   **{k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mha_grouped_heads_read_kv_head_h_over_rep():
    """With 4 heads over 2 KV heads, heads 0-1 read KV head 0 and 2-3 KV
    head 1: the same as 4 KV heads whose k/v rows repeat that way; and
    `attention=` still replaces the attention function."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 9, 16)).astype(np.float32))
    wq, wo = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((32, 16), (16, 32)))
    wk, wv = (torch.from_numpy(rng.standard_normal((16, 16)).astype(
        np.float32)) for _ in range(2))
    got = attn.mha(x, wq, wk, wv, wo, n_heads=4, n_kv_heads=2)
    rep = [wk.reshape(2, 8, 16)[i // 2] for i in range(4)]
    rep_v = [wv.reshape(2, 8, 16)[i // 2] for i in range(4)]
    want = attn.mha(x, wq, torch.cat(rep), torch.cat(rep_v), wo, n_heads=4)
    torch.testing.assert_close(got, want)
    calls = []

    def spy(q, k, v, window=None):
        calls.append(q.shape)
        return attn.sdpa(q, k, v, mask=attn.attn_mask(q.shape[2], k.shape[2]))

    torch.testing.assert_close(
        attn.mha(x, wq, wk, wv, wo, n_heads=4, n_kv_heads=2, attention=spy),
        got)
    assert calls == [(1, 4, 9, 8)]


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["gqa", "causal"])
def test_config_and_attrs_match(files, name):
    j, p = files[name]["jax"], files[name]["port"]
    assert p.arch == "qwen3_tts_tokenizer"
    assert p.cfg == q3.Q3TConfig(**vars(j.cfg)) == {
        "gqa": SMALL, "causal": FULL_CAUSAL}[name]
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size",
              "latent_dim", "has_encoder", "has_decoder", "causal_time"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.has_encoder == (name == "gqa")
    if name == "gqa":
        assert vars(p.enc_cfg) == vars(j.enc_cfg)
        assert p.enc_cfg.n_q == 4 and p.enc_cfg.codebook_dim == 16


@pytest.mark.parametrize("name", ["gqa", "causal"])
def test_load_matches_params_from_jax(files, name):
    want = q3.params_from_jax(files[name]["jax"].params)
    got = files[name]["port"].params
    assert sorted(want) == sorted(got)
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 100
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)
    layer = got["pt_layers"][0]
    assert layer["k_w"].shape == ((16, 32) if name == "gqa" else (32, 32))
    assert (layer["q_b"] is None) == (name == "causal")
    assert got["cb"].shape == (4, V, 16)
    assert got["ups"][0]["dw"]["w"].shape == (32, 1, 7)
    assert got["blocks"][0]["tr"]["w"].shape == (64, 32, 16)  # [C_in, C_out, K]


@pytest.mark.parametrize("t", [1, 2, 9])
@pytest.mark.parametrize("name", ["gqa", "causal"])
def test_decode_matches_jax(files, name, t):
    codes = _codes((t, 4), 10 * t + len(name))
    got, want = files[name]["port"].decode(codes), files[name]["jax"].decode(codes)
    assert got.shape == want.shape == (t * HOP,)
    _assert_close_pcm(got, want)
    assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("n_q", [1, 2])
def test_fewer_codebooks_match_jax(files, n_q):
    """n_q 1: the semantic level alone, no acoustic term."""
    codes = _codes((5, 4), 20 + n_q)
    got = files["gqa"]["port"].decode(codes, n_q=n_q)
    _assert_close_pcm(got, files["gqa"]["jax"].decode(codes, n_q=n_q))


def test_batched_clipped_async_and_i16(files):
    p, j = files["gqa"]["port"], files["gqa"]["jax"]
    codes = _codes((2, 6, 4), 3)
    codes[0, 0, 0], codes[1, 5, 3] = -2, 99
    got = p.decode(codes)
    _assert_close_pcm(got, j.decode(codes))
    for i in range(2):          # rows independent, up to the sums' order
        _assert_close_pcm(got[i], p.decode(codes[i]))
    np.testing.assert_array_equal(p.decode_async(codes).result(), got)
    many = p.decode_many([codes[0], codes[1], codes[1, :4]])
    for o, s in zip(many, (codes[0], codes[1], codes[1, :4])):
        _assert_close_pcm(o, p.decode(s))
    a, b = p.decode(codes[0], pcm_format="i16"), j.decode(codes[0],
                                                          pcm_format="i16")
    assert a.dtype == np.int16
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


# a ragged tail, whole hops, under one hop
@pytest.mark.parametrize("n", [HOP * 3 + 733, HOP * 4, 500])
def test_encode_matches_jax(files, n):
    p = files["gqa"]["port"]
    pcm = _pcm(n, n)
    got, want = p.encode(pcm), files["gqa"]["jax"].encode(pcm)
    assert got.dtype == np.int32 and got.shape == want.shape == (-(-n // HOP), 4)
    assert_codes(got, want, mimi_margin(p.enc_params, p.enc_cfg, pcm, want,
                                        got))


def test_batched_int16_encode_and_round_trip(files):
    p, j = files["gqa"]["port"], files["gqa"]["jax"]
    pcm = _pcm(HOP * 3, 5, batch=2)
    got = p.encode(pcm)
    assert got.shape == (2, 3, 4)
    for i in range(2):
        want = j.encode(pcm[i])
        assert_codes(got[i], want, mimi_margin(p.enc_params, p.enc_cfg,
                                               pcm[i], want, got[i]))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    want, got16 = j.encode(i16), p.encode(i16)
    assert_codes(got16, want, mimi_margin(
        p.enc_params, p.enc_cfg, i16.astype(np.float32) / 32768, want, got16))
    back = p.decode(p.encode(_pcm(HOP * 2, 6)))
    assert back.shape == (HOP * 2,) and np.isfinite(back).all()


def _f16_leaves(tree):
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def test_float16_decode_matches_jax(files):
    """f16 decode against codec_tpu's f16 and the port's f32 (the bf16
    tests' bound, corr > 0.99); the weights f16, none bf16."""
    path = files["gqa"]["path"]
    j16 = codec_tpu.load_model(path, compute_dtype="float16")
    p16 = codec_tpu_torch.load_model(path, compute_dtype="f16", device="cpu")
    dtypes = {t.dtype for t in _f16_leaves(p16.params) if t.is_floating_point()}
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    codes = _codes((6, 4), 16)
    got = p16.decode(codes)
    want, f32 = j16.decode(codes), files["gqa"]["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99


def test_bfloat16_decode_and_encode(files):
    path = files["gqa"]["path"]
    p16 = codec_tpu_torch.load_model(path, compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["pt_layers"][0]["q_b"].dtype == torch.bfloat16
    codes = _codes((6, 4), 7)
    got, want = p16.decode(codes), files["gqa"]["port"].decode(codes)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    c16 = p16.encode(_pcm(HOP * 2, 8))
    assert c16.shape == (2, 4) and c16.dtype == np.int32


def test_codec_errors_match_jax(files):
    """decode_latent and encode_latent raise as codec_tpu's do; encode on
    a decoder-only file; n_q out of range."""
    for name in ("gqa", "causal"):
        p, j = files[name]["port"], files[name]["jax"]
        for call in ("decode_latent", "encode_latent"):
            arg = (np.zeros((4, 32), np.float32) if call == "decode_latent"
                   else np.zeros(HOP, np.float32))
            with pytest.raises(CodecError) as got:
                getattr(p, call)(arg)
            with pytest.raises(ValueError) as want:
                getattr(j, call)(arg)
            assert str(got.value) == str(want.value)
    with pytest.raises(CodecError, match="has no encoder"):
        files["causal"]["port"].encode(_pcm(HOP, 1))
    for n_q in (5, -1):
        with pytest.raises(CodecError, match="n_q"):
            files["gqa"]["port"].decode(_codes((3, 4), 1), n_q=n_q)


def test_aliases_resolve_as_in_codec_tpu():
    """Every arch string codec_tpu registers for Qwen3-TTS-Tokenizer and
    Pocket-Mimi loads the port's class of the same name."""
    from codec_tpu.models import registry as jreg

    names = {"Qwen3TTSTokenizerCodec", "PocketMimiCodec"}
    aliases = [a for a in jreg.known_archs()
               if jreg.get_model_class(a).__name__ in names]
    assert len(aliases) == 6
    for a in aliases:
        assert codec_tpu_torch.models.registry.get_model_class(a).__name__ \
            == jreg.get_model_class(a).__name__
        assert a in codec_tpu_torch.known_archs()


def test_cli_info_decode_encode(files, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    path = str(files["gqa"]["path"])
    assert main(["info", "--model", path]) == 0
    assert "architecture: qwen3_tts_tokenizer" in capsys.readouterr().out
    codes = _codes((4, 4), 9)
    np.save(tmp_path / "c.npy", codes)
    assert main(["decode", "--model", path, "--codes", str(tmp_path / "c.npy"),
                 "--out", str(tmp_path / "o.wav"), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 24000 and x.shape == (4 * HOP, 1)
    want = files["gqa"]["port"].decode(codes, pcm_format="i16")
    assert np.abs(np.round(x[:, 0] * 32768).astype(np.int32)
                  - want.astype(np.int32)).max() <= 1
    write_wav(tmp_path / "in.wav", _pcm(HOP * 2, 11), 24000)
    assert main(["encode", "--model", path, "--in", str(tmp_path / "in.wav"),
                 "--codes", str(tmp_path / "e.npy"), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    assert np.load(tmp_path / "e.npy").shape == (2, 4)
    assert main(["decode-latent", "--model", path, "--latent",
                 str(tmp_path / "c.npy"), "--out", str(tmp_path / "z.wav"),
                 "--device", "cpu"]) == 1
