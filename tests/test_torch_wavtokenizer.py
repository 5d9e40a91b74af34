"""The port's WavTokenizer (codec_tpu_torch.models.wavtokenizer) against
codec_tpu's on the CPU: one small random GGUF with its encoder (the port's
writer, the wire names both loaders read), loaded by both packages, the
same codes and PCM from a NumPy seed.

f32 bound: correlation > 0.99999 and max abs err <= 1e-4 x peak. Encode
codes equal, or differing only at f64 near-ties (tests/encode_ties.py).
The search runs through rvq_encode_fused, whose plain version runs here.
"""

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.io.gguf import GGUFWriter
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.models import wavtokenizer as wt
from codec_tpu_torch.models.wavtokenizer_init import random_wt_params
from encode_ties import assert_codes, euclid_margin, f64

# the widths of tests/test_wavtokenizer_parity.py (backbone 64, 2 ConvNeXt
# blocks of 96, n_fft 480 = 1.5 hops, 64 codes), a 64-wide latent, and an
# encoder of 4 filters doubling to 64
SMALL = dict(codebook_size=64, codebook_dim=64, dim=64, intermediate=96,
             n_convnext=2, n_fft=480, enc_filters=4)
HOP, V = 320, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, params, encoder=True):
    w = GGUFWriter(path, "wavtokenizer_large")
    w.add_uint32("codec.sample_rate", 24000)
    w.add_uint32("codec.hop_size", HOP)
    w.add_bool("codec.has_encoder", encoder)
    w.add_bool("codec.has_decoder", True)
    for name, arr in params.items():
        w.add_tensor(name, arr)
    w.write()


def _pair(path):
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("wt") / "tiny_wt.gguf"
    _write(path, random_wt_params(seed=0, encoder=True, **SMALL))
    return _pair(path)


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
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(
        np.float32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "wavtokenizer" and p.cfg == wt.WtConfig(**vars(j.cfg))
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.has_encoder and not p.causal_time
    assert p.cfg.use_adanorm and p.cfg.use_pos_net


def test_load_matches_params_from_jax(tiny):
    """The port's loader reads PyTorch layouts off the file; codec_tpu's
    tree of the same file, converted, must equal it bit for bit (the search
    state included)."""
    want = wt.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    assert sorted(want) == sorted(got)
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 50
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got["search"]["norms"].shape == (1, V)
    assert got["enc"]["lstm"][0]["w_ih"].shape == (256, 64)


@pytest.mark.parametrize("t", [1, 2, 9, 40])
def test_decode_matches_jax(tiny, t):
    codes = _codes((t, 1), t)
    got = tiny["port"].decode(codes)
    want = tiny["jax"].decode(codes)
    assert got.shape == want.shape == (HOP * t,)
    _assert_close_pcm(got, want)


def test_batched_and_clipped_codes_match_jax(tiny):
    codes = _codes((3, 12, 1), 5)
    codes[0, 0, 0], codes[1, 4, 0], codes[2, 7, 0] = -3, 500, V
    got, want = tiny["port"].decode(codes), tiny["jax"].decode(codes)
    assert got.shape == (3, HOP * 12)
    _assert_close_pcm(got, want)


def _margin(model, pcm, want, got):
    """near-tie margin_fn for one row: the port's latent in f64."""
    with torch.inference_mode():
        lat = f64(wt.wt_encode_latent_fn(model.params,
                                         torch.from_numpy(pcm)[None])[0])
    cb = f64(model.params["cb"])
    return lambda fr, q: euclid_margin(lat[fr], cb, want[fr, :q], got[fr, q],
                                       want[fr, q])


# a whole number of hops, a ragged tail, one hop, less than one hop (the k7
# and k16 convs' reflect pads reach past their input), one sample
@pytest.mark.parametrize("n", [HOP * 12, HOP * 5 + 77, HOP, 100, 1])
def test_encode_matches_jax(tiny, n):
    pcm = _pcm(n, n)
    got = tiny["port"].encode(pcm)
    want = tiny["jax"].encode(pcm)
    assert got.shape == want.shape == (-(-n // HOP), 1)
    assert_codes(got, want, _margin(tiny["port"], pcm, want, got))


def test_batched_and_int16_encode(tiny):
    p = tiny["port"]
    pcm = _pcm(HOP * 7 + 5, 3, batch=2)
    got = p.encode(pcm)
    assert got.shape == (2, 8, 1)
    for i in range(2):
        assert_codes(got[i], tiny["jax"].encode(pcm[i]),
                     _margin(p, pcm[i], tiny["jax"].encode(pcm[i]), got[i]))
    i16 = np.round(pcm[0] * 32767).astype(np.int16)
    assert_codes(p.encode(i16), tiny["jax"].encode(i16),
                 _margin(p, i16.astype(np.float32) / 32768, tiny["jax"].encode(
                     i16), p.encode(i16)))
    assert len(np.unique(got)) > 3            # the search picks many rows


@pytest.mark.parametrize("n,left,right", [(5, 3, 7), (1, 3, 3), (2, 0, 9),
                                          (8, 4, 4), (3, 7, 0)])
def test_reflect_pad_follows_numpy_past_the_input(n, left, right):
    x = np.arange(2 * n, dtype=np.float32).reshape(1, 2, n) + 1
    got = wt.reflect_pad(torch.from_numpy(x), left, right).numpy()
    np.testing.assert_array_equal(
        got, np.pad(x, ((0, 0), (0, 0), (left, right)), mode="reflect"))


def test_lstm_weights_stored_transposed(tmp_path, tiny):
    """The reference converter stores LSTM weights [in, 4H]: both loaders
    take that layout too, to the same parameters and codes."""
    params = random_wt_params(seed=0, encoder=True, **SMALL)
    for k in list(params):
        if ".lstm.weight_" in k:
            params[k] = np.ascontiguousarray(params[k].T)
    path = tmp_path / "wt_t.gguf"
    _write(path, params)
    pair = _pair(path)
    for a, b in zip(pair["port"].params["enc"]["lstm"],
                    tiny["port"].params["enc"]["lstm"]):
        for k in a:
            assert torch.equal(a[k], b[k])
    pcm = _pcm(HOP * 6, 8)
    np.testing.assert_array_equal(pair["port"].encode(pcm),
                                  tiny["port"].encode(pcm))
    got, want = pair["port"].encode(pcm), pair["jax"].encode(pcm)
    assert_codes(got, want, _margin(pair["port"], pcm, want, got))


def test_plain_layer_norm_and_no_pos_net(tmp_path):
    """A file without AdaLayerNorm (plain LN weights) and without pos_net:
    both loaders take the plain path, decoding alike; decode-only."""
    params = random_wt_params(seed=1, **SMALL)
    out = {}
    for k, v in params.items():
        if ".pos_net." in k:
            continue
        if k.endswith(".scale.weight"):
            out[k.replace(".scale.weight", ".weight")] = v[0]
        elif k.endswith(".shift.weight"):
            out[k.replace(".shift.weight", ".bias")] = v[0]
        else:
            out[k] = v
    path = tmp_path / "wt_plain.gguf"
    _write(path, out, encoder=False)
    pair = _pair(path)
    p = pair["port"]
    assert not p.cfg.use_adanorm and not p.cfg.use_pos_net
    assert not p.has_encoder and "pos_net" not in p.params
    codes = _codes((10, 1), 9)
    _assert_close_pcm(p.decode(codes), pair["jax"].decode(codes))
    with pytest.raises(CodecError, match="no encoder"):
        p.encode(_pcm(HOP, 1))


def test_many_and_async_match_decode(tiny):
    p = tiny["port"]
    seqs = [_codes((t, 1), 20 + t) for t in (6, 6, 9)]
    outs = p.decode_many(seqs)
    for s, o in zip(seqs, outs):
        np.testing.assert_allclose(o, p.decode(s), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p.decode_async(seqs[2]).result(),
                                  p.decode(seqs[2]))


def test_i16_and_bfloat16(tiny):
    codes = _codes((16, 1), 11)
    got = tiny["port"].decode(codes, pcm_format="i16")
    want = tiny["jax"].decode(codes, pcm_format="i16")
    assert got.dtype == np.int16
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["cnx"][0]["pw1_w"].dtype == torch.bfloat16
    assert p16.params["search"]["cb"].dtype == torch.float32
    pcm16 = p16.decode(codes)
    assert pcm16.dtype == np.float32 and np.isfinite(pcm16).all()
    assert np.corrcoef(pcm16, tiny["port"].decode(codes))[0, 1] > 0.99
    codes16 = p16.encode(_pcm(HOP * 8, 12))
    assert codes16.shape == (8, 1) and codes16.dtype == np.int32



def _f16_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _f16_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_float16_decode_matches_jax(tiny):
    """The port's f16 decode against codec_tpu's f16 and the port's f32, at
    the bf16 tests' bound (corr > 0.99); the weights are f16 (the search's
    f32), none bf16."""
    j16 = codec_tpu.load_model(tiny["path"], compute_dtype="float16")
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="f16",
                                     device="cpu")
    dtypes = {t.dtype for t in _f16_leaves(p16.params)
              if t.is_floating_point()}
    assert p16.compute_dtype == torch.float16
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    codes = _codes((12, 1), 31)
    got = p16.decode(codes)
    want, f32 = j16.decode(codes), tiny["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99


def test_aliases_resolve_as_in_codec_tpu():
    """Every arch string codec_tpu registers for the three iSTFT-head archs
    loads the port's class of the same name."""
    from codec_tpu.models import registry as jreg

    names = {"WavTokenizerCodec", "SopranoCodec", "XyTokenizerCodec"}
    aliases = [a for a in jreg.known_archs()
               if jreg.get_model_class(a).__name__ in names]
    assert len(aliases) == 6
    for a in aliases:
        assert codec_tpu_torch.models.registry.get_model_class(a).__name__ \
            == jreg.get_model_class(a).__name__
        assert a in codec_tpu_torch.known_archs()


def test_cli_encode_and_e2e(tiny, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    pcm = _pcm(HOP * 10, 13)
    wav = tmp_path / "in.wav"
    write_wav(wav, pcm, 24000)
    assert main(["encode", "--model", str(tiny["path"]), "--in", str(wav),
                 "--codes", str(tmp_path / "c.npy"), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    codes = np.load(tmp_path / "c.npy")
    assert codes.shape == (10, 1) and codes.dtype == np.int32
    assert main(["e2e", "--model", str(tiny["path"]), "--in", str(wav),
                 "--out", str(tmp_path / "o.wav"), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 24000 and x.shape == (HOP * 10, 1)
    assert GGUFReader(tiny["path"]).architecture == "wavtokenizer_large"
