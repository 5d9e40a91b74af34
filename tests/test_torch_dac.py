"""The port's DAC decode (codec_tpu_torch) against codec_tpu's on the CPU.

Both packages load one GGUF and decode the same codes or latents from a
NumPy seed. f32 bound: correlation > 0.99999 and max abs error <= 1e-4 *
peak, as for Mimi (tests/test_torch_mimi.py): the same f32 math with
reductions in other orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.ops import conv as jconv
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.models import dac, dac_init
from codec_tpu_torch.ops import conv

V, NQ = 32, 4             # the tiny fixture's codebook size and count


def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err = np.abs(got - want).max()
    peak = np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def _codes(shape, v, seed):
    return np.random.default_rng(seed).integers(0, v, shape).astype(np.int32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny HF DacModel of tests/test_dac_parity.py, converted once."""
    from transformers import DacConfig, DacModel

    from codec_tpu.convert import get_converter

    torch.manual_seed(0)
    cfg = DacConfig(
        encoder_hidden_size=8, decoder_hidden_size=32,
        downsampling_ratios=[2, 4, 5, 8], upsampling_ratios=[8, 5, 4, 2],
        n_codebooks=NQ, codebook_size=V, codebook_dim=4, hidden_size=64,
        sampling_rate=24000)
    hf = DacModel(cfg).eval()
    cv = get_converter("dac")(quantization="F32")
    cv.load_from_state_dict({k: v.numpy() for k, v in hf.state_dict().items()},
                            cfg.to_dict())
    path = tmp_path_factory.mktemp("dac") / "tiny_dac.gguf"
    cv.convert_and_save(path)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "dac" and "dac" in codec_tpu_torch.known_archs()
    assert p.cfg == dac.DacConfig(**vars(j.cfg))
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time"):
        assert getattr(p, a) == getattr(j, a), a


def test_load_matches_params_from_jax(tiny):
    """load_dac_params reads the GGUF's PyTorch layouts; it must equal
    codec_tpu's load of the same file (WIO, pre-flipped convtrs),
    converted, bit for bit."""
    want = dac.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 0
    for a, b in zip(flat_w, flat_g):
        assert torch.equal(a, b)
        assert a.is_contiguous() and b.is_contiguous()   # the kernels' rule


def test_unit_rows_are_cached_at_load(tiny):
    """Each block's f32 rows are built once at load and equal unit_vec's
    of its alphas and biases (what the wrappers built on every call)."""
    from codec_tpu_torch.ops import seanet_cuda

    for blk in tiny["port"].params["dec_blocks"]:
        u = blk["units"]
        assert u["vec"].shape == (3, 6, u["a1"].shape[-1])
        assert torch.equal(u["vec"], seanet_cuda.unit_vec(
            u["a1"], u["b1"], u["a2"], u["b2"]))


@pytest.mark.parametrize("t", [11, 40])
def test_decode_matches_jax(tiny, t):
    codes = _codes((t, NQ), V, t)
    got = tiny["port"].decode(codes)
    want = tiny["jax"].decode(codes)
    assert got.shape == want.shape == (320 * t - 8,)
    _assert_close_pcm(got, want)


def test_decode_partial_nq_and_clipped_codes_match_jax(tiny):
    codes = _codes((15, NQ), V, 1)
    codes[0, 0], codes[4, 1] = -3, 500
    for n_q in (1, 2):
        _assert_close_pcm(tiny["port"].decode(codes, n_q=n_q),
                          tiny["jax"].decode(codes, n_q=n_q))


def test_batched_decode_matches_single(tiny):
    p = tiny["port"]
    codes = _codes((3, 9, NQ), V, 2)
    batched = p.decode(codes)
    assert batched.shape == (3, 320 * 9 - 8)
    for i in range(3):
        np.testing.assert_allclose(batched[i], p.decode(codes[i]),
                                   rtol=1e-5, atol=1e-6)


def test_i16_within_one_step_of_jax(tiny):
    codes = _codes((12, NQ), V, 3)
    got = tiny["port"].decode(codes, pcm_format="i16")
    want = tiny["jax"].decode(codes, pcm_format="i16")
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    # f32 reduction-order noise may move a sample across a rounding
    # boundary by one step
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_decode_latent_matches_jax(tiny):
    z = np.random.default_rng(4).standard_normal((2, 7, 64)).astype(np.float32)
    got = tiny["port"].decode_latent(z)
    want = tiny["jax"].decode_latent(z)
    assert got.shape == want.shape == (2, 320 * 7 - 8)
    _assert_close_pcm(got, want)
    one = tiny["port"].decode_latent(z[1])
    np.testing.assert_allclose(one, got[1], rtol=1e-5, atol=1e-6)
    i16 = tiny["port"].decode_latent(z[0], pcm_format="i16")
    assert i16.dtype == np.int16
    assert np.abs(i16.astype(np.int32)
                  - np.rint(got[0] * 32767.0).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("codes_shape,n_q,fmt", [
    ((5,), 0, "f32"),
    ((0, NQ), 0, "f32"),
    ((5, NQ), NQ + 1, "f32"),
    ((5, NQ), -1, "f32"),
    ((5, 2), 3, "f32"),
    ((5, NQ), 0, "f64"),
])
def test_bad_decode_arguments_raise(tiny, codes_shape, n_q, fmt):
    with pytest.raises(CodecError):
        tiny["port"].decode(np.zeros(codes_shape, np.int32), n_q=n_q,
                            pcm_format=fmt)


@pytest.mark.parametrize("shape", [(5,), (5, 63), (0, 64), (1, 1, 5, 64)])
def test_bad_latent_shape_raises(tiny, shape):
    with pytest.raises(CodecError, match="bad latent shape"):
        tiny["port"].decode_latent(np.zeros(shape, np.float32))


def test_encode_not_yet_ported(tiny, tmp_path):
    """Encode is ported (the HF fixture has an encoder); a decode-only
    file raises."""
    assert tiny["port"].encode(np.zeros(320, np.float32)).shape == (1, NQ)
    path = tmp_path / "decode_only.gguf"
    dac_init.write_random_dac_gguf(path, seed=0, cfg=dac.DacConfig(
        n_q=2, codebook_size=16, codebook_dim=4, latent_dim=8), decoder_dim=16)
    dec_only = codec_tpu_torch.load_model(path, device="cpu")
    assert not dec_only.has_encoder
    with pytest.raises(CodecError, match="no encoder"):
        dec_only.encode(np.zeros(320, np.float32))


def test_output_length_follows_causality(tiny, tmp_path):
    """DAC is not causal: it keeps codec_tpu's full 320*T - 8 samples;
    a Mimi decode is still cropped to T * hop."""
    from codec_tpu_torch.models.mimi import MimiConfig
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf

    for t in (11, 40):
        codes = _codes((t, NQ), V, 5)
        n = tiny["jax"].decode(codes).shape[0]
        assert tiny["port"].decode(codes).shape == (n,) == (320 * t - 8,)
    path = tmp_path / "mimi.gguf"
    write_random_mimi_gguf(path, seed=0, num_filters=8, cfg=MimiConfig(
        n_q=2, codebook_size=16, codebook_dim=8, hidden=32, n_layers=1,
        n_heads=2, head_dim=16, intermediate=64, window=10))
    mimi = codec_tpu_torch.load_model(path, device="cpu")
    assert mimi.causal_time
    assert mimi.decode(_codes((3, 2), 16, 6)).shape == (3 * 1920,)


@pytest.mark.parametrize("s", [8, 5, 4, 2])
def test_convtr_at_the_upsampling_strides(s):
    """k = 2s, padding ceil(s/2): T*s + s - 2*ceil(s/2) samples (5T - 1 at
    s = 5). The port's convtr1d (pre-flipped WIO) and DAC's conv-transpose
    (PyTorch layout) against codec_tpu's convtr1d, f32 at 1e-5."""
    rng = np.random.default_rng(s)
    t, cin, cout = 13, 6, 5
    x = rng.standard_normal((2, t, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, cout, 2 * s)) / np.sqrt(2 * s * cin)
         ).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    w_wio = w[:, :, ::-1].transpose(2, 0, 1).copy()
    pad = (s + 1) // 2
    want = np.asarray(jconv.convtr1d(jnp.asarray(x), jnp.asarray(w_wio),
                                     jnp.asarray(b), stride=s, padding=pad))
    assert want.shape == (2, t * s + s - 2 * pad, cout)
    got = conv.convtr1d(torch.from_numpy(x), torch.from_numpy(w_wio),
                        torch.from_numpy(b), stride=s, padding=pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got = dac._convtr(torch.from_numpy(x), {"w": torch.from_numpy(w),
                                            "b": torch.from_numpy(b)})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bfloat16_compute_decodes(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["dec_blocks"][0]["units"]["w1"].dtype == torch.bfloat16
    codes = _codes((6, NQ), V, 7)
    got, want = p16.decode(codes), tiny["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99


def test_cli_info_and_decode(tiny, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    codes = _codes((8, NQ), V, 8)
    np.save(tmp_path / "c.npy", codes)
    out = tmp_path / "o.wav"
    assert main(["info", "--model", str(tiny["path"])]) == 0
    assert "architecture: dac" in capsys.readouterr().out
    assert main(["decode", "--model", str(tiny["path"]), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(out), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    want = tmp_path / "want.wav"
    write_wav(want, tiny["port"].decode(codes), 24000)
    assert out.read_bytes() == want.read_bytes()
    x, sr = read_wav(out)
    assert sr == 24000 and x.shape == (320 * 8 - 8, 1)


def test_random_params_shapes_and_rates():
    cfg = dac.DacConfig(n_q=2, codebook_size=16, codebook_dim=4, latent_dim=8)
    p = dac_init.random_dac_params(cfg, seed=0, decoder_dim=16)
    assert p["dec.model.0.weight"].shape == (16, 8, 7)
    assert p["dec.model.1.block.conv_t1.weight"].shape == (16, 8, 16)
    assert p["dec.model.4.block.res_unit3.conv1.weight"].shape == (1, 1, 7)
    assert p["dec.model.6.weight"].shape == (1, 1, 7)
    assert np.array_equal(p["vq.q1.codebook.weight"], dac_init.random_dac_params(
        cfg, seed=0, decoder_dim=16)["vq.q1.codebook.weight"])
    with pytest.raises(ValueError, match="rates"):
        dac_init.random_dac_params(cfg, rates=(8, 5, 4, 3))


def test_full_width_random_gguf_decodes_alike_in_both(tmp_path):
    """descript/dac_24khz widths (latent 1024, decoder 1536, rates
    8/5/4/2, 9 x 1024 x 8 codebooks) with random weights from a seed,
    T = 8 frames; the output is not saturated."""
    path = tmp_path / "dac_full.gguf"
    dac_init.write_random_dac_gguf(path, seed=0)
    j = codec_tpu.load_model(path)
    p = codec_tpu_torch.load_model(path, device="cpu")
    assert p.cfg == dac.DacConfig() and GGUFReader(path).architecture == "dac"
    assert [tuple(b["units"]["w1"].shape) for b in p.params["dec_blocks"]] == [
        (3, 7, c, c) for c in (768, 384, 192, 96)]
    codes = _codes((8, 9), 1024, 9)
    got = p.decode(codes)
    assert got.shape == (320 * 8 - 8,)
    _assert_close_pcm(got, j.decode(codes))
    assert (np.abs(got) > 0.99).mean() < 0.01


def test_decode_fn_takes_a_res_units_hook(tiny):
    """dac_decode_fn runs the units through its hook; on the CPU the
    kernels' wrappers and the plain version are the same math."""
    p = tiny["port"]
    codes = torch.from_numpy(_codes((1, 6, NQ), V, 10)).long()
    calls = []

    def hook(x, units):
        calls.append(tuple(x.shape))
        return dac.plain_res_units(x, units)

    with torch.inference_mode():
        got = dac.dac_decode_fn(p.params, codes, p.cfg, res_units=hook)
        want = dac.dac_decode_fn(p.params, codes, p.cfg)
    assert [c[-1] for c in calls] == [16, 8, 4, 2]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_profile_tool_needs_a_card():
    """The profiler script fails, and prints no result, without CUDA."""
    from codec_tpu_torch.tools.profile_decode import main

    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["dac"])
