"""The port's encode (codec_tpu_torch) against codec_tpu's on the CPU, both
in f32, for Mimi, DAC and SNAC.

Both packages load one GGUF and encode the same PCM from a NumPy seed.
Codes must be equal. Where a frame differs, at most max(2, T/100) frames
may, and each frame's first differing level must be a float near-tie: its
two picks' distances, recomputed in f64 from the port's latent through
codec_tpu's code prefix, differ by less than 1e-4 relative (the rule of
tests/test_mimi_fullsize.py, tests/test_dac_fullsize.py and
tests/test_snac_parity.py). Two f32 searches that sum in other orders can
flip such a tie; a wrong search cannot hide in one.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import dac as jdac
from codec_tpu.models import mimi as jmimi
from codec_tpu.models import mimi_init as jmimi_init
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.wav import read_wav, write_wav
from codec_tpu_torch.models import (dac, dac_init, mimi, mimi_init, snac,
                                    snac_init)
from encode_ties import assert_codes, f64, model_margin, mimi_margin

TESTS = Path(__file__).resolve().parent


def _pcm(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


# -- Mimi ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_mimi(tmp_path_factory):
    """The tiny HF Mimi of tests/test_torch_mimi.py with its codebooks
    spread as tests/test_mimi_fullsize.py spreads them (HF's random init
    leaves embed_sum near 0, which puts every search on a degenerate
    tie)."""
    from transformers import MimiConfig, MimiModel

    from codec_tpu.convert import get_converter

    torch.manual_seed(0)
    cfg = MimiConfig(
        sampling_rate=24000, frame_rate=12.5, audio_channels=1,
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        head_dim=32, num_key_value_heads=2, intermediate_size=128,
        num_filters=8, num_residual_layers=1, codebook_size=64,
        codebook_dim=32, vector_quantization_hidden_dimension=32,
        num_quantizers=4, num_semantic_quantizers=1, sliding_window=250,
        upsample_groups=64, upsampling_ratios=[8, 6, 5, 4],
        use_causal_conv=True)
    hf = MimiModel(cfg).eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, buf in hf.named_buffers():
            if name.endswith("codebook.embed_sum"):
                buf.copy_(torch.randn(buf.shape, generator=g))
    conv = get_converter("mimi")(quantization="F32")
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    conv.load_from_state_dict(sd, cfg.to_dict())
    path = tmp_path_factory.mktemp("mimi_enc") / "tiny_mimi.gguf"
    conv.convert_and_save(path)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def test_mimi_codes_match_jax_off_the_frame(tiny_mimi):
    """n = T·1920 + 517: the last frame is partial, so each strided conv
    pads its own input (codec_tpu re-masks its bucket pad per layer)."""
    pcm = _pcm(10 * 1920 + 517, 0, 0.3)
    j, p = tiny_mimi["jax"], tiny_mimi["port"]
    want, got = j.encode(pcm), p.encode(pcm)
    assert got.shape == (11, 4)
    # the codes are not degenerate: every level picks several rows
    assert all(len(np.unique(got[:, q])) > 2 for q in range(4))
    assert_codes(got, want, model_margin(p, pcm, want, got))


def test_mimi_batched_matches_single(tiny_mimi):
    p = tiny_mimi["port"]
    pcm = _pcm((2, 6 * 1920 + 100), 1, 0.3)
    batched = p.encode(pcm)
    assert batched.shape == (2, 7, 4)
    for i in range(2):
        np.testing.assert_array_equal(batched[i], p.encode(pcm[i]))


def test_mimi_int16_input_is_f32_over_32768(tiny_mimi):
    p = tiny_mimi["port"]
    i16 = np.clip(np.rint(_pcm(5 * 1920, 2, 0.3) * 32767), -32768,
                  32767).astype(np.int16)
    got = p.encode(i16)
    np.testing.assert_array_equal(got, p.encode(i16.astype(np.float32)
                                                / 32768.0))
    want = tiny_mimi["jax"].encode(i16)
    assert_codes(got, want, model_margin(
        p, i16.astype(np.float32) / 32768.0, want, got))


@pytest.mark.parametrize("n_q", [1, 2, 0])
def test_mimi_partial_nq_matches_jax(tiny_mimi, n_q):
    pcm = _pcm(8 * 1920, 3, 0.3)
    j, p = tiny_mimi["jax"], tiny_mimi["port"]
    want, got = j.encode(pcm, n_q=n_q), p.encode(pcm, n_q=n_q)
    assert got.shape == (8, n_q or 4)
    assert_codes(got, want, model_margin(p, pcm, want, got))


@pytest.mark.parametrize("pcm_shape,n_q", [
    ((1920,), 5),            # n_q above the model's
    ((1920,), -1),
    ((0,), 0),               # no samples
    ((1, 1, 1920), 0),       # 3-D
])
def test_mimi_bad_encode_arguments_raise(tiny_mimi, pcm_shape, n_q):
    with pytest.raises(CodecError):
        tiny_mimi["port"].encode(np.zeros(pcm_shape, np.float32), n_q=n_q)


def test_mimi_params_from_jax_encoder_half(tiny_mimi):
    """The encoder half of params_from_jax (codec_tpu's WIO weights and
    stacked layers) equals the port's own load of the file."""
    want = mimi.params_from_jax(tiny_mimi["jax"].params)
    got = tiny_mimi["port"].params
    for key in ("enc_l0", "enc_stages", "enc_l14", "etr", "dn", "sem_ip",
                "acu_ip"):
        assert key in got
        for a, b in zip(_leaves(want[key]), _leaves(got[key]), strict=True):
            assert (a is None and b is None) or torch.equal(a, b)


def test_exact_encode_follows_the_dtype_and_the_argument(tiny_mimi):
    path = tiny_mimi["path"]
    assert tiny_mimi["port"].exact_encode
    assert not codec_tpu_torch.load_model(path, compute_dtype="bfloat16",
                                          device="cpu").exact_encode
    assert not codec_tpu_torch.load_model(path, device="cpu",
                                          exact_encode=False).exact_encode


def test_mimi_bfloat16_encodes(tiny_mimi):
    p16 = codec_tpu_torch.load_model(tiny_mimi["path"],
                                     compute_dtype="bfloat16", device="cpu")
    codes = p16.encode(_pcm(4 * 1920, 4))
    assert codes.shape == (4, 4) and codes.dtype == np.int32
    assert codes.min() >= 0 and codes.max() < 64


def test_full_width_mimi_encode_matches_jax():
    """kyutai/mimi widths (hidden 512, 8 layers, 32 x 2048 x 256 codebooks,
    64 filters) with codec_tpu's random weights, 1.5 s of audio."""
    cfg = jmimi.MimiConfig()
    tree = jmimi_init.random_mimi_params(cfg, seed=0)
    pcm = _pcm((1, 18 * 1920 + 517), 5, 0.3)
    want = np.asarray(jmimi.mimi_encode_fn(tree, pcm, cfg))[0]
    params = mimi.params_from_jax(tree)
    pcfg = mimi.MimiConfig()
    with torch.inference_mode():
        got = mimi.mimi_encode_fn(params, torch.from_numpy(pcm), pcfg)
    got = got.numpy()[0]
    assert got.shape == (19, 32)
    assert_codes(got, want, mimi_margin(params, pcfg, pcm[0], want, got))


# -- DAC ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dac(tmp_path_factory):
    """The tiny HF DacModel of tests/test_torch_dac.py, converted once."""
    from transformers import DacConfig, DacModel

    from codec_tpu.convert import get_converter

    torch.manual_seed(0)
    cfg = DacConfig(
        encoder_hidden_size=8, decoder_hidden_size=32,
        downsampling_ratios=[2, 4, 5, 8], upsampling_ratios=[8, 5, 4, 2],
        n_codebooks=4, codebook_size=32, codebook_dim=4, hidden_size=64,
        sampling_rate=24000)
    hf = DacModel(cfg).eval()
    cv = get_converter("dac")(quantization="F32")
    cv.load_from_state_dict({k: v.numpy() for k, v in hf.state_dict().items()},
                            cfg.to_dict())
    path = tmp_path_factory.mktemp("dac_enc") / "tiny_dac.gguf"
    cv.convert_and_save(path)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def test_dac_codes_match_jax(tiny_dac):
    pcm = _pcm(40 * 320, 6)
    j, p = tiny_dac["jax"], tiny_dac["port"]
    want, got = j.encode(pcm), p.encode(pcm)
    assert got.shape == (40, 4)
    assert_codes(got, want, model_margin(p, pcm, want, got))


def test_dac_latent_matches_jax(tiny_dac):
    """The pre-VQ latent against dac_encode_latent_fn: corr > 0.99999 and
    max abs err <= 1e-4 * peak."""
    pcm = _pcm((2, 24 * 320), 7)
    j, p = tiny_dac["jax"], tiny_dac["port"]
    want = np.asarray(jdac.dac_encode_latent_fn(j.params, pcm, j.cfg),
                      np.float64)
    with torch.inference_mode():
        got = f64(dac.dac_encode_latent_fn(p.params, torch.from_numpy(pcm),
                                            p.cfg))
    assert got.shape == want.shape == (2, 24, 64)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_dac_partial_nq_and_batch(tiny_dac):
    p = tiny_dac["port"]
    pcm = _pcm((2, 12 * 320), 8)
    full = p.encode(pcm)
    assert full.shape == (2, 12, 4)
    np.testing.assert_array_equal(p.encode(pcm, n_q=2), full[..., :2])
    np.testing.assert_array_equal(p.encode(pcm[1]), full[1])


# -- SNAC ---------------------------------------------------------------------

def _torch_snac_module():
    spec = importlib.util.spec_from_file_location(
        "snac_parity_mirror", TESTS / "test_snac_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_snac(tmp_path_factory):
    """The torch SNAC mirror of tests/test_snac_parity.py, converted with
    the recipe of its tiny_snac fixture."""
    from codec_tpu.convert import get_converter

    m = _torch_snac_module()
    ref = m.TorchSNAC()
    c = get_converter("snac")(quantization="F32")
    c.load_from_state_dict(ref.sd, {
        "sample_rate": 24000, "encoder_rates": list(m.RATES),
        "decoder_rates": list(m.DEC_RATES), "vq_strides": list(m.VQ_STRIDES),
        "codebook_size": m.V, "codebook_dim": m.CB_DIM,
        "latent_dim": ref.latent,
        "encoder_dim": m.ENC_DIM, "decoder_dim": m.DEC_DIM,
        "depthwise": True, "noise": True,
    })
    path = tmp_path_factory.mktemp("snac_enc") / "tiny.gguf"
    c.convert_and_save(path)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def test_snac_packed_codes_match_jax(tiny_snac):
    """n not a multiple of pad_to (2048): both pad it; codes [T, 3] in the
    Orpheus packing (level q's code repeated s_q times)."""
    n = 2048 * 2 + 700
    pcm = _pcm(n, 9)
    j, p = tiny_snac["jax"], tiny_snac["port"]
    want, got = j.encode(pcm), p.encode(pcm)
    assert got.shape == (3 * 2048 // 512, 3)
    for q, s in enumerate((4, 2, 1)):
        np.testing.assert_array_equal(got[:, q], np.repeat(got[::s, q], s))
    padded = np.pad(pcm, (0, 3 * 2048 - n))
    assert_codes(got, want, model_margin(p, padded, want, got))


def test_snac_int16_and_batch(tiny_snac):
    p = tiny_snac["port"]
    pcm = _pcm((2, 2048), 10, 0.3)
    i16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    got = p.encode(i16)
    assert got.shape == (2, 4, 3)
    np.testing.assert_array_equal(got, p.encode(i16.astype(np.float32)
                                                / 32768.0))
    np.testing.assert_array_equal(got[0], p.encode(i16[0]))


# -- the random writers and the CLI -------------------------------------------

SMALL_MIMI = mimi.MimiConfig(n_q=4, codebook_size=64, codebook_dim=32,
                             hidden=64, n_layers=2, n_heads=2, head_dim=32,
                             intermediate=128, window=20)


@pytest.mark.parametrize("arch", ["mimi", "dac", "snac"])
def test_random_writers_with_encoder_encode_alike(arch, tmp_path):
    """Files written with encoder=True hold the encoder under the wire
    names codec_tpu reads; the decoder is the same as without it."""
    path, plain = tmp_path / f"{arch}.gguf", tmp_path / f"{arch}_dec.gguf"
    if arch == "mimi":
        kw = dict(seed=1, cfg=SMALL_MIMI, num_filters=8)
        write, n = mimi_init.write_random_mimi_gguf, 5 * 1920 + 9
    elif arch == "dac":
        kw = dict(seed=1, decoder_dim=32, cfg=dac.DacConfig(
            n_q=4, codebook_size=32, codebook_dim=4, latent_dim=64))
        write, n = dac_init.write_random_dac_gguf, 30 * 320
    else:
        kw = dict(seed=1, decoder_dim=32, cfg=snac.SnacConfig(
            latent_dim=64, codebook_size=64, codebook_dim=8))
        write, n = snac_init.write_random_snac_gguf, 2 * 2048
    write(path, encoder=True, **kw)
    write(plain, **kw)
    j = codec_tpu.load_model(path)
    p = codec_tpu_torch.load_model(path, device="cpu")
    assert p.has_encoder and j.has_encoder
    assert not codec_tpu_torch.load_model(plain, device="cpu").has_encoder
    pcm = _pcm(n, 11, 0.3)
    want, got = j.encode(pcm), p.encode(pcm)
    assert_codes(got, want, model_margin(p, pcm, want, got))
    codes = np.random.default_rng(12).integers(
        0, p.codebook_size, (8, p.n_q)).astype(np.int32)
    dec_only = codec_tpu_torch.load_model(plain, device="cpu")
    np.testing.assert_array_equal(p.decode(codes), dec_only.decode(codes))


def test_cli_encode_matches_jax_and_e2e_writes_a_wav(tiny_mimi, tmp_path,
                                                     capsys):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main

    pcm = _pcm(6 * 1920 + 300, 13, 0.3)
    wav = tmp_path / "in.wav"
    write_wav(wav, pcm, 24000)
    model = str(tiny_mimi["path"])
    assert jmain(["encode", "--model", model, "--in", str(wav), "--codes",
                  str(tmp_path / "want.npy")]) == 0
    assert main(["encode", "--model", model, "--in", str(wav), "--codes",
                 str(tmp_path / "got.npy"), "--device", "cpu", "--dtype",
                 "float32"]) == 0
    want, got = np.load(tmp_path / "want.npy"), np.load(tmp_path / "got.npy")
    assert got.dtype == want.dtype == np.int32 and got.shape == (7, 4)
    x, _ = read_wav(wav)
    assert_codes(got, want, model_margin(tiny_mimi["port"], x[:, 0], want,
                                         got))
    out = tmp_path / "out.wav"
    assert main(["e2e", "--model", model, "--in", str(wav), "--out", str(out),
                 "--device", "cpu", "--nq", "2"]) == 0
    y, sr = read_wav(out)
    assert sr == 24000 and y.shape == (7 * 1920, 1)
    write_wav(tmp_path / "16k.wav", pcm, 16000)
    assert main(["encode", "--model", model, "--in", str(tmp_path / "16k.wav"),
                 "--codes", str(tmp_path / "x.npy"), "--device", "cpu"]) == 1
    assert "sample rate" in capsys.readouterr().err


# -- the base model's continuous-latent encode ----------------------------------

@pytest.mark.parametrize("arch", ["mimi", "dac", "snac"])
def test_encode_latent_raises_as_the_reference_does(arch, request):
    """None of the ported archs has a continuous-latent encode: the port's
    model raises the reference's CodecError, with its message."""
    import codec_tpu.runtime.model as jmodel

    fixture = request.getfixturevalue(f"tiny_{arch}")
    pcm = _pcm(4 * 1920, 14)
    with pytest.raises(jmodel.CodecError) as want:
        fixture["jax"].encode_latent(pcm)
    with pytest.raises(CodecError) as got:
        fixture["port"].encode_latent(pcm)
    assert str(got.value) == str(want.value)
    assert str(got.value).endswith("continuous-latent encode not supported")
