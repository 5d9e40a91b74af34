"""The port's Mimi decode (codec_tpu_torch) against codec_tpu's on the CPU.

Both packages load one GGUF and decode the same codes from a NumPy seed.
f32 bound: correlation > 0.99999 and max abs error <= 1e-4 * peak — the two
run the same f32 math with reductions in different orders.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import mimi as jmimi
from codec_tpu.models import mimi_init as jmimi_init
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.io.wav import write_wav
from codec_tpu_torch.models import mimi, mimi_init

ROOT = Path(__file__).resolve().parent.parent


def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err = np.abs(got - want).max()
    peak = np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny HF Mimi of tests/test_mimi_parity.py, converted once."""
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
    conv = get_converter("mimi")(quantization="F32")
    conv.load_from_state_dict({k: v.numpy() for k, v in hf.state_dict().items()},
                              cfg.to_dict())
    path = tmp_path_factory.mktemp("mimi") / "tiny_mimi.gguf"
    conv.convert_and_save(path)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu"), "hf": hf}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _codes(shape, v, seed):
    return np.random.default_rng(seed).integers(0, v, shape).astype(np.int32)


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "mimi" and p.cfg == mimi.MimiConfig(**vars(j.cfg))
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder"):
        assert getattr(p, a) == getattr(j, a), a


def test_load_matches_params_from_jax(tiny):
    """load_mimi_params reads the GGUF straight into PyTorch layouts; it
    must equal codec_tpu's load of the same file, converted."""
    want = mimi.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 0
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)


def test_decode_matches_jax_past_the_window(tiny):
    """T=150 frames: the transformer sees T=300, past its 250 window."""
    codes = _codes((150, 4), 64, 0)
    _assert_close_pcm(tiny["port"].decode(codes), tiny["jax"].decode(codes))


def test_decode_partial_nq_matches_jax(tiny):
    codes = _codes((20, 4), 64, 3)
    for n_q in (1, 2):
        _assert_close_pcm(tiny["port"].decode(codes, n_q=n_q),
                          tiny["jax"].decode(codes, n_q=n_q))


def test_out_of_range_codes_are_clipped_like_jax(tiny):
    codes = _codes((12, 4), 64, 4)
    codes[0, 0], codes[3, 2] = -5, 1000
    _assert_close_pcm(tiny["port"].decode(codes), tiny["jax"].decode(codes))


def test_batched_decode_matches_single(tiny):
    p = tiny["port"]
    codes = _codes((3, 7, 4), 64, 5)
    batched = p.decode(codes)
    assert batched.shape == (3, 7 * 1920)
    for i in range(3):
        np.testing.assert_allclose(batched[i], p.decode(codes[i]),
                                   rtol=1e-5, atol=1e-6)


def test_i16_is_write_wav_exact_and_matches_jax(tiny, tmp_path):
    p = tiny["port"]
    codes = _codes((9, 4), 64, 6)
    f32 = p.decode(codes)
    i16 = p.decode(codes, pcm_format="i16")
    assert i16.dtype == np.int16 and i16.shape == f32.shape
    np.testing.assert_array_equal(
        i16, np.clip(np.rint(f32 * 32767.0), -32768, 32767).astype(np.int16))
    write_wav(tmp_path / "a.wav", i16, 24000)
    write_wav(tmp_path / "b.wav", f32, 24000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    j16 = tiny["jax"].decode(codes, pcm_format="i16")
    assert j16.dtype == np.int16
    # the two frameworks round the same formula; f32 reduction-order
    # noise may move a sample across a rounding boundary by one step
    assert np.abs(i16.astype(np.int32) - j16.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("codes_shape,n_q,fmt", [
    ((5,), 0, "f32"),            # 1-D
    ((1, 1, 5, 4), 0, "f32"),    # 4-D
    ((0, 4), 0, "f32"),          # T = 0
    ((5, 4), 5, "f32"),          # n_q above the model's
    ((5, 4), -1, "f32"),         # negative n_q
    ((5, 2), 3, "f32"),          # fewer code columns than n_q
    ((5, 4), 0, "f64"),          # unknown pcm_format
])
def test_bad_decode_arguments_raise(tiny, codes_shape, n_q, fmt):
    with pytest.raises(CodecError):
        tiny["port"].decode(np.zeros(codes_shape, np.int32), n_q=n_q,
                            pcm_format=fmt)


def test_encode_and_streaming_not_yet_ported(tiny, tmp_path):
    """Encode and the streaming sessions are ported; a decode-only file
    has no encoder, so its streaming_encoder and encode raise, and its
    streaming_decoder opens."""
    p = tiny["port"]
    assert p.has_encoder
    assert p.streaming_decoder() is not None
    assert p.streaming_encoder() is not None
    path = tmp_path / "decode_only.gguf"
    mimi_init.write_random_mimi_gguf(path, seed=0, cfg=SMALL, num_filters=8)
    dec_only = codec_tpu_torch.load_model(path, device="cpu")
    assert not dec_only.has_encoder
    with pytest.raises(CodecError, match="no encoder"):
        dec_only.streaming_encoder()
    with pytest.raises(CodecError, match="no encoder"):
        dec_only.encode(np.zeros(1920, np.float32))
    assert dec_only.streaming_decoder().push(
        np.zeros((1, 4), np.int32)).shape == (1920,)


def test_decode_matches_hf_directly(tiny):
    """The gate against HF MimiModel itself, beside the one against
    codec_tpu: the same codes through MimiModel.decode (T=150 frames, past
    the 250-frame window of the transformer's 300 steps)."""
    codes = _codes((150, 4), 64, 14)
    with torch.no_grad():
        want = tiny["hf"].decode(torch.from_numpy(codes.T[None]).long()
                                 )[0].numpy()[0, 0]
    _assert_close_pcm(tiny["port"].decode(codes), want)


def test_partial_nq_decode_matches_hf_directly(tiny):
    codes = _codes((10, 4), 64, 15)
    with torch.no_grad():
        want = tiny["hf"].decode(torch.from_numpy(codes.T[None, :2]).long()
                                 )[0].numpy()[0, 0]
    _assert_close_pcm(tiny["port"].decode(codes, n_q=2), want)


def test_encode_matches_hf_directly(tiny):
    """MimiModel.encode's codes on a partial last frame: equal, or differing
    only at f64 near-ties (tests/encode_ties.py)."""
    from encode_ties import assert_codes, mimi_margin

    p = tiny["port"]
    pcm = (np.random.default_rng(16).standard_normal(6 * 1920 + 517)
           * 0.1).astype(np.float32)
    with torch.no_grad():
        want = tiny["hf"].encode(torch.from_numpy(pcm)[None, None]
                                 ).audio_codes.numpy()[0].T.astype(np.int32)
    got = p.encode(pcm)
    assert_codes(got, want, mimi_margin(p.params, p.cfg, pcm, want, got))


def test_unported_arch_raises(tmp_path):
    """Every arch of codec_tpu is ported, so a made-up one stands in."""
    w = GGUFWriter(tmp_path / "other.gguf", "no_such_codec")
    w.add_tensor("x", np.zeros(4, np.float32))
    w.write()
    with pytest.raises(CodecError,
                       match="'no_such_codec' is not yet ported"):
        codec_tpu_torch.load_model(tmp_path / "other.gguf", device="cpu")


def test_bfloat16_compute_decodes(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["dtr"][0]["q_w"].dtype == torch.bfloat16
    codes = _codes((6, 4), 64, 7)
    got = p16.decode(codes)
    want = tiny["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99


def test_resolve_compute_dtype(tmp_path):
    from codec_tpu_torch.runtime.model import resolve_compute_dtype

    def reader(st):
        w = GGUFWriter(tmp_path / f"{st}.gguf", "mimi")
        w.add_tensor("big", np.ones((64, 64), np.float32), st)
        w.add_tensor("small", np.ones(8, np.float32), "F32")
        w.write()
        return GGUFReader(tmp_path / f"{st}.gguf")

    assert resolve_compute_dtype("auto", reader("F32")) == torch.float32
    assert resolve_compute_dtype("auto", reader("F16")) == torch.bfloat16
    assert resolve_compute_dtype("auto", reader("BF16")) == torch.bfloat16
    assert resolve_compute_dtype("auto", reader("Q8_0")) == torch.float32
    assert resolve_compute_dtype("bf16") == torch.bfloat16
    with pytest.raises(CodecError):
        resolve_compute_dtype("float64")


def test_cli_info_and_decode(tiny, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav

    codes = _codes((8, 4), 64, 8)
    np.save(tmp_path / "c.npy", codes)
    out = tmp_path / "o.wav"
    assert main(["info", "--model", str(tiny["path"])]) == 0
    assert "architecture: mimi" in capsys.readouterr().out
    assert main(["decode", "--model", str(tiny["path"]), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(out), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    want = tmp_path / "want.wav"
    write_wav(want, tiny["port"].decode(codes), 24000)
    assert out.read_bytes() == want.read_bytes()
    x, sr = read_wav(out)
    assert sr == 24000 and x.shape == (8 * 1920, 1)
    assert main(["decode", "--model", str(tiny["path"]), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(out), "--device", "cpu",
                 "--nq", "9"]) == 1


SMALL = mimi.MimiConfig(n_q=4, codebook_size=64, codebook_dim=32, hidden=64,
                        n_layers=2, n_heads=2, head_dim=32, intermediate=128,
                        window=20)


def test_random_params_follow_jax_draws():
    tree = jmimi_init.random_mimi_params(jmimi.MimiConfig(**vars(SMALL)),
                                         num_filters=8, seed=3)
    want = mimi.params_from_jax(tree)
    got = mimi_init.random_mimi_params(SMALL, num_filters=8, seed=3)
    flat_w, flat_g = _leaves(want), _leaves(got)
    for a, b in zip(flat_w, flat_g):
        assert (a is None and b is None) or torch.equal(a, b)


def test_written_random_gguf_decodes_alike_in_both(tmp_path):
    """write_random_mimi_gguf uses the wire names and layouts codec_tpu's
    loader reads; a window of 20 frames puts the band inside T."""
    path = tmp_path / "rand.gguf"
    mimi_init.write_random_mimi_gguf(path, seed=1, cfg=SMALL, num_filters=8)
    j = codec_tpu.load_model(path)
    p = codec_tpu_torch.load_model(path, device="cpu")
    assert p.cfg == dataclasses.replace(SMALL, has_encoder=False)
    codes = _codes((30, 4), 64, 9)
    _assert_close_pcm(p.decode(codes), j.decode(codes))


def test_full_width_decode_matches_jax():
    """kyutai/mimi widths (hidden 512, 8 layers, 32 x 2048 x 256 codebooks,
    64 filters) with codec_tpu's random weights, T=150 frames."""
    cfg = jmimi.MimiConfig()
    tree = jmimi_init.random_mimi_params(cfg, seed=0)
    codes = _codes((1, 150, 32), 2048, 10)
    want = np.asarray(jmimi.mimi_decode_fn(tree, codes, cfg))
    params = mimi.params_from_jax(tree)
    with torch.inference_mode():
        got = mimi.mimi_decode_fn(params, torch.from_numpy(codes).long(),
                                  mimi.MimiConfig()).numpy()
    _assert_close_pcm(got, want)


def test_port_imports_neither_jax_nor_codec_tpu():
    """The port runs where JAX is absent. (A sys.modules check cannot work
    in a process that has JAX loaded, so scan the sources.)"""
    bad = []
    files = sorted((ROOT / "codec_tpu_torch").rglob("*.py"))
    assert {"rvq.py", "rvq_cuda.py", "model.py", "codec_cli.py"} <= {
        f.name for f in files}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "codec_tpu")]
    assert not bad, bad
    assert (ROOT / "chip_smoke.py").exists()
    src = (ROOT / "chip_smoke.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".")[0] in ("jax", "codec_tpu") for m in mods)
