"""The port's GGUF reader and writer (codec_tpu_torch.io.gguf) against
codec_tpu.io.gguf: arrays and KVs must be bit-identical."""

import numpy as np
import pytest
import torch

from codec_tpu.io import gguf as jg
from codec_tpu_torch.io import gguf as pg


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4, 8)).astype(np.float32),
        "q8": rng.standard_normal((2, 64)).astype(np.float32),
        "q4k": rng.standard_normal((1, 256)).astype(np.float32),
        "q5k": rng.standard_normal((2, 256)).astype(np.float32),
        "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
    }


_TYPES = {"f32": "F32", "f16": "F16", "q8": "Q8_0", "q4k": "Q4_K",
          "q5k": "Q5_K", "i32": "I32"}


def _fill(w):
    w.add_name("tiny")
    w.add_uint32("codec.n_q", 4)
    w.add_int32("codec.neg", -3)
    w.add_float32("codec.rope_theta", 10000.0)
    w.add_bool("codec.has_encoder", True)
    w.add_string("codec.note", "héllo")
    w.add_array("codec.ratios", [8, 6, 5, 4])
    w.add_array("codec.f", [0.5, -1.25])
    for name, arr in _arrays().items():
        w.add_tensor(name, arr, _TYPES[name])


def test_reader_matches_codec_tpu_on_its_file(tmp_path):
    """A file written by codec_tpu's writer, plus a BF16 tensor (which that
    writer has no branch for, so its bytes are appended as written)."""
    path = tmp_path / "j.gguf"
    w = jg.GGUFWriter(path, "mimi")
    _fill(w)
    bf = torch.randn(3, 4).to(torch.bfloat16)
    w.tensors.append(("bf16", jg.GGML_TYPE_BF16, [3, 4],
                      bf.view(torch.int16).numpy().tobytes()))
    w.write()
    jr, pr = jg.GGUFReader(path), pg.GGUFReader(path)
    assert pr.kv == jr.kv
    assert pr.architecture == jr.architecture == "mimi"
    assert pr.get_i32("codec.n_q") == 4 and pr.get_bool("codec.has_encoder")
    assert pr.get_f32("codec.rope_theta") == 10000.0
    assert pr.tensor_names() == jr.tensor_names()
    for name in jr.tensor_names():
        got, want = pr.get(name), jr.get(name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert pr.tensors[name].type_name == jr.tensors[name].type_name
    np.testing.assert_array_equal(pr.get("bf16"), bf.float().numpy())
    assert pr.get_or_none("absent") is None


def test_writer_bytes_equal_codec_tpu_writer(tmp_path):
    jw = jg.GGUFWriter(tmp_path / "j.gguf", "mimi")
    pw = pg.GGUFWriter(tmp_path / "p.gguf", "mimi")
    _fill(jw)
    _fill(pw)
    jw.write()
    pw.write()
    assert (tmp_path / "p.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_writer_round_trip(tmp_path):
    path = tmp_path / "p.gguf"
    w = pg.GGUFWriter(path, "mimi")
    _fill(w)
    x = np.random.default_rng(1).standard_normal((5, 6)).astype(np.float32)
    w.add_tensor("bf16", x, "BF16")
    w.write()
    r = pg.GGUFReader(path)
    arrs = _arrays()
    np.testing.assert_array_equal(r.get("f32"), arrs["f32"])
    np.testing.assert_array_equal(r.get("i32"), arrs["i32"])
    np.testing.assert_array_equal(r.get("f16"),
                                  arrs["f16"].astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(
        r.get("bf16"), torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    for name, tol in (("q8", 0.02), ("q4k", 0.3), ("q5k", 0.15)):
        np.testing.assert_allclose(r.get(name), arrs[name], atol=tol)
    assert r.kv["codec.note"] == "héllo" and r.kv["codec.ratios"] == [8, 6, 5, 4]


def test_bf16_rounding_matches_torch():
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32) * 100
    x[:4] = [np.inf, -np.inf, 0.0, np.float32(3.0000002)]
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(pg._f32_to_bf16_bits(x).view(np.int16), want)
    nan_bits = pg._f32_to_bf16_bits(np.array([np.nan], np.float32))
    assert nan_bits[0] == 0x7FC0


def test_truncated_file_is_rejected(tmp_path):
    path = tmp_path / "t.gguf"
    w = pg.GGUFWriter(path, "mimi")
    w.add_tensor("x", np.zeros((64, 64), np.float32))
    w.write()
    path.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError, match="truncated"):
        pg.GGUFReader(path).get("x")
