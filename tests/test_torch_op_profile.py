"""The port's per-op profiler (codec_tpu_torch/runtime/op_profile.py)
against codec_tpu's on the CPU: a small random Mimi file (the widths of
tests/test_torch_mimi.py), decoded and encoded with $CODEC_OP_PROFILE set
and unset.

Set, each entry call appends one JSONL record in codec_tpu's schema
(event, key, by_op, top_by_op_shape, n_instructions = sum of by_op, cost);
an arch's entry that calls the base class's makes one record, not two.
Unset, nothing is written and the PCM equals the profiled call's bit for
bit. $CODEC_OP_PROFILE_TRACE writes one Chrome trace a call.
"""

import json

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu_torch.models import mimi_init
from codec_tpu_torch.runtime import op_profile
from test_torch_mimi import SMALL, _codes

SCHEMA = {"event", "key", "by_op", "top_by_op_shape", "n_instructions",
          "cost"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mimi_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("op_profile") / "mimi.gguf"
    mimi_init.write_random_mimi_gguf(path, seed=5, cfg=SMALL, num_filters=8,
                                     encoder=True)
    return path


@pytest.fixture(scope="module")
def port(mimi_path):
    return codec_tpu_torch.load_model(mimi_path, device="cpu")


@pytest.fixture
def unset(monkeypatch):
    monkeypatch.delenv("CODEC_OP_PROFILE", raising=False)
    monkeypatch.delenv("CODEC_OP_PROFILE_TRACE", raising=False)


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_each_entry_call_appends_one_record(port, unset, tmp_path,
                                            monkeypatch):
    out = tmp_path / "ops.jsonl"
    monkeypatch.setenv("CODEC_OP_PROFILE", str(out))
    codes = _codes((6, 4), 64, 70)
    port.decode(codes)
    port.encode(np.zeros(2 * 1920, np.float32))
    port.decode(codes[None])
    recs = _records(out)
    assert [r["key"] for r in recs] == [
        "('mimi', 'decode', (6, 4), 'int32')",
        "('mimi', 'encode', (3840,), 'float32')",
        "('mimi', 'decode', (1, 6, 4), 'int32')"]
    for r in recs:
        assert set(r) == SCHEMA and r["event"] == "graph_profile"
        assert r["n_instructions"] == sum(r["by_op"].values()) > 0
        assert all(op.startswith("aten::") for op in r["by_op"])
        assert 0 < len(r["top_by_op_shape"]) <= 40
        assert sum(r["top_by_op_shape"].values()) <= r["n_instructions"]
        assert set(r["cost"]) == {"self_device_us", "self_cpu_us", "flops"}
        assert r["cost"]["self_device_us"] == 0.0      # no card here
        assert r["cost"]["self_cpu_us"] > 0 and r["cost"]["flops"] > 0
    assert {"aten::conv1d", "aten::linear"} <= set(recs[0]["by_op"])
    assert "aten::linear float[1,12,64]" in recs[0]["top_by_op_shape"]


def test_unset_writes_nothing_and_pcm_is_bit_identical(port, unset,
                                                       tmp_path,
                                                       monkeypatch):
    codes = _codes((7, 4), 64, 71)
    monkeypatch.chdir(tmp_path)
    assert not op_profile.enabled()
    plain = port.decode(codes)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("CODEC_OP_PROFILE", str(tmp_path / "ops.jsonl"))
    profiled = port.decode(codes)
    np.testing.assert_array_equal(plain, profiled)
    assert len(_records(tmp_path / "ops.jsonl")) == 1


def test_an_override_calling_the_base_entry_is_one_record(mimi_path, unset,
                                                          tmp_path,
                                                          monkeypatch):
    class Wrapped(type(codec_tpu_torch.load_model(mimi_path, device="cpu"))):
        def decode(self, codes, n_q=0, pcm_format="f32"):
            return super().decode(codes, n_q=n_q, pcm_format=pcm_format)

    model = Wrapped(codec_tpu_torch.GGUFReader(mimi_path), device="cpu")
    monkeypatch.setenv("CODEC_OP_PROFILE", str(tmp_path / "ops.jsonl"))
    model.decode(_codes((5, 4), 64, 72))
    assert len(_records(tmp_path / "ops.jsonl")) == 1


def test_trace_dir_gets_one_chrome_trace_a_call(port, unset, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("CODEC_OP_PROFILE_TRACE", str(tmp_path / "traces"))
    port.decode(_codes((5, 4), 64, 73))
    port.decode(_codes((5, 4), 64, 74))
    traces = sorted((tmp_path / "traces").iterdir())
    assert len(traces) == 2 and all(t.name.startswith("mimi.decode.")
                                    for t in traces)
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_records_have_the_jax_schema(mimi_path, unset, tmp_path,
                                     monkeypatch):
    """codec_tpu's record of a fresh compile has the port's keys."""
    monkeypatch.setenv("CODEC_OP_PROFILE", str(tmp_path / "jax.jsonl"))
    codec_tpu.load_model(mimi_path).decode(_codes((6, 4), 64, 75))
    rec = _records(tmp_path / "jax.jsonl")[0]
    assert set(rec) == SCHEMA and rec["event"] == "graph_profile"
    assert rec["n_instructions"] == sum(rec["by_op"].values())
