"""The port's device mesh (codec_tpu_torch/parallel, CodecModel.set_mesh,
LlamaBackbone.set_mesh / set_mesh_ep / set_mesh_pp) on the CPU, the
counterparts of tests/test_parallel.py's tests of this slice.

The port's mesh names the CPU eight times (`devices=["cpu"] * 8`), the
counterpart of the 8 virtual CPU devices codec_tpu's tests run on
(tests/conftest.py): every entry holds its own replica or shard, and the
shares run in turn. Each sharded result is held against the port
unsharded and against codec_tpu's sharded result on its 8-device mesh, on
the same GGUF (written by the port's writers, which codec_tpu reads) and
the same NumPy inputs. Where codec_tpu's test reads the compiled HLO for a
collective, the port's counts its explicit reductions and checks each
shard's shape and device.

Bounds (tests/test_parallel.py's): DP decodes atol = rtol = 1e-5 (DAC's
1e-4) against the port unsharded and codec_tpu's sharded result; encodes
equal codes; backbones atol = rtol = 1e-4; generated codes equal.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.lm.backbone import create_backbone as jax_create_backbone
from codec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import create_lm, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import apply_backbone_mesh, create_backbone
from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B,
                                            write_random_backbone_gguf)
from codec_tpu_torch.models.lm_tts_init import QWEN3_30B_A3B
from codec_tpu_torch.ops.sample import OnDeviceSampling
from codec_tpu_torch.parallel import pipeline
from codec_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                           named_devices, replicate,
                                           row_slices, shard_batch)
from test_torch_fused import files  # noqa: F401

N_DEV = 8


def cpu_mesh(n=N_DEV, axis="dp"):
    return make_mesh(n, axis=axis, devices=["cpu"] * n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _close_peak(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_mesh_shapes_and_helpers():
    m = make_mesh(4, axis="tp", devices=["cpu"] * 4)
    assert m.shape == {"tp": 4} and m.axis_names == ("tp",)
    assert m.axis_devices("tp") == [torch.device("cpu")] * 4
    m2 = make_mesh_2d(2, 3, devices=["cpu"] * 6)
    assert m2.shape == {"dp": 2, "tp": 3} and m2.devices.shape == (2, 3)
    assert len(m2.axis_devices("dp")) == 2 and len(m2.axis_devices("tp")) == 3
    x = torch.arange(10).reshape(5, 2)
    parts = shard_batch(m, x, axis="tp")
    assert [p.shape[0] for p in parts] == [2, 1, 1, 1]
    assert torch.equal(torch.cat(parts), x)
    assert row_slices(5, 4) == [slice(0, 2), slice(2, 3), slice(3, 4),
                                slice(4, 5)]
    assert [s.stop - s.start for s in row_slices(2, 4)] == [1, 1, 0, 0]
    # a tensor already on its device is shared (weights are only read)
    reps = replicate(m, {"w": x, "k": 3, "l": [x, None]})
    assert len(reps) == 4 and reps[1]["k"] == 3 and reps[3]["l"][1] is None
    assert reps[2]["w"] is x and reps[2]["l"][0] is x
    assert named_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert named_devices("cuda", 3) is None
    assert named_devices("cuda:0", 2) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="devices"):
        make_mesh(3, devices=["cpu"] * 2)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="need 2 devices"):
            make_mesh(2)


# ---------------------------------------------------------------------------
# data parallelism: CodecModel.set_mesh over decode and encode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wt(tmp_path_factory):
    """A small WavTokenizer with its encoder (hop 320, one codebook of
    256), loaded by both packages with and without an 8-entry mesh."""
    from codec_tpu_torch.models import wavtokenizer_init

    path = tmp_path_factory.mktemp("par") / "wt.gguf"
    wavtokenizer_init.write_random_wt_gguf(
        path, seed=3, encoder=True, codebook_size=256, codebook_dim=64,
        dim=64, intermediate=96, n_convnext=2, n_fft=480, enc_filters=4)
    return {"path": path,
            "port": codec_tpu_torch.load_model(path, device="cpu"),
            "dp": codec_tpu_torch.load_model(path, mesh=cpu_mesh()),
            "jax": codec_tpu.load_model(path, mesh=jax_make_mesh(N_DEV))}


@pytest.fixture(scope="module")
def codes_batch():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (5, 6, 1)).astype(np.int32)


def test_dp_decode_sharded_and_matches(wt, codes_batch):
    """B = 5 over 8 entries: five slices of one row, three entries idle
    (codec_tpu pads to 8 rows; the port crops nothing)."""
    out = wt["dp"].decode(codes_batch)
    assert wt["dp"].last_out_devices == [torch.device("cpu")] * 5
    np.testing.assert_allclose(out, wt["port"].decode(codes_batch),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, wt["jax"].decode(codes_batch),
                               atol=1e-5, rtol=1e-5)
    # an unbatched input runs on the first replica
    one = wt["dp"].decode(codes_batch[0])
    assert wt["dp"].last_out_devices == [torch.device("cpu")]
    np.testing.assert_allclose(one, out[0], atol=1e-5, rtol=1e-5)
    # uneven slices: 11 rows over 8 entries (3 of two rows, 5 of one)
    big = np.concatenate([codes_batch, codes_batch[:4], codes_batch[:2]])
    np.testing.assert_allclose(wt["dp"].decode(big),
                               wt["port"].decode(big), atol=1e-5, rtol=1e-5)
    assert len(wt["dp"].last_out_devices) == N_DEV


def test_dp_encode_sharded_and_matches(wt):
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal((3, 320 * 4)) * 0.2).astype(np.float32)
    codes = wt["dp"].encode(pcm)
    assert len(wt["dp"].last_out_devices) == 3
    np.testing.assert_array_equal(codes, wt["port"].encode(pcm))
    np.testing.assert_array_equal(codes, wt["jax"].encode(pcm))
    i16 = (pcm * 20000).astype(np.int16)
    np.testing.assert_array_equal(wt["dp"].encode(i16),
                                  wt["port"].encode(i16))


def test_dp_entries_take_keywords(wt, codes_batch):
    """decode(codes=...) and encode(pcm=...) with and without a mesh."""
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal((2, 320 * 2)) * 0.2).astype(np.float32)
    for key in ("port", "dp"):
        model = wt[key]
        np.testing.assert_array_equal(model.decode(codes=codes_batch[:3]),
                                      model.decode(codes_batch[:3]))
        np.testing.assert_array_equal(model.encode(pcm=pcm, n_q=1),
                                      model.encode(pcm))
    with pytest.raises(TypeError, match="codes"):
        wt["dp"].decode(n_q=1)


def test_dp_weights_replicated(wt):
    model = wt["dp"]
    assert model.mesh.shape == {"dp": N_DEV}
    assert len(model.replicas) == N_DEV and model.replicas[0] is model
    mine = _leaves(model.params)
    assert len(mine) > 5
    for r in model.replicas[1:]:
        assert r.device == torch.device("cpu") and r.mesh is None
        for a, b in zip(mine, _leaves(r.params)):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_batch_decode_cli_dp(wt, tmp_path, capsys):
    """`codec-batch-decode-torch --dp 8 --device cpu`: the padded batch
    split over 8 CPU entries; WAVs equal the unsharded run's and codec_tpu's
    --dp 8 run's within 2.5 LSB (as its own test allows)."""
    from codec_tpu.cli.batch_decode import main as jmain
    from codec_tpu_torch.cli.batch_decode import main

    rng = np.random.default_rng(11)
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"s{i}.npy"))
        np.save(files[-1], rng.integers(0, 256, (4, 1)).astype(np.int32))
    path = str(wt["path"])
    assert main(["--model", path, "--codes", *files, "--out-dir",
                 str(tmp_path / "ref"), "--device", "cpu"]) == 0
    assert main(["--model", path, "--codes", *files, "--out-dir",
                 str(tmp_path / "dp"), "--device", "cpu", "--dp",
                 str(N_DEV)]) == 0
    assert "device output sharding" in capsys.readouterr().out
    assert jmain(["--model", path, "--codes", *files, "--out-dir",
                  str(tmp_path / "jax"), "--dp", str(N_DEV)]) == 0
    for i in range(3):
        y, _ = read_wav(tmp_path / "dp" / f"s{i}.wav")
        for other in ("ref", "jax"):
            want, _ = read_wav(tmp_path / other / f"s{i}.wav")
            np.testing.assert_allclose(y, want, atol=2.5 / 32767)
    assert main(["--model", path, "--codes", *files, "--out-dir",
                 str(tmp_path / "x"), "--device", "cpu", "--dp", "2",
                 "--sp", "2"]) == 1
    assert "mutually exclusive" in capsys.readouterr().err


def test_dp_latent_decode_sharded(tmp_path_factory):
    """decode_latent over the mesh (Soprano, a latent-only model)."""
    from codec_tpu_torch.models import soprano_init

    path = tmp_path_factory.mktemp("sop_dp") / "sop.gguf"
    cfg = dataclasses.replace(soprano_init.SOPRANO_1_1, latent_dim=24,
                              decoder_dim=32, intermediate_dim=48,
                              num_layers=2)
    soprano_init.write_random_soprano_gguf(path, seed=0, cfg=cfg)
    rng = np.random.default_rng(5)
    latent = (rng.standard_normal((3, 7, 24)) * 0.5).astype(np.float32)
    model = codec_tpu_torch.load_model(path, mesh=cpu_mesh())
    out = model.decode_latent(latent)
    assert len(model.last_out_devices) == 3
    np.testing.assert_allclose(
        out, codec_tpu_torch.load_model(path, device="cpu").decode_latent(
            latent), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, codec_tpu.load_model(
        path, mesh=jax_make_mesh(N_DEV)).decode_latent(latent), atol=1e-5,
        rtol=1e-5)
    i16 = model.decode_latent(latent, pcm_format="i16")
    assert i16.dtype == np.int16 and i16.shape == out.shape


def test_dp_dac_decode_sharded_and_matches(tmp_path_factory):
    """DAC (the second bench arch) through the DP path; decode_async,
    PendingPcm.gather and decode_many split the same way."""
    from codec_tpu_torch.models import dac, dac_init

    path = tmp_path_factory.mktemp("dac_dp") / "dac.gguf"
    dac_init.write_random_dac_gguf(path, seed=0, cfg=dac.DacConfig(
        n_q=4, codebook_size=32, codebook_dim=4, latent_dim=64),
        decoder_dim=32, encoder=True)
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 32, (5, 6, 4)).astype(np.int32)
    port = codec_tpu_torch.load_model(path, device="cpu")
    model = codec_tpu_torch.load_model(path, mesh=cpu_mesh())
    want = port.decode(codes)
    out = model.decode(codes)
    assert len(model.last_out_devices) == 5
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, codec_tpu.load_model(
        path, mesh=jax_make_mesh(N_DEV)).decode(codes), atol=1e-4, rtol=1e-4)
    pend = [model.decode_async(codes), model.decode_async(codes[:2],
                                                          pcm_format="i16")]
    assert len(pend[0].device_array()) == 5
    got = codec_tpu_torch.runtime.model.PendingPcm.gather(pend)
    _close_peak(got[0], want, 1e-4)
    np.testing.assert_array_equal(got[1], model.decode(codes[:2],
                                                       pcm_format="i16"))
    many = model.decode_many([codes[0], codes[1, :4], codes[2]])
    _close_peak(many[0], want[0], 1e-4)
    _close_peak(many[1], port.decode(codes[1, :4]), 1e-4)
    _close_peak(many[2], want[2], 1e-4)


def test_dp_latent_encode_sharded(tmp_path_factory):
    """encode_latent over the mesh (BlueMagpie), against unsharded."""
    from codec_tpu_torch.models.bluemagpie_init import (BLUEMAGPIE,
                                                        write_random_bm_gguf)

    path = tmp_path_factory.mktemp("bm_dp") / "bm.gguf"
    cfg = dataclasses.replace(BLUEMAGPIE, latent_dim=8, decoder_rates=(2, 3),
                              encoder_rates=(2, 2), decode_hop=6,
                              encode_hop=4)
    write_random_bm_gguf(path, seed=0, cfg=cfg, encoder=True, decoder_dim=32,
                         encoder_dim=8)
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((4, 64)) * 0.3).astype(np.float32)
    model = codec_tpu_torch.load_model(path, mesh=cpu_mesh(3))
    mu = model.encode_latent(pcm)
    assert len(model.last_out_devices) == 3
    np.testing.assert_allclose(
        mu, codec_tpu_torch.load_model(path, device="cpu").encode_latent(pcm),
        atol=1e-5, rtol=1e-5)


def test_dp_serve_batch_decode(wt, codes_batch):
    """Concurrent callers of one meshed model (a server's threads): each
    request's waveform matches its unsharded decode."""
    from concurrent.futures import ThreadPoolExecutor

    model = wt["dp"]
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda i: model.decode(codes_batch[i: i + 2]),
                           range(codes_batch.shape[0] - 1)))
    for i, got in enumerate(outs):
        np.testing.assert_allclose(
            got, wt["port"].decode(codes_batch[i: i + 2]), atol=1e-5,
            rtol=1e-5)


def test_sp_is_not_ported(wt):
    with pytest.raises(CodecError, match="sequence parallelism.*next slice"):
        codec_tpu_torch.load_model(wt["path"], device="cpu").set_mesh(
            cpu_mesh(2, "sp"), axis="sp", dim=1)


# ---------------------------------------------------------------------------
# tensor parallelism: LlamaBackbone.set_mesh
# ---------------------------------------------------------------------------

TP_CFG = dataclasses.replace(
    LLAMA_3_2_1B, hidden=32, n_layers=2, n_heads=8, n_kv_heads=8, head_dim=4,
    ffn_dim=64, vocab_size=64, rope_theta=10000.0, max_ctx=32)
PP_CFG = dataclasses.replace(
    LLAMA_3_2_1B, hidden=32, n_layers=8, n_heads=4, n_kv_heads=2, head_dim=8,
    ffn_dim=48, vocab_size=64, rope_theta=10000.0, max_ctx=32)
MOE_CFG = dataclasses.replace(
    QWEN3_30B_A3B, hidden=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
    ffn_dim=48, vocab_size=64, rope_theta=10000.0, max_ctx=32, n_experts=8,
    n_experts_used=2, moe_ffn_dim=16)


@pytest.fixture(scope="module")
def bb_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bb")
    out = {}
    for name, cfg, scaling in (("tp", TP_CFG, None), ("pp", PP_CFG, None),
                               ("moe", MOE_CFG, None)):
        out[name] = write_random_backbone_gguf(
            d / f"{name}.gguf", seed=5, qtype="F32", cfg=cfg,
            rope_scaling=scaling)
    return out


def _embeds(seed, t, h=32):
    return np.random.default_rng(seed).standard_normal(
        (t, h)).astype(np.float32) * 0.3


def _run(bb, embeds):
    return bb.prefill(embeds), bb.step(embeds[0])


def test_tp_backbone_matches_single_and_partitions(bb_files):
    """Megatron shards: prefill + step match the unsharded port and
    codec_tpu's TP backbone; each device holds its heads' q/k/v rows, its
    o columns and its kv heads' cache; two reductions a layer a forward;
    reset keeps every placement."""
    embeds = _embeds(2, 5)
    want = _run(create_backbone(bb_files["tp"], max_ctx=32, device="cpu"),
                embeds)
    tp = create_backbone(bb_files["tp"], max_ctx=32, device="cpu")
    tp.set_mesh(cpu_mesh(axis="tp"), axis="tp")
    assert tp.mesh_kind == "tp" and len(tp.shards) == N_DEV
    lw = tp.shards[3]["layers"][1]
    assert lw["q"].shape == (4, 32) and lw["k"].shape == (4, 32)
    assert lw["o"].shape == (32, 4) and lw["gate"].shape == (8, 32)
    assert lw["down"].shape == (32, 8)
    assert all(kv.shape == (2, 2, 1, 32, 4) for kv in tp.kvs)
    assert "layers" not in tp.params and tp.kv is None
    got = _run(tp, embeds)
    assert tp.reductions == 2 * 2 * TP_CFG.n_layers
    jax_tp = jax_create_backbone(str(bb_files["tp"]), max_ctx=32)
    jax_tp.set_mesh(jax_make_mesh(N_DEV, axis="tp"), axis="tp")
    for g, w, j in zip(got, want, _run(jax_tp, embeds)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=1e-4)
    kvs = [kv.data_ptr() for kv in tp.kvs]
    tp.reset()
    assert tp.pos == 0 and [kv.data_ptr() for kv in tp.kvs] == kvs
    np.testing.assert_allclose(tp.prefill(embeds), want[0], atol=1e-4,
                               rtol=1e-4)


def test_tp_backbone_rejects_indivisible(bb_files, files):  # noqa: F811
    bb = create_backbone(bb_files["tp"], max_ctx=32, device="cpu")
    bb.cfg.n_kv_heads = 3                      # 3 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        bb.set_mesh(cpu_mesh(axis="tp"), axis="tp")
    packed = create_backbone(files[2], quantized=True, device="cpu")
    with pytest.raises(ValueError, match="packed-quantized"):
        packed.set_mesh(cpu_mesh(2, axis="tp"), axis="tp")
    bb = create_backbone(bb_files["tp"], max_ctx=32, device="cpu")
    bb.set_mesh(cpu_mesh(2, axis="tp"), axis="tp")
    with pytest.raises(ValueError, match="already sharded"):
        bb.set_mesh_pp(cpu_mesh(2, axis="pp"))


def test_tp_moe_backbone_matches(bb_files):
    """TP over a MoE: every expert's ffn dim splits (moe_ffn_dim 16 over
    2), the router replicated; the gathered form (a step) and the dense
    one (the prefill) both match."""
    embeds = _embeds(9, 4)
    want = _run(create_backbone(bb_files["moe"], max_ctx=32, device="cpu"),
                embeds)
    tp = create_backbone(bb_files["moe"], max_ctx=32, device="cpu")
    tp.set_mesh(cpu_mesh(2, axis="tp"), axis="tp")
    assert tp.shards[1]["layers"][0]["gate_exps"].shape == (8, 8, 32)
    assert tp.shards[1]["layers"][0]["down_exps"].shape == (8, 32, 8)
    for g, w in zip(_run(tp, embeds), want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# pipeline parallelism: LlamaBackbone.set_mesh_pp, parallel/pipeline.py
# ---------------------------------------------------------------------------

def test_pp_backbone_matches_single_and_partitions(bb_files):
    """One layer a stage over 8 stages, prefill in 4 microbatches: matches
    the unsharded port and codec_tpu's PP backbone; reset keeps every
    stage's layers and cache."""
    embeds = _embeds(4, 7)
    want = _run(create_backbone(bb_files["pp"], max_ctx=32, device="cpu"),
                embeds)
    pp = create_backbone(bb_files["pp"], max_ctx=32, device="cpu")
    pp.set_mesh_pp(cpu_mesh(axis="pp"), axis="pp", microbatches=4)
    assert [len(s["layers"]) for s in pp.shards] == [1] * N_DEV
    assert all(kv.shape == (1, 2, 2, 32, 8) for kv in pp.kvs)
    got = _run(pp, embeds)
    jax_pp = jax_create_backbone(str(bb_files["pp"]), max_ctx=32)
    jax_pp.set_mesh_pp(jax_make_mesh(N_DEV, axis="pp"), axis="pp",
                       microbatches=4)
    for g, w, j in zip(got, want, _run(jax_pp, embeds)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=1e-4)
    kvs = [kv.data_ptr() for kv in pp.kvs]
    pp.reset()
    assert [kv.data_ptr() for kv in pp.kvs] == kvs and pp.mesh_kind == "pp"


def test_pp_schedule_is_gpipe(bb_files, monkeypatch):
    """Step t runs microbatch t - s on stage s; bubbles issue nothing."""
    calls = []
    real = pipeline.run_layers

    def spy(layers, kv, pos0, x, *a, **k):
        calls.append((pos0, x.shape[0], kv.data_ptr()))
        return real(layers, kv, pos0, x, *a, **k)

    monkeypatch.setattr(pipeline, "run_layers", spy)
    pp = create_backbone(bb_files["pp"], max_ctx=32, device="cpu")
    pp.set_mesh_pp(cpu_mesh(2, axis="pp"), axis="pp", microbatches=3)
    pp.prefill(_embeds(1, 7))                  # mb 3: rows 0-2, 3-5, 6
    s0, s1 = (kv.data_ptr() for kv in pp.kvs)
    assert calls == [(0, 3, s0), (3, 3, s0), (0, 3, s1), (6, 1, s0),
                     (3, 3, s1), (6, 1, s1)]


def test_pp_backbone_two_stage_and_rejects(bb_files):
    embeds = _embeds(5, 5)
    want = create_backbone(bb_files["pp"], max_ctx=32,
                           device="cpu").prefill(embeds)
    pp = create_backbone(bb_files["pp"], max_ctx=32, device="cpu")
    pp.set_mesh_pp(cpu_mesh(2, axis="pp"), axis="pp", microbatches=2)
    assert [len(s["layers"]) for s in pp.shards] == [4, 4]
    np.testing.assert_allclose(pp.prefill(embeds), want, atol=1e-4,
                               rtol=1e-4)
    bad = create_backbone(bb_files["pp"], max_ctx=32, device="cpu")
    bad.cfg.n_layers = 7
    with pytest.raises(ValueError, match="not divisible"):
        bad.set_mesh_pp(cpu_mesh(axis="pp"), axis="pp")


def test_pp_moe_backbone_matches(bb_files):
    embeds = _embeds(10, 4)
    want = _run(create_backbone(bb_files["moe"], max_ctx=32, device="cpu"),
                embeds)
    pp = create_backbone(bb_files["moe"], max_ctx=32, device="cpu")
    pp.set_mesh_pp(cpu_mesh(2, axis="pp"), axis="pp", microbatches=2)
    for g, w in zip(_run(pp, embeds), want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_pp_quantized_backbone_matches(files):  # noqa: F811
    """PP over packed Q8_0 layers: whole layers a stage stay packed (the
    packed products' path); matches the unsharded packed backbone and
    codec_tpu's PP over its packed weights."""
    path = files[2]
    embeds = _embeds(12, 5, h=256)
    want = _run(create_backbone(path, quantized=True, device="cpu"), embeds)
    pp = create_backbone(path, quantized=True, device="cpu")
    pp.set_mesh_pp(cpu_mesh(2, axis="pp"), axis="pp", microbatches=2)
    assert isinstance(pp.shards[1]["layers"][0]["q"], dict)
    got = _run(pp, embeds)
    jax_pp = jax_create_backbone(str(path), quantized=True)
    jax_pp.set_mesh_pp(jax_make_mesh(2, axis="pp"), axis="pp",
                       microbatches=2)
    for g, w, j in zip(got, want, _run(jax_pp, embeds)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=1e-4)


def test_pp_prefill_to_cache_end(bb_files):
    """A prefill whose microbatches end at the last cache row (pos0 1, 15
    rows in 4 microbatches of 4, 4, 4, 3 into a 16-row cache)."""
    embeds = _embeds(15, 16)
    ref = create_backbone(bb_files["pp"], max_ctx=16, device="cpu")
    ref.prefill(embeds[:1])
    want = ref.prefill(embeds[1:])
    pp = create_backbone(bb_files["pp"], max_ctx=16, device="cpu")
    pp.set_mesh_pp(cpu_mesh(2, axis="pp"), axis="pp", microbatches=4)
    pp.prefill(embeds[:1])
    np.testing.assert_allclose(pp.prefill(embeds[1:]), want, atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="context full"):
        pp.step(embeds[0])


# ---------------------------------------------------------------------------
# expert parallelism: LlamaBackbone.set_mesh_ep
# ---------------------------------------------------------------------------

def test_ep_backbone_matches_single_and_partitions(bb_files):
    """One expert a device: the prefill (T k >= E, the dense form) and a
    step (the gathered form, each device gathering only its own chosen
    experts) match the unsharded port and codec_tpu's EP backbone; one
    reduction a layer a forward."""
    embeds = _embeds(8, 5)
    want = _run(create_backbone(bb_files["moe"], max_ctx=32, device="cpu"),
                embeds)
    ep = create_backbone(bb_files["moe"], max_ctx=32, device="cpu")
    ep.set_mesh_ep(cpu_mesh(axis="ep"))
    lw = ep.shards[5]["layers"][0]
    assert lw["gate_exps"].shape == (1, 16, 32)
    assert lw["down_exps"].shape == (1, 32, 16)
    assert lw["router"].shape == (8, 32) and lw["q"].shape == (32, 32)
    assert ep.expert0 == list(range(N_DEV))
    got = _run(ep, embeds)
    assert ep.reductions == 2 * MOE_CFG.n_layers
    jax_ep = jax_create_backbone(str(bb_files["moe"]), max_ctx=32)
    jax_ep.set_mesh_ep(jax_make_mesh(N_DEV, axis="ep"))
    for g, w, j in zip(got, want, _run(jax_ep, embeds)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g, j, atol=1e-4, rtol=1e-4)


def test_ep_rejects_dense_and_indivisible(bb_files):
    dense = create_backbone(bb_files["pp"], max_ctx=32, device="cpu")
    with pytest.raises(ValueError, match="not a MoE"):
        dense.set_mesh_ep(cpu_mesh(axis="ep"))
    moe = create_backbone(bb_files["moe"], max_ctx=32, device="cpu")
    moe.cfg.n_experts = 6                  # 6 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        moe.set_mesh_ep(cpu_mesh(axis="ep"))


# ---------------------------------------------------------------------------
# where a sharded backbone runs: the host loop, the CLI, the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csm(files):  # noqa: F811
    _, model, bb = files
    reader = GGUFReader(model)
    return dict(reader=reader, bb=bb, model=model,
                codec=codec_tpu_torch.load_model(model, device="cpu"),
                lm=create_lm(reader, device="cpu"))


def _gen(csm, bb, **kw):
    bb.reset()
    alm = AudioLM(csm["reader"], codec=csm["codec"], lm=csm["lm"])
    return tts_runner.run_codebook_ar(
        alm, bb, list(bb.embed_tokens([3, 17, 42, 99, 150, 7])), max_steps=5,
        decode=False, **kw)


def _placed(csm, kind, n=2, quantized=True):
    bb = create_backbone(csm["bb"], quantized=quantized and kind != "tp",
                         device="cpu")
    apply_backbone_mesh(bb, kind, n, devices=["cpu"] * n)
    return bb


def test_pp_gen_matches_unsharded(csm):
    """Whole AR generation through the host loop over a 2-stage backbone:
    the codes of the unsharded run, greedy and with the on-device frame
    (a PP backbone stands down from the chunk to the per-frame loop, as
    codec_tpu's does)."""
    from codec_tpu_torch.lm.fused_gen import supports_gen_chunk

    ref_bb = create_backbone(csm["bb"], quantized=True, device="cpu")
    pp = _placed(csm, "pp")
    assert not supports_gen_chunk(csm["lm"], pp)
    assert supports_gen_chunk(csm["lm"], ref_bb)
    want = _gen(csm, ref_bb)
    got = _gen(csm, pp)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.n_steps == want.n_steps == 5
    ods = OnDeviceSampling(chunk_frames=3)
    np.testing.assert_array_equal(_gen(csm, pp, on_device=ods).codes,
                                  _gen(csm, ref_bb, on_device=ods).codes)


def test_tp_ep_gen_host_path_and_chunks_refuse(csm, bb_files):
    """TP runs the host loop with the unsharded codes, and now the chunks
    too: a TP backbone's chunked run, its batch, an engine over it and
    run_backbone_synthesize_batch(mesh=) give the unsharded codes, and an
    EP backbone's chunk runs; only a PP backbone is still refused by the
    batch runner and the engine (CodecError), as codec_tpu runs it through
    the host per-frame loop alone."""
    from codec_tpu_torch.cli.tts_cli import run_backbone_synthesize_batch
    from codec_tpu_torch.serve.cont_batch import ContinuousBatcher

    ref_bb = create_backbone(csm["bb"], device="cpu")
    tp = _placed(csm, "tp")
    np.testing.assert_array_equal(_gen(csm, tp).codes, _gen(csm, ref_bb).codes)
    ods = OnDeviceSampling(chunk_frames=3)
    np.testing.assert_array_equal(_gen(csm, tp, on_device=ods).codes,
                                  _gen(csm, ref_bb, on_device=ods).codes)
    alms = [AudioLM(csm["reader"], codec=csm["codec"], lm=csm["lm"])
            for _ in range(2)]
    prompts = [list(ref_bb.embed_tokens([3, 17]))] * 2
    want = tts_runner.run_codebook_ar_batch(alms, ref_bb, prompts, ods,
                                            max_steps=2, decode=False)
    got = tts_runner.run_codebook_ar_batch(alms, tp, prompts, ods,
                                           max_steps=2, decode=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
    ContinuousBatcher(tp.lane(), csm["lm"], n_slots=2, on_device=ods)
    pp = _placed(csm, "pp")
    with pytest.raises(CodecError, match="not ported"):
        tts_runner.run_codebook_ar_batch(alms, pp, prompts, ods,
                                         max_steps=2, decode=False)
    with pytest.raises(CodecError, match="not ported"):
        ContinuousBatcher(pp, csm["lm"], n_slots=2, on_device=ods)
    got = tts_runner.run_codebook_ar_batch(alms, ref_bb, prompts, ods,
                                           max_steps=2, decode=False,
                                           mesh=cpu_mesh(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
    ContinuousBatcher(ref_bb, csm["lm"], n_slots=2, on_device=ods,
                      mesh=cpu_mesh(2))
    outs = run_backbone_synthesize_batch(
        csm["codec"], csm["reader"], str(csm["bb"]), ["a", "b"],
        max_frames=2, mesh=cpu_mesh(2), device="cpu")
    assert [o[1] for o in outs] == [2, 2]
    ep = create_backbone(bb_files["moe"], max_ctx=32, device="cpu")
    ep.set_mesh_ep(cpu_mesh(2, axis="ep"))
    from codec_tpu_torch.lm import fused_gen
    runner = fused_gen.gen_chunk_cached(csm["lm"], ep, n_frames=2, ctx=32)
    assert len(runner.kvs) == 2


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_cli_synthesize_backbone_mesh(csm, tmp_path, flag, capsys):
    """`tts-cli-torch synthesize --tp 2 / --pp 2 --device cpu` on the host
    path: the WAV of the unsharded run, and within codec_tpu's same run
    (its 8-device mesh) by correlation; flags mutually exclusive."""
    from codec_tpu.cli.tts_cli import main as jax_main
    from codec_tpu_torch.cli.tts_cli import main

    args = ["synthesize", "--model", str(csm["model"]), "--backbone",
            str(csm["bb"]), "--text", "hello there", "--max-frames", "3"]
    if flag == "--pp":
        args.append("--quant-exec")
    assert main(args + ["--out", str(tmp_path / "ref.wav"),
                        "--device", "cpu"]) == 0
    assert main(args + ["--out", str(tmp_path / "mesh.wav"), "--device",
                        "cpu", flag, "2"]) == 0
    assert "3 steps" in capsys.readouterr().out
    assert (tmp_path / "mesh.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()
    try:
        assert jax_main(args + ["--out", str(tmp_path / "jax.wav"), flag,
                                "2"]) == 0
    finally:
        os.environ.pop("CODEC_QUANT_EXEC", None)       # its main() sets it
    got, _ = read_wav(tmp_path / "mesh.wav")
    want, _ = read_wav(tmp_path / "jax.wav")
    assert got.shape == want.shape
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    assert main(args + ["--out", str(tmp_path / "x.wav"), "--device", "cpu",
                        "--tp", "2", "--pp", "2"]) == 1
    assert "mutually exclusive" in capsys.readouterr().err


def test_server_backbone_mesh(csm):
    """`codec-serve-torch --pp 2`: the serialized /synthesize's bytes equal
    the unsharded server's; --dp builds its dp mesh (its requests:
    tests/test_torch_parallel_graphs.py); the engine over --pp raises."""
    import http.client
    import json

    from codec_tpu_torch.serve import CodecHTTPServer

    def synth(srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
            conn.request("POST", "/synthesize", json.dumps(
                {"text": "hello there", "seed": 3, "max_frames": 3}))
            r = conn.getresponse()
            body = r.read()
            conn.close()
            return r.status, body
        finally:
            srv.shutdown()

    kw = dict(port=0, backbone_path=str(csm["bb"]), quant_exec=True,
              device="cpu")
    want = synth(CodecHTTPServer(str(csm["model"]), **kw))
    srv = CodecHTTPServer(str(csm["model"]), backbone_mesh=("pp", 2), **kw)
    assert srv.backbone.mesh_kind == "pp"
    got = synth(srv)
    assert got[0] == want[0] == 200 and got[1] == want[1]
    srv = CodecHTTPServer(str(csm["model"]), dp=2, **kw)
    assert dict(srv.batch_mesh.shape) == {"dp": 2}
    srv.httpd.server_close()
    with pytest.raises(CodecError, match="not ported"):
        CodecHTTPServer(str(csm["model"]), backbone_mesh=("pp", 2),
                        cont_batch=2, **kw)


def test_chip_smoke_mesh_phase_on_cpu(tmp_path_factory, monkeypatch):
    """chip_smoke.py's phase 11 end to end at small widths on the CPU: DP
    decode and encode, the PP, TP and EP backbones against unsharded, the
    CLI and the server with --pp 2 byte-equal to their unsharded runs (the
    launch counts are those the card is held to)."""
    from pathlib import Path

    from codec_tpu_torch.models import dac, dac_init
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_ggufs,
                                                write_random_csm_gguf)
    from test_torch_fused import BB, DEPTH, MIMI

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    tmp = tmp_path_factory.mktemp("smoke11")
    model = write_random_csm_gguf(tmp / "csm.gguf", seed=2, mimi_cfg=MIMI,
                                  num_filters=8, dcfg=DEPTH, encoder=True)
    q4 = write_random_backbone_ggufs(
        {"Q4_K": tmp / "bb_Q4_K.gguf"}, seed=1, cfg=BB,
        spm_b64=spm_model_b64(byte_fallback_vocab()))["Q4_K"]
    moe = write_random_backbone_gguf(
        tmp / "moe.gguf", seed=3, qtype="Q4_K", rope_scaling=None,
        cfg=dataclasses.replace(MOE_CFG, hidden=256, head_dim=64,
                                ffn_dim=256, moe_ffn_dim=32, max_ctx=96))
    dac_path = tmp / "dac.gguf"
    dac_init.write_random_dac_gguf(dac_path, seed=0, cfg=dac.DacConfig(
        n_q=2, codebook_size=16, codebook_dim=4, latent_dim=64),
        decoder_dim=16, encoder=True)
    models = {"mimi": codec_tpu_torch.load_model(model, device="cpu"),
              "dac": codec_tpu_torch.load_model(dac_path, device="cpu")}
    none = dict.fromkeys(("flash_sdpa_window", "seanet_res_unit",
                          "q4_k_matmul", "rvq_encode_fused"), 0)
    got, times = cs.mesh_phase(
        "CPU", lambda: None, lambda: dict(none), none, models,
        {"csm": model, "Q4_K": q4},
        create_backbone(moe, quantized=True, device="cpu"), dev="cpu",
        sizes=dict(seconds=1, steps=3, prompt=5, frames=3,
                   moe_steps=3))
    assert got["flash_sdpa_window"] == 2 * cs.MIMI_LAYERS * 2
    assert got["rvq_encode_fused"] == 4 and got["seanet_res_unit"] == 24
    assert got["q4_k_matmul"] > 0
    assert set(times) >= {"mimi_dp_decode", "mimi_dp_encode",
                          "dac_dp_decode", "pp_step", "tp_step", "ep_step"}
