"""The port's runtime surface around decode (codec_tpu_torch) against
codec_tpu's on the CPU: decode_async and PendingPcm, decode_many, the
perf_log phases, and the decode-latent and batch-decode CLIs.

Each arch's file is written once from a seed (small widths) and loaded by
both packages. decode_async runs decode's own code, so its output must
equal the port's decode bit for bit. decode_many decodes equal lengths as
one batch, whose rows CPU convolutions may sum in another order than a
batch of one (up to 4e-5 relative seen at DAC's widths): it is held to the
port's per-sequence decode and to codec_tpu's at the f32 bound of
tests/test_torch_mimi.py (corr > 0.99999, max abs err <= 1e-4 * peak).
WAVs from the two
packages' CLIs may differ by one 16-bit step where f32 noise moves a
sample across a rounding boundary.
"""

import json

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.models import dac, dac_init, mimi_init, snac, snac_init
from codec_tpu_torch.runtime.model import PendingPcm
from test_torch_mimi import SMALL, _assert_close_pcm, _codes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny shapes: they gain nothing
    from more, and with several test workers sharing the cores their
    threads' spin-waits slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Small random Mimi (SMALL, with its encoder), DAC and SNAC files,
    each loaded by both packages."""
    d = tmp_path_factory.mktemp("runtime")
    mimi_init.write_random_mimi_gguf(d / "mimi.gguf", seed=5, cfg=SMALL,
                                     num_filters=8, encoder=True)
    dac_init.write_random_dac_gguf(d / "dac.gguf", seed=5, decoder_dim=32,
                                   cfg=dac.DacConfig(n_q=4, codebook_size=64))
    snac_init.write_random_snac_gguf(d / "snac.gguf", seed=5, decoder_dim=32,
                                     cfg=snac.SnacConfig(codebook_size=64))
    return {arch: {"path": d / f"{arch}.gguf",
                   "jax": codec_tpu.load_model(d / f"{arch}.gguf"),
                   "port": codec_tpu_torch.load_model(d / f"{arch}.gguf",
                                                      device="cpu")}
            for arch in ("mimi", "dac", "snac")}


# (arch, code columns, frame lengths: two equal and one other); SNAC's
# lengths are multiples of its coarsest stride 4
SEQS = [("mimi", 4, (9, 9, 14)), ("dac", 4, (7, 7, 11)),
        ("snac", 3, (8, 8, 12))]


def _seqs(cols, lens, seed):
    return [_codes((t, cols), 64, seed + i) for i, t in enumerate(lens)]


@pytest.mark.parametrize("arch,cols,lens", SEQS)
def test_decode_many_matches_decode_and_jax(models, arch, cols, lens):
    p, j = models[arch]["port"], models[arch]["jax"]
    seqs = _seqs(cols, lens, 30)
    got = p.decode_many(seqs)
    assert len(got) == len(seqs)
    for g, s in zip(got, seqs):
        _assert_close_pcm(g, p.decode(s))
        _assert_close_pcm(g, j.decode(s))
    for g, w in zip(got, j.decode_many(seqs)):
        _assert_close_pcm(g, w)


@pytest.mark.parametrize("arch,cols,lens", SEQS)
def test_decode_async_and_gather_match_decode_and_jax(models, arch, cols,
                                                      lens):
    p, j = models[arch]["port"], models[arch]["jax"]
    seqs = _seqs(cols, lens, 40)
    pending = [p.decode_async(s) for s in seqs]
    assert all(isinstance(x, PendingPcm) for x in pending)
    gathered = PendingPcm.gather(pending)
    for x, g, s in zip(pending, gathered, seqs):
        want = p.decode(s)
        np.testing.assert_array_equal(x.result(), want)
        np.testing.assert_array_equal(g, want)
        assert torch.is_tensor(x.device_array())
        assert tuple(x.device_array().shape) == (1,) + want.shape
        _assert_close_pcm(g, j.decode_async(s).result())


def test_decode_async_batched_i16_and_nq(models):
    p, j = models["mimi"]["port"], models["mimi"]["jax"]
    codes = _codes((2, 10, 4), 64, 50)
    got = p.decode_async(codes, n_q=2, pcm_format="i16").result()
    assert got.dtype == np.int16 and got.shape == (2, 10 * 1920)
    np.testing.assert_array_equal(got, p.decode(codes, n_q=2,
                                                pcm_format="i16"))
    want = j.decode_async(codes, n_q=2, pcm_format="i16").result()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_decode_many_groups_partial_nq_and_i16(models):
    p, j = models["mimi"]["port"], models["mimi"]["jax"]
    seqs = _seqs(4, (6, 11, 6), 60)
    got = p.decode_many(seqs, n_q=3, pcm_format="i16")
    want = j.decode_many(seqs, n_q=3, pcm_format="i16")
    for g, w, s in zip(got, want, seqs):
        assert g.dtype == np.int16 and g.shape == (s.shape[0] * 1920,)
        for other in (p.decode(s, n_q=3, pcm_format="i16"), w):
            assert np.abs(g.astype(np.int32) - other).max() <= 1


@pytest.mark.parametrize("bad,n_q", [
    ([np.zeros((0, 4), np.int32)], 0),          # T = 0
    ([np.zeros((2, 5, 4), np.int32)], 0),       # not [T, Q]
    ([np.zeros((5, 4), np.int32)], 9),          # n_q above the model's
    ([np.zeros((5, 2), np.int32)], 3),          # fewer columns than n_q
])
def test_decode_many_rejects_what_jax_rejects(models, bad, n_q):
    with pytest.raises(CodecError):
        models["mimi"]["port"].decode_many(bad, n_q=n_q)
    with pytest.raises(ValueError):
        models["mimi"]["jax"].decode_many(bad, n_q=n_q)


def test_decode_async_rejects_bad_arguments(models):
    p = models["mimi"]["port"]
    for codes, fmt in ((np.zeros((0, 4), np.int32), "f32"),
                       (np.zeros((5, 4), np.int32), "f64")):
        with pytest.raises(CodecError):
            p.decode_async(codes, pcm_format=fmt)


# -- perf_log ---------------------------------------------------------------

def _phases(path):
    """(phase, detail) of each JSONL line, less codec_tpu's compile events
    (the port compiles nothing)."""
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(r["wall_us"] >= 0 for r in recs)
    return [(r["phase"], r.get("detail", "")) for r in recs
            if r["phase"] != "graph_build"]


def _calls(model):
    codes = _codes((6, 4), 64, 70)
    model.decode(codes)
    model.encode(np.zeros(2 * 1920, np.float32))
    model.decode_many([codes, codes[:4], codes])


def test_perf_log_writes_the_jax_phases(models, tmp_path, monkeypatch):
    monkeypatch.setenv("CODEC_PERF_LOG", str(tmp_path / "port.jsonl"))
    _calls(models["mimi"]["port"])
    monkeypatch.setenv("CODEC_PERF_LOG", str(tmp_path / "jax.jsonl"))
    _calls(models["mimi"]["jax"])
    got = _phases(tmp_path / "port.jsonl")
    assert got == [("graph_compute", "decode"), ("decode_total", "mimi"),
                   ("graph_compute", "encode"), ("encode_total", "mimi"),
                   ("graph_compute", "decode_many"),
                   ("decode_total", "mimi_many3")]
    assert got == _phases(tmp_path / "jax.jsonl")


def test_perf_log_writes_nothing_when_unset(models, tmp_path, monkeypatch):
    monkeypatch.delenv("CODEC_PERF_LOG", raising=False)
    monkeypatch.chdir(tmp_path)
    _calls(models["mimi"]["port"])
    assert list(tmp_path.iterdir()) == []


# -- the CLIs ---------------------------------------------------------------

def _same_wav(a, b):
    """Two 16-bit WAVs of one decode: same rate and length, samples within
    one step of each other."""
    (x, sr_a), (y, sr_b) = read_wav(a, keep_i16=True), read_wav(b,
                                                                keep_i16=True)
    assert sr_a == sr_b and x.shape == y.shape and x.dtype == np.int16
    assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1


def test_cli_decode_latent_writes_the_jax_wav(models, tmp_path, monkeypatch):
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main

    monkeypatch.setenv("CODEC_TIERED_JIT", "fast")
    z = np.random.default_rng(80).standard_normal((9, 1024)).astype(
        np.float32)
    np.save(tmp_path / "z.npy", z)
    path = str(models["dac"]["path"])
    assert main(["decode-latent", "--model", path, "--latent",
                 str(tmp_path / "z.npy"), "--out", str(tmp_path / "p.wav"),
                 "--device", "cpu", "--dtype", "float32"]) == 0
    assert jmain(["decode-latent", "--model", path, "--latent",
                  str(tmp_path / "z.npy"), "--out",
                  str(tmp_path / "j.wav")]) == 0
    _same_wav(tmp_path / "p.wav", tmp_path / "j.wav")
    x, sr = read_wav(tmp_path / "p.wav")
    assert sr == 24000 and x.shape == (9 * 320 - 8, 1)


def test_cli_decode_latent_raises_for_mimi(models, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main

    np.save(tmp_path / "z.npy", np.zeros((4, 64), np.float32))
    assert main(["decode-latent", "--model", str(models["mimi"]["path"]),
                 "--latent", str(tmp_path / "z.npy"), "--out",
                 str(tmp_path / "o.wav"), "--device", "cpu"]) == 1
    assert "decode_latent not supported" in capsys.readouterr().err
    with pytest.raises(ValueError, match="decode_latent not supported"):
        models["mimi"]["jax"].decode_latent(np.zeros((4, 64), np.float32))


@pytest.mark.parametrize("arch,cols,lens,pipeline", [
    ("mimi", 4, (9, 14, 9), False), ("mimi", 4, (9, 9), False),
    ("mimi", 4, (9, 9), True), ("dac", 4, (7, 11), False),
    ("snac", 3, (8, 12, 8), True)])
def test_cli_batch_decode_writes_the_jax_wavs(models, tmp_path, monkeypatch,
                                              arch, cols, lens, pipeline):
    from codec_tpu.cli.batch_decode import main as jmain
    from codec_tpu_torch.cli.batch_decode import main

    monkeypatch.setenv("CODEC_TIERED_JIT", "fast")
    files = []
    for i, s in enumerate(_seqs(cols, lens, 90)):
        files.append(str(tmp_path / f"seq{i}.npy"))
        np.save(files[-1], s)
    path = str(models[arch]["path"])
    extra = ["--pipeline"] if pipeline else []
    assert main(["--model", path, "--codes", *files, "--out-dir",
                 str(tmp_path / "port"), "--device", "cpu", "--dtype",
                 "float32", *extra]) == 0
    assert jmain(["--model", path, "--codes", *files, "--out-dir",
                  str(tmp_path / "jax"), *extra]) == 0
    for i, t in enumerate(lens):
        _same_wav(tmp_path / "port" / f"seq{i}.wav",
                  tmp_path / "jax" / f"seq{i}.wav")
        x, _ = read_wav(tmp_path / "port" / f"seq{i}.wav", keep_i16=True)
        want = models[arch]["port"].decode(np.load(files[i]),
                                           pcm_format="i16")
        assert np.abs(x[:, 0].astype(np.int32) - want).max() <= 1


def test_cli_batch_decode_latents_and_unported_flags(models, tmp_path,
                                                     monkeypatch, capsys):
    from codec_tpu.cli.batch_decode import main as jmain
    from codec_tpu_torch.cli.batch_decode import main

    monkeypatch.setenv("CODEC_TIERED_JIT", "fast")
    rng = np.random.default_rng(95)
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"z{i}.npy"))
        np.save(files[-1], rng.standard_normal((8, 1024)).astype(np.float32))
    path = str(models["dac"]["path"])
    assert main(["--model", path, "--codes", *files, "--latent", "--out-dir",
                 str(tmp_path / "port"), "--device", "cpu", "--dtype",
                 "float32"]) == 0
    assert jmain(["--model", path, "--codes", *files, "--latent",
                  "--out-dir", str(tmp_path / "jax")]) == 0
    for i in range(2):
        _same_wav(tmp_path / "port" / f"z{i}.wav", tmp_path / "jax" /
                  f"z{i}.wav")
    # --dp splits the batch over a mesh of two CPU entries (the same
    # WAVs); --sp (sequence parallelism) is still not ported
    assert main(["--model", path, "--codes", *files, "--latent", "--out-dir",
                 str(tmp_path / "dp"), "--device", "cpu", "--dtype",
                 "float32", "--dp", "2"]) == 0
    assert "dp=2: device output sharding ['cpu', 'cpu']" in \
        capsys.readouterr().out
    for i in range(2):
        _same_wav(tmp_path / "dp" / f"z{i}.wav", tmp_path / "port" /
                  f"z{i}.wav")
    assert main(["--model", path, "--codes", *files, "--out-dir",
                 str(tmp_path / "x"), "--device", "cpu", "--sp", "2"]) == 1
    assert "not ported yet" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# float16 compute and the metadata accessors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f16_models(tmp_path_factory):
    """Small random Mimi, DAC and SNAC files with their encoders, loaded by
    codec_tpu in float16 and by the port in float16 and float32."""
    d = tmp_path_factory.mktemp("f16")
    mimi_init.write_random_mimi_gguf(d / "mimi.gguf", seed=5, cfg=SMALL,
                                     num_filters=8, encoder=True)
    dac_init.write_random_dac_gguf(d / "dac.gguf", seed=5, decoder_dim=32,
                                   cfg=dac.DacConfig(n_q=4, codebook_size=64),
                                   encoder=True)
    snac_init.write_random_snac_gguf(d / "snac.gguf", seed=5, decoder_dim=32,
                                     cfg=snac.SnacConfig(codebook_size=64),
                                     encoder=True)
    return {arch: {"jax": codec_tpu.load_model(d / f"{arch}.gguf",
                                               compute_dtype="float16"),
                   "port": codec_tpu_torch.load_model(
                       d / f"{arch}.gguf", compute_dtype="f16", device="cpu"),
                   "f32": codec_tpu_torch.load_model(d / f"{arch}.gguf",
                                                     device="cpu")}
            for arch in ("mimi", "dac", "snac")}


def test_float16_aliases_resolve():
    from codec_tpu.runtime.model import resolve_compute_dtype as jax_resolve
    from codec_tpu_torch.runtime.model import resolve_compute_dtype

    for spec in ("float16", "f16", "F16", torch.float16):
        assert resolve_compute_dtype(spec) == torch.float16
    for spec in ("float16", "f16"):
        assert np.dtype(jax_resolve(spec)) == np.float16


@pytest.mark.parametrize("arch,cols", [("mimi", 4), ("dac", 4), ("snac", 3)])
def test_float16_decode_matches_jax(f16_models, arch, cols):
    """The port's f16 decode against codec_tpu's f16 and the port's f32,
    at the bf16 tests' bound (corr > 0.99); the weights are f16 (with f32
    rows the kernels read), none bf16."""
    m = f16_models[arch]

    def leaves(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in leaves(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    dtypes = {t.dtype for t in leaves(m["port"].params) if t.is_floating_point()}
    assert m["port"].compute_dtype == torch.float16
    assert torch.float16 in dtypes and torch.bfloat16 not in dtypes
    codes = _codes((8, cols), 64, 21)
    got = m["port"].decode(codes)
    want, f32 = m["jax"].decode(codes), m["f32"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape == f32.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99
    assert np.corrcoef(got, f32)[0, 1] > 0.99


@pytest.mark.parametrize("arch", ["mimi", "dac", "snac"])
def test_float16_encode_matches_jax(f16_models, arch):
    """f16 encodes: codec_tpu's f16 codes' shape and range, and (tiny
    random models, f16 sums) at least 90% of its codes."""
    m = f16_models[arch]
    pcm = (np.random.default_rng(22).standard_normal(8 * m["port"].hop_size)
           * 0.3).astype(np.float32)
    got, want = m["port"].encode(pcm), m["jax"].encode(pcm)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.min() >= 0 and got.max() < 64
    assert (got == want).mean() >= 0.9


@pytest.mark.parametrize("arch", ["mimi", "dac", "snac"])
def test_metadata_accessors_match_jax(models, arch):
    port, ref = models[arch]["port"], models[arch]["jax"]
    for attr in ("n_fft", "win_length", "n_mels", "name", "n_tensors"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.n_tensors == len(port.reader.tensors) > 0
    assert (port.n_fft, port.win_length, port.n_mels) == (-1, -1, -1)
