"""The port's HTTP server (codec_tpu_torch/serve/server.py) on the CPU,
mirroring tests/test_serve.py's non-parallel tests.

Servers run in-process on 127.0.0.1 (port 0) with device="cpu":
  - a small DAC with its encoder (non-causal: no streaming decode);
    codec_tpu's server on the same file for the decode bytes;
  - a small Pocket-TTS file (flow_lm, self-contained);
  - tests/test_torch_fused.py's CSM file (tiny Mimi + residual_depth_ar)
    with its Q8_0 backbone, serialized (--quant-exec) and through a
    2-slot continuous-batching engine.
Bounds: /decode bytes equal the port's decode(pcm_format="i16") and are
within 1 LSB of codec_tpu's server; streamed and batched PCM within 1 LSB
of the whole decode (another grouping of the same sums); the engine's
responses equal the serialized on-device path's bytes.
"""

import base64
import dataclasses
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from codec_tpu_torch.serve import CodecHTTPServer
from codec_tpu_torch.serve.server import main
from test_torch_fused import files  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _req(srv, method, path, body=None):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _post(srv, path, obj):
    return _req(srv, "POST", path, json.dumps(obj))


def _pcm(wav: bytes) -> np.ndarray:
    return np.frombuffer(wav[44:], dtype="<i2").astype(np.int32)


@pytest.fixture(scope="module")
def dac_path(tmp_path_factory):
    from codec_tpu_torch.models import dac, dac_init

    path = tmp_path_factory.mktemp("srv") / "dac.gguf"
    dac_init.write_random_dac_gguf(path, seed=0, cfg=dac.DacConfig(
        n_q=2, codebook_size=16, codebook_dim=4, latent_dim=64),
        decoder_dim=16, encoder=True)
    return path


@pytest.fixture(scope="module")
def server(dac_path):
    srv = _start(CodecHTTPServer(str(dac_path), port=0, device="cpu"))
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def tts_server(tmp_path_factory):
    from codec_tpu_torch.models.lm_tts_init import write_pocket_tts_gguf
    from test_torch_flow_lm import FLOW, SMALL

    path = write_pocket_tts_gguf(
        tmp_path_factory.mktemp("ptts") / "pocket_tts.gguf", seed=3,
        flow=FLOW, codec_cfg=SMALL, channels=(32, 16, 8, 8), ffn=64)
    srv = _start(CodecHTTPServer(str(path), port=0, device="cpu"))
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def ar_server(files):
    _, model, bb = files
    srv = _start(CodecHTTPServer(str(model), port=0, backbone_path=str(bb),
                                 quant_exec=True, device="cpu"))
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def cont_server(files):
    _, model, bb = files
    srv = _start(CodecHTTPServer(str(model), port=0, backbone_path=str(bb),
                                 quant_exec=True, cont_batch=2,
                                 chunk_frames=8, device="cpu"))
    yield srv
    srv.shutdown()


def test_health(server):
    status, data = _req(server, "GET", "/health")
    assert status == 200
    info = json.loads(data)
    assert info["arch"] == "dac" and info["has_decoder"] and info["has_encoder"]
    assert info["lm_kind"] is None


def test_decode_roundtrip(server, dac_path):
    """/decode bytes equal the port's decode(pcm_format="i16"), within 1
    LSB of codec_tpu's server on the same file; /encode of the result
    gives a code a frame."""
    from codec_tpu.serve import CodecHTTPServer as JaxServer

    codes = np.random.default_rng(1).integers(0, 16, (6, 2))
    status, wav = _post(server, "/decode", {"codes": codes.tolist()})
    assert status == 200 and wav[:4] == b"RIFF"
    want = server.model.decode(codes.astype(np.int32), pcm_format="i16")
    assert wav[44:] == want.astype("<i2").tobytes()
    ref = _start(JaxServer(str(dac_path), port=0))
    try:
        status, jwav = _post(ref, "/decode", {"codes": codes.tolist()})
    finally:
        ref.shutdown()
    assert status == 200 and len(jwav) == len(wav) and jwav[:44] == wav[:44]
    assert int(np.abs(_pcm(wav) - _pcm(jwav)).max()) <= 1
    status, data = _req(server, "POST", "/encode", wav)
    assert status == 200
    got = json.loads(data)["codes"]
    assert len(got) == 6 and len(got[0]) == 2


def test_batch_decode_endpoint(server):
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 16, (t, 2)).tolist() for t in (3, 6, 3)]
    status, data = _post(server, "/batch_decode", {"sequences": seqs})
    assert status == 200
    out = json.loads(data)
    assert out["sample_rate"] == server.model.sample_rate
    wavs = [base64.b64decode(w) for w in out["wavs"]]
    assert len(wavs) == 3
    for s, w in zip(seqs, wavs):
        st, single = _post(server, "/decode", {"codes": s})
        assert st == 200 and len(w) == len(single)
        assert int(np.abs(_pcm(w) - _pcm(single)).max()) <= 1


def test_errors(server):
    assert _req(server, "GET", "/nope")[0] == 404
    assert _req(server, "POST", "/nope", "{}")[0] == 404
    status, data = _req(server, "POST", "/decode", "not json")
    assert status == 400 and b"error" in data
    assert _post(server, "/decode", {"codes": [1, 2]})[0] == 400
    status, data = _post(server, "/synthesize", {"text": "x"})
    assert status == 400 and b"flow_lm" in data
    status, data = _post(server, "/synthesize_batch", {"texts": ["x"]})
    assert status == 400 and b"--backbone" in data
    status, data = _req(server, "POST", "/encode", b"RIFF-not-a-wav")
    assert status in (400, 500) and b"error" in data


def test_concurrent_decode_matches_serial(server):
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, 16, (4, 2)).tolist() for _ in range(6)]
    serial = [_post(server, "/decode", {"codes": c}) for c in reqs]
    assert all(s == 200 for s, _ in serial)
    results = [None] * len(reqs)

    def worker(i):
        results[i] = _post(server, "/decode", {"codes": reqs[i]})
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for (_, sd), (cs, cd) in zip(serial, results):
        assert cs == 200 and cd == sd


def test_decode_stream_rejects_non_causal(server):
    status, data = _post(server, "/decode_stream", {"codes": [[1, 2], [2, 3]]})
    assert status == 400 and b"no streaming decode path" in data


def test_concurrent_synthesize_state_isolation(tts_server):
    """Concurrent flow_lm /synthesize with distinct seeds give exactly the
    bytes each gives alone: per-request state on shared weights."""
    reqs = [{"text": "hello there", "seed": s, "max_frames": 4}
            for s in range(3)]
    serial = [_post(tts_server, "/synthesize", r) for r in reqs]
    assert all(s == 200 for s, _ in serial)
    assert len({d for _, d in serial}) == len(serial)
    results = [None] * len(reqs)

    def worker(i):
        results[i] = _post(tts_server, "/synthesize", reqs[i])
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for (_, sd), (cs, cd) in zip(serial, results):
        assert cs == 200 and cd == sd


def test_concurrent_stream_and_batch_synthesize(tts_server):
    """A streamed flow_lm synthesize beside plain ones: all complete, the
    plain ones equal the lone plain response, and the streamed PCM (one
    push a frame) is within 1 LSB of it."""
    batch_req = {"text": "hello", "seed": 9, "max_frames": 4}
    _, batch_wav = _post(tts_server, "/synthesize", batch_req)
    out = {}

    def stream_worker():
        out["stream"] = _post(tts_server, "/synthesize",
                              dict(batch_req, stream=True))

    def batch_worker(i):
        out[f"b{i}"] = _post(tts_server, "/synthesize", batch_req)
    ts = [threading.Thread(target=stream_worker)] + \
        [threading.Thread(target=batch_worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert set(out) == {"stream", "b0", "b1"}
    assert all(v[0] == 200 for v in out.values())
    for i in range(2):
        assert out[f"b{i}"][1] == batch_wav
    a, b = _pcm(out["stream"][1]), _pcm(batch_wav)
    assert a.shape == b.shape and a.shape[0] > 0
    assert int(np.abs(a - b).max()) <= 1


def test_decode_stream_endpoint(ar_server):
    """Chunked streaming decode on the (causal) Mimi: within 1 LSB of the
    whole decode."""
    codes = np.random.default_rng(7).integers(0, 16, (7, ar_server.model.n_q))
    status, wav = _post(ar_server, "/decode_stream",
                        {"codes": codes.tolist(), "chunk_frames": 3})
    assert status == 200 and wav[:4] == b"RIFF"
    got = _pcm(wav)
    ref = ar_server.model.decode(codes.astype(np.int32), pcm_format="i16")
    assert got.shape == ref.shape
    assert int(np.abs(got - ref.astype(np.int32)).max()) <= 1


def test_backbone_synthesize_endpoint(ar_server):
    req = {"text": "hello there", "seed": 3, "max_frames": 4}
    status, wav = _post(ar_server, "/synthesize", req)
    assert status == 200 and wav[:4] == b"RIFF" and len(wav) > 44
    assert len(wav) == 44 + 2 * 4 * ar_server.model.hop_size
    assert _post(ar_server, "/synthesize", req)[1] == wav
    out = {}

    def worker(i):
        out[i] = _post(ar_server, "/synthesize", dict(req, seed=10 + i))
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert sorted(out) == [0, 1] and all(v[0] == 200 for v in out.values())


def test_synthesize_batch_endpoint(ar_server):
    """B texts through one batched chunk: per-text WAVs, deterministic per
    (seed, stream index); per-text sampling changes only its stream."""
    req = {"texts": ["hello there", "hello hello"], "seed": 4,
           "max_frames": 4, "chunk_frames": 2}
    status, body = _post(ar_server, "/synthesize_batch", req)
    assert status == 200, body
    out = json.loads(body)
    assert len(out["wavs"]) == 2 and out["n_frames"] == [4, 4]
    assert out["stops"] == ["max_frames"] * 2
    wavs = [base64.b64decode(w) for w in out["wavs"]]
    assert all(w[:4] == b"RIFF" and len(w) > 44 for w in wavs)
    assert json.loads(_post(ar_server, "/synthesize_batch", req)[1])["wavs"] \
        == out["wavs"]
    sreq = dict(req, sampling=[{}, {"temperature": 1.5, "top_k": 3}])
    status, body = _post(ar_server, "/synthesize_batch", sreq)
    assert status == 200, body
    out3 = json.loads(body)
    assert out3["wavs"][0] == out["wavs"][0]
    assert out3["wavs"][1] != out["wavs"][1]


def test_cont_batch_matches_serialized_path(ar_server, cont_server):
    """An engine /synthesize answers with the serialized on-device chunked
    path's bytes (same weights, seed and chain)."""
    req = {"text": "hello there", "seed": 3, "max_frames": 6}
    s_ref, wav_ref = _post(ar_server, "/synthesize",
                           dict(req, on_device=True, chunk_frames=8))
    s, wav = _post(cont_server, "/synthesize", req)
    assert s_ref == 200 and s == 200
    assert wav == wav_ref


def test_cont_batch_concurrent_requests(cont_server):
    """More concurrent requests than slots: all 200, and each replayed
    alone returns the same bytes (slot and batch company do not matter);
    a request's own chain rides with it."""
    out = {}

    def worker(i):
        out[i] = _post(cont_server, "/synthesize",
                       {"text": f"words {i}", "seed": 40 + i, "max_frames": 5,
                        **({"temperature": 1.3, "top_k": 4} if i == 2 else {})})
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert sorted(out) == [0, 1, 2, 3]
    assert all(v[0] == 200 for v in out.values())
    for i in (0, 2):
        status, wav = _post(cont_server, "/synthesize",
                            {"text": f"words {i}", "seed": 40 + i,
                             "max_frames": 5,
                             **({"temperature": 1.3, "top_k": 4}
                                if i == 2 else {})})
        assert status == 200 and wav == out[i][1]


def test_cont_batch_stream_synthesize(cont_server):
    """{"stream": true} through the engine: the frames are vocoded through
    a streaming session as their chunks are read; the PCM is within 1 LSB
    of the plain response."""
    req = {"text": "hello there", "seed": 5, "max_frames": 7}
    s_ref, wav_ref = _post(cont_server, "/synthesize", req)
    s_st, wav_st = _post(cont_server, "/synthesize", dict(req, stream=True))
    assert s_ref == 200 and s_st == 200
    a, b = _pcm(wav_st), _pcm(wav_ref)
    assert a.shape == b.shape and a.shape[0] > 0
    assert int(np.abs(a - b).max()) <= 1


def test_stats_endpoint(cont_server, server):
    status, data = _req(cont_server, "GET", "/stats")
    assert status == 200
    info = json.loads(data)
    assert info["backbone"] is True and info["dp_mesh"] is None
    assert info["cont_batch"] == {"slots": 2, "chunk_frames": 8,
                                  "active": 0, "queued": 0}
    status, data = _req(server, "GET", "/stats")
    assert status == 200 and json.loads(data)["cont_batch"] is None


@pytest.mark.parametrize("flag", ["--tp", "--pp", "--ep", "--dp"])
def test_parallel_flags_are_not_ported(files, flag, capsys,  # noqa: F811
                                       monkeypatch):
    """Each flag beside --dp 2: --dp alone builds a dp mesh and with --tp a
    2-D dp x tp mesh with the backbone TP-split over it (their requests:
    tests/test_torch_parallel_graphs.py); beside --pp or --ep it exits 1
    with codec_tpu's message."""
    _, model, bb = files
    started = []
    monkeypatch.setattr(CodecHTTPServer, "serve_forever",
                        lambda self: started.append(self))
    rc = main(["--model", str(model), "--backbone", str(bb), "--device",
               "cpu", flag, "2", "--dp", "2"])
    if flag in ("--pp", "--ep"):
        assert rc == 1
        assert "--dp composes with --tp only" in capsys.readouterr().err
        return
    (srv,) = started
    srv.httpd.server_close()
    assert rc == 0 and dict(srv.batch_mesh.shape) == (
        {"dp": 2, "tp": 2} if flag == "--tp" else {"dp": 2})


def test_cont_batch_needs_a_backbone(dac_path, capsys):
    assert main(["--model", str(dac_path), "--device", "cpu",
                 "--cont-batch", "2"]) == 1
    assert "--cont-batch needs --backbone" in capsys.readouterr().err


def test_wav_header_and_pcm16():
    from codec_tpu.serve.server import _pcm16 as jax_pcm16
    from codec_tpu.serve.server import _wav_header as jax_header
    from codec_tpu_torch.io.wav import read_wav
    from codec_tpu_torch.serve.server import _pcm16, _wav_header

    x = np.random.default_rng(2).uniform(-1.2, 1.2, 100).astype(np.float32)
    for n in (100, -1):
        assert _wav_header(n, 24000) == jax_header(n, 24000)
    assert _pcm16(x) == jax_pcm16(x)
    y, sr = read_wav(io.BytesIO(_wav_header(100, 24000) + _pcm16(x)))
    assert sr == 24000 and y.shape == (100, 1)


def test_chip_smoke_serving_on_cpu(tmp_path_factory, monkeypatch):
    """chip_smoke.py's phase 9f end to end at small widths on the CPU (its
    card-only measurements left out): the servers, every endpoint, the
    engine built beside running /decode requests, serialized against
    continuous, the concurrent and streamed requests, both
    /synthesize_batch kinds against their single-stream runs, the flow
    stream; the launch counts are those the card is held to."""
    from pathlib import Path

    from codec_tpu_torch.models import chatterbox_init as cbi
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_ggufs,
                                                write_random_csm_gguf)
    from codec_tpu_torch.models.lm_tts_init import write_pocket_tts_gguf
    from test_torch_chatterbox import BB as CBX_BB
    from test_torch_chatterbox import T3, VE
    from test_torch_flow_lm import FLOW, SMALL
    from test_torch_fused import BB, DEPTH, MIMI
    from test_torch_s3g import SMALL as S3G_SMALL
    from test_torch_s3g import WIDTHS

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    tmp = tmp_path_factory.mktemp("smoke9f")
    model = write_random_csm_gguf(tmp / "csm.gguf", seed=2, mimi_cfg=MIMI,
                                  num_filters=8, dcfg=DEPTH, encoder=True)
    bbs = write_random_backbone_ggufs(
        {q: tmp / f"bb_{q}.gguf" for q in ("Q4_K", "Q8_0")}, seed=1, cfg=BB,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    h = 256                                  # Q4_K wants widths of 256
    cbx = cbi.write_chatterbox_tts_gguf(
        tmp / "cbx.gguf", seed=3, t3=dataclasses.replace(T3, hidden=h),
        ve=dataclasses.replace(VE, hidden_dim=h),
        cfg=dataclasses.replace(S3G_SMALL, codebook_size=T3.start_speech),
        **WIDTHS)
    cbx_bb = write_random_backbone_ggufs(
        {"Q4_K": tmp / "t3_Q4_K.gguf"}, seed=4,
        cfg=dataclasses.replace(CBX_BB, hidden=h, n_layers=1, head_dim=64,
                                ffn_dim=512),
        rope_scaling=cbi.T3_ROPE_SCALING)["Q4_K"]
    pocket = write_pocket_tts_gguf(tmp / "pocket_tts.gguf", seed=3, flow=FLOW,
                                   codec_cfg=SMALL, channels=(32, 16, 8, 8),
                                   ffn=64)
    paths = {"csm": model, **bbs, "cbx": cbx, "cbx_bb": cbx_bb,
             "pocket": pocket}
    none = dict.fromkeys(("flash_sdpa_window", "q8_0_matmul", "q4_k_matmul",
                          "rvq_encode_fused"), 0)
    got, times = cs.serving("CPU", lambda: None, lambda: dict(none), none,
                            paths, dev="cpu",
                            sizes=dict(frames=6, seconds=2, cbx_frames=6))
    carried = "flash_sdpa_window (carried keys)"
    assert got["rvq_encode_fused"] == 2
    assert got["q8_0_matmul"] > 0 and got["q4_k_matmul"] > 0
    assert got[carried] > 0 and got["flash_sdpa_window"] > 0
    assert times["ttfa_ms"] > 0 and set(times["engine"]) == {1, 2, 4}


def test_capture_lock_keeps_captures_apart():
    """fused_gen.CaptureLock: while a thread holds it exclusive (a CUDA
    graph capture) no other thread holds it shared; shared holders run
    together, re-enter freely, and the capturing thread may take it shared
    again or over its own shared hold. Four threads of shared work and one
    of captures run to their end (no deadlock)."""
    import time

    from codec_tpu_torch.lm.fused_gen import CaptureLock

    lock, seen, overlap = CaptureLock(), [], []

    def work(i):
        for _ in range(40):
            with lock.shared(), lock.shared():
                seen.append(i)
                time.sleep(0.0002)

    def captures():
        for _ in range(15):
            with lock.shared(), lock.exclusive():
                overlap.append(lock._shared - lock._held())
                with lock.shared():
                    seen.append("capture")
                time.sleep(0.0005)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    ts.append(threading.Thread(target=captures))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert len(seen) == 4 * 40 + 15 and overlap == [0] * 15
