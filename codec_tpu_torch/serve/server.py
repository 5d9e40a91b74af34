"""codec-serve-torch: HTTP serving of codec and TTS models on the port
(counterpart of codec_tpu/serve/server.py).

One process owns the model: weights on the device, shared by every
request; a standard-library threaded HTTP front end. Every request thread
owns its generation state (a fresh AudioLM or LmState per /synthesize, a
streaming-decoder session per stream) while the weights are shared, so
concurrent requests overlap their host work with each other's device work.
Two things are serialized: the shared backbone (one generation at a time
on `_bb_lock`; the continuous-batching engine steps a backbone of its own
over the same weights), and CUDA graph captures, which hold
`lm/fused_gen.capture_lock` exclusive while every handler's device work
holds it shared (a capture fails when another thread allocates,
synchronizes or copies while it runs). The engine's graph is captured
when the server is built, before it accepts a request.

Endpoints:
  GET  /health                 → model/LM info JSON
  GET  /stats                  → engine occupancy JSON
  POST /decode                 body {"codes": [[...], ...], "n_q": 0}
                               → audio/wav
  POST /decode_stream          body {"codes": ..., "chunk_frames": 25}
                               → chunked-transfer audio/wav through a
                               streaming-decoder session (causal codecs)
  POST /batch_decode           body {"sequences": [[[...]], ...], "n_q": 0}
                               → {"wavs": [base64 WAV, ...]} (decode_many)
  POST /encode                 body: WAV bytes → {"codes": [[...], ...]}
  POST /synthesize             body {"text": "...", "seed": 0,
                                     "max_frames": 0}
                               → audio/wav; {"stream": true} sends the WAV
                               chunked as frames are vocoded. flow_lm
                               models are self-contained; codebook-AR and
                               Chatterbox models need --backbone (with
                               "on_device" and "chunk_frames" in the body
                               for the device chunks, and "temperature",
                               "top_k", "top_p", "min_p" over the family's
                               chain), and with
                               --cont-batch N plain codebook-AR requests
                               join the N-slot engine (per-request
                               "temperature", "top_k", "top_p", "min_p")
  POST /synthesize_batch       body {"texts": [...], "seed": 0,
                                     "max_frames": 0, "chunk_frames": 8,
                                     "sampling": [{...}, ...]}
                               → {"wavs": [b64...], "n_frames", "stops"};
                               B generations through one batched chunk
                               (codebook-AR kinds and Chatterbox)

Usage:
  python -m codec_tpu_torch.serve --model pocket.gguf [--port 8765]
  python -m codec_tpu_torch.serve --model csm.gguf --backbone bb.gguf \\
      [--cont-batch 4 --chunk-frames 8] [--quant-exec] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


# a request's own sampler chain: body fields over the family's defaults
_CHAIN = ("temperature", "top_k", "top_p", "min_p")


def _wav_header(n_samples: int, sample_rate: int) -> bytes:
    """PCM16 mono WAV header. n_samples < 0 → 'unknown length' sizes
    (max-uint32 data size; players and ffmpeg accept this for streams)."""
    data_bytes = n_samples * 2 if n_samples >= 0 else 0xFFFFFFFF - 44
    riff = 36 + data_bytes if n_samples >= 0 else 0xFFFFFFFF
    return (b"RIFF" + struct.pack("<I", riff) + b"WAVEfmt " +
            struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2,
                        2, 16) + b"data" + struct.pack("<I", data_bytes))


def _pcm16(x: np.ndarray) -> bytes:
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


class CodecHTTPServer:
    """The server over one codec GGUF (and a backbone GGUF for the
    backbone flows) on `device`. `quant_exec` keeps a Q8_0/Q4_K backbone's
    matrices packed for the dequantizing kernels. `cont_batch` > 0 starts
    the continuous-batching engine with that many slots, `chunk_frames`
    frames a chunk. `backbone_mesh` ("tp" | "pp" | "ep", N) shards the
    backbone once at startup (lm/backbone.py::apply_backbone_mesh; the
    first N cards, or N entries of a `device` that names one): /synthesize
    runs over it on the host path, `on_device`, the engine and
    /synthesize_batch step a TP or EP backbone's shares in their chunks,
    and a PP one runs the host per-frame loop (its engine raises
    CodecError). `dp` > 1 (codec_tpu's --dp): /synthesize_batch's streams
    and the engine's slots data-parallel over a dp mesh (`batch_mesh`; dp
    entries of the device), or with ("tp", M) one 2-D dp x tp mesh with
    the backbone TP-split over it; with "pp" or "ep" it raises
    ValueError."""

    def __init__(self, model_path: str, host: str = "127.0.0.1",
                 port: int = 8765, backbone_path: str = None,
                 backbone_mesh: tuple = None, dp: int = 0,
                 cont_batch: int = 0, chunk_frames: int = 8,
                 prefill_bucket: int = 0, quant_exec: bool = False,
                 device="cuda"):
        import threading as _threading

        import codec_tpu_torch

        from ..io.gguf import GGUFReader
        from ..lm import create_lm

        self.device = device
        self.model = codec_tpu_torch.load_model(model_path, device=device)
        self.reader = GGUFReader(model_path)
        self.lm = create_lm(self.reader, device=device)
        # the backbone flows: one backbone loaded at startup, its KV state
        # reset a request, generations serialized on a lock (the codec
        # decode and flow_lm paths stay concurrent)
        self.backbone = None
        self.backbone_path = backbone_path
        self.batch_mesh = None          # the dp mesh of the batched paths
        self._bb_lock = _threading.Lock()
        self._shared_lm = None          # the CodecLM of /synthesize_batch
        self._t3 = None                 # a Chatterbox file's T3
        if backbone_path:
            from ..lm.backbone import create_backbone
            from ..lm.chatterbox_t3 import ChatterboxT3, is_chatterbox

            self.backbone = create_backbone(backbone_path,
                                            quantized=quant_exec,
                                            device=device)
            if is_chatterbox(self.reader):
                self._t3 = ChatterboxT3(self.reader, device=device)
            if backbone_mesh is not None and self._t3 is not None:
                raise ValueError("--tp/--pp/--ep do not support the "
                                 "chatterbox dual-lane flow")
            from ..parallel.mesh import make_mesh, make_mesh_2d, named_devices

            if dp > 1 and backbone_mesh and backbone_mesh[0] == "tp":
                # --dp N --tp M: one 2-D mesh, the batched paths' streams
                # over dp and each dp row's backbone shares over tp
                n_tp = backbone_mesh[1]
                self.batch_mesh = make_mesh_2d(
                    dp, n_tp, devices=named_devices(device, dp * n_tp))
                self.backbone.set_mesh(self.batch_mesh, axis="tp")
            elif dp > 1 and backbone_mesh:
                raise ValueError("--dp composes with --tp only "
                                 "(pp/ep backbones run per-stream)")
            elif dp > 1:
                self.batch_mesh = make_mesh(dp, axis="dp",
                                            devices=named_devices(device, dp))
            elif backbone_mesh is not None:
                from ..lm.backbone import apply_backbone_mesh

                apply_backbone_mesh(self.backbone, *backbone_mesh,
                                    devices=named_devices(
                                        device, backbone_mesh[1]))

        # continuous batching (--cont-batch N): /synthesize requests of
        # plain codebook-AR kinds run through one N-slot engine, admitted
        # as a slot frees up and retired as their stream stops, instead of
        # serializing on the backbone lock (serve/cont_batch.py)
        self.cont_engine = None
        self._cont_batcher = None
        self._cont_pi = None
        self._cont_tok = None
        if cont_batch > 0:
            if self.backbone is None:
                raise ValueError("--cont-batch needs --backbone")
            if self.lm is None:
                raise ValueError("--cont-batch needs a codec_lm adaptor "
                                 "in the model GGUF")
            from ..cli.tts_cli import load_backbone_tokenizer
            from ..lm.fused_gen import refuse_pp
            from ..lm.prompt_info import build_prompt_info
            from ..ops.sample import OnDeviceSampling
            from .cont_batch import ContinuousBatcher, EngineThread

            pi = build_prompt_info(self.reader, self.lm.info)
            if pi.is_continuous or pi.sequential_text_audio \
                    or pi.streaming_interleave or self._t3 is not None:
                raise ValueError(f"--cont-batch supports plain codebook-AR "
                                 f"kinds only (family: {pi.host_arch})")
            self._cont_pi = pi
            self._cont_tok = load_backbone_tokenizer(
                GGUFReader(backbone_path))
            bb = self.backbone
            refuse_pp(bb, "the continuous-batching engine")
            # the engine's own cache over the shared weights (and shares):
            # its admissions never touch the serialized paths' backbone;
            # its slots split over the dp mesh of /synthesize_batch (slots
            # a multiple of dp)
            self._cont_batcher = ContinuousBatcher(
                bb.lane(), self.lm, n_slots=cont_batch,
                on_device=OnDeviceSampling(
                    temperature=pi.default_temperature,
                    top_k=pi.default_top_k, top_p=pi.default_top_p,
                    chunk_frames=max(2, chunk_frames)),
                pi=pi, prefill_bucket=prefill_bucket, mesh=self.batch_mesh)
            self.cont_engine = EngineThread(self._cont_batcher)
            self.cont_engine.start()
        self.prefill_bucket = int(prefill_bucket)
        self.httpd = ThreadingHTTPServer((host, port), _handler(self))
        self.host, self.port = host, self.httpd.server_address[1]

    def serve_forever(self):
        print(f"serve: listening on http://{self.host}:{self.port} "
              f"(arch={self.model.arch}, "
              f"lm={self.lm.info.kind if self.lm else None}, "
              f"device={self.device})")
        self.httpd.serve_forever()

    def shutdown(self):
        if self.cont_engine is not None:
            self.cont_engine.stop()
        self.httpd.shutdown()
        self.httpd.server_close()


def _handler(outer: CodecHTTPServer):
    from ..lm.fused_gen import capture_lock

    shared = capture_lock.shared

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            print(f"serve: {self.address_string()} {fmt % args}",
                  file=sys.stderr)

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str) -> None:
            self._json(code, {"error": msg})

        def do_GET(self):
            if self.path == "/stats":
                return self._stats()
            if self.path != "/health":
                return self._err(404, f"no route {self.path}")
            m = outer.model
            self._json(200, {
                "status": "ok", "arch": m.arch,
                "sample_rate": m.sample_rate, "hop_size": m.hop_size,
                "n_q": m.n_q, "has_encoder": m.has_encoder,
                "has_decoder": m.has_decoder,
                "lm_kind": outer.lm.info.kind if outer.lm else None,
                "dp_mesh": _mesh_shape(outer.batch_mesh),
            })

        def _stats(self):
            """The continuous-batching engine's occupancy (slots, active,
            queued) when --cont-batch is on."""
            cb = None
            if outer._cont_batcher is not None:
                b = outer._cont_batcher
                cb = {"slots": b.B, "chunk_frames": b.K,
                      "active": b.n_active, "queued": b.n_queued}
            self._json(200, {"cont_batch": cb,
                             "backbone": outer.backbone_path is not None,
                             "dp_mesh": _mesh_shape(outer.batch_mesh)})

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_POST(self):
            self._response_started = False
            try:
                route = {"/decode": self._decode,
                         "/decode_stream": self._decode_stream,
                         "/batch_decode": self._batch_decode,
                         "/encode": self._encode,
                         "/synthesize": self._synthesize,
                         "/synthesize_batch": self._synthesize_batch
                         }.get(self.path)
                if route is None:
                    return self._err(404, f"no route {self.path}")
                return route()
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                if self._response_started:
                    # the status line and headers are on the wire: a
                    # second response would corrupt the chunked stream;
                    # drop the connection (the client sees a truncation)
                    self.log_message("mid-stream error: %s", e)
                    self.close_connection = True
                    return
                return self._err(400, str(e))
            except BrokenPipeError:
                self.close_connection = True
            except Exception as e:        # noqa: BLE001
                # an unexpected error must not kill the worker thread
                # silently: log the traceback, answer 500 when the
                # response has not started, else drop the connection
                import traceback

                self.log_message("handler error: %s\n%s", e,
                                 traceback.format_exc())
                if self._response_started:
                    self.close_connection = True
                    return
                return self._err(500, f"{type(e).__name__}: {e}")

        def send_response(self, code, message=None):
            self._response_started = True
            super().send_response(code, message)

        def _start_chunked(self):
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._chunk(_wav_header(-1, outer.model.sample_rate))

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _wav(self, pcm16: bytes, extra=()):
            body = _wav_header(len(pcm16) // 2,
                               outer.model.sample_rate) + pcm16
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _codes(req):
            codes = np.asarray(req["codes"], np.int32)
            if codes.ndim != 2:
                raise ValueError("codes must be [T, n_q]")
            return codes

        def _decode(self):
            req = json.loads(self._body())
            codes = self._codes(req)
            # i16: the PCM16 conversion on the device (half the bytes to
            # the host; write_wav's rounding)
            with shared():
                pcm = outer.model.decode(codes, n_q=int(req.get("n_q", 0)),
                                         pcm_format="i16")
            self._wav(pcm.astype("<i2").tobytes())

        def _streams(self):
            if not getattr(outer.model, "causal_time", False) or \
                    not hasattr(outer.model, "streaming_decoder"):
                raise ValueError(
                    f"{outer.model.arch}: no streaming decode path")

        def _decode_stream(self):
            """Chunked-transfer WAV decode for causal codecs: the frames go
            through a per-request streaming-decoder session, so the first
            audio leaves after one chunk of frames."""
            req = json.loads(self._body())
            codes = self._codes(req)
            self._streams()
            chunk_frames = max(1, int(req.get("chunk_frames", 25)))
            with shared():
                dec = outer.model.streaming_decoder(
                    n_q=int(req.get("n_q", 0)) or codes.shape[1])
            self._start_chunked()
            for t0 in range(0, codes.shape[0], chunk_frames):
                with shared():
                    pcm = dec.push(codes[t0: t0 + chunk_frames])
                self._chunk(_pcm16(pcm))
            self._chunk(b"")

        def _batch_decode(self):
            """Many sequences in one request (CodecModel.decode_many): one
            base64 WAV a sequence."""
            import base64

            req = json.loads(self._body())
            seqs = [np.asarray(s, np.int32) for s in req["sequences"]]
            with shared():
                outs = outer.model.decode_many(
                    seqs, n_q=int(req.get("n_q", 0)), pcm_format="i16")
            sr = outer.model.sample_rate
            wavs = [base64.b64encode(_wav_header(len(p), sr)
                                     + p.astype("<i2").tobytes()).decode()
                    for p in outs]
            self._json(200, {"wavs": wavs, "sample_rate": sr})

        def _encode(self):
            from ..io.wav import read_wav, to_mono

            # mono PCM16 stays int16: encode() uploads half the bytes and
            # divides by 32768 on the device (codec_cli's path)
            x, sr = read_wav(io.BytesIO(self._body()), keep_i16=True)
            want_sr = getattr(outer.model, "encode_sample_rate", 0) or \
                outer.model.sample_rate
            if sr != want_sr:
                raise ValueError(f"sample rate {sr} != expected {want_sr}")
            if x.dtype == np.int16 and x.shape[1] == 1:
                x = x[:, 0]
            else:
                if x.dtype == np.int16:
                    x = x.astype(np.float32) / 32768.0
                x = to_mono(x)
            with shared():
                codes = outer.model.encode(x)
            self._json(200, {"codes": codes.tolist()})

        def _synthesize(self):
            from ..cli.tts_cli import (run_backbone_synthesize,
                                       run_flow_synthesize)
            from ..lm.flow_lm import FlowLM

            req = json.loads(self._body())
            text = req["text"]
            if outer.lm is not None and isinstance(outer.lm, FlowLM):
                if req.get("stream"):
                    return self._synthesize_flow_stream(req, text)
                with shared():
                    pcm, n_frames, stop = run_flow_synthesize(
                        outer.model, outer.lm, text,
                        seed=int(req.get("seed", 0)),
                        max_frames=int(req.get("max_frames", 0)))
            elif outer.cont_engine is not None:
                # the engine: concurrent requests generate together (the
                # products at m = slots), each returning when its own
                # stream stops
                if req.get("stream"):
                    return self._synthesize_cont_stream(req, text)
                pcm, n_frames, stop = self._synthesize_cont(req, text)
            elif outer.backbone is not None:
                # the shared backbone's KV state is reset a request; the
                # generations serialize on its lock (a new graph's capture
                # holds capture_lock exclusive)
                with outer._bb_lock:
                    pcm, n_frames, stop = run_backbone_synthesize(
                        outer.model, outer.reader, outer.backbone_path,
                        text, seed=int(req.get("seed", 0)),
                        max_frames=int(req.get("max_frames", 0)),
                        bb=outer.backbone, lm=outer.lm, t3=outer._t3,
                        on_device=bool(req.get("on_device", False)),
                        chunk_frames=int(req.get("chunk_frames", 8)),
                        prefill_bucket=outer.prefill_bucket,
                        device=outer.device,
                        **{k: req[k] for k in _CHAIN if k in req})
            else:
                raise ValueError(
                    "synthesize needs a flow_lm model GGUF (self-"
                    "contained) or a server started with --backbone "
                    "for codebook-AR kinds")
            self._wav(_pcm16(pcm), (("X-Frames", str(n_frames)),
                                    ("X-Stop", stop)))

        def _cont_submit(self, req, text, frame_cb=None):
            """Tokenize and embed the prompt on this handler thread (beside
            the other streams' generation) and submit it to the engine.
            Body fields temperature / top_k / top_p / min_p override the
            engine's default chain for this request (the chain is a
            per-slot row of the graph's input)."""
            from ..cli.tts_cli import sampling_overrides
            from ..lm.audio_lm import AudioLM

            pi = outer._cont_pi
            ids = outer._cont_tok.encode(
                pi.prompt_prefix + text + pi.prompt_suffix)
            alm = AudioLM(outer.reader, codec=outer.model, lm=outer.lm)
            with shared():
                if alm.prompt_needs_composed:
                    embeds = [alm.compose_prompt_embd(t) for t in ids]
                else:
                    embeds = list(outer.backbone.embed_tokens(
                        np.asarray(ids)))
            mf = int(req.get("max_frames", 0))
            sampling = None
            if any(k in req for k in _CHAIN):
                sampling = sampling_overrides(outer._cont_batcher.ods,
                                              [req], 1)[0]
            return alm, outer._cont_batcher.submit(
                alm, embeds, seed=int(req.get("seed", 0)),
                max_steps=mf if mf > 0 else 512, sampling=sampling,
                frame_cb=frame_cb)

        def _synthesize_cont(self, req, text):
            """Submit to the engine and wait for this request's result."""
            _alm, handle = self._cont_submit(req, text)
            try:
                res = handle.wait(timeout=600.0)
            except TimeoutError:
                # free the slot instead of generating to max_steps for a
                # client that has stopped listening
                handle.cancel()
                raise ValueError("synthesis timed out; request cancelled")
            if res.pcm is None:
                raise ValueError("no audio frames generated")
            return res.pcm, int(res.codes.shape[0]), \
                "eos" if res.stopped_by_eos else "max_frames"

        def _synthesize_cont_stream(self, req, text):
            """Streamed engine synthesize: the frames a chunk yields are
            vocoded through a per-request streaming-decoder session and
            leave as chunked WAV (time to first audio: one engine chunk
            and one vocode), while the stream keeps generating in the
            shared batch. Needs a causal codec with a streaming decoder
            and a plain LM-codes→codec-codes transform (no delay pattern,
            control cb0 or merged vocab: those flush at EOS)."""
            import queue

            self._streams()
            frames: queue.Queue = queue.Queue()
            alm, handle = self._cont_submit(req, text, frame_cb=frames.put)
            try:
                tr = alm.decode_transform
                if tr.audio_cb_offset or tr.cb0_speech_offset or \
                        tr.max_delay(alm.n_codebook):
                    raise ValueError(
                        "streaming synthesize needs a trivial decode "
                        "transform (delay/merged-cb0 models flush at EOS)")
                with shared():
                    dec = outer.model.streaming_decoder(n_q=alm.n_codebook)
                vocode_n = max(1, int(req.get("chunk_frames", 0))
                               or outer._cont_batcher.K)
                self._start_chunked()
                deadline = time.monotonic() + 600.0
                buf = []
                while True:
                    try:
                        buf.append(frames.get(timeout=0.05))
                    except queue.Empty:
                        if handle.done:
                            break
                        if time.monotonic() > deadline:
                            raise ValueError("synthesis timed out; "
                                             "request cancelled")
                        continue
                    if len(buf) >= vocode_n:
                        with shared():
                            pcm = dec.push(np.stack(buf))
                        self._chunk(_pcm16(pcm))
                        buf = []
                while not frames.empty():      # frames queued before done
                    buf.append(frames.get_nowait())
                handle.wait(timeout=0)         # re-raise an engine error
                if buf:
                    with shared():
                        pcm = dec.push(np.stack(buf))
                    self._chunk(_pcm16(pcm))
                self._chunk(b"")
            except BaseException:
                # any failure here (a client gone mid-stream included)
                # frees the engine slot, or the stream would generate to
                # max_steps into a dead queue
                handle.cancel()
                raise

        def _synthesize_batch(self):
            """B texts through one batched chunk
            (run_backbone_synthesize_batch) on the shared backbone. Body:
            {"texts", "seed", "max_frames", "chunk_frames", "sampling":
            [{"temperature", "top_k", "top_p", "min_p"}, ...] (optional,
            one a text)}; response: one base64 WAV a text."""
            import base64

            from ..cli.tts_cli import run_backbone_synthesize_batch

            req = json.loads(self._body())
            texts = req["texts"]
            if outer.backbone is None:
                raise ValueError("synthesize_batch needs a server "
                                 "started with --backbone")
            with outer._bb_lock:
                if outer._shared_lm is None:
                    from ..lm import create_lm

                    outer._shared_lm = create_lm(outer.reader,
                                                 device=outer.device)
                outs = run_backbone_synthesize_batch(
                    outer.model, outer.reader, outer.backbone_path, texts,
                    seed=int(req.get("seed", 0)),
                    max_frames=int(req.get("max_frames", 0)),
                    bb=outer.backbone, lm=outer._shared_lm, t3=outer._t3,
                    chunk_frames=int(req.get("chunk_frames", 8)),
                    prefill_bucket=outer.prefill_bucket,
                    sampling=req.get("sampling"), device=outer.device,
                    mesh=outer.batch_mesh)
            sr = outer.model.sample_rate
            wavs, frames, stops = [], [], []
            for pcm, n_frames, stop in outs:
                pcm = pcm if pcm is not None else np.zeros(0, np.float32)
                wavs.append(base64.b64encode(
                    _wav_header(len(pcm), sr) + _pcm16(pcm)).decode())
                frames.append(n_frames)
                stops.append(stop)
            self._json(200, {"wavs": wavs, "sample_rate": sr,
                             "n_frames": frames, "stops": stops})

        def _synthesize_flow_stream(self, req, text):
            """Chunked-transfer WAV of a flow_lm model: each AR frame is
            vocoded through the streaming decoder and sent at once."""
            import math

            from ..cli.tts_cli import flow_prepare_text

            lm, model = outer.lm, outer.model
            text2, fae_guess = flow_prepare_text(text)
            ids = lm.tokenize(text2)
            st = lm.new_state()
            with shared():
                lm.flow_prefill(st, ids)
                dec = model.streaming_decoder()
            fae = lm.frames_after_eos if lm.frames_after_eos >= 0 \
                else fae_guess + 2
            max_gen = int(req.get("max_frames", 0)) or \
                max(8, int(math.ceil((len(ids) / 3.0 + 2.0) * 12.5)))
            max_gen = min(max_gen, lm.max_T - st.kind_state["kv_pos"])
            rng = np.random.default_rng(int(req.get("seed", 0)))
            noise_std = math.sqrt(lm.temperature)
            self._start_chunked()
            prev = None
            eos_step = -1
            for step in range(max_gen):
                noise = (rng.standard_normal(lm.ldim)
                         * noise_std).astype(np.float32)
                with shared():
                    lat, _, is_eos = lm.flow_step(st, prev_latent=prev,
                                                  noise=noise)
                    if is_eos and eos_step < 0:
                        eos_step = step
                    if eos_step >= 0 and step >= eos_step + fae:
                        break
                    pcm = dec.push(lm.denorm_latent(lat)[None])
                self._chunk(_pcm16(pcm))
                prev = lat
            self._chunk(b"")

    return Handler


def _mesh_shape(mesh):
    """A mesh's axis sizes for /health and /stats (None without one)."""
    return dict(mesh.shape) if mesh is not None else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="codec-serve-torch")
    ap.add_argument("--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the codec, the adaptor and the "
                         "backbone (cuda or cpu)")
    ap.add_argument("--cont-batch", type=int, default=0,
                    help="continuous batching: N engine slots for "
                         "/synthesize on codebook-AR kinds (needs "
                         "--backbone); requests join and leave the running "
                         "batch at chunk boundaries")
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="frames per device call (one CUDA graph replay) "
                         "in the --cont-batch engine")
    ap.add_argument("--prefill-bucket", type=int, default=0,
                    help="prefill whole prompts in one forward padded to a "
                         "multiple of N tokens (0 = one step per token)")
    ap.add_argument("--backbone", default=None,
                    help="backbone GGUF for the codebook-AR and Chatterbox "
                         "/synthesize (tts-cli-torch's --backbone)")
    ap.add_argument("--quant-exec", action="store_true",
                    help="keep Q8_0/Q4_K backbone matrices packed on the "
                         "device and multiply them with the dequantizing "
                         "kernels")
    ap.add_argument("--tp", type=int, default=0,
                    help="shard the backbone tensor-parallel over N devices")
    ap.add_argument("--pp", type=int, default=0,
                    help="shard the backbone pipeline-parallel over N "
                         "stages (the host per-frame loop; no engine)")
    ap.add_argument("--ep", type=int, default=0,
                    help="shard a MoE backbone expert-parallel over N "
                         "devices")
    ap.add_argument("--dp", type=int, default=0,
                    help="/synthesize_batch streams and --cont-batch slots "
                         "data-parallel over N devices (with --tp M one 2-D "
                         "dp x tp mesh of N x M; not with --pp/--ep)")
    return ap


def main(argv=None) -> int:
    from ..cli.tts_cli import backbone_mesh_flag
    from ..lm.base import LmError

    args = build_parser().parse_args(argv)
    try:
        mesh = backbone_mesh_flag(args)
        srv = CodecHTTPServer(args.model, args.host, args.port,
                              backbone_path=args.backbone,
                              backbone_mesh=mesh, dp=args.dp,
                              cont_batch=args.cont_batch,
                              chunk_frames=args.chunk_frames,
                              prefill_bucket=args.prefill_bucket,
                              quant_exec=args.quant_exec,
                              device=args.device)
    except (FileNotFoundError, ValueError, LmError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
