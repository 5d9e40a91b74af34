"""Where a decode's device time goes: one warm request under torch.profiler.

    python -m codec_tpu_torch.tools.profile_decode \
        [dac|mimi|snac|wavtokenizer|soprano|xy_tokenizer|qwen3|pocket|
         neucodec|distill_neucodec|xcodec2|moss|nemo|bluemagpie|s3t|s3g]
        [--seconds 20] [--encode]
    python -m codec_tpu_torch.tools.profile_decode csm [--qtype Q4_K]
    python -m codec_tpu_torch.tools.profile_decode mimi_stream

Writes a full-width random model (seed 0) to a temporary directory, runs
two warm-up decodes per request (b1 f32, b1 bf16, b4 f32), then one
unprofiled and one profiled decode (SNAC: the frame count rounded down
to a multiple of 4; Soprano, Pocket-Mimi and BlueMagpie: `decode_latent`
of as many N(0, 1) latent frames; MOSS: 48 kHz stereo; Chatterbox S3Gen:
the seconds of speech tokens after its builtin 10 s prompt, b1 only, one
sequence a decode). With `--encode`,
the same for `encode` (Pocket-Mimi and BlueMagpie: `encode_latent`) of
N(0, 0.3) PCM at the rate the model encodes (b1 f32, b1 bf16, b4 f32; the
file holds the encoder; DistillNeuCodec: 16 kHz, the rate its model, as
codec_tpu's, leaves undeclared; MOSS: one stereo stream a call, so no b4;
the base NeuCodec, Soprano, S3Gen and S3T's decode are not there).
Prints the card's name and power limit, the
latency, the device busy time (the kernels' self time, aten ops
excluded), the idle share against the unprofiled latency, and the
kernels with the most device time. Needs a CUDA device.

`csm` profiles one warm generation frame of the CSM-style TTS path
instead: a full-width random CSM codec and a Llama-3.2-1B-shaped backbone
(packed `--qtype`), a 16-token prompt prefilled, two warm frames, then
one frame (the c0 head and the depth decoder's 31 forwards with greedy
host sampling, the feedback compose, one backbone step) unprofiled and
under the profiler. It also counts the frame's kernel launches.

`mimi_stream` profiles one warm push of a Mimi streaming decode session
(a full-width random Mimi; b1 f32 in pushes of 1 and 5 frames, b1 bf16
and b4 f32 in pushes of 1; ten warm pushes first) and prints where its
device time goes: the top kernels with their shares. A push's latency,
busy time, idle share and launches are chip_smoke.py's (its streaming
phase), measured there with CUDA events.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _kernel_times(prof):
    """(name, device ms, count) of every kernel (aten ops left out)."""
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")]


def _report(kernels, top: int) -> float:
    busy = sum(ms for _, ms, _ in kernels)
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} {key[:110]}")
    return busy


def _csm_frame(qtype: str, top: int, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    import codec_tpu_torch
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import create_backbone
    from codec_tpu_torch.lm.tts_runner import prefill_prompt
    from codec_tpu_torch.models.lm_init import (write_random_backbone_gguf,
                                                write_random_csm_gguf)

    with tempfile.TemporaryDirectory(prefix="profile_decode_") as tmp:
        csm_path = write_random_csm_gguf(Path(tmp) / "csm.gguf", seed=0)
        bb_path = write_random_backbone_gguf(Path(tmp) / "bb.gguf", seed=0,
                                             qtype=qtype)
        reader = GGUFReader(csm_path)
        alm = AudioLM(reader, codec=codec_tpu_torch.load_model(csm_path),
                      device="cuda")
        bb = create_backbone(bb_path, quantized=True, device="cuda")
    lm, st = alm.lm, alm.state
    ids = np.random.default_rng(0).integers(0, bb.cfg.vocab_size, 16)
    h = prefill_prompt(bb, list(bb.embed_tokens(ids)))

    def frame():
        nonlocal h
        st.step_begin(h)
        for _ in range(lm.info.n_codebook):
            logits, _ = st.step_logits()
            st.step_push_code(int(np.argmax(logits)))
        h = bb.step(lm.compose_audio_embd(st.step_finish()))

    for _ in range(2):
        frame()

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    latency = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed()
    kernels = _kernel_times(prof)
    qk = {"Q4_K": "q4_k_matmul_kernel", "Q8_0": "q8_0_matmul_kernel"}[qtype]
    bb_launches = sum(n for k, _, n in kernels if qk in k)
    print(f"\n== csm frame, {qtype} backbone: latency {latency:.2f} ms, "
          f"profiled {wall:.2f} ms, {sum(n for _, _, n in kernels)} kernel "
          f"launches ({bb_launches} {qk}) [{card}]")
    busy = _report(kernels, top)
    print(f"device busy {busy:.2f} ms, idle share {1 - busy / latency:.3f}, "
          f"packed products {sum(ms for k, ms, _ in kernels if qk in k):.3f} ms")


def _stream_push(top: int, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    import codec_tpu_torch
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="profile_decode_") as tmp:
        path = Path(tmp) / "mimi.gguf"
        write_random_mimi_gguf(path, seed=0)
        models = {dt: codec_tpu_torch.load_model(path, compute_dtype=dt,
                                                 device="cuda")
                  for dt in ("float32", "bfloat16")}
    for dtype, batch, chunk in (("float32", 1, 1), ("float32", 1, 5),
                                ("bfloat16", 1, 1), ("float32", 4, 1)):
        model = models[dtype]
        codes = rng.integers(0, model.codebook_size,
                             (batch, 250, model.n_q)).astype(np.int32)
        session = model.streaming_decoder(batch=batch)
        for i in range(10):
            session.push(codes[:, i * chunk:(i + 1) * chunk])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            session.push(codes[:, 10 * chunk:11 * chunk])
        print(f"\n== mimi stream decode push b{batch} {dtype}, {chunk} "
              f"frame(s): device time by kernel [{card}]")
        _report(_kernel_times(prof), top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_decode")
    ap.add_argument("arch", nargs="?", default="dac",
                    choices=["dac", "mimi", "snac", "wavtokenizer",
                             "soprano", "xy_tokenizer", "qwen3", "pocket",
                             "neucodec", "distill_neucodec", "xcodec2",
                             "moss", "nemo", "bluemagpie", "s3t", "s3g",
                             "csm",
                             "mimi_stream"])
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--qtype", default="Q4_K", choices=["Q4_K", "Q8_0"],
                    help="csm: the backbone's packed type")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--encode", action="store_true",
                    help="profile encode(pcm) instead of decode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import codec_tpu_torch
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.neucodec_init import write_random_neu_gguf
    from codec_tpu_torch.models.xcodec2_init import write_random_x2_gguf
    from codec_tpu_torch.models.pocket_init import write_random_pocket_gguf
    from codec_tpu_torch.models.qwen3_tts_init import write_random_q3t_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf
    from codec_tpu_torch.models.soprano_init import write_random_soprano_gguf
    from codec_tpu_torch.models.wavtokenizer_init import write_random_wt_gguf
    from codec_tpu_torch.models.xy_init import write_random_xy_gguf
    from codec_tpu_torch.models.bluemagpie_init import write_random_bm_gguf
    from codec_tpu_torch.models.moss_init import write_random_moss_gguf
    from codec_tpu_torch.models.nemo_init import write_random_nemo_gguf
    from codec_tpu_torch.models.s3g_init import write_random_s3g_gguf
    from codec_tpu_torch.models.s3t_init import write_random_s3t_gguf

    card = _card()
    print(f"card: {card}")
    if args.arch == "csm":
        _csm_frame(args.qtype, args.top, card)
        return 0
    if args.arch == "mimi_stream":
        _stream_push(args.top, card)
        return 0
    if args.encode and args.arch in ("soprano", "neucodec", "s3g"):
        raise SystemExit(f"profile_decode: {args.arch} has no encoder")
    if not args.encode and args.arch == "s3t":
        raise SystemExit("profile_decode: s3t has no decoder (--encode)")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="profile_decode_") as tmp:
        path = Path(tmp) / f"{args.arch}.gguf"
        write = {"dac": write_random_dac_gguf, "mimi": write_random_mimi_gguf,
                 "snac": write_random_snac_gguf,
                 "wavtokenizer": write_random_wt_gguf,
                 "soprano": write_random_soprano_gguf,
                 "xy_tokenizer": write_random_xy_gguf,
                 "qwen3": write_random_q3t_gguf,
                 "pocket": write_random_pocket_gguf,
                 "neucodec": write_random_neu_gguf,
                 "distill_neucodec": lambda p, seed, encoder=True:
                     write_random_neu_gguf(p, seed, encoder=True),
                 "xcodec2": write_random_x2_gguf,
                 "moss": write_random_moss_gguf,
                 "nemo": write_random_nemo_gguf,
                 "bluemagpie": write_random_bm_gguf,
                 "s3t": lambda p, seed, encoder=True:
                     write_random_s3t_gguf(p, seed),
                 "s3g": write_random_s3g_gguf}[args.arch]
        write(path, seed=0, **({"encoder": True} if args.encode else {}))
        for dtype, batch in (("float32", 1), ("bfloat16", 1), ("float32", 4)):
            if batch > 1 and (args.arch == "s3g" or (
                    args.encode and args.arch == "moss")):
                continue
            model = codec_tpu_torch.load_model(path, compute_dtype=dtype,
                                               device="cuda")
            if args.encode:
                rate = (16000 if args.arch == "distill_neucodec" else
                        model.encode_sample_rate or model.sample_rate)
                shape = ((args.seconds * rate, 2) if args.arch == "moss"
                         else (batch, args.seconds * rate))
                pcm = (rng.standard_normal(shape) * 0.3).astype(np.float32)
                encode = (model.encode_latent
                          if args.arch in ("pocket", "bluemagpie")
                          else model.encode)
                run = lambda: encode(pcm)                 # noqa: E731
            elif args.arch == "soprano":
                frames = args.seconds * model.sample_rate // (
                    model.hop_size * model.cfg.upscale) + 1
                z = rng.standard_normal((batch, frames, model.latent_dim)
                                        ).astype(np.float32)
                run = lambda: model.decode_latent(z)      # noqa: E731
            elif args.arch in ("pocket", "bluemagpie"):
                frames = args.seconds * model.sample_rate // model.hop_size
                z = rng.standard_normal((batch, frames, model.latent_dim)
                                        ).astype(np.float32)
                run = lambda: model.decode_latent(z)      # noqa: E731
            else:
                frames = args.seconds * model.sample_rate // model.hop_size
                if args.arch == "snac":
                    frames -= frames % model.cfg.vq_strides[0]
                codes = rng.integers(0, model.codebook_size,
                                     (batch, frames, model.n_q)
                                     ).astype(np.int32)
                run = lambda: model.decode(codes)         # noqa: E731
            for _ in range(2):
                run()
            latency = _timed(run)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = _timed(run)
            kernels = _kernel_times(prof)
            busy = sum(ms for _, ms, _ in kernels)
            print(f"\n== {args.arch} {'encode' if args.encode else 'decode'} "
                  f"{args.seconds} s b{batch} {dtype}: "
                  f"latency {latency:.2f} ms, profiled {wall:.2f} ms, device "
                  f"busy {busy:.2f} ms, idle share {1 - busy / latency:.3f} "
                  f"[{card}]")
            _report(kernels, args.top)
            del model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
