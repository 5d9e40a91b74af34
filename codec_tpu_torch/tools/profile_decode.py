"""Where a decode's device time goes: one warm request under torch.profiler.

    python -m codec_tpu_torch.tools.profile_decode [dac|mimi|snac] \
        [--seconds 20]

Writes a full-width random model (seed 0) to a temporary directory, runs
two warm-up decodes per request (b1 f32, b1 bf16, b4 f32), then one
unprofiled and one profiled decode (SNAC: the frame count rounded down
to a multiple of 4). Prints the card's name and power limit, the
latency, the device busy time (the kernels' self time, aten ops
excluded), the idle share against the unprofiled latency, and the
kernels with the most device time. Needs a CUDA device.
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


def _timed_decode(model, codes) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decode(codes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_decode")
    ap.add_argument("arch", nargs="?", default="dac",
                    choices=["dac", "mimi", "snac"])
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import codec_tpu_torch
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf

    card = _card()
    print(f"card: {card}")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="profile_decode_") as tmp:
        path = Path(tmp) / f"{args.arch}.gguf"
        {"dac": write_random_dac_gguf, "mimi": write_random_mimi_gguf,
         "snac": write_random_snac_gguf}[args.arch](path, seed=0)
        for dtype, batch in (("float32", 1), ("bfloat16", 1), ("float32", 4)):
            model = codec_tpu_torch.load_model(path, compute_dtype=dtype,
                                               device="cuda")
            frames = args.seconds * model.sample_rate // model.hop_size
            if args.arch == "snac":
                frames -= frames % model.cfg.vq_strides[0]
            codes = rng.integers(0, model.codebook_size,
                                 (batch, frames, model.n_q)).astype(np.int32)
            for _ in range(2):
                model.decode(codes)
            latency = _timed_decode(model, codes)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = _timed_decode(model, codes)
            kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0
                       and not e.key.startswith("aten::")]
            busy = sum(ms for _, ms, _ in kernels)
            print(f"\n== {args.arch} {args.seconds} s b{batch} {dtype}: "
                  f"latency {latency:.2f} ms, profiled {wall:.2f} ms, device "
                  f"busy {busy:.2f} ms, idle share {1 - busy / latency:.3f} "
                  f"[{card}]")
            for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:args.top]:
                print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} "
                      f"{key[:110]}")
            del model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
