#!/usr/bin/env python3
"""Smoke run of codec_tpu_torch on one NVIDIA GPU (H100): the quickest proof
that the port builds, is right, and decodes on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from codec_tpu_torch/csrc (nvcc)
  3. each kernel against its plain PyTorch version on the card
  4. write a full-width random Mimi GGUF and load it with load_model
  5. decode requests through the model (20 s b1, 60 s b1, 20 s b4 in f32,
     20 s b1 in bf16), counting kernel launches; the f32 outputs are held
     against the same weights with the plain attention on the card
  6. CUDA-event times (median of >= 10 runs after warm-up)
Then one JSON line of kernel results, the card line again, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# (B, H, T, D, window): the Mimi decoder transformer at 20 s b1, 60 s b1
# and 20 s b4, pure causal, and D=128 with a small window
KERNEL_SHAPES_F32 = [(1, 8, 500, 64, 250), (1, 8, 1500, 64, 250),
                     (4, 8, 500, 64, 250), (1, 2, 300, 64, None),
                     (1, 2, 256, 128, 16)]
KERNEL_SHAPE_BF16 = (1, 8, 500, 64, 250)
# bounds of tests/test_attn_pallas.py: f32 atol 2e-5 rtol 1e-5; bf16 atol 3e-2
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_ATOL = 3e-2
# (name, seconds of audio, batch, compute dtype)
REQUESTS = [("20s_b1_f32", 20, 1, "float32"), ("60s_b1_f32", 60, 1, "float32"),
            ("20s_b4_f32", 20, 4, "float32"), ("20s_b1_bf16", 20, 1, "bfloat16")]
LAYERS = 8                  # kernel launches per decode: one per layer
TIMED_RUNS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    """Median over `runs` CUDA-event samples of one call of fn (each sample
    averages `reps` back-to-back calls), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def randn(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", dtype)


def main() -> int:
    # -- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this runs on an NVIDIA GPU")
    name_limit = card()
    log(f"card: {name_limit}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import codec_tpu_torch
    from codec_tpu_torch.kernels import build
    from codec_tpu_torch.models.mimi import mimi_decode_fn
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                               flash_sdpa_window_ref)
    from codec_tpu_torch.runtime.model import f32_precision

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    res = build.build()
    log(f"[build] {res.path.name}: nvcc {res.seconds:.2f} s "
        f"(phase {time.monotonic() - t0:.2f} s)")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 3. kernel against its plain version ---------------------------------
    max_err = 0.0
    cases = [(s, torch.float32) for s in KERNEL_SHAPES_F32]
    cases.append((KERNEL_SHAPE_BF16, torch.bfloat16))
    for i, ((b, h, t, d, w), dtype) in enumerate(cases):
        q, k, v = (randn((b, h, t, d), dtype, SEED + 3 * i + j) for j in range(3))
        got = flash_sdpa_window(q, k, v, window=w)
        want = flash_sdpa_window_ref(q, k, v, window=w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **F32_TOL)
            max_err = max(max_err, err)
            bound = "atol 2e-5 rtol 1e-5"
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=BF16_ATOL, rtol=0)
            bound = f"atol {BF16_ATOL}"
        log(f"[kernel] flash_sdpa_window B{b} H{h} T{t} D{d} window={w} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} ({bound}) ok")

    # -- 4. a full-width Mimi GGUF through load_model -------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        path = Path(tmp.name) / "mimi_random.gguf"
        t0 = time.monotonic()
        write_random_mimi_gguf(path, seed=SEED)
        log(f"[model] wrote {path.name} ({path.stat().st_size / 2**20:.1f} MiB) "
            f"in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        models = {dt: codec_tpu_torch.load_model(path, compute_dtype=dt,
                                                 device="cuda")
                  for dt in ("float32", "bfloat16")}
        torch.cuda.synchronize()
        m32 = models["float32"]
        cfg = m32.cfg
        log(f"[model] load_model f32 + bf16 in {time.monotonic() - t0:.2f} s: "
            f"hidden {cfg.hidden}, {cfg.n_layers} layers, {cfg.n_heads} heads "
            f"x {cfg.head_dim}, mlp {cfg.intermediate}, {cfg.n_q} codebooks x "
            f"{cfg.codebook_size} x {cfg.codebook_dim}, window {cfg.window}")
    finally:
        tmp.cleanup()

    rng = np.random.default_rng(SEED)
    reqs = []
    for name, secs, batch, dt in REQUESTS:
        frames = secs * cfg.sample_rate // cfg.hop_size
        codes = rng.integers(0, cfg.codebook_size,
                             (batch, frames, cfg.n_q)).astype(np.int32)
        reqs.append((name, secs, batch, models[dt], codes))

    # -- 5. the main path: decode requests through the model -----------------
    outs = {}
    flash_sdpa_window.launches = 0
    for name, secs, batch, model, codes in reqs:
        before = flash_sdpa_window.launches
        outs[name] = model.decode(codes)
        step = flash_sdpa_window.launches - before
        if step != LAYERS:
            raise RuntimeError(f"{name}: {step} kernel launches, want {LAYERS}")
    main_path_launches = flash_sdpa_window.launches
    if main_path_launches != LAYERS * len(reqs):
        raise RuntimeError(f"main path launched the kernel "
                           f"{main_path_launches} times")
    log(f"[decode] main path: {main_path_launches} flash_sdpa_window "
        f"launches over {len(reqs)} decodes ({LAYERS} per decode)")

    def plain_decode(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = mimi_decode_fn(model.params, c, model.cfg,
                                 attention=flash_sdpa_window_ref)
        return pcm.float().cpu().numpy()

    for name, secs, batch, model, codes in reqs:
        pcm = outs[name]
        want_shape = (batch, codes.shape[1] * cfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"{name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"{name}: non-finite samples")
        line = f"[decode] {name}: pcm {pcm.shape} finite, peak {np.abs(pcm).max():.4f}"
        if model.compute_dtype == torch.float32:
            ref = plain_decode(model, codes)
            corr = np.corrcoef(pcm.ravel(), ref.ravel())[0, 1]
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not corr > 0.99999:
                raise RuntimeError(f"{name}: corr {corr} vs plain attention")
            line += (f"; vs plain attention on the card: corr {corr:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            f32 = m32.decode(codes)
            line += (f"; vs the f32 model: corr "
                     f"{np.corrcoef(pcm.ravel(), f32.ravel())[0, 1]:.6f}")
        log(line)

    # -- 6. times --------------------------------------------------------------
    log(f"[time] card: {name_limit}; CUDA events, median of {TIMED_RUNS} runs")
    kernel_ms = plain_ms = None
    for (b, h, t, d, w), dtype in [(s, torch.float32) for s in KERNEL_SHAPES_F32[:3]] + \
            [(KERNEL_SHAPE_BF16, torch.bfloat16)]:
        q, k, v = (randn((b, h, t, d), dtype, SEED + j) for j in range(3))
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: flash_sdpa_window_ref(q, k, v, window=w), reps=20)
        k1 = cuda_ms(lambda: flash_sdpa_window(q, k, v, window=w), reps=20)
        k2 = cuda_ms(lambda: flash_sdpa_window(q, k, v, window=w), reps=20)
        p2 = cuda_ms(lambda: flash_sdpa_window_ref(q, k, v, window=w), reps=20)
        kern, plain = min(k1, k2), min(p1, p2)
        if (b, h, t, d, w) == KERNEL_SHAPES_F32[0] and dtype == torch.float32:
            kernel_ms, plain_ms = kern, plain
        log(f"[time] flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
            f"{str(dtype)[6:]}: kernel {kern:.4f} ms ({k1:.4f}, {k2:.4f}), "
            f"plain {plain:.4f} ms ({p1:.4f}, {p2:.4f}) [{name_limit}]")

    for name, secs, batch, model, codes in reqs:
        ms = cuda_ms(lambda: model.decode(codes))
        xrt = secs * batch / (ms / 1000.0)
        line = (f"[time] decode {name}: {ms:.3f} ms per request, "
                f"{xrt:.1f}x realtime ({secs * batch} s of audio)")
        if model.compute_dtype == torch.float32:
            c = torch.from_numpy(codes.astype(np.int64)).cuda()

            def dev(attention=None):
                with torch.inference_mode(), f32_precision(True):
                    mimi_decode_fn(model.params, c, model.cfg,
                                   attention=attention)
            d_kern = cuda_ms(dev)
            d_plain = cuda_ms(lambda: dev(flash_sdpa_window_ref))
            line += (f"; mimi_decode_fn alone (codes already on the card, "
                     f"no copy back) {d_kern:.3f} ms with the kernel, "
                     f"{d_plain:.3f} ms with plain attention")
        log(line + f" [{name_limit}]")

    result = {"kernels": [{
        "name": "flash_sdpa_window", "route": "cuda",
        "source": "codec_tpu_torch/csrc/flash_sdpa_window.cu",
        "replaces": "codec_tpu/ops/attn_pallas.py:82",
        "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}
    print(json.dumps(result), flush=True)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
