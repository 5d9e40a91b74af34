"""The Mimi path's two split-f32 kernels and its requests on the card.

    python -m codec_tpu_torch.tools.mimi_times [--json out.json]
        [--what attn,rvq,requests,attn_tiles,moss_attn] [--runs 10]
        [--tag LABEL]
        [--gguf mimi.gguf]

`attn`: `flash_sdpa_window` at chip_smoke.py's timed shapes (B1 H8 T500,
T1500 and B4 T500, D 64, window 250, f32; T500 in bf16): CUDA-event time
of back-to-back calls (the wrapper's host cost included), device time
(torch.profiler), the plain version and F.scaled_dot_product_attention
with the band mask. `rvq`: `rvq_encode_fused` at Mimi's shapes (N 250
n_q 31 and n_q 1, N 1000 n_q 31; D 256, V 2048), with the norms given
where the wrapper takes them (as a model passes them from load) and
without. `requests`: Mimi 20 s encodes (b1 and b4 f32) and decodes (20 s
b4 and 60 s b1 f32, 20 s b1 f32 and bf16) through load_model on a
full-width random Mimi with its encoder (seed 0). `moss_attn`: the
kernel at MOSS-Audio-Tokenizer's four stages (20 s of 48 kHz stereo, D 64:
H12 T250 w125, H12 T2500 w12, H6 T15000 w75, H3 T120000 w600) in f32 and
bf16, CUDA-event time and device time only. `attn_tiles` (this tree
only): a copy of csrc/flash_sdpa_window.cu under build/, its Cfg's
query m-tiles per block at D 64 and warps per block set to each pair of
ATTN_TILES, built by nvcc and timed by
launches through ctypes (no wrapper: 50 back to back per CUDA-event
sample) at the `attn` shapes and B4 bf16, each checked against the plain
version: the sweep the kernel's choice (csrc/flash_sdpa_window.cu, Cfg:
2 m-tiles in f32, 1 in bf16, 4 warps) is held to. Every row carries the
card's name and power limit; --json writes the rows. Times are medians of
`--runs` samples. Only the wrappers' public functions are used, so the
same file (with tools/roofline.py) times an older tree: copy both into a
`git archive` of the parent and run the two trees in turns (parent,
change, change, parent). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from codec_tpu_torch.tools.roofline import least_time

ATTN_SHAPES = [((1, 8, 500, 64, 250), torch.float32),
               ((1, 8, 1500, 64, 250), torch.float32),
               ((4, 8, 500, 64, 250), torch.float32),
               ((1, 8, 500, 64, 250), torch.bfloat16)]
RVQ_SHAPES = [(250, 31), (250, 1), (1000, 31)]     # (N, n_q); D 256, V 2048
# (name, seconds, batch, compute dtype)
ENCODES = [("encode 20s_b1_f32", 20, 1, "float32"),
           ("encode 20s_b4_f32", 20, 4, "float32")]
DECODES = [("decode 20s_b1_f32", 20, 1, "float32"),
           ("decode 20s_b4_f32", 20, 4, "float32"),
           ("decode 60s_b1_f32", 60, 1, "float32"),
           ("decode 20s_b1_bf16", 20, 1, "bfloat16")]
MOSS_ATTN_SHAPES = [(1, 12, 250, 64, 125), (1, 12, 2500, 64, 12),
                    (1, 6, 15000, 64, 75), (1, 3, 120000, 64, 600)]
WHAT = ("attn", "rvq", "requests", "attn_tiles", "moss_attn")
# (query m-tiles per block at D 64, warps per block): the kernel's pick first
ATTN_TILES = [(2, 4), (1, 4), (2, 8), (1, 8)]
# the two lines of csrc/flash_sdpa_window.cu's Cfg a sweep copy rewrites,
# and what they become (both dtypes take the same m-tiles at D 64)
_CFG_LINES = (("static constexpr int MT = D != 64 ? 1 : Elem<T>::kF32 ? 2 : 1;",
               "static constexpr int MT = D != 64 ? 1 : {mt};"),
              ("static constexpr int W = 4;", "static constexpr int W = {warps};"))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 10, warmup: int = 2, reps: int = 1) -> float:
    """Median over `runs` CUDA-event samples of fn's time per call, each
    sample `reps` calls back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def device_ms(fn, calls: int = 20):
    """The kernels' self time per call under torch.profiler (aten ops left
    out); None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0 and not e.key.startswith("aten::"))
    return total / 1e3 / calls if total > 0 else None


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def attn_rows(runs: int = 10, log=print, tag: str = ""):
    from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                               flash_sdpa_window_ref)

    rows = []
    for (b, h, t, d, w), dtype in ATTN_SHAPES:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
            np.float32)).to("cuda", dtype) for _ in range(3))
        i = torch.arange(t, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)

        def kernel():
            return flash_sdpa_window(q, k, v, window=w)

        ms = cuda_ms(kernel, runs, reps=20)
        dev = device_ms(kernel)
        plain = cuda_ms(lambda: flash_sdpa_window_ref(q, k, v, window=w), runs,
                        reps=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                             attn_mask=band),
                      runs, reps=20)
        pairs = sum(min(j + 1, w) for j in range(t)) * b * h
        flop, nbytes = 4 * d * pairs, 4 * b * h * t * d * dtype.itemsize
        # the units the kernel uses: f32, three TF32 passes per product;
        # bf16, one pass for QK^T and two for PV
        passes = [(3 * flop, "tf32")] if dtype == torch.float32 else [
            (3 * flop // 2, dtype)]
        bound = least_time(passes, nbytes)[0]
        bound_fma = least_time([(flop, dtype)], nbytes)[0]
        row = dict(kind="attn", shape=[b, h, t, d, w], dtype=str(dtype)[6:],
                   ms=ms, device_ms=dev, plain_ms=plain, sdpa_ms=lib,
                   bound_ms=bound, bound_one_pass_ms=bound_fma)
        rows.append(row)
        log(f"[time]{tag} flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
            f"{row['dtype']}: {ms:.4f} ms (events, back to back), device "
            f"{_fmt(dev)}, plain {plain:.4f} ms, SDPA with the band mask "
            f"{lib:.4f} ms, bound {bound:.4f} ms (the kernel's passes), "
            f"{bound_fma:.4f} ms (one pass at the type's rate)")
    return rows


def moss_attn_rows(runs: int = 10, log=print, tag: str = ""):
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window

    rows = []
    for (b, h, t, d, w) in MOSS_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(0)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, h, t, d)).astype(np.float32)).to("cuda", dtype)
                for _ in range(3))

            def kernel():
                return flash_sdpa_window(q, k, v, window=w)

            ms = cuda_ms(kernel, runs, reps=20 if t <= 2500 else 1)
            dev = device_ms(kernel, calls=20 if t <= 15000 else 5)
            row = dict(kind="moss_attn", shape=[b, h, t, d, w],
                       dtype=str(dtype)[6:], ms=ms, device_ms=dev)
            rows.append(row)
            log(f"[time]{tag} flash_sdpa_window MOSS B{b} H{h} T{t} D{d} "
                f"w{w} {row['dtype']}: {ms:.4f} ms (events), device "
                f"{_fmt(dev)}")
    return rows


def attn_tile_rows(runs: int = 10, log=print, tag: str = ""):
    import ctypes

    from codec_tpu_torch.kernels.build import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS,
                                               find_nvcc)
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref

    out = BUILD_DIR.parent / "attn_tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC_DIR / "flash_sdpa_window.cu").read_text()
    procs = {}
    for mt, warps in ATTN_TILES:
        copy = src
        for line, patched in _CFG_LINES:
            if copy.count(line) != 1:
                raise RuntimeError(f"attn_tiles: Cfg no longer holds {line!r}")
            copy = copy.replace(line, patched.format(mt=mt, warps=warps))
        path = out / f"attn_{mt}_{warps}.cu"
        path.write_text(copy)
        procs[mt, warps] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "--shared", "-o",
             str(out / f"attn_{mt}_{warps}.so"), str(path)],
            stderr=subprocess.PIPE, text=True)
    fns = {}
    for tile, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tile}:\n{err}")
        fn = ctypes.CDLL(str(out / f"attn_{tile[0]}_{tile[1]}.so")).codec_flash_sdpa_window
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fns[tile] = fn
    rows = []
    shapes = ATTN_SHAPES + [((4, 8, 500, 64, 250), torch.bfloat16)]
    for (b, h, t, d, w), dtype in shapes:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
            np.float32)).to("cuda", dtype) for _ in range(3))
        want = flash_sdpa_window_ref(q, k, v, window=w).float()
        o = torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t,
                t, 0, d, w or 0, d ** -0.5, 0 if dtype == torch.float32 else 1,
                stream)
        for tile, fn in fns.items():
            def launch():
                if fn(*args) != 0:
                    raise RuntimeError(f"launch failed for {tile}")
            launch()
            torch.cuda.synchronize()
            err = (o.float() - want).abs().max().item()
            ms = cuda_ms(launch, runs, warmup=5, reps=50)
            rows.append(dict(kind="attn_tile", shape=[b, h, t, d, w],
                             dtype=str(dtype)[6:], mt=tile[0], warps=tile[1],
                             ms=ms, max_abs_err=err))
            log(f"[time]{tag} flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]} with {tile[0]} m-tile(s) a block at D 64, "
                f"{tile[1]} warps: {ms:.4f} ms (launches back to back), max "
                f"abs err to the plain version {err:.2e}")
    return rows


def rvq_rows(runs: int = 10, log=print, tag: str = ""):
    from codec_tpu_torch.ops.rvq import codebook_norms
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    takes_norms = "norms" in inspect.signature(rvq_encode_fused).parameters
    rows = []
    d, v = 256, 2048
    for n, n_q in RVQ_SHAPES:
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((1, n, d)).astype(
            np.float32)).cuda()
        cb = torch.from_numpy((rng.standard_normal((n_q, v, d)) * 0.5).astype(
            np.float32)).cuda()
        nrm = codebook_norms(cb)
        calls = {"no norms": lambda: rvq_encode_fused(x, cb)}
        if takes_norms:
            calls["norms given"] = lambda: rvq_encode_fused(x, cb, norms=nrm)
        flop = 2 * n * v * d * n_q
        nbytes = 4 * (n * d + n_q * v * d + n_q * v + n * n_q)
        # three TF32 passes per f32 product; the f32 FMA bound beside it
        bound = least_time([(3 * flop, "tf32")], nbytes)[0]
        bound_fma = least_time([(flop, torch.float32)], nbytes)[0]
        for form, fn in calls.items():
            ms = cuda_ms(fn, runs, reps=5)
            dev = device_ms(fn, calls=5)
            rows.append(dict(kind="rvq", n=n, n_q=n_q, form=form, ms=ms,
                             device_ms=dev, bound_ms=bound,
                             bound_fma_ms=bound_fma))
            log(f"[time]{tag} rvq_encode_fused N{n} n_q{n_q} D{d} V{v} ({form}): "
                f"{ms:.4f} ms (events, back to back), device {_fmt(dev)}, "
                f"bound {bound:.4f} ms (three TF32 passes), {bound_fma:.4f} "
                f"ms (f32 FMA)")
    return rows


def request_rows(runs: int = 10, log=print, tag: str = "", gguf=None):
    import codec_tpu_torch
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf

    rows = []
    with tempfile.TemporaryDirectory(prefix="mimi_times_") as tmp:
        path = Path(gguf) if gguf else Path(tmp) / "mimi.gguf"
        if not path.exists():
            write_random_mimi_gguf(path, seed=0, encoder=True)
        models = {dt: codec_tpu_torch.load_model(path, compute_dtype=dt,
                                                 device="cuda")
                  for dt in ("float32", "bfloat16")}
    rng = np.random.default_rng(2)
    for name, secs, batch, dt in ENCODES + DECODES:
        model = models[dt]
        if name.startswith("encode"):
            pcm = (rng.standard_normal((batch, secs * model.sample_rate))
                   * 0.3).astype(np.float32)
            fn = lambda: model.encode(pcm)   # noqa: E731
        else:
            frames = secs * model.sample_rate // model.hop_size
            codes = rng.integers(0, model.codebook_size,
                                 (batch, frames, model.n_q)).astype(np.int32)
            fn = lambda: model.decode(codes)   # noqa: E731
        ms = cuda_ms(fn, runs)
        rows.append(dict(kind="request", name=name, ms=ms))
        log(f"[time]{tag} mimi {name}: {ms:.3f} ms per request")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mimi_times")
    ap.add_argument("--json", help="write the rows to this file")
    ap.add_argument("--what", default="attn,rvq,requests",
                    help=f"comma-separated of {', '.join(WHAT)}")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--tag", default="", help="a label for every line")
    ap.add_argument("--gguf", help="the random Mimi file to reuse (written "
                    "there when missing)")
    args = ap.parse_args(argv)
    what = args.what.split(",")
    for w in what:
        if w not in WHAT:
            raise SystemExit(f"mimi_times: unknown --what {w!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    tag = f" {args.tag}" if args.tag else ""

    def log(msg):
        print(f"{msg} [{name}]", flush=True)

    rows = []
    if "attn" in what:
        rows += attn_rows(args.runs, log, tag)
    if "rvq" in what:
        rows += rvq_rows(args.runs, log, tag)
    if "requests" in what:
        rows += request_rows(args.runs, log, tag, args.gguf)
    if "attn_tiles" in what:
        rows += attn_tile_rows(args.runs, log, tag)
    if "moss_attn" in what:
        rows += moss_attn_rows(args.runs, log, tag)
    if args.json:
        Path(args.json).write_text(json.dumps({"card": name, "rows": rows},
                                              indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
