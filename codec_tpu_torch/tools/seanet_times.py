"""The residual-unit kernels on the card, at every DAC and SNAC width.

    python -m codec_tpu_torch.tools.seanet_times [--json out.json]
        [--what units,chains,tiles,requests,snac,snac_tiles,snac_requests]
        [--runs 10]

Times `seanet_res_unit` at every DAC decoder width (C 768/384/192/96 at
the T of a 20 s b1 decode) and encoder width (C 64/128/256/512), at
dilations 1, 3 and 9, in f32 and bf16: the kernel, its plain version
(cuDNN conv + matmul, TF32 off in f32), the least time the card could
take (operations over the type's peak or bytes over the HBM rate) and
the kernel's share of it. Then `seanet_res_chain` against three unit
launches (d = 1, 3, 9) and the plain chain at the chain's widths (C96
decode, C64 and C128 encode). Those two are the default (--what
units,chains). `tiles`: the unit at d = 1 with each of its compiled tiles
(ops/seanet_cuda.py::_UNIT_TILES) at every DAC width, 20 s b1, 2 s b1
and (decoder widths) 20 s b4, beside the tile that `unit_tile` picks:
the sweep that its choice is held to. `requests`: the DAC 20 s decode
requests (b1 f32, b4 f32, b1 bf16) through load_model on a full-width
random DAC, with the device memory a decode allocates at its peak above
what was allocated before it. Prints one line per row with the card's
name and power limit; --json writes the rows. Times are CUDA events over
three calls back to back, median of 10 samples, best of two turns.
Units, chains and requests use only the wrappers' public functions, so
the same file (with tools/roofline.py) times an older tree's kernels.

SNAC's depthwise units (`snac_res_chain`, one N = 1 launch per unit):
`snac`: the unit at every SNAC decoder width (C 512/256/128/64 at the T
of a 20 s b1 decode) and encoder width (C 48/96/192/384 after the pad to
2048), d = 1, 3 and 9, in f32 and bf16, beside its plain version and its
bound (`res_work(..., depthwise=True)`), then each block's three units as
a decode launches them. `snac_tiles` (this tree only): the unit at d = 1
with each of SNAC's 1x1 tiles (`_SNAC_TILES`) at every SNAC width, 20 s
b1, 2 s b1 and (decoder widths) 20 s b4, beside the tile `snac_tile`
picks (through the private `_launch_snac_unit`). `snac_requests`: the SNAC 20 s decodes (b1
f32, b4 f32, b1 bf16) with their peak device memory, as `requests`.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from codec_tpu_torch.tools.roofline import least_time

# (C, T) of the DAC residual blocks at 20 s b1 (24 kHz, hop 320)
DECODE_BLOCKS = [(768, 12000), (384, 60000), (192, 240000), (96, 480000)]
ENCODE_BLOCKS = [(64, 480000), (128, 240000), (256, 60000), (512, 12000)]
CHAIN_BLOCKS = [(96, 480000), (64, 480000), (128, 240000)]
DILATIONS = (1, 3, 9)
REQUESTS = [("20s_b1_f32", 1, "float32"), ("20s_b4_f32", 4, "float32"),
            ("20s_b1_bf16", 1, "bfloat16")]
# SNAC's (C, T) at 20 s b1: the decoder's blocks (936 frames) and the
# encoder's after its pad to 2048 samples
SNAC_DECODE_BLOCKS = [(512, 7488), (256, 59904), (128, 239616), (64, 479232)]
SNAC_ENCODE_BLOCKS = [(48, 481280), (96, 240640), (192, 60160), (384, 7520)]
WHAT = ("units", "chains", "tiles", "requests", "snac", "snac_tiles",
        "snac_requests")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 10, warmup: int = 2, reps: int = 3) -> float:
    """Median over `runs` CUDA-event samples of fn's time per call, each
    sample `reps` calls back to back (so that the host's work for a call
    overlaps the device's work for the one before, as in a decode)."""
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


def turns(kernel, plain, runs: int = 10):
    """Kernel and plain in turns (plain, kernel, kernel, plain), ms per
    call: the best of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, runs) for f in (plain, kernel, kernel, plain))
    return min(k1, k2), min(p1, p2)


def res_work(n, b, t, c, dtype, k=7, depthwise=False):
    """n residual units' conv FLOP (the snakes' few operations per element
    are left out) and bytes (x read and out written once, the weights read
    once). SNAC's depthwise taps run in f32 in both dtypes."""
    taps = k if depthwise else k * c
    weights = n * (taps * c + c * c) * dtype.itemsize
    flops = [(2 * n * c * c * b * t, dtype),
             (2 * n * taps * c * b * t, torch.float32 if depthwise else dtype)]
    return flops, 2 * b * t * c * dtype.itemsize + weights


def res_params(n, c, dtype, seed, k=7):
    """n residual units' weights: convs at fan-in scale (std 1/sqrt(K*C)),
    biases N(0, 0.1), alphas |N(0, 1)| + 1."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    return dict(w1s=t(rng.standard_normal((n, k, c, c)) / np.sqrt(k * c)),
                b1s=t(rng.standard_normal((n, c)) * 0.1),
                a1s=t(np.abs(rng.standard_normal((n, c))) + 1.0),
                a2s=t(np.abs(rng.standard_normal((n, c))) + 1.0),
                w2s=t(rng.standard_normal((n, c, c)) / np.sqrt(c)),
                b2s=t(rng.standard_normal((n, c)) * 0.1))


def dw_params(n, c, dtype, seed, k=7):
    """n depthwise (SNAC) units' weights at the scales of
    tests/test_seanet_pallas.py's depthwise test: taps N(0, 0.2), biases
    N(0, 0.1), alphas N(1, 0.5) (some negative), the 1x1 at that test's
    gain for any C."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    return dict(w1s=t(rng.standard_normal((n, k, c)) * 0.2),
                b1s=t(rng.standard_normal((n, c)) * 0.1),
                a1s=t(1.0 + 0.5 * rng.standard_normal((n, c))),
                a2s=t(1.0 + 0.5 * rng.standard_normal((n, c))),
                w2s=t(rng.standard_normal((n, c, c)) * 0.1 * np.sqrt(128 / c)),
                b2s=t(rng.standard_normal((n, c)) * 0.1))


def unit_args(p, u=0):
    return (p["a1s"][u], p["w1s"][u], p["b1s"][u], p["a2s"][u], p["w2s"][u],
            p["b2s"][u])


def _x(t, c, dtype, seed, b=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, t, c)).astype(
        np.float32)).to("cuda", dtype)


def unit_rows(runs: int = 10, log=print, tag: str = "",
              dilations=DILATIONS):
    """One row per (block, d in `dilations`, dtype): kernel, plain and
    bound ms."""
    from codec_tpu_torch.ops import seanet_cuda
    from codec_tpu_torch.runtime.model import f32_precision

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for where, blocks in (("decode", DECODE_BLOCKS),
                              ("encode", ENCODE_BLOCKS)):
            for c, t in blocks:
                p = res_params(1, c, dtype, seed=c)
                x = _x(t, c, dtype, seed=c + 1)
                bound, by = least_time(*res_work(1, 1, t, c, dtype))
                for d in dilations:
                    with f32_precision(dtype == torch.float32):
                        kern, plain = turns(
                            lambda: seanet_cuda.seanet_res_unit(
                                x, *unit_args(p), dilation=d),
                            lambda: seanet_cuda.seanet_res_unit_ref(
                                x, *unit_args(p), dilation=d), runs)
                    row = dict(kind="unit", where=where, c=c, t=t, d=d,
                               dtype=str(dtype)[6:], ms=kern, plain_ms=plain,
                               bound_ms=bound, bound_by=by)
                    rows.append(row)
                    log(f"[time]{tag} unit {where} C{c} T{t} d{d} "
                        f"{row['dtype']}: kernel {kern:.4f} ms, plain "
                        f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), "
                        f"{bound / kern:.1%} of bound")
                del x, p
    return rows


def chain_rows(runs: int = 10, log=print, tag: str = ""):
    """One row per (chain width, dtype): the chain, three unit launches
    (d = 1, 3, 9) and the plain chain, ms; and the gate's choice."""
    from codec_tpu_torch.ops import seanet_cuda
    from codec_tpu_torch.runtime.model import f32_precision

    rows = []
    limit = seanet_cuda.smem_per_block(0)
    for dtype in (torch.float32, torch.bfloat16):
        for c, t in CHAIN_BLOCKS:
            p = res_params(3, c, dtype, seed=c + 2)
            x = _x(t, c, dtype, seed=c + 3)

            def units():
                y = x
                for u, d in enumerate(DILATIONS):
                    y = seanet_cuda.seanet_res_unit(y, *unit_args(p, u),
                                                    dilation=d)
                return y

            with f32_precision(dtype == torch.float32):
                chain, plain = turns(
                    lambda: seanet_cuda.seanet_res_chain(x, **p,
                                                         dilations=DILATIONS),
                    lambda: seanet_cuda.seanet_res_chain_ref(
                        x, **p, dilations=DILATIONS), runs)
                three = min(cuda_ms(units, runs), cuda_ms(units, runs))
            bound, by = least_time(*res_work(3, 1, t, c, dtype))
            gate = seanet_cuda.use_chain(c, 7, DILATIONS, dtype, limit)
            row = dict(kind="chain", c=c, t=t, dtype=str(dtype)[6:],
                       ms=chain, units_ms=three, plain_ms=plain,
                       bound_ms=bound, bound_by=by, gate_takes_chain=gate)
            rows.append(row)
            log(f"[time]{tag} chain C{c} T{t} {row['dtype']}: chain "
                f"{chain:.4f} ms, three unit launches {three:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms ({by}); gate takes "
                f"{'the chain' if gate else 'three units'}, the faster is "
                f"{'the chain' if chain < three else 'three units'}")
            del x, p
    return rows


def tile_rows(runs: int = 10, log=print, tag: str = ""):
    """One row per (dtype, block, batch, T, tile): the unit at d = 1 with
    that tile, ms; `picked` marks unit_tile's choice, `best` the fastest
    tile of the case. Calls the wrapper's private _launch_unit, which
    takes a tile."""
    from codec_tpu_torch.ops import seanet_cuda

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(c, t, 1) for c, t in DECODE_BLOCKS + ENCODE_BLOCKS]
        cases += [(c, t // 10, 1) for c, t in DECODE_BLOCKS + ENCODE_BLOCKS]
        cases += [(c, t, 4) for c, t in DECODE_BLOCKS]
        for c, t, b in cases:
            p = res_params(1, c, dtype, seed=c)
            x = _x(t, c, dtype, seed=c + 1, b=b)
            a1, w1, b1, a2, w2, b2 = unit_args(p)
            vec = seanet_cuda.unit_vec(a1[None], b1[None], a2[None],
                                       b2[None])
            pick = seanet_cuda.unit_tile(c, dtype, t, b, sms)
            case = []
            for tile in seanet_cuda._UNIT_TILES[dtype]:
                ms = min(cuda_ms(lambda: seanet_cuda._launch_unit(
                    x, w1, w2, vec, 1, tile), runs) for _ in range(2))
                case.append(dict(kind="tile", dtype=str(dtype)[6:], c=c, t=t,
                                 b=b, tile=list(tile), ms=ms,
                                 picked=tile == pick))
            best = min(case, key=lambda r: r["ms"])
            for row in case:
                row["best"] = row is best
                rows_, cols = row["tile"]
                log(f"[time]{tag} tile {row['dtype']} C{c} T{t} B{b} "
                    f"{rows_}x{cols}: {row['ms']:.4f} ms"
                    f"{' (unit_tile)' if row['picked'] else ''}"
                    f"{' (fastest)' if row['best'] else ''}")
            picked = next(r for r in case if r["picked"])
            log(f"[time]{tag} tile {str(dtype)[6:]} C{c} T{t} B{b}: "
                f"unit_tile's {picked['tile']} is "
                f"{picked['ms'] / best['ms'] - 1:.1%} above the fastest "
                f"{best['tile']}")
            rows += case
            del x, p
    return rows


def snac_rows(runs: int = 10, log=print, tag: str = ""):
    """SNAC's depthwise units: one row per (block, d, dtype), the unit
    (one N = 1 launch of snac_res_chain) against its plain version and its
    bound; then one row per (block, dtype) for the block's three units as a
    decode launches them (snac_res_units)."""
    from codec_tpu_torch.ops import seanet_cuda
    from codec_tpu_torch.runtime.model import f32_precision

    rows = []
    # a wrapper that takes the units' rows precomputed gets them, as a
    # decode passes them (an older tree's builds them on every call)
    takes_vec = "vec" in inspect.signature(
        seanet_cuda.snac_res_chain).parameters
    for dtype in (torch.float32, torch.bfloat16):
        for where, blocks in (("decode", SNAC_DECODE_BLOCKS),
                              ("encode", SNAC_ENCODE_BLOCKS)):
            for c, t in blocks:
                p = dw_params(3, c, dtype, seed=c)
                x = _x(t, c, dtype, seed=c + 1) * 0.3
                name = str(dtype)[6:]
                vec = (dict(vec=seanet_cuda.unit_vec(
                    p["a1s"], p["b1s"], p["a2s"], p["b2s"])) if takes_vec
                       else {})
                for u, d in enumerate(DILATIONS):
                    pu = {k: v[u:u + 1] for k, v in {**p, **vec}.items()}
                    bound, by = least_time(*res_work(1, 1, t, c, dtype,
                                                     depthwise=True))
                    with f32_precision(dtype == torch.float32):
                        kern, plain = turns(
                            lambda: seanet_cuda.snac_res_chain(
                                x, **pu, dilations=(d,)),
                            lambda: seanet_cuda.snac_res_chain_ref(
                                x, **{k: v for k, v in pu.items()
                                      if k != "vec"}, dilations=(d,)), runs)
                    rows.append(dict(kind="snac_unit", where=where, c=c, t=t,
                                     d=d, dtype=name, ms=kern, plain_ms=plain,
                                     bound_ms=bound, bound_by=by))
                    log(f"[time]{tag} snac unit {where} C{c} T{t} d{d} "
                        f"{name}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
                        f"bound {bound:.4f} ms ({by}), {bound / kern:.1%} of "
                        f"bound")
                bound, by = least_time(*res_work(3, 1, t, c, dtype,
                                                 depthwise=True))
                with f32_precision(dtype == torch.float32):
                    kern, plain = turns(
                        lambda: seanet_cuda.snac_res_units(x, **p, **vec),
                        lambda: seanet_cuda.snac_res_chain_ref(x, **p), runs)
                rows.append(dict(kind="snac_block", where=where, c=c, t=t,
                                 dtype=name, ms=kern, plain_ms=plain,
                                 bound_ms=bound, bound_by=by))
                log(f"[time]{tag} snac block {where} C{c} T{t} {name}: three "
                    f"units {kern:.4f} ms, plain {plain:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}), {bound / kern:.1%} of bound")
                del x, p
    return rows


def snac_tile_rows(runs: int = 10, log=print, tag: str = ""):
    """One row per (dtype, SNAC block, batch, T, tile): the unit at d = 1
    with that 1x1 tile, ms; `picked` marks snac_tile's choice, `best` the
    fastest tile of the case. Calls the wrapper's private
    _launch_snac_unit, which takes a tile."""
    from codec_tpu_torch.ops import seanet_cuda

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = SNAC_DECODE_BLOCKS + SNAC_ENCODE_BLOCKS
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(c, t, 1) for c, t in blocks]
        cases += [(c, t // 10, 1) for c, t in blocks]
        cases += [(c, t, 4) for c, t in SNAC_DECODE_BLOCKS]
        for c, t, b in cases:
            p = dw_params(1, c, dtype, seed=c)
            x = _x(t, c, dtype, seed=c + 1, b=b) * 0.3
            vec = seanet_cuda.unit_vec(p["a1s"], p["b1s"], p["a2s"], p["b2s"])
            w1, w2 = p["w1s"][0], p["w2s"][0]
            pick = seanet_cuda.snac_tile(c, dtype, t, b, sms)
            case = []
            for tile in seanet_cuda._SNAC_TILES[dtype]:
                ms = min(cuda_ms(lambda: seanet_cuda._launch_snac_unit(
                    x, w1, w2, vec, 1, tile), runs) for _ in range(2))
                case.append(dict(kind="snac_tile", dtype=str(dtype)[6:], c=c,
                                 t=t, b=b, tile=list(tile), ms=ms,
                                 picked=tile == pick))
            best = min(case, key=lambda r: r["ms"])
            for row in case:
                row["best"] = row is best
                rows_, cols = row["tile"]
                log(f"[time]{tag} snac tile {row['dtype']} C{c} T{t} B{b} "
                    f"{rows_}x{cols}: {row['ms']:.4f} ms"
                    f"{' (snac_tile)' if row['picked'] else ''}"
                    f"{' (fastest)' if row['best'] else ''}")
            picked = next(r for r in case if r["picked"])
            log(f"[time]{tag} snac tile {str(dtype)[6:]} C{c} T{t} B{b}: "
                f"snac_tile's {picked['tile']} is "
                f"{picked['ms'] / best['ms'] - 1:.1%} above the fastest "
                f"{best['tile']}")
            rows += case
            del x, p
    return rows


def _request_rows(arch: str, runs: int, log, tag: str):
    """An arch's 20 s decode requests through load_model on a full-width
    random model (seed 0): ms per request, host codes to host PCM, and the
    device memory one decode allocates at its peak beyond what was
    allocated before it (torch.cuda.max_memory_allocated)."""
    import codec_tpu_torch
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf

    rows = []
    rng = np.random.default_rng(0)
    write = {"dac": write_random_dac_gguf, "snac": write_random_snac_gguf}
    with tempfile.TemporaryDirectory(prefix="seanet_times_") as tmp:
        path = Path(tmp) / f"{arch}.gguf"
        write[arch](path, seed=0)
        models = {dt: codec_tpu_torch.load_model(path, compute_dtype=dt,
                                                 device="cuda")
                  for dt in ("float32", "bfloat16")}
    for name, batch, dt in REQUESTS:
        model = models[dt]
        frames = 20 * model.sample_rate // model.hop_size
        if arch == "snac":              # a multiple of the coarsest stride
            frames -= frames % model.cfg.vq_strides[0]
        codes = rng.integers(0, model.codebook_size,
                             (batch, frames, model.n_q)).astype(np.int32)
        ms = cuda_ms(lambda: model.decode(codes), runs, reps=1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.decode(codes)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        rows.append(dict(kind="request", arch=arch, name=name, ms=ms,
                         peak_bytes=peak))
        log(f"[time]{tag} {arch} decode {name}: {ms:.3f} ms per request, "
            f"peak device memory {peak / 2 ** 20:.1f} MiB above the "
            f"{before / 2 ** 20:.1f} MiB allocated before it")
    return rows


def request_rows(runs: int = 10, log=print, tag: str = ""):
    """The DAC 20 s decode requests (see _request_rows)."""
    return _request_rows("dac", runs, log, tag)


def snac_request_rows(runs: int = 10, log=print, tag: str = ""):
    """The SNAC 20 s decode requests (see _request_rows)."""
    return _request_rows("snac", runs, log, tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="seanet_times")
    ap.add_argument("--json", help="write the rows to this file")
    ap.add_argument("--what", default="units,chains",
                    help=f"comma-separated, of {','.join(WHAT)}")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--tag", default="", help="a label for every line")
    args = ap.parse_args(argv)
    what = args.what.split(",")
    if not set(what) <= set(WHAT):
        ap.error(f"--what: want some of {','.join(WHAT)}, got {args.what}")
    if not torch.cuda.is_available():
        raise SystemExit("seanet_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f" {args.tag}" if args.tag else ""
    name_limit = card()
    print(f"card: {name_limit}", flush=True)
    t0 = time.monotonic()
    log = lambda line: print(f"{line} [{name_limit}]", flush=True)
    run = dict(units=unit_rows, chains=chain_rows, tiles=tile_rows,
               requests=request_rows, snac=snac_rows,
               snac_tiles=snac_tile_rows, snac_requests=snac_request_rows)
    rows = [r for name in what for r in run[name](args.runs, log, tag)]
    print(f"seanet_times ran {time.monotonic() - t0:.1f} s", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": name_limit, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
