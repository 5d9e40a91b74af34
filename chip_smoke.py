#!/usr/bin/env python3
"""Smoke run of codec_tpu_torch on one NVIDIA GPU (H100): the quickest proof
that the port builds, is right, and decodes on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from codec_tpu_torch/csrc (nvcc, one process
     per source); the packed products' ptxas stack frames and spills and
     their SASS I2F counts (cuobjdump), all of which must be 0
  3. each kernel against its plain PyTorch version on the card (the
     residual units also at the encoders' widths, the RVQ search also on
     integer-valued inputs and duplicated rows, where it must agree bit
     for bit)
  4. Mimi: write a full-width random Mimi GGUF, load it with load_model,
     and decode requests through it (20 s b1, 60 s b1, 20 s b4 in f32,
     20 s b1 in bf16) with every launch count set to 0 just before and
     read just after; the f32 outputs are held against the same weights
     with the plain attention on the card
  5. DAC: the same for a full-width random DAC (descript/dac_24khz widths):
     20 s b1 and 20 s b4 in f32, 20 s b1 in bf16, and one decode_latent;
     the f32 outputs are held against the same weights with the plain
     residual units on the card
  6. SNAC: the same for a full-width random SNAC (hubertsiuzdak/snac_24khz
     widths, Orpheus packing): 20 s b1 and 20 s b4 in f32, 20 s b1 in
     bf16, each checked for its launch count, shape, finite samples and
     (f32) saturation and held against the plain residual units
  7. encode: the same random Mimi, DAC and SNAC files hold their encoders;
     encode requests through load_model(...).encode (Mimi 20 s b1 and b4
     in f32, 20 s b1 in bf16; DAC and SNAC 20 s b1 in f32 and bf16), each
     with every launch count set to 0 just before and read just after
     (exact counts), checked for shape and range, the f32 codes held
     against the plain path on the card (plain attention, plain RVQ,
     plain residual units) under the near-tie rule, and one encode →
     decode round trip per arch
  8. CSM-style TTS: write a random CSM codec GGUF (full-width Mimi + a
     residual_depth_ar adaptor at CSM-1B's depth-decoder widths) and
     Llama-3.2-1B-shaped backbones in Q4_K and Q8_0, load each backbone
     packed on the card (the memory it adds is checked), and run three
     requests of a 16-token prompt to 25 greedy frames (Q4_K per-token
     prefill, Q4_K prefill in one bucket of 16, Q8_0 per-token) through
     run_codebook_ar and the Mimi decode, each with the launch counts set
     to 0 just before and read just after; the backbone hiddens are held
     against the plain packed product on the card, teacher-forced on the
     same inputs, and the greedy codes against the plain path's
  9. CUDA-event times (median of >= 10 runs after warm-up), each kernel
     beside its plain version, its bound on this card and, for the
     attention and the packed products, one PyTorch call that computes
     the same function; device times of the packed products from
     torch.profiler, warm (one matrix again and again), cold (cycling over
     the loaded backbones' 16 layers of each shape) at m = 1 and 16, and
     one backbone forward's 112 products; per-request TTS times (median of 3 runs after one
     warm-up); per-request encode times (median of 10 after 2 warm-ups)
Then one JSON line of kernel results, the card line again, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
TIMED_RUNS = 10

# -- flash_sdpa_window: (B, H, T, D, window): the Mimi decoder transformer
# at 20 s b1, 60 s b1 and 20 s b4, pure causal, and D=128 with a small
# window; bounds of tests/test_attn_pallas.py (f32 atol 2e-5 rtol 1e-5,
# bf16 atol 3e-2)
ATTN_SHAPES_F32 = [(1, 8, 500, 64, 250), (1, 8, 1500, 64, 250),
                   (4, 8, 500, 64, 250), (1, 2, 300, 64, None),
                   (1, 2, 256, 128, 16)]
ATTN_SHAPE_BF16 = (1, 8, 500, 64, 250)
ATTN_F32_TOL = dict(atol=2e-5, rtol=1e-5)
ATTN_BF16_ATOL = 3e-2
# (name, seconds of audio, batch, compute dtype)
MIMI_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                 ("60s_b1_f32", 60, 1, "float32"),
                 ("20s_b4_f32", 20, 4, "float32"),
                 ("20s_b1_bf16", 20, 1, "bfloat16")]
MIMI_LAYERS = 8                    # flash_sdpa_window launches per decode

# -- seanet_res_unit (B, T, C, d) and seanet_res_chain (B, T, C): the DAC
# decoder's block shapes at 20 s b1, a batch of 2, and T below the halo.
# f32 bound: max abs err <= 1e-4 * max|plain| and corr > 0.99999 (the
# kernels' sin^2 series differs from torch.sin by up to 7.2e-6, and sums
# run in another order). bf16 kernels round their conv operands to bf16
# as the TPU kernels do; they are held against the plain version in f32
# on the same bf16 inputs, at the bounds of tests/test_seanet_pallas.py.
# Those bounds leave about 5 standard deviations of the rounding noise at
# outputs near 0, and a check over 46M outputs meets its 6-7 sigma tail:
# so the inputs keep the chain's output near that test's scale (std about
# 3.4): alphas |N(0, 1)| + 1 and biases N(0, 0.1) (res_params).
UNIT_SHAPES = [(1, 12000, 768, 1), (1, 12000, 768, 9), (1, 60000, 384, 3),
               (2, 1000, 384, 9), (1, 20, 96, 9)]
CHAIN_SHAPES = [(1, 240000, 192), (1, 480000, 96), (2, 100, 96), (1, 20, 192)]
UNIT_BF16 = dict(rtol=2e-2, atol=5e-2, corr=0.9999)
CHAIN_BF16 = dict(rtol=3e-2, atol=8e-2, corr=0.9995)
DILATIONS = (1, 3, 9)
# (C, T) of the four decoder blocks of a 20 s b1 DAC decode
DAC_BLOCKS = [(768, 12000), (384, 60000), (192, 240000), (96, 480000)]
DAC_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                ("20s_b4_f32", 20, 4, "float32"),
                ("20s_b1_bf16", 20, 1, "bfloat16")]

# -- snac_res_chain (B, T, C): the four SNAC decoder blocks of a 20 s b1
# decode (936 frames), a batch of 2, a T that is no multiple of 32, T below
# the halo and T = 1. Each shape runs in the form a decode launches (one
# N = 1 launch per dilation, snac_res_units) and, where its state fits, as
# the chain (N = 3). Bounds as for the DAC chain; inputs at the scales of
# tests/test_seanet_pallas.py's depthwise test (x 0.3, taps 0.2, biases
# 0.1, the 1x1 at that test's gain for any C), alphas N(1, 0.5)
SNAC_BLOCKS = [(512, 7488), (256, 59904), (128, 239616), (64, 479232)]
SNAC_SHAPES = [(1, t, c) for c, t in SNAC_BLOCKS] + [
    (2, 1000, 128), (1, 4100, 256), (1, 20, 64), (1, 1, 64)]
SNAC_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                 ("20s_b4_f32", 20, 4, "float32"),
                 ("20s_b1_bf16", 20, 1, "bfloat16")]

# -- q8_0_matmul / q4_k_matmul: the Llama-3.2-1B backbone's matrices
# (out, in) q/o, k/v, gate/up and down, at m = 1, 16 and 32 rows with x in
# f32 and at m = 1 in bf16. The kernel and its plain version multiply the
# same dequantized weights in f32 with sums in another order: max abs err
# <= 1e-4 * max|plain|. One-hot rows must give the dequantized weights bit
# for bit.
QMAT_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
QMAT_MS = (1, 16, 32)
QMAT_MAIN = (8192, 2048)                # gate/up, the kernels' line shape
SHAPE_NAMES = {(2048, 2048): "q/o", (512, 2048): "k/v", (8192, 2048): "gate/up",
               (2048, 8192): "down"}
FORWARD_ORDER = ("q", "k", "v", "o", "gate", "up", "down")
L2_BYTES = 50 * 2 ** 20
FLUSH_BYTES = 64 * 2 ** 20
# -- the CSM TTS path: (name, backbone qtype, prefill bucket); each request
# is a 16-token prompt (ids from SEED) to 25 greedy frames (2 s at 12.5 Hz)
TTS_REQUESTS = [("q4_k_per_token", "Q4_K", 0), ("q4_k_bucket16", "Q4_K", 16),
                ("q8_0_per_token", "Q8_0", 0)]
TTS_PROMPT, TTS_FRAMES, TTS_TIMED_RUNS = 16, 25, 3
Q4K_LOAD_LIMIT = 2.5e9                  # bytes a Q4_K backbone load may add

# -- rvq_encode_fused (B, T, D, n_q, V): Mimi at 20 s b1 (acoustic and
# semantic) and b4, the unaligned shapes of tests/test_rvq_pallas.py, and
# V = 5 with frames near 0 (rows past V are never chosen). Integer-valued
# inputs (exact in f32, with many exact ties), with or without duplicated
# rows (the lower copy must win), must give the plain version's codes bit
# for bit; normal inputs equal codes, or each differing frame's first
# differing level an f64 near-tie (relative distance margin < 1e-4) in at
# most max(2, N/100) frames
RVQ_SHAPES = [(1, 250, 256, 31, 2048), (1, 250, 256, 1, 2048),
              (4, 250, 256, 31, 2048), (1, 7, 32, 4, 64), (1, 130, 96, 3, 100)]
RVQ_MAIN = (1, 250, 256, 31, 2048)      # the kernels line's shape
NEAR_TIE = 1e-4
# the encoders' residual-unit blocks at 20 s b1: DAC (C, T) and SNAC (C, T)
# after its pad to 2048
DAC_ENC_BLOCKS = [(64, 480000), (128, 240000), (256, 60000), (512, 12000)]
SNAC_ENC_BLOCKS = [(48, 481280), (96, 240640), (192, 60160), (384, 7520)]
# (arch, name, seconds of audio, batch, compute dtype)
ENCODE_REQUESTS = [("mimi", "20s_b1_f32", 20, 1, "float32"),
                   ("mimi", "20s_b4_f32", 20, 4, "float32"),
                   ("mimi", "20s_b1_bf16", 20, 1, "bfloat16"),
                   ("dac", "20s_b1_f32", 20, 1, "float32"),
                   ("dac", "20s_b1_bf16", 20, 1, "bfloat16"),
                   ("snac", "20s_b1_f32", 20, 1, "float32"),
                   ("snac", "20s_b1_bf16", 20, 1, "bfloat16")]

# H100 SXM data-sheet peaks (dense): f32 on the FMA units (the f32 kernels
# use no TF32), bf16 on the tensor cores, and HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier in a mangled name: an Itanium name is
    prefixed by its length, which may follow a hash's digits."""
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for j in range(len(run)):
            ident = mangled[m.end(): m.end() + int(run[j:])]
            if len(ident) == int(run[j:]) and ident.endswith("_kernel") \
                    and re.fullmatch(r"[A-Za-z_]\w*", ident):
                return ident
    return mangled[:60]


def ptxas_report(nvcc_log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: the
    kernel, its type and tile, its registers and any spills."""
    out, name, spill = [], None, ""
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            tile = re.search(r"(FmaTile|MmaTile)I((?:Li\d+E)+)", mangled)
            rows = re.search(r"matmul_kernelI(?:Lb(\d)E)?Li(\d+)E", mangled)
            name = " ".join(filter(None, [
                kernel_name(mangled),
                "bf16" if "bfloat16" in mangled else "f32",
                tile and f"{tile.group(1)}<"
                f"{','.join(re.findall(r'Li(\d+)E', tile.group(2)))}>",
                rows and f"m<={rows.group(2)}",
                rows and rows.group(1) == "0" and "cp.async"]))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (f", spills {m.group(1)}/{m.group(2)} bytes"
                     if m.group(1) != "0" or m.group(2) != "0" else "")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers{spill}")
            name, spill = None, ""
    return out


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


def turns(kernel, plain, reps: int = 1):
    """Kernel and plain times in turns (plain, kernel, kernel, plain): the
    best of each pair and the four samples."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def randn(shape, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to("cuda", dtype)


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


def unit_args(p, u=0):
    return (p["a1s"][u], p["w1s"][u], p["b1s"][u], p["a2s"][u], p["w2s"][u],
            p["b2s"][u])


def corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1])


def dw_params(n, c, dtype, seed, k=7):
    """n depthwise units' weights (SNAC_SHAPES gives the scales)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    return dict(w1s=t(rng.standard_normal((n, k, c)) * 0.2),
                b1s=t(rng.standard_normal((n, c)) * 0.1),
                a1s=t(1.0 + 0.5 * rng.standard_normal((n, c))),
                a2s=t(1.0 + 0.5 * rng.standard_normal((n, c))),
                w2s=t(rng.standard_normal((n, c, c)) * 0.1 * np.sqrt(128 / c)),
                b2s=t(rng.standard_normal((n, c)) * 0.1))


def least_time(flops, nbytes):
    """The least time this card could take: the larger of the bytes over
    the HBM rate and the operations over their type's peak; flops is
    [(count, dtype)]. Returns (ms, "bytes" or "operations")."""
    t_ops = sum(f / PEAK_FLOPS[dt] for f, dt in flops)
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def attn_work(b, h, t, d, w, dtype):
    """flash_sdpa_window's FLOP (QK and PV over the visible band) and bytes
    (q, k, v read and out written once)."""
    pairs = sum(min(i + 1, w or t) for i in range(t))
    return [(4 * d * pairs * b * h, dtype)], 4 * b * h * t * d * dtype.itemsize


def res_work(n, b, t, c, dtype, k=7, depthwise=False):
    """n residual units' conv FLOP (the snakes' few operations per element
    are left out) and bytes (x read and out written once, the weights read
    once). SNAC's depthwise taps run in f32 in both dtypes."""
    taps = k if depthwise else k * c
    weights = n * (taps * c + c * c) * dtype.itemsize
    flops = [(2 * n * c * c * b * t, dtype),
             (2 * n * taps * c * b * t, torch.float32 if depthwise else dtype)]
    return flops, 2 * b * t * c * dtype.itemsize + weights


def qmat_work(out_d, in_d, m, packed):
    """A packed product's FLOP (f32 FMAs) and bytes: the packed weights
    (quants, scales, mins), x read and y written once."""
    wbytes = sum(t.numel() * t.element_size() for t in packed.values())
    return [(2 * m * in_d * out_d, torch.float32)], wbytes + 4 * m * (in_d + out_d)


def rvq_work(n, d, n_q, v):
    """The RVQ search's operations (f32 FMAs: 2·N·V·D·n_q; the row lookup is
    a gather) and bytes (x, the codebooks and their norms read once, the
    codes written once)."""
    return ([(2 * n * v * d * n_q, torch.float32)],
            4 * (n * d + n_q * v * d + n_q * v + n * n_q))


def rvq_inputs(b, t, d, n_q, v, kind, seed):
    """x [b, t, d], codebooks [n_q, v, d] f32 on the card: "int" small
    integers (every product and sum exact in f32, many exact ties); "dup"
    the same with row v + V/2 a copy of row v; "normal" N(0, 1) frames,
    N(0, 0.5) codebooks; "tiny" normal frames near 0."""
    rng = np.random.default_rng(seed)
    if kind in ("int", "dup"):
        x, cb = rng.integers(-3, 4, (b, t, d)), rng.integers(-3, 4, (n_q, v, d))
        if kind == "dup":
            cb[:, v // 2: 2 * (v // 2)] = cb[:, : v // 2]
    else:
        x = rng.standard_normal((b, t, d)) * (1e-3 if kind == "tiny" else 1.0)
        cb = rng.standard_normal((n_q, v, d)) * 0.5
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(cb.astype(np.float32)).cuda())


def rel_margin(d, got_v, want_v):
    return float((d[got_v] - d[want_v]) / max(d[want_v], 1e-12))


def euclid_margin(r, cb, prefix, got_v, want_v):
    """f64: r [D] minus cb[lvl][c] for each prefix code, then the relative
    distance margin of got's pick over want's at the next level."""
    for lvl, c in enumerate(prefix):
        r = r - cb[lvl][c]
    return rel_margin(((r[None] - cb[len(prefix)]) ** 2).sum(-1), got_v,
                      want_v)


def cosine_margin(z, cb, got_v, want_v):
    zn = z / max(np.linalg.norm(z), 1e-12)
    cbn = cb / np.maximum(np.linalg.norm(cb, axis=1, keepdims=True), 1e-12)
    return rel_margin(((zn[None] - cbn) ** 2).sum(-1), got_v, want_v)


def near_ties(got, want, margin_fn):
    """got, want [T, Q]: equal codes, or at most max(2, T/100) differing
    frames, each first differing level an f64 near-tie. Returns the
    differing frames' (frame, level, margin); raises otherwise."""
    diff = got != want
    frames = np.where(diff.any(axis=1))[0]
    if len(frames) > max(2, want.shape[0] // 100):
        raise RuntimeError(f"{len(frames)}/{want.shape[0]} frames differ")
    out = []
    for fr in frames:
        q = int(diff[fr].argmax())
        m = margin_fn(int(fr), q)
        if not abs(m) < NEAR_TIE:
            raise RuntimeError(f"frame {fr} level {q}: codes differ with "
                               f"relative margin {m:.3e}")
        out.append((int(fr), q, m))
    return out


def f64(t):
    return t.detach().double().cpu().numpy()


def device_ms(fn, n: int = 50):
    """Device time per call of fn: the kernels' self time under
    torch.profiler over n warm calls (aten ops left out), / n. None when
    the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0 and not e.key.startswith("aten::"))
    return total / 1e3 / n if total > 0 else None


def profiled_ms(fn, calls: int, keep) -> float:
    """Device time per call: fn runs once to warm up, then once under
    torch.profiler; the self time of the kernels whose name `keep` accepts
    (aten ops left out), / calls. Raises when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0 and not e.key.startswith("aten::")
                and keep(e.key))
    if not total > 0:
        raise RuntimeError("torch.profiler reported no device time")
    return total / 1e3 / calls


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


class Recorder:
    """The Backbone protocol around a LlamaBackbone that records each call:
    (kind, input rows, returned hidden, host seconds). Every call ends in
    a copy of the hidden to the host, so its time covers the device work."""

    def __init__(self, bb):
        self.bb, self.calls = bb, []

    def step(self, embed):
        t = time.perf_counter()
        h = self.bb.step(embed)
        self.calls.append(("step", np.asarray(embed), h, time.perf_counter() - t))
        return h

    def prefill(self, embeds, bucket: int = 0):
        t = time.perf_counter()
        h = self.bb.prefill(embeds, bucket=bucket)
        self.calls.append(("prefill", np.asarray(embeds), h,
                           time.perf_counter() - t))
        return h


def main() -> int:
    t_start = time.monotonic()
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
    from codec_tpu_torch.models import dac, snac
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.mimi import mimi_decode_fn
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf
    from codec_tpu_torch.ops import seanet_cuda
    from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                               flash_sdpa_window_ref)
    from codec_tpu_torch.ops.seanet_cuda import (seanet_res_chain,
                                                 seanet_res_unit,
                                                 snac_res_chain)
    from codec_tpu_torch.runtime.model import f32_precision
    from codec_tpu_torch.io.gguf import GGUFReader, quantize_q4_k, quantize_q8_0
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.tts_runner import (_decode_transformed,
                                               run_codebook_ar)
    from codec_tpu_torch.models.lm_init import (write_random_backbone_gguf,
                                                write_random_csm_gguf)
    from codec_tpu_torch.ops import qmat
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul
    from codec_tpu_torch.models import mimi
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from codec_tpu_torch.tools import sass_report

    wrappers = {"flash_sdpa_window": flash_sdpa_window,
                "seanet_res_unit": seanet_res_unit,
                "seanet_res_chain": seanet_res_chain,
                "snac_res_chain": snac_res_chain,
                "q8_0_matmul": q8_0_matmul,
                "q4_k_matmul": q4_k_matmul,
                "rvq_encode_fused": rvq_encode_fused}
    none = dict.fromkeys(wrappers, 0)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    res = build.build()
    log(f"[build] {res.path.name}: nvcc {res.seconds:.2f} s "
        f"(phase {time.monotonic() - t0:.2f} s)")
    for line in ptxas_report(res.log):
        log(f"[build] {line}")
    # the packed products' machine code: ptxas's stack frame and spills, and
    # the int→float conversions (I2F) left in the SASS
    packed = (sass_report.combine(res.log, res.path, "matmul_kernel") if res.log
              else sass_report.report("matmul_kernel"))
    for r in packed:
        log(f"[build] {kernel_name(r.name)} {r.name}: {r.registers} registers, "
            f"{r.stack} bytes stack frame, spills {r.spill_stores}/"
            f"{r.spill_loads} bytes, {r.i2f} I2F of {r.instructions} SASS "
            f"instructions")
    if len(packed) != 36 or any(r.stack or r.spill_stores or r.spill_loads
                                or r.i2f for r in packed):
        raise RuntimeError(f"packed products: want 36 kernels with no stack "
                           f"frame, no spills and no I2F, got {len(packed)}")
    smem = seanet_cuda.smem_per_block(0)
    log(f"[build] opt-in shared memory per block: {smem} bytes")

    # -- 3. kernels against their plain versions ------------------------------
    max_err = {name: 0.0 for name in wrappers}
    cases = [(s, torch.float32) for s in ATTN_SHAPES_F32]
    cases.append((ATTN_SHAPE_BF16, torch.bfloat16))
    for i, ((b, h, t, d, w), dtype) in enumerate(cases):
        q, k, v = (randn((b, h, t, d), dtype, SEED + 3 * i + j) for j in range(3))
        got = flash_sdpa_window(q, k, v, window=w)
        want = flash_sdpa_window_ref(q, k, v, window=w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **ATTN_F32_TOL)
            max_err["flash_sdpa_window"] = max(max_err["flash_sdpa_window"], err)
            bound = "atol 2e-5 rtol 1e-5"
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=ATTN_BF16_ATOL, rtol=0)
            bound = f"atol {ATTN_BF16_ATOL}"
        log(f"[kernel] flash_sdpa_window B{b} H{h} T{t} D{d} window={w} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} ({bound}) ok")

    def hold(name, label, got, want_f32, dtype, bf16_bounds):
        """The seanet bounds (see UNIT_SHAPES); want_f32 is the plain
        version in f32."""
        torch.cuda.synchronize()
        g, w = got.float().cpu().numpy(), want_f32.float().cpu().numpy()
        err, peak, c = float(np.abs(g - w).max()), float(np.abs(w).max()), corr(g, w)
        if not np.isfinite(g).all():
            raise RuntimeError(f"{name} {label}: non-finite output")
        if dtype == torch.float32:
            if not (err <= 1e-4 * peak and c > 0.99999):
                raise RuntimeError(f"{name} {label}: max abs err {err} "
                                   f"(peak {peak}), corr {c}")
            max_err[name] = max(max_err[name], err)
            bound = "max err <= 1e-4 peak, corr > 0.99999"
        else:
            np.testing.assert_allclose(g, w, rtol=bf16_bounds["rtol"],
                                       atol=bf16_bounds["atol"])
            if not c > bf16_bounds["corr"]:
                raise RuntimeError(f"{name} {label}: corr {c}")
            margin = float((np.abs(g - w) - bf16_bounds["atol"]
                            - bf16_bounds["rtol"] * np.abs(w)).max())
            bound = (f"rtol {bf16_bounds['rtol']} atol {bf16_bounds['atol']}"
                     f" corr > {bf16_bounds['corr']}; worst margin {margin:.4f}")
        log(f"[kernel] {name} {label}: max abs err {err:.3e} (peak "
            f"{peak:.3f}), corr {c:.9f} ({bound}) ok")

    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, t, c, d) in enumerate(UNIT_SHAPES):
            p = res_params(1, c, dtype, SEED + 10 + i)
            x = randn((b, t, c), dtype, SEED + 20 + i)
            got = seanet_res_unit(x, *unit_args(p), dilation=d)
            with f32_precision(True):
                want = seanet_cuda.seanet_res_unit_ref(
                    x.float(), *(a.float() for a in unit_args(p)), dilation=d)
            hold("seanet_res_unit", f"B{b} T{t} C{c} d{d} {str(dtype)[6:]}",
                 got, want, dtype, UNIT_BF16)
        for i, (b, t, c) in enumerate(CHAIN_SHAPES):
            p = res_params(3, c, dtype, SEED + 30 + i)
            x = randn((b, t, c), dtype, SEED + 40 + i)
            got = seanet_res_chain(x, **p, dilations=DILATIONS)
            with f32_precision(True):
                want = seanet_cuda.seanet_res_chain_ref(
                    x.float(), **{k: v.float() for k, v in p.items()},
                    dilations=DILATIONS)
            hold("seanet_res_chain", f"B{b} T{t} C{c} {str(dtype)[6:]}",
                 got, want, dtype, CHAIN_BF16)
            del x, got, want
        for i, (b, t, c) in enumerate(SNAC_SHAPES):
            p = dw_params(3, c, dtype, SEED + 70 + i)
            if c >= 64 and not (p["a1s"] < 0).any():
                raise RuntimeError("snac_res_chain: no negative alpha drawn")
            x = randn((b, t, c), dtype, SEED + 80 + i, scale=0.3)
            with f32_precision(True):
                want = seanet_cuda.snac_res_chain_ref(
                    x.float(), **{k: v.float() for k, v in p.items()},
                    dilations=DILATIONS)
            forms = [("N=1 x3", lambda: seanet_cuda.snac_res_units(
                x, **p, dilations=DILATIONS))]
            if seanet_cuda.dw_chain_tile(c, 7, DILATIONS, dtype, smem):
                forms.append(("N=3", lambda: snac_res_chain(
                    x, **p, dilations=DILATIONS)))
            for form, run in forms:
                hold("snac_res_chain", f"{form} B{b} T{t} C{c} "
                     f"{str(dtype)[6:]}", run(), want, dtype, CHAIN_BF16)
            del x, want

    # the residual units at the encoders' widths, in the launches an encode
    # makes (DAC: the gate's chain, or one unit launch per unit; SNAC: one
    # N = 1 launch per unit). A chain is held against the plain chain, each
    # unit launch (on the block's input, one per dilation) against the
    # plain unit, at the bounds of the decode's checks of the same forms
    def unit_by_unit(name, x, p, dtype, label, launch, plain, bounds):
        for u, dil in enumerate(DILATIONS):
            pu = {k: v[u:u + 1] for k, v in p.items()}
            got = launch(x, pu, dil)
            with f32_precision(True):
                want = plain(x.float(), {k: v.float() for k, v in pu.items()},
                             dil)
            hold(name, f"{label} unit {u + 1} (d={dil}) {str(dtype)[6:]}",
                 got, want, dtype, bounds)
            del got, want

    for dtype in (torch.float32, torch.bfloat16):
        for i, (c, t) in enumerate(DAC_ENC_BLOCKS):
            p = res_params(3, c, dtype, SEED + 150 + i)
            x = randn((1, t, c), dtype, SEED + 160 + i)
            label = f"DAC encoder block C{c} T{t}"
            if seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem):
                with f32_precision(True):
                    want = seanet_cuda.seanet_res_chain_ref(
                        x.float(), **{k: v.float() for k, v in p.items()},
                        dilations=DILATIONS)
                hold("seanet_res_chain", f"{label} as the chain "
                     f"{str(dtype)[6:]}", seanet_res_chain(
                         x, **p, dilations=DILATIONS), want, dtype, CHAIN_BF16)
                del want
            else:
                unit_by_unit(
                    "seanet_res_unit", x, p, dtype, label,
                    lambda y, pu, dil: seanet_res_unit(
                        y, *unit_args(pu), dilation=dil),
                    lambda y, pu, dil: seanet_cuda.seanet_res_unit_ref(
                        y, *unit_args(pu), dilation=dil), UNIT_BF16)
            del x
        for i, (c, t) in enumerate(SNAC_ENC_BLOCKS):
            p = dw_params(3, c, dtype, SEED + 170 + i)
            x = randn((1, t, c), dtype, SEED + 180 + i, scale=0.3)
            unit_by_unit(
                "snac_res_chain", x, p, dtype, f"SNAC encoder block C{c} T{t}",
                lambda y, pu, dil: snac_res_chain(y, **pu, dilations=(dil,)),
                lambda y, pu, dil: seanet_cuda.snac_res_chain_ref(
                    y, **pu, dilations=(dil,)), CHAIN_BF16)
            del x

    # the RVQ search: integer-valued inputs, also with duplicated rows, bit
    # for bit; normal inputs under the near-tie rule, V = 5 with frames
    # near 0. Its
    # codes have no error in size: its max_abs_err is the largest relative
    # distance margin at a frame where its codes differ (0.0: none differ)
    rvq_cases = [(shape, kind) for shape in RVQ_SHAPES
                 for kind in ("int", "dup", "normal")]
    rvq_cases.append(((1, 300, 64, 3, 5), "tiny"))
    for i, ((b, t, d, n_q, v), kind) in enumerate(rvq_cases):
        x, cb = rvq_inputs(b, t, d, n_q, v, kind, SEED + 190 + i)
        got = rvq_encode_fused(x, cb).cpu().numpy().reshape(b * t, n_q)
        want = rvq_encode(x, cb).cpu().numpy().reshape(b * t, n_q)
        label = f"rvq_encode_fused N{b * t} D{d} n_q{n_q} V{v} {kind}"
        if got.min() < 0 or got.max() >= (v // 2 if kind == "dup" else v):
            raise RuntimeError(f"{label}: a code past V or past the lower "
                               f"copy of a duplicated row")
        if kind in ("int", "dup"):
            if not np.array_equal(got, want):
                raise RuntimeError(f"{label}: {(got != want).sum()} codes "
                                   f"differ from the plain version's")
            note = "equal to the plain version's bit for bit"
        else:
            x64, cb64 = f64(x).reshape(b * t, d), f64(cb)
            ties = near_ties(got, want, lambda fr, q: euclid_margin(
                x64[fr], cb64, want[fr, :q], got[fr, q], want[fr, q]))
            max_err["rvq_encode_fused"] = max(
                [max_err["rvq_encode_fused"]] + [abs(m) for _, _, m in ties])
            note = ("equal to the plain version's" if not ties else
                    f"{len(ties)} frames differ, each a near-tie (margins "
                    f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
        log(f"[kernel] {label}: codes {note} ok")
        del x, cb

    # the packed products: each backbone shape, m = 1/16/32 in f32 and m = 1
    # in bf16 against the plain version, then 32 one-hot rows (bit-exact)
    def packed_product(name, x, qt):
        if name == "q8_0_matmul":
            return q8_0_matmul(x, qt["qs"], qt["scale"])
        return q4_k_matmul(x, qt["qs"], qt["scale"], qt["minv"])

    qrng = np.random.default_rng(SEED + 110)
    qmat_weights = {}
    for out_d, in_d in QMAT_SHAPES:
        w = qrng.standard_normal((out_d, in_d), dtype=np.float32) * 0.02
        for name, quantize, pack in (
                ("q8_0_matmul", quantize_q8_0, qmat.pack_q8_0),
                ("q4_k_matmul", quantize_q4_k, qmat.pack_q4_k)):
            qt = qmat.to_device(pack(np.frombuffer(quantize(w), np.uint8),
                                     w.shape), "cuda")
            qmat_weights[name, out_d, in_d] = qt
            dense = qmat.dequant_ref(qt)
            for m in QMAT_MS:
                for dtype in (torch.float32, torch.bfloat16)[:2 if m == 1 else 1]:
                    x = randn((m, in_d), dtype, SEED + 120 + m)
                    got = packed_product(name, x, qt)
                    want = x.float() @ dense.T
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    peak = want.abs().max().item()
                    if not (got.dtype == torch.float32 and err <= 1e-4 * peak):
                        raise RuntimeError(f"{name} {out_d}x{in_d} m{m} "
                                           f"{dtype}: max abs err {err} "
                                           f"(peak {peak})")
                    max_err[name] = max(max_err[name], err)
                    log(f"[kernel] {name} out {out_d} in {in_d} m{m} "
                        f"{str(dtype)[6:]}: max abs err {err:.3e} (peak "
                        f"{peak:.3f}; bound 1e-4 peak) ok")
            cols = torch.from_numpy(qrng.choice(in_d, 32, replace=False)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.zeros((32, in_d), dtype=dtype, device="cuda")
                x[torch.arange(32, device="cuda"), cols] = 1
                if not torch.equal(packed_product(name, x, qt), dense[:, cols].T):
                    raise RuntimeError(f"{name} {out_d}x{in_d} {dtype}: one-hot "
                                       f"rows do not give the dequantized "
                                       f"weights bit for bit")
            log(f"[kernel] {name} out {out_d} in {in_d}: 32 one-hot rows give "
                f"the dequantized weights bit for bit, f32 and bf16 x")
            del dense

    # -- 4, 5. full-width models through load_model ---------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        paths = {name: Path(tmp.name) / f"{name}_random.gguf"
                 for name in ("mimi", "dac", "snac")}
        t0 = time.monotonic()
        write_random_mimi_gguf(paths["mimi"], seed=SEED, encoder=True)
        write_random_dac_gguf(paths["dac"], seed=SEED, encoder=True)
        write_random_snac_gguf(paths["snac"], seed=SEED, encoder=True)
        log("[model] wrote " + ", ".join(
            f"{path.name} ({path.stat().st_size / 2**20:.1f} MiB)"
            for path in paths.values())
            + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        mimi_models, dac_models, snac_models = (
            {dt: codec_tpu_torch.load_model(paths[name], compute_dtype=dt,
                                            device="cuda")
             for dt in ("float32", "bfloat16")}
            for name in ("mimi", "dac", "snac"))
        torch.cuda.synchronize()
    finally:
        tmp.cleanup()
    cfg = mimi_models["float32"].cfg
    dcfg = dac_models["float32"].cfg
    widths = [blk["units"]["w1"].shape[-1]
              for blk in dac_models["float32"].params["dec_blocks"]]
    scfg = snac_models["float32"].cfg
    snac_widths = [blk["units"]["w1"].shape[-1]
                   for blk in snac_models["float32"].params["dec_blocks"]]
    log(f"[model] load_model Mimi + DAC + SNAC, f32 + bf16, in "
        f"{time.monotonic() - t0:.2f} s")
    log(f"[model] Mimi: hidden {cfg.hidden}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads x {cfg.head_dim}, mlp {cfg.intermediate}, "
        f"{cfg.n_q} codebooks x {cfg.codebook_size} x {cfg.codebook_dim}, "
        f"window {cfg.window}")
    log(f"[model] DAC: latent {dcfg.latent_dim}, block widths {widths}, hop "
        f"{dcfg.hop_size}, {dcfg.n_q} codebooks x {dcfg.codebook_size} x "
        f"{dcfg.codebook_dim}, {dcfg.sample_rate} Hz")
    log(f"[model] SNAC: latent {scfg.latent_dim}, block widths {snac_widths}, "
        f"rates {scfg.decoder_rates}, hop {scfg.hop_size}, {scfg.n_q} "
        f"codebooks x {scfg.codebook_size} x {scfg.codebook_dim} at strides "
        f"{scfg.vq_strides}, {scfg.sample_rate} Hz")

    rng = np.random.default_rng(SEED)

    def requests(spec, models, mcfg, multiple=1):
        out = []
        for name, secs, batch, dt in spec:
            frames = secs * mcfg.sample_rate // mcfg.hop_size
            frames -= frames % multiple
            codes = rng.integers(0, mcfg.codebook_size,
                                 (batch, frames, mcfg.n_q)).astype(np.int32)
            out.append((name, secs, batch, models[dt], codes))
        return out

    mimi_reqs = requests(MIMI_REQUESTS, mimi_models, cfg)
    dac_reqs = requests(DAC_REQUESTS, dac_models, dcfg)
    snac_reqs = requests(SNAC_REQUESTS, snac_models, scfg,
                         multiple=scfg.vq_strides[0])

    # -- 4. the Mimi path ------------------------------------------------------
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in mimi_reqs:
        before = flash_sdpa_window.launches
        outs[name] = model.decode(codes)
        step = flash_sdpa_window.launches - before
        if step != MIMI_LAYERS:
            raise RuntimeError(f"mimi {name}: {step} kernel launches, want "
                               f"{MIMI_LAYERS}")
    mimi_counts = counts()
    want_counts = {**none, "flash_sdpa_window": MIMI_LAYERS * len(mimi_reqs)}
    if mimi_counts != want_counts:
        raise RuntimeError(f"Mimi path launches {mimi_counts}, want {want_counts}")
    log(f"[mimi] main path launches: {mimi_counts} over {len(mimi_reqs)} "
        f"decodes ({MIMI_LAYERS} per decode)")

    def plain_mimi(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = mimi_decode_fn(model.params, c, model.cfg,
                                 attention=flash_sdpa_window_ref)
        return pcm.float().cpu().numpy()

    for name, secs, batch, model, codes in mimi_reqs:
        pcm = outs[name]
        want_shape = (batch, codes.shape[1] * cfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"mimi {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"mimi {name}: non-finite samples")
        line = (f"[mimi] {name}: pcm {pcm.shape} finite, peak "
                f"{np.abs(pcm).max():.4f}")
        if model.compute_dtype == torch.float32:
            ref = plain_mimi(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"mimi {name}: corr {c} vs plain attention")
            line += (f"; vs plain attention on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, mimi_models['float32'].decode(codes)):.6f}")
        log(line)

    # -- 5. the DAC path -------------------------------------------------------
    plan, per_decode = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        plan[dtype] = [seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem)
                       for c in widths]
        per_decode[dtype] = {
            **none, "seanet_res_unit": 3 * sum(not t for t in plan[dtype]),
            "seanet_res_chain": sum(plan[dtype])}
        if not (per_decode[dtype]["seanet_res_unit"]
                and per_decode[dtype]["seanet_res_chain"]):
            raise RuntimeError(f"the gate runs only one kernel per DAC decode "
                               f"in {dtype}: {per_decode[dtype]}")
        tiles = [seanet_cuda.chain_tile(c, 7, DILATIONS, dtype, smem)
                 for c in widths]
        log(f"[dac] gate at {smem} bytes, {str(dtype)[6:]}: widths {widths}, "
            f"chain tiles {tiles}, chain taken {plan[dtype]} (from "
            f"{seanet_cuda.CHAIN_MIN_TILE} rows); launches per decode "
            f"{per_decode[dtype]}")
    n_latent = dcfg.sample_rate * 20 // dcfg.hop_size
    latent = np.random.default_rng(SEED + 1).standard_normal(
        (n_latent, dcfg.latent_dim)).astype(np.float32)
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in dac_reqs:
        before = counts()
        outs[name] = model.decode(codes)
        step = {k: v - before[k] for k, v in counts().items()}
        if step != per_decode[model.compute_dtype]:
            raise RuntimeError(f"dac {name}: launches {step}, want "
                               f"{per_decode[model.compute_dtype]}")
    before = counts()
    lat_pcm = dac_models["float32"].decode_latent(latent)
    step = {k: v - before[k] for k, v in counts().items()}
    dac_counts = counts()
    if step != per_decode[torch.float32]:
        raise RuntimeError(f"dac decode_latent: launches {step}, want "
                           f"{per_decode[torch.float32]}")
    log(f"[dac] main path launches: {dac_counts} over {len(dac_reqs)} decodes "
        f"and 1 decode_latent")

    def plain_dac(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = dac.dac_decode_fn(model.params, c, model.cfg,
                                    res_units=dac.plain_res_units)
        return pcm.float().cpu().numpy()

    n_out = lambda frames: dcfg.hop_size * frames - 8     # rates 8/5/4/2
    if lat_pcm.shape != (n_out(n_latent),) or not np.isfinite(lat_pcm).all():
        raise RuntimeError(f"dac decode_latent: pcm {lat_pcm.shape}, finite "
                           f"{np.isfinite(lat_pcm).all()}")
    log(f"[dac] decode_latent 20s_b1_f32: pcm {lat_pcm.shape} finite")
    for name, secs, batch, model, codes in dac_reqs:
        pcm = outs[name]
        want_shape = (batch, n_out(codes.shape[1]))
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"dac {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"dac {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        line = (f"[dac] {name}: pcm {pcm.shape} finite, peak "
                f"{np.abs(pcm).max():.4f}, std {pcm.std():.4f}, share "
                f"|pcm| > 0.99: {sat:.2e}")
        if model.compute_dtype == torch.float32:
            if not sat < 0.01:
                raise RuntimeError(f"dac {name}: {sat:.2%} of samples saturated")
            ref = plain_dac(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"dac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, dac_models['float32'].decode(codes)):.6f}")
        log(line)
    del outs

    # -- 6. the SNAC path ------------------------------------------------------
    # the gate (seanet_cuda.snac_res_units): one N = 1 launch per unit
    snac_per_decode = {**none,
                       "snac_res_chain": len(DILATIONS) * len(snac_widths)}
    log(f"[snac] gate: one N=1 launch per unit at widths {snac_widths}; "
        f"launches per decode {snac_per_decode}")
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in snac_reqs:
        before = counts()
        outs[name] = model.decode(codes)
        step = {k: v - before[k] for k, v in counts().items()}
        if step != snac_per_decode:
            raise RuntimeError(f"snac {name}: launches {step}, want "
                               f"{snac_per_decode}")
    snac_counts = counts()
    log(f"[snac] main path launches: {snac_counts} over {len(snac_reqs)} "
        f"decodes")

    def plain_snac(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = snac.snac_decode_fn(model.params, c, model.cfg,
                                      res_units=snac.plain_res_units)
        return pcm.float().cpu().numpy()

    for name, secs, batch, model, codes in snac_reqs:
        pcm = outs[name]
        want_shape = (batch, codes.shape[1] * scfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"snac {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"snac {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        line = (f"[snac] {name}: {codes.shape[1]} frames -> pcm {pcm.shape} "
                f"finite, peak {np.abs(pcm).max():.4f}, std {pcm.std():.4f}, "
                f"share |pcm| > 0.99: {sat:.2e}")
        if model.compute_dtype == torch.float32:
            if not sat < 0.01:
                raise RuntimeError(f"snac {name}: {sat:.2%} of samples saturated")
            ref = plain_snac(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"snac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, snac_models['float32'].decode(codes)):.6f}")
        log(line)
    del outs

    # -- 7. encode --------------------------------------------------------------
    enc_models = {"mimi": mimi_models, "dac": dac_models, "snac": snac_models}
    enc_widths = {arch: [blk["units"]["w1"].shape[-1]
                         for blk in enc_models[arch]["float32"].params["enc_blocks"]]
                  for arch in ("dac", "snac")}
    enc_per = {}
    for dtype in (torch.float32, torch.bfloat16):
        chains = [seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem)
                  for c in enc_widths["dac"]]
        enc_per["mimi", dtype] = {**none, "flash_sdpa_window": MIMI_LAYERS,
                                  "rvq_encode_fused": 2}
        enc_per["dac", dtype] = {
            **none, "seanet_res_unit": 3 * sum(not c for c in chains),
            "seanet_res_chain": sum(chains)}
        enc_per["snac", dtype] = {
            **none, "snac_res_chain": len(DILATIONS) * len(enc_widths["snac"])}
        log(f"[encode] {str(dtype)[6:]}: DAC encoder widths "
            f"{enc_widths['dac']}, chain taken {chains}; SNAC encoder widths "
            f"{enc_widths['snac']}; launches per encode: mimi "
            f"{enc_per['mimi', dtype]}, dac {enc_per['dac', dtype]}, snac "
            f"{enc_per['snac', dtype]}")
    enc_rng = np.random.default_rng(SEED + 200)
    enc_reqs = []
    for arch, name, secs, batch, dt in ENCODE_REQUESTS:
        model = enc_models[arch][dt]
        if not model.has_encoder:
            raise RuntimeError(f"{arch}: the random file holds no encoder")
        pcm = (enc_rng.standard_normal((batch, secs * model.sample_rate))
               * 0.3).astype(np.float32)
        enc_reqs.append((arch, name, secs, batch, model, pcm))
    enc_counts, enc_outs = dict(none), {}
    for arch, name, secs, batch, model, pcm in enc_reqs:
        zero_counts()
        enc_outs[arch, name] = model.encode(pcm)
        step = counts()
        if step != enc_per[arch, model.compute_dtype]:
            raise RuntimeError(f"{arch} encode {name}: launches {step}, want "
                               f"{enc_per[arch, model.compute_dtype]}")
        enc_counts = {k: v + step[k] for k, v in enc_counts.items()}
    log(f"[encode] main path launches: {enc_counts} over {len(enc_reqs)} "
        f"encodes")

    def plain_encode(arch, model, pcm):
        """The plain path on the card (plain attention, plain RVQ, plain
        residual units) → (latent f64 [B, T, C], codes [B, T, Q])."""
        x = torch.from_numpy(pcm).cuda()
        with torch.inference_mode(), f32_precision(True):
            if arch == "mimi":
                lat = mimi.mimi_encode_latent_fn(
                    model.params, x, model.cfg, attention=flash_sdpa_window_ref)
                codes = mimi.mimi_quantize(model.params, lat, model.cfg,
                                           quantize=rvq_encode)
            elif arch == "dac":
                lat = dac.dac_encode_latent_fn(model.params, x, model.cfg,
                                               res_units=dac.plain_res_units)
                codes = dac.dac_quantize(model.params["vq"], lat,
                                         model.cfg.n_q)
            else:
                lat = snac.snac_encode_latent_fn(
                    model.params, x, model.cfg, res_units=snac.plain_res_units)
                codes = snac.snac_quantize(model.params["vq"], lat, model.cfg)
            return f64(lat), codes.cpu().numpy()

    def encode_margin(arch, model, lat, want, got):
        """margin_fn (near_ties) at one batch row: lat [T, C] f64."""
        p, mcfg = model.params, model.cfg
        if arch == "mimi":
            groups = [(f64(p["sem_ip"]), f64(p["cb_sem"]), 0),
                      (f64(p["acu_ip"]), f64(p["cb_acu"]), mcfg.n_sem)]

            def margin(fr, q):
                ip, cb, base = groups[q >= mcfg.n_sem]
                return euclid_margin(lat[fr] @ ip.T, cb, want[fr, base:q],
                                     got[fr, q], want[fr, q])
            return margin
        vq = {k: f64(v) for k, v in p["vq"].items()}
        if arch == "dac":
            def margin(fr, q):
                r = lat[fr]
                for lvl in range(q):
                    r = r - (vq["out_w"][lvl] @ vq["cb"][lvl][want[fr, lvl]]
                             + vq["out_b"][lvl])
                return cosine_margin(vq["in_w"][q] @ r + vq["in_b"][q],
                                     vq["cb"][q], got[fr, q], want[fr, q])
            return margin

        def margin(fr, q):
            res = lat
            for lvl in range(q):
                s_ = mcfg.vq_strides[lvl]
                zq = vq["cb"][lvl][want[::s_, lvl]] @ vq["out_w"][lvl].T \
                    + vq["out_b"][lvl]
                res = res - np.repeat(zq, s_, axis=0)
            s_ = mcfg.vq_strides[q]
            pooled = res.reshape(-1, s_, res.shape[-1]).mean(axis=1)
            return cosine_margin(vq["in_w"][q] @ pooled[fr // s_]
                                 + vq["in_b"][q], vq["cb"][q], got[fr, q],
                                 want[fr, q])
        return margin

    for arch, name, secs, batch, model, pcm in enc_reqs:
        codes = enc_outs[arch, name]
        n = pcm.shape[1]
        if arch == "mimi":
            frames = -(-n // model.hop_size)
        elif arch == "dac":
            frames = n // model.hop_size
        else:
            frames = -(-n // model.cfg.pad_to) * model.cfg.pad_to // model.hop_size
        want_shape = (batch, frames, model.n_q)
        if codes.shape != want_shape or codes.dtype != np.int32:
            raise RuntimeError(f"{arch} encode {name}: codes {codes.shape} "
                               f"{codes.dtype}, want {want_shape} int32")
        if codes.min() < 0 or codes.max() >= model.codebook_size:
            raise RuntimeError(f"{arch} encode {name}: codes out of range")
        distinct = [len(np.unique(codes[..., q])) for q in range(model.n_q)]
        line = (f"[encode] {arch} {name}: codes {codes.shape} in range, "
                f"distinct codes per level {distinct[:4]}"
                f"{'...' if len(distinct) > 4 else ''}")
        if model.compute_dtype == torch.float32:
            x = pcm if arch != "snac" else np.pad(
                pcm, ((0, 0), (0, frames * model.hop_size - n)))
            lat, want = plain_encode(arch, model, x)
            ties = [t for bi in range(batch) for t in near_ties(
                codes[bi], want[bi],
                encode_margin(arch, model, lat[bi], want[bi], codes[bi]))]
            line += ("; equal to the plain path's on the card" if not ties
                     else f"; vs the plain path on the card: {len(ties)} "
                     f"frames differ, each a near-tie (margins "
                     f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
            if batch == 1:
                pcm_out = model.decode(codes)
                if not np.isfinite(pcm_out).all():
                    raise RuntimeError(f"{arch}: encode → decode gave "
                                       f"non-finite samples")
                line += (f"; encode → decode round trip: pcm "
                         f"{pcm_out.shape} finite")
        log(line)

    # -- 8. the CSM TTS path ---------------------------------------------------
    t0 = time.monotonic()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tts_")
    try:
        csm_path = write_random_csm_gguf(Path(tmp.name) / "csm_random.gguf",
                                         seed=SEED)
        bb_paths = {q: write_random_backbone_gguf(
            Path(tmp.name) / f"backbone_{q}.gguf", seed=SEED, qtype=q)
            for q in ("Q4_K", "Q8_0")}
        log("[tts] wrote " + ", ".join(
            f"{path.name} ({path.stat().st_size / 2**20:.1f} MiB)"
            for path in [csm_path, *bb_paths.values()])
            + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        csm = codec_tpu_torch.load_model(csm_path, device="cuda")
        reader = GGUFReader(csm_path)
        lm = create_lm(reader, device="cuda")
        backbones, growth = {}, {}
        for qtype, path in bb_paths.items():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            backbones[qtype] = create_backbone(path, quantized=True,
                                               device="cuda")
            torch.cuda.synchronize()
            growth[qtype] = torch.cuda.memory_allocated() - before
    finally:
        tmp.cleanup()
    bcfg = backbones["Q4_K"].cfg
    log(f"[tts] loaded in {time.monotonic() - t0:.2f} s: backbone hidden "
        f"{bcfg.hidden}, {bcfg.n_layers} layers, {bcfg.n_heads} heads x "
        f"{bcfg.head_dim}, {bcfg.n_kv_heads} KV heads, FFN {bcfg.ffn_dim}, "
        f"vocab {bcfg.vocab_size}, rope_theta {bcfg.rope_theta:g} with llama3 "
        f"factors, max_ctx {bcfg.max_ctx}; adaptor {lm.depth_layers} depth "
        f"layers at {lm.depth_hidden}, {lm.n_heads} heads x {lm.head_dim}, "
        f"{lm.info.n_codebook} codebooks x {lm.info.codebook_sizes[0]}")
    for qtype, bb in backbones.items():
        mats = [v for lw in bb.params["layers"] for v in lw.values()
                if isinstance(v, dict)]
        if len(mats) != 7 * bcfg.n_layers:
            raise RuntimeError(f"{qtype} backbone: {len(mats)} packed "
                               f"matrices, want {7 * bcfg.n_layers}")
        packed = sum(t.numel() * t.element_size() for qt in mats
                     for t in qt.values())
        emb = bb.params["tok_embd"]
        log(f"[tts] {qtype} backbone load added {growth[qtype] / 1e9:.3f} GB "
            f"on the card (packed matrices {packed / 1e9:.3f}, f32 tok_embd "
            f"{emb.numel() * emb.element_size() / 1e9:.3f}, KV cache "
            f"{bb.kv.numel() * bb.kv.element_size() / 1e9:.3f})")
    if not growth["Q4_K"] < Q4K_LOAD_LIMIT:
        raise RuntimeError(f"the Q4_K backbone load added {growth['Q4_K']} "
                           f"bytes, the limit is {Q4K_LOAD_LIMIT:.0f}")

    prompt = list(backbones["Q4_K"].embed_tokens(np.random.default_rng(
        SEED + 130).integers(0, bcfg.vocab_size, TTS_PROMPT)))
    kernel_of = {"Q4_K": "q4_k_matmul", "Q8_0": "q8_0_matmul"}

    def tts_request(bb, bucket):
        """One greedy request through run_codebook_ar and the Mimi decode
        → (result, pcm, recorder, times in ms)."""
        bb.reset()
        alm = AudioLM(reader, codec=csm, lm=lm)
        rec = Recorder(bb)
        t = time.perf_counter()
        res = run_codebook_ar(alm, rec, prompt, max_steps=TTS_FRAMES,
                              decode=False, prefill_bucket=bucket)
        gen = time.perf_counter() - t
        t = time.perf_counter()
        pcm = _decode_transformed(alm, res.codes)
        dec = time.perf_counter() - t
        n_pre = 1 if bucket else TTS_PROMPT
        pre = sum(c[3] for c in rec.calls[:n_pre])
        steps = [c[3] for c in rec.calls[n_pre:]]
        return res, pcm, rec, {
            "prefill": pre * 1e3, "step": statistics.mean(steps) * 1e3,
            "frame": (gen - pre - sum(steps)) / TTS_FRAMES * 1e3,
            "decode": dec * 1e3, "total": (gen + dec) * 1e3}

    plain_bbs = {q: LlamaBackbone.from_params(bb.cfg, bb.params,
                                              qmm=qmat.qmatmul_plain)
                 for q, bb in backbones.items()}
    tts_counts = dict(none)
    for name, qtype, bucket in TTS_REQUESTS:
        n_pre = 1 if bucket else TTS_PROMPT
        want = {**none, "flash_sdpa_window": MIMI_LAYERS,
                kernel_of[qtype]: 7 * bcfg.n_layers * (n_pre + TTS_FRAMES)}
        zero_counts()
        res, pcm, rec, _ = tts_request(backbones[qtype], bucket)
        step = counts()
        if step != want:
            raise RuntimeError(f"tts {name}: launches {step}, want {want}")
        tts_counts = {k: v + step[k] for k, v in tts_counts.items()}
        if res.codes.shape != (TTS_FRAMES, lm.info.n_codebook) \
                or res.stopped_by_eos:
            raise RuntimeError(f"tts {name}: codes {res.codes.shape}, "
                               f"eos {res.stopped_by_eos}")
        if pcm.shape != (TTS_FRAMES * csm.hop_size,) or not np.isfinite(pcm).all():
            raise RuntimeError(f"tts {name}: pcm {pcm.shape}, finite "
                               f"{np.isfinite(pcm).all()}")
        # the backbone hiddens through the plain packed product on the
        # card, teacher-forced on the same inputs
        plain = plain_bbs[qtype]
        plain.reset()
        want_h = np.stack([plain.prefill(rows, bucket=bucket) if kind == "prefill"
                           else plain.step(rows) for kind, rows, _, _ in rec.calls])
        got_h = np.stack([c[2] for c in rec.calls])
        c = corr(got_h, want_h)
        rel = float(np.abs(got_h - want_h).max() / np.abs(want_h).max())
        if not (c > 0.99999 and rel <= 1e-4):
            raise RuntimeError(f"tts {name}: hiddens vs the plain product: "
                               f"corr {c}, max rel err {rel}")
        # the greedy codes of the plain path; at a first difference, the
        # kernel path's top-2 margin decides (near-tie rule)
        pres = tts_request(plain, bucket)[0]
        diff = np.argwhere(pres.codes != res.codes)
        line = (f"[tts] {name}: launches {step[kernel_of[qtype]]} "
                f"{kernel_of[qtype]} + {step['flash_sdpa_window']} "
                f"flash_sdpa_window; {len(rec.calls)} backbone calls, hiddens "
                f"vs the plain product: corr {c:.9f}, max rel err {rel:.3e}; "
                f"pcm {pcm.shape} finite, peak {np.abs(pcm).max():.4f}; ")
        if len(diff):
            f, k = (int(v) for v in diff[0])
            st = lm.new_state()
            st.step_begin(rec.calls[n_pre - 1 + f][2])
            for j in range(k):
                st.step_logits()
                st.step_push_code(int(res.codes[f, j]))
            top = np.sort(st.step_logits()[0])[-2:]
            if not top[1] - top[0] <= 1e-4 * abs(top[1]):
                raise RuntimeError(f"tts {name}: greedy codes differ from the "
                                   f"plain path at frame {f} codebook {k}, "
                                   f"top-2 margin {top[1] - top[0]}")
            line += (f"codes first differ from the plain path at frame {f} "
                     f"codebook {k}: a near-tie, top-2 margin "
                     f"{top[1] - top[0]:.3e} (allowed)")
        else:
            line += f"greedy codes equal the plain path's ({res.codes.shape})"
        log(line)
    log(f"[tts] main path launches: {tts_counts} over {len(TTS_REQUESTS)} "
        f"requests")
    del plain_bbs

    # -- 9. times --------------------------------------------------------------
    log(f"[time] card: {name_limit}; CUDA events, median of {TIMED_RUNS} "
        f"runs after 2 warm-ups; turns plain, kernel, kernel, plain")
    times = {}
    for (b, h, t, d, w), dtype in [(s, torch.float32) for s in ATTN_SHAPES_F32[:3]] + \
            [(ATTN_SHAPE_BF16, torch.bfloat16)]:
        q, k, v = (randn((b, h, t, d), dtype, SEED + j) for j in range(3))
        kern, plain, s = turns(lambda: flash_sdpa_window(q, k, v, window=w),
                               lambda: flash_sdpa_window_ref(q, k, v, window=w),
                               reps=20)
        line = (f"[time] flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                f"(samples k {s[0]:.4f} {s[1]:.4f}, p {s[2]:.4f} {s[3]:.4f})")
        if (b, h, t, d, w) == ATTN_SHAPES_F32[0] and dtype == torch.float32:
            # the library's call for the same function: SDPA with the band
            # mask (key j visible to query i iff i - w < j <= i)
            i = torch.arange(t, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=band)
            diff = (sdpa() - flash_sdpa_window(q, k, v, window=w)).abs().max()
            lib = cuda_ms(sdpa, reps=20)
            work = attn_work(b, h, t, d, w, dtype)
            times["flash_sdpa_window"] = (kern, plain, *least_time(*work), lib)
            line += (f"; F.scaled_dot_product_attention with the band mask "
                     f"{lib:.4f} ms (max abs diff to the kernel "
                     f"{diff.item():.2e}); bound "
                     f"{times['flash_sdpa_window'][2]:.4f} ms")
        log(line + f" [{name_limit}]")

    for dtype in (torch.float32, torch.bfloat16):
        for bi, (c, t) in enumerate(DAC_BLOCKS, start=1):
            p = res_params(3, c, dtype, SEED + 50 + bi)
            x = randn((1, t, c), dtype, SEED + 60 + bi)
            flop = 2 * 8 * c * c * t            # one unit, K = 7
            with f32_precision(dtype == torch.float32):
                unit, plain1, s = turns(
                    lambda: seanet_res_unit(x, *unit_args(p), dilation=1),
                    lambda: seanet_cuda.seanet_res_unit_ref(
                        x, *unit_args(p), dilation=1))
                line = (f"[time] block {bi} C{c} T{t} {str(dtype)[6:]}: "
                        f"one unit (d=1): kernel {unit:.3f} ms "
                        f"({flop / unit / 1e9:.2f} TFLOP/s), plain "
                        f"{plain1:.3f} ms ({flop / plain1 / 1e9:.2f} TFLOP/s)")
                if bi == 1 and dtype == torch.float32:
                    work = res_work(1, 1, t, c, dtype)
                    times["seanet_res_unit"] = (unit, plain1,
                                                *least_time(*work), None)
                if seanet_cuda.chain_tile(c, 7, DILATIONS, dtype, smem):
                    chain, plain3, s = turns(
                        lambda: seanet_res_chain(x, **p, dilations=DILATIONS),
                        lambda: seanet_cuda.seanet_res_chain_ref(
                            x, **p, dilations=DILATIONS))
                    line += (f"; chain of 3: kernel {chain:.3f} ms "
                             f"({3 * flop / chain / 1e9:.2f} TFLOP/s), plain "
                             f"{plain3:.3f} ms")
                    if bi == 4 and dtype == torch.float32:
                        work = res_work(3, 1, t, c, dtype)
                        times["seanet_res_chain"] = (chain, plain3,
                                                     *least_time(*work), None)
            log(line + f" [{name_limit}]")
            del x, p

    for dtype in (torch.float32, torch.bfloat16):
        for bi, (c, t) in enumerate(SNAC_BLOCKS, start=1):
            p = dw_params(3, c, dtype, SEED + 90 + bi)
            x = randn((1, t, c), dtype, SEED + 100 + bi, scale=0.3)
            flops, nbytes = res_work(3, 1, t, c, dtype, depthwise=True)
            b_ms, b_by = least_time(flops, nbytes)
            flop = sum(f for f, _ in flops)
            with f32_precision(dtype == torch.float32):
                kern, plain, s = turns(
                    lambda: seanet_cuda.snac_res_units(x, **p),
                    lambda: seanet_cuda.snac_res_chain_ref(x, **p))
            line = (f"[time] snac block {bi} C{c} T{t} {str(dtype)[6:]}: "
                    f"three units as 3 N=1 launches {kern:.3f} ms "
                    f"({flop / kern / 1e9:.2f} TFLOP/s, "
                    f"{nbytes / kern / 1e6:.1f} GB/s, {b_ms / kern:.1%} of the "
                    f"bound {b_ms:.4f} ms, {b_by}), plain {plain:.3f} ms "
                    f"(samples k {s[0]:.3f} {s[1]:.3f}, p {s[2]:.3f} "
                    f"{s[3]:.3f})")
            if seanet_cuda.dw_chain_tile(c, 7, DILATIONS, dtype, smem):
                chain = cuda_ms(lambda: snac_res_chain(x, **p))
                line += f"; chain N=3 {chain:.3f} ms"
            if bi == 3 and dtype == torch.float32:
                times["snac_res_chain"] = (kern, plain, b_ms, b_by, None)
            log(line + f" [{name_limit}]")
            del x, p

    # the packed products at m = 1 (one decode step) on every backbone
    # shape: device time per call from torch.profiler, and the CUDA-event
    # time of back-to-back calls, which includes the host's launch work
    for out_d, in_d in QMAT_SHAPES:
        x = randn((1, in_d), torch.float32, SEED + 140)
        for name in ("q8_0_matmul", "q4_k_matmul"):
            qt = qmat_weights[name, out_d, in_d]
            dense = qmat.dequant_ref(qt)
            kern = lambda: packed_product(name, x, qt)
            plain = lambda: qmat.qmatmul_plain(x, qt)
            lib = lambda: F.linear(x, dense)
            dev = [device_ms(fn) for fn in (kern, plain, lib)]
            k_ev, p_ev, s = turns(kern, plain, reps=20)
            l_ev = cuda_ms(lib, reps=20)
            b_ms, b_by = least_time(*qmat_work(out_d, in_d, 1, qt))
            log(f"[time] {name} out {out_d} in {in_d} m1 f32: device time "
                f"kernel {fmt_ms(dev[0])}, plain (dequant + matmul) "
                f"{fmt_ms(dev[1])}, F.linear on the dequantized f32 weight "
                f"{fmt_ms(dev[2])}; bound {b_ms:.4f} ms ({b_by}); CUDA events "
                f"per call kernel {k_ev:.4f} ms, plain {p_ev:.4f} ms, "
                f"F.linear {l_ev:.4f} ms [{name_limit}]")
            if (out_d, in_d) == QMAT_MAIN:
                times[name] = (dev[0] or k_ev, dev[1] or p_ev, b_ms, b_by,
                               dev[2] or l_ev)
            del dense

    # the packed products cold, as a forward finds them: each shape's line
    # cycles over the 16 layers' matrices of that shape in the loaded
    # backbone (a 64 MB buffer written between launches where the cycle
    # would stay in L2), at m = 1 and m = 16 (a bucketed prefill); then one
    # forward's 112 products at m = 1 in forward order. Device times by the
    # kernel's name under torch.profiler, F.linear on the same dequantized
    # f32 weights measured the same way
    cold = {}
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for qtype, bb in backbones.items():
        name = kernel_of[qtype]
        layers = bb.params["layers"]
        dense = [{k: qmat.dequant_ref(lw[k]) for k in FORWARD_ORDER}
                 for lw in layers]
        xs = {d: randn((1, d), torch.float32, SEED + 150 + d)
              for d in (bcfg.hidden, bcfg.ffn_dim)}
        for out_d, in_d in QMAT_SHAPES:
            pairs = [(lw[k], dw[k]) for lw, dw in zip(layers, dense)
                     for k in FORWARD_ORDER if tuple(lw[k]["qs"].shape)[0] == out_d
                     and qmat.in_features(lw[k]) == in_d]
            wbytes = sum(t.numel() * t.element_size() for qt, _ in pairs
                         for t in qt.values())
            flush = wbytes < 2 * L2_BYTES
            for m in (1, 16):
                x = randn((m, in_d), torch.float32, SEED + 160 + m)

                def cycle(use_dense):
                    for qt, dw in pairs:
                        if flush:
                            flush_buf.fill_(1.0)
                        if use_dense:
                            F.linear(x, dw)
                        else:
                            packed_product(name, x, qt)
                k_ms = profiled_ms(lambda: cycle(False), len(pairs),
                                   lambda key: "matmul_kernel" in key)
                l_ms = profiled_ms(lambda: cycle(True), len(pairs),
                                   lambda key: "FillFunctor" not in key)
                b_ms, b_by = least_time(*qmat_work(out_d, in_d, m, pairs[0][0]))
                if m == 1 and (out_d, in_d) == QMAT_MAIN:
                    cold[name] = k_ms
                log(f"[time] {name} cold {SHAPE_NAMES[out_d, in_d]} out {out_d} "
                    f"in {in_d} m{m} f32 ({len(pairs)} matrices, "
                    f"{wbytes / 1e6:.1f} MB{', 64 MB written between launches' if flush else ''}): "
                    f"device time kernel {fmt_ms(k_ms)}, F.linear on the "
                    f"dequantized f32 weight {fmt_ms(l_ms)}; bound {b_ms:.4f} ms "
                    f"({b_by}), {b_ms / k_ms:.1%} of it [{name_limit}]")
        order = [(lw[k], dw[k]) for lw, dw in zip(layers, dense)
                 for k in FORWARD_ORDER]

        def forward(use_dense):
            for qt, dw in order:
                x = xs[dw.shape[1]]
                if use_dense:
                    F.linear(x, dw)
                else:
                    packed_product(name, x, qt)
        reps = 3
        k_ms = profiled_ms(lambda: [forward(False) for _ in range(reps)], reps,
                           lambda key: "matmul_kernel" in key)
        l_ms = profiled_ms(lambda: [forward(True) for _ in range(reps)], reps,
                           lambda key: True)
        b_sum = sum(least_time(*qmat_work(qt["qs"].shape[0], dw.shape[1], 1,
                                          qt))[0] for qt, dw in order)
        log(f"[time] {name} one backbone forward, {len(order)} products at m1 "
            f"in forward order (cold): device time kernel {fmt_ms(k_ms)}, "
            f"F.linear on the dequantized f32 weights {fmt_ms(l_ms)}; summed "
            f"bound {b_sum:.4f} ms, {b_sum / k_ms:.1%} of it [{name_limit}]")
        del dense, order
    del flush_buf

    for name, qtype, bucket in TTS_REQUESTS:
        runs = [tts_request(backbones[qtype], bucket)[3]
                for _ in range(TTS_TIMED_RUNS)]
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        audio_s = TTS_FRAMES * csm.hop_size / csm.sample_rate
        log(f"[time] tts {name}: prefill {med['prefill']:.2f} ms, backbone "
            f"step {med['step']:.3f} ms, frame (c0 head + "
            f"{lm.info.n_codebook - 1} depth forwards + host sampling + "
            f"compose) {med['frame']:.3f} ms, Mimi decode "
            f"{med['decode']:.2f} ms, total {med['total']:.1f} ms, "
            f"{audio_s / (med['total'] / 1e3):.3f}x realtime ({audio_s:.0f} s "
            f"of audio; median of {TTS_TIMED_RUNS} runs after a warm-up) "
            f"[{name_limit}]")

    decode_fns = {"dac": dac.dac_decode_fn, "snac": snac.snac_decode_fn}
    for label, reqs, plain_units in (
            ("mimi", mimi_reqs, None), ("dac", dac_reqs, dac.plain_res_units),
            ("snac", snac_reqs, snac.plain_res_units)):
        for name, secs, batch, model, codes in reqs:
            ms = cuda_ms(lambda: model.decode(codes))
            xrt = secs * batch / (ms / 1000.0)
            line = (f"[time] {label} decode {name}: {ms:.3f} ms per request, "
                    f"{xrt:.1f}x realtime ({secs * batch} s of audio)")
            if model.compute_dtype == torch.float32:
                c = torch.from_numpy(codes.astype(np.int64)).cuda()

                if label == "mimi":
                    def dev(plain=False):
                        with torch.inference_mode(), f32_precision(True):
                            mimi_decode_fn(model.params, c, model.cfg,
                                           attention=flash_sdpa_window_ref
                                           if plain else None)
                    what = "plain attention"
                else:
                    def dev(plain=False):
                        with torch.inference_mode(), f32_precision(True):
                            decode_fns[label](model.params, c, model.cfg,
                                              res_units=plain_units
                                              if plain else None)
                    what = "plain res units"
                d_kern = cuda_ms(dev)
                d_plain = cuda_ms(lambda: dev(True))
                line += (f"; decode fn alone (codes already on the card, no "
                         f"copy back) {d_kern:.3f} ms with the kernels, "
                         f"{d_plain:.3f} ms with {what}")
            log(line + f" [{name_limit}]")

    # the RVQ search at Mimi's shapes (20 s b1 acoustic and semantic, b4)
    for b, t, d, n_q, v in RVQ_SHAPES[:3]:
        x, cb = rvq_inputs(b, t, d, n_q, v, "normal", SEED + 210)
        kern, plain, s = turns(lambda: rvq_encode_fused(x, cb),
                               lambda: rvq_encode(x, cb), reps=5)
        b_ms, b_by = least_time(*rvq_work(b * t, d, n_q, v))
        flop = rvq_work(b * t, d, n_q, v)[0][0][0]
        log(f"[time] rvq_encode_fused N{b * t} D{d} n_q{n_q} V{v} f32: kernel "
            f"{kern:.4f} ms ({flop / kern / 1e9:.2f} TFLOP/s, {b_ms / kern:.1%} "
            f"of the bound {b_ms:.4f} ms, {b_by}), plain (n_q matmuls + "
            f"argmaxes) {plain:.4f} ms (samples k {s[0]:.4f} {s[1]:.4f}, p "
            f"{s[2]:.4f} {s[3]:.4f}) [{name_limit}]")
        if (b, t, d, n_q, v) == RVQ_MAIN:
            times["rvq_encode_fused"] = (kern, plain, b_ms, b_by, None)
        del x, cb

    # the encode requests, host PCM to host codes; for f32, the encode
    # function alone (PCM already on the card) with the kernels and with
    # the plain path
    enc_fns = {"mimi": (lambda m, x, plain: mimi.mimi_encode_fn(
                   m.params, x, m.cfg, attention=flash_sdpa_window_ref
                   if plain else None, quantize=rvq_encode if plain else None)),
               "dac": (lambda m, x, plain: dac.dac_encode_fn(
                   m.params, x, m.cfg, res_units=dac.plain_res_units
                   if plain else None)),
               "snac": (lambda m, x, plain: snac.snac_encode_fn(
                   m.params, x, m.cfg, res_units=snac.plain_res_units
                   if plain else None))}
    for arch, name, secs, batch, model, pcm in enc_reqs:
        ms = cuda_ms(lambda: model.encode(pcm))
        line = (f"[time] {arch} encode {name}: {ms:.3f} ms per request, "
                f"{secs * batch / (ms / 1000.0):.1f}x realtime ({secs * batch} "
                f"s of audio)")
        if model.compute_dtype == torch.float32:
            n = pcm.shape[1]
            x = torch.from_numpy(np.pad(pcm, ((0, 0), (0, enc_outs[
                arch, name].shape[1] * model.hop_size - n)))
                if arch == "snac" else pcm).cuda()

            def dev(plain=False):
                with torch.inference_mode(), f32_precision(True):
                    enc_fns[arch](model, x, plain)
            d_kern = cuda_ms(dev)
            d_plain = cuda_ms(lambda: dev(True))
            line += (f"; encode fn alone (PCM already on the card) "
                     f"{d_kern:.3f} ms with the kernels, {d_plain:.3f} ms "
                     f"with the plain path")
        log(line + f" [{name_limit}]")

    main_counts = {"flash_sdpa_window": mimi_counts["flash_sdpa_window"]
                   + tts_counts["flash_sdpa_window"]
                   + enc_counts["flash_sdpa_window"],
                   "seanet_res_unit": dac_counts["seanet_res_unit"]
                   + enc_counts["seanet_res_unit"],
                   "seanet_res_chain": dac_counts["seanet_res_chain"]
                   + enc_counts["seanet_res_chain"],
                   "snac_res_chain": snac_counts["snac_res_chain"]
                   + enc_counts["snac_res_chain"],
                   "q8_0_matmul": tts_counts["q8_0_matmul"],
                   "q4_k_matmul": tts_counts["q4_k_matmul"],
                   "rvq_encode_fused": enc_counts["rvq_encode_fused"]}
    sources = {"flash_sdpa_window": ("codec_tpu_torch/csrc/flash_sdpa_window.cu",
                                     "codec_tpu/ops/attn_pallas.py:82"),
               "seanet_res_unit": ("codec_tpu_torch/csrc/seanet_res.cu",
                                   "codec_tpu/ops/seanet_pallas.py:92"),
               "seanet_res_chain": ("codec_tpu_torch/csrc/seanet_res.cu",
                                    "codec_tpu/ops/seanet_pallas.py:218"),
               "snac_res_chain": ("codec_tpu_torch/csrc/snac_res.cu",
                                  "codec_tpu/ops/seanet_pallas.py:328"),
               "q8_0_matmul": ("codec_tpu_torch/csrc/qmat.cu",
                               "codec_tpu/ops/qmat_pallas.py:171"),
               "q4_k_matmul": ("codec_tpu_torch/csrc/qmat.cu",
                               "codec_tpu/ops/qmat_pallas.py:200"),
               "rvq_encode_fused": ("codec_tpu_torch/csrc/rvq_encode.cu",
                                    "codec_tpu/ops/rvq_pallas.py:76")}
    # times at: attention B1 H8 T500 D64 w250, the DAC unit at block 1
    # (d=1), the DAC chain at block 4, SNAC's three units at block 3 (the
    # N=1 launches a decode makes), the packed products at m = 1 on the
    # gate matrix (device times), the RVQ search at Mimi's 20 s b1
    # acoustic shape (N 250, D 256, n_q 31, V 2048); all f32. No single
    # PyTorch call computes a residual unit or an n_q-level search, so
    # those rows have no library time; the packed products' library time
    # is F.linear on the dequantized f32 weight (no PyTorch call multiplies
    # GGUF-packed weights); their cold_ms is the same shape cold (the
    # cycle over the backbone's gate/up matrices). Launches: all paths of
    # this run (the attention:
    # Mimi decodes, the TTS requests' Mimi decodes and Mimi encodes; the
    # residual units: decodes and encodes).
    result = {"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": main_counts[name], "max_abs_err": max_err[name],
        **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                   times[name])), **({"cold_ms": cold[name]} if name in cold
                                     else {})}
        for name, (src, rep) in sources.items()]}
    log(f"[time] chip_smoke.py ran {time.monotonic() - t_start:.1f} s")
    print(json.dumps(result), flush=True)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
