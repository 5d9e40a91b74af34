"""Where the RVQ kernel's time goes on the card, phase by phase.

Builds a copy of csrc/rvq_encode.cu with a %globaltimer read at each phase
boundary of a level (the first consumer thread of every block sums the
time between them) and runs it standalone on normal inputs at Mimi's
shapes (D 256, V 2048, n_q 31). Prints how many clusters (8 blocks each)
of each instantiation (32, 16 or 8 frames per cluster) the card holds at
once, with the kernel's shared memory and at one block per SM; then, for
each N and each frame count, the launch time (CUDA events, median of 10),
each phase's mean time per level over the blocks, and whether the codes
equal the plain version's. The frame count that ops/rvq_cuda.py::plan
picks is marked with *: the sweep its choice is held to.

    python -m codec_tpu_torch.tools.rvq_phases [--n 16 128 250 1000]
        [--variant split|presplit]

Phases: "wait" (a staged chunk's barrier), "score" (the tensor-core
products of a chunk, 256 rows x 32 columns), "reduce" (the row tiles'
scores, the block's best per frame, the pushes to every block of the
cluster), "exchange" (the wait for every block's candidates, the
winners, the codes, the winners' rows by bulk copy) and "update" (r -=
cb[idx] and its split). The timer reads cost a little; the launch time
is of the instrumented copy. Needs the CUDA toolkit's nvcc.

--variant presplit times what codebooks split into hi and lo once at load
would save: each k8 step loads A's hi and lo by two ldmatrix and splits
nothing. The lo stage is stood in for by the same stage (its copies and
its shared memory are left out), so the time is a lower bound on that
design's, and the codes are not the plain version's.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import numpy as np
import torch

from ..kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..ops import rvq_cuda
from ..ops.rvq import codebook_norms, rvq_encode
from ..ops.seanet_cuda import smem_per_block

PHASES = ("wait", "score", "reduce", "exchange", "update")
_TIMER = """
__device__ __forceinline__ unsigned long long phase_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(i) do { __syncwarp(); const unsigned long long t_ = phase_clock(); \\
  phase_ns[i] += t_ - phase_t; phase_t = t_; } while (0)
"""
_OCCUPANCY = """
// the clusters the card holds with one block per SM: ask with all of a
// block's shared memory
extern "C" int rvq_phases_max_clusters(int frames, int d, int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(optin);
  err = frames == 32 ? opt_in<32>(dev, bytes)
        : frames == 16 ? opt_in<16>(dev, bytes)
                       : opt_in<8>(dev, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(kCluster * 64, bytes, nullptr, &attr);
  return static_cast<int>(
      frames == 32 ? cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<32>, &cfg)
      : frames == 16 ? cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<16>, &cfg)
                     : cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<8>, &cfg));
}
"""


_SPLIT_A = """              ldsm_x4(raw, st + row * 128 + (((2 * ks + a_half) ^ (row & 7)) << 4));
#pragma unroll
              for (int u = 0; u < 4; ++u) split(__uint_as_float(raw[u]), h[t][u], l[t][u]);
"""
_PRESPLIT_A = """              const uint32_t a_at = st + row * 128 + (((2 * ks + a_half) ^ (row & 7)) << 4);
              ldsm_x4(h[t], a_at);
              ldsm_x4(l[t], a_at);
"""


def instrumented_source(variant: str = "split") -> str:
    """csrc/rvq_encode.cu with the phase timers (and, for "presplit", A
    loaded as hi and lo without a split); raises if the kernel's text no
    longer holds a boundary."""
    src = (CSRC_DIR / "rvq_encode.cu").read_text()

    def sub(old, new, count=1):
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"rvq_phases: the kernel's text changed near "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)

    sub("namespace {\n", "namespace {\n" + _TIMER)
    if variant == "presplit":
        sub(_SPLIT_A, _PRESPLIT_A)
    sub("int n, int d, int n_q, int v) {\n",
        "int n, int d, int n_q, int v, unsigned long long* prof) {\n"
        f"  unsigned long long phase_ns[{len(PHASES)}] = {{}}, "
        "phase_t = phase_clock();\n")
    for i, name in enumerate(PHASES):
        sub(f"// [phase {i}: {name}]\n", f"PHASE({i});\n")
    sub("  cluster.sync();            // no block leaves",
        f"  if (threadIdx.x == 0)\n    for (int i = 0; i < {len(PHASES)}; ++i)\n"
        f"      prof[blockIdx.x * {len(PHASES)} + i] = phase_ns[i];\n"
        "  cluster.sync();            // no block leaves")
    sub("int n_q, int v,\n                   cudaStream_t stream) {",
        "int n_q, int v,\n                   cudaStream_t stream, "
        "unsigned long long* prof) {")
    sub("codes, n, d, n_q, v);", "codes, n, d, n_q, v, prof);")
    sub("void* stream) {", "void* stream, void* prof) {\n"
        "  auto* pf = static_cast<unsigned long long*>(prof);")
    sub("n, d, n_q, v, s)\n", "n, d, n_q, v, s, pf)\n", count=2)
    sub("n, d, n_q, v, s));", "n, d, n_q, v, s, pf));")
    return src + _OCCUPANCY


def build(variant: str = "split") -> ctypes.CDLL:
    out = BUILD_DIR.parent / "rvq_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rvq_phases_{variant}.cu").write_text(instrumented_source(variant))
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "--shared",
                    "-o", str(out / f"rvq_phases_{variant}.so"),
                    str(out / f"rvq_phases_{variant}.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / f"rvq_phases_{variant}.so"))
    lib.codec_rvq_encode.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    for fn in (lib.codec_rvq_encode_max_clusters, lib.rvq_phases_max_clusters):
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rvq_phases")
    ap.add_argument("--n", type=int, nargs="+", default=[16, 128, 250, 1000],
                    help="frames (B·T) per launch")
    ap.add_argument("--variant", choices=("split", "presplit"), default="split")
    args = ap.parse_args(argv)
    d, n_q, v = 256, 31, 2048
    lib = build(args.variant)
    print(f"variant: {args.variant}")
    for frames in rvq_cuda.FRAMES:
        counts = []
        for fn in (lib.codec_rvq_encode_max_clusters, lib.rvq_phases_max_clusters):
            out = ctypes.c_int(0)
            if fn(frames, d, ctypes.byref(out)) != 0:
                raise RuntimeError("cudaOccupancyMaxActiveClusters failed")
            counts.append(out.value)
        print(f"F{frames}: the card holds {counts[0]} clusters of "
              f"{rvq_cuda.CLUSTER} at once with the kernel's shared memory "
              f"({rvq_cuda.smem_bytes(frames, d)} bytes), {counts[1]} at one "
              f"block per SM (the plan assumes {rvq_cuda.HELD})")
    rng = np.random.default_rng(0)
    cb = torch.from_numpy((rng.standard_normal((n_q, v, d)) * 0.5).astype(
        np.float32)).cuda()
    norms = codebook_norms(cb)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for n in args.n:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        want = rvq_encode(x[None], cb, norms)[0]
        pick = rvq_cuda.plan(n, d, smem_per_block(0))
        for frames in rvq_cuda.FRAMES:
            blocks = -(-n // frames) * rvq_cuda.CLUSTER
            codes = torch.empty((n, n_q), dtype=torch.int32, device="cuda")
            prof = torch.zeros((blocks, len(PHASES)), dtype=torch.int64,
                               device="cuda")

            def launch():
                err = lib.codec_rvq_encode(
                    x.data_ptr(), cb.data_ptr(), norms.data_ptr(),
                    codes.data_ptr(), n, d, n_q, v, frames, stream,
                    prof.data_ptr())
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            samples = []
            for i in range(12):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                launch()
                end.record()
                end.synchronize()
                if i >= 2:
                    samples.append(start.elapsed_time(end))
            per_level = prof.cpu().numpy().astype(np.float64) / 1e3 / n_q
            mark = "*" if frames == pick else " "
            print(f"N {n} F{frames}{mark} ({blocks} blocks): "
                  f"{statistics.median(samples):.4f} ms per launch, codes "
                  f"equal to the plain version's: {torch.equal(codes, want)}; "
                  f"µs per level (mean over the blocks): " + ", ".join(
                      f"{name} {per_level[:, i].mean():.2f}"
                      for i, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
