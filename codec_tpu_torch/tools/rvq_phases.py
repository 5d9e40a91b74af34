"""Where the RVQ kernel's time goes on the card, phase by phase.

Builds a copy of csrc/rvq_encode.cu with a %globaltimer read at each phase
boundary of a level (thread 0 of every block sums the time between them)
and runs it standalone on normal inputs at Mimi's shapes (D 256, V 2048,
n_q 31). Prints, for each N, the launch time (CUDA events, median of 10),
each phase's mean time per level over the blocks, whether the codes equal
the plain version's, and how many 8-block clusters the card holds at once
with the kernel's shared memory and at one block per SM.

    python -m codec_tpu_torch.tools.rvq_phases [--n 16 128 250 1000]

Phases: "wait" (the chunk's copy and the barrier before it is scored),
"score" (the FMA loop, with the next chunk's copy issued), "reduce" (the
tile's scores and the block's candidates), "cluster barrier", "exchange"
(the candidates through distributed shared memory) and "update" (r -=
cb[idx]). The timer reads cost a little; the launch time is of the
instrumented copy. Needs the CUDA toolkit's nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import numpy as np
import torch

from ..kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..ops.rvq import codebook_norms, rvq_encode

PHASES = ("wait", "score", "reduce", "cluster barrier", "exchange", "update")
# (text in the kernel, the phase that ends right after it); "update" ends
# at the level's last barrier
_MARKS = [("        cp_async_wait<kStages - 2>();\n        __syncthreads();\n", 0),
          ("              for (int f = 0; f < kFramesPerThread; ++f) acc[f][j] = "
           "fmaf(rv[f], wu, acc[f][j]);\n            }\n          }\n        }\n", 1),
          ("    Cand* mine = cand + (q & 1) * kFrames;\n", 2),
          ("    cluster.sync();          // every block's candidates are written\n", 3),
          ("    __syncthreads();\n    // r -= cb[idx]\n", 4)]
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
// one_per_sm: ask with all of a block's shared memory, so that one block
// fits per SM
extern "C" int rvq_phases_max_clusters(int d, int one_per_sm, int* out) {
  auto kernel = rvq_encode_kernel<true>;
  size_t bytes = smem_bytes(d);
  if (one_per_sm) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    bytes = static_cast<size_t>(optin);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}
"""


def instrumented_source() -> str:
    """csrc/rvq_encode.cu with the phase timers; raises if the kernel's
    text no longer holds a boundary."""
    src = (CSRC_DIR / "rvq_encode.cu").read_text()

    def sub(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"rvq_phases: the kernel's text changed near "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)

    sub("namespace {\n", "namespace {\n" + _TIMER)
    sub("int n_q, int v) {\n",
        "int n_q, int v, unsigned long long* prof) {\n"
        "  unsigned long long phase_ns[6] = {}, phase_t = phase_clock();\n")
    for text, phase in _MARKS:
        sub(text, text + f"PHASE({phase});\n")
    sub("    __syncthreads();\n  }\n  cluster.sync();",
        "    __syncthreads();\nPHASE(5);\n  }\n  if (threadIdx.x == 0)\n"
        "    for (int i = 0; i < 6; ++i) prof[blockIdx.x * 6 + i] = phase_ns[i];\n"
        "  cluster.sync();")
    sub("int n_q, int v, cudaStream_t stream) {",
        "int n_q, int v, cudaStream_t stream, unsigned long long* prof) {")
    sub("(x, cb, norms, codes, n, d, n_q, v);", "(x, cb, norms, codes, n, d, n_q, v, prof);")
    sub("int n_q, int v, void* stream) {",
        "int n_q, int v, void* stream, void* prof) {\n"
        "  auto* pf = static_cast<unsigned long long*>(prof);")
    sub("n, d, n_q, v, s)\n", "n, d, n_q, v, s, pf)\n")
    sub("n, d, n_q, v, s));", "n, d, n_q, v, s, pf));")
    return src + _OCCUPANCY


def build() -> ctypes.CDLL:
    out = BUILD_DIR.parent / "rvq_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rvq_phases.cu").write_text(instrumented_source())
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "--shared", "-o",
                    str(out / "rvq_phases.so"), str(out / "rvq_phases.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "rvq_phases.so"))
    lib.codec_rvq_encode.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rvq_phases")
    ap.add_argument("--n", type=int, nargs="+", default=[16, 128, 250, 1000],
                    help="frames (B·T) per launch")
    args = ap.parse_args(argv)
    d, n_q, v = 256, 31, 2048
    lib = build()
    held = []
    for one_per_sm in (0, 1):
        clusters = ctypes.c_int(0)
        if lib.rvq_phases_max_clusters(d, one_per_sm, ctypes.byref(clusters)) != 0:
            raise RuntimeError("cudaOccupancyMaxActiveClusters failed")
        held.append(clusters.value)
    print(f"clusters of 8 blocks the card holds at once (D {d}): {held[0]} with "
          f"the kernel's shared memory, {held[1]} at one block per SM")
    rng = np.random.default_rng(0)
    cb = torch.from_numpy((rng.standard_normal((n_q, v, d)) * 0.5).astype(
        np.float32)).cuda()
    norms = codebook_norms(cb)
    for n in args.n:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda()
        codes = torch.empty((n, n_q), dtype=torch.int32, device="cuda")
        prof = torch.zeros(((n + 15) // 16 * 8, 6), dtype=torch.int64, device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def launch():
            err = lib.codec_rvq_encode(x.data_ptr(), cb.data_ptr(), norms.data_ptr(),
                                       codes.data_ptr(), n, d, n_q, v, stream,
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
        equal = torch.equal(codes, rvq_encode(x[None], cb)[0])
        per_level = prof.cpu().numpy().astype(np.float64) / 1e3 / n_q
        print(f"N {n}: {statistics.median(samples):.4f} ms per launch, codes equal "
              f"to the plain version's: {equal}; µs per level (mean over "
              f"{per_level.shape[0]} blocks): " + ", ".join(
                  f"{name} {per_level[:, i].mean():.2f}"
                  for i, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
