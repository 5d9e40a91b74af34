// Fused residual vector quantization search (Euclidean RVQ encode) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/rvq_pallas.py::rvq_encode_fused
// (_rvq_kernel). For each frame x[n] (f32 [N, D]) the residual r starts at
// x and, for each level q of the codebooks (f32 [n_q, V, D], with the row
// norms norms[q, v] = sum_d cb[q, v, d]^2 computed by the wrapper):
//   score_v = 2 * (r . cb_v) - norm_v,   idx = first argmax_v,   r -= cb[idx]
// codes[n, q] = idx (int32 [N, n_q]). Ties go to the lowest v, as
// torch.argmax and jnp.argmax do. The subtraction is the reference's
// take-and-subtract, elementwise in f32, so it is bit for bit the plain
// version's; the dot products are f32 FMA chains in d order (no TF32), so
// they differ from cuBLAS's only in the order of the sums.
//
// What bounds it on this card: the products, 2·N·V·D·n_q operations on the
// f32 FMA units (Mimi at 20 s b1: 8.1 GFLOP, 0.12 ms at 67 TFLOP/s); the
// bytes it must move (x, the codebooks, the norms, the codes) take a
// twentieth of that. Level q+1 needs every frame's index at level q, so the
// levels run in order inside one launch.
//
// How the design answers that: a frame needs all V scores of a level
// before its next level starts, and 250 frames (20 s at b1) in tiles of 16
// rows and all of V would fill only 16 SMs. So a thread-block cluster of 8
// blocks takes 16 frames and splits V eight ways: each block scores its
// V/8 rows for the 16 frames, reduces them to one (score, index) per frame,
// and the cluster combines the eight candidates through distributed shared
// memory, in rank order (rank r holds rows [r·V/8, (r+1)·V/8)), so the
// lowest index wins exact ties. Every block then applies the winner to its
// own copy of the 16 residuals, which stay in shared memory across all
// levels; one cluster barrier per level, with the candidates double
// buffered. Within a block, 128 threads each keep an 8-frame x 4-row tile
// of dot products in registers. The codebook streams through shared memory
// in 256-row x 32-column chunks, double buffered with cp.async. Which chunk
// comes next never depends on a result, so the stream runs on across row
// tiles and levels: the next level's first chunk loads while a level's
// candidates are reduced and its residuals updated. The update reads the
// 16 winning rows with 16-byte loads, all in flight at once. Rows past V
// and columns past D are never read from device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // blocks per cluster: V split 8 ways
constexpr int kFrames = 16;                  // frames per cluster
constexpr int kThreads = 128;
constexpr int kRowGroups = 64;               // threads per frame group
constexpr int kFramesPerThread = kFrames / (kThreads / kRowGroups);   // 8
constexpr int kRowsPerThread = 4;
constexpr int kTileV = kRowGroups * kRowsPerThread;                 // 256 rows
constexpr int kKc = 32;                      // columns per staged chunk
constexpr int kCbStride = kKc + 4;           // floats per staged row (16-byte rows,
                                             // conflict-free 16-byte reads)
constexpr int kStages = 2;                   // chunk buffers
constexpr int kWarps = kThreads / 32;
constexpr int kUpdateLoads = 8;              // row loads in flight per thread
static_assert(kCluster * kFrames == kThreads, "one thread per (frame, block) candidate");

struct Cand {
  float s;
  int i;
};

// (s, i) beats (bs, bi): a higher score, or an equal one at a lower index
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's chunk sequence: chunk g is level g / per_level, row tile
// (g % per_level) / chunks (rows [v_lo + 256·tile, ...) of the block's
// slice), columns [32·c, 32·c + 32) with c = g % chunks.
struct Chunks {
  int v_lo, v_hi, chunks, per_level;
};

// Stage chunk g into buf [256][kCbStride]; what lies past the slice's rows
// or past d is zero-filled without a read (a zero source size reads
// nothing; the address stays in the codebook). VEC: 16-byte copies
// (d % 4 == 0), else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void stage(float* buf, const float* cb, const Chunks& s, int g,
                                      int d, int v) {
  constexpr int kW = VEC ? 4 : 1;
  constexpr int kPerRow = kKc / kW;
  const int q = g / s.per_level, rem = g % s.per_level;
  const int t0 = s.v_lo + (rem / s.chunks) * kTileV, k0 = (rem % s.chunks) * kKc;
  const int rows = min(kTileV, s.v_hi - t0);
  const float* cbq = cb + static_cast<size_t>(q) * v * d;
  for (int e = threadIdx.x; e < kTileV * kPerRow; e += kThreads) {
    const int row = e / kPerRow, k = k0 + (e % kPerRow) * kW;
    const int avail = row < rows ? max(0, min(kW, d - k)) : 0;
    const float* src = avail ? cbq + static_cast<size_t>(t0 + row) * d + k : cbq;
    cp_async(buf + row * kCbStride + (k - k0), src, 4 * kW, 4 * avail);
  }
}

template <bool VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                      const float* __restrict__ norms, int* __restrict__ codes, int n, int d,
                      int n_q, int v) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int dp = (d + kKc - 1) / kKc * kKc;
  float* cb_s = smem;                                           // [kStages][256][36]
  float* r_s = cb_s + kStages * kTileV * kCbStride;             // [dp][16]
  Cand* cand = reinterpret_cast<Cand*>(r_s + dp * kFrames);     // [2][16]
  Cand* red = cand + 2 * kFrames;                               // [warps][8]
  int* idx_s = reinterpret_cast<int*>(red + kWarps * kFramesPerThread);   // [16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tv = tid % kRowGroups, tf = tid / kRowGroups;
  const int frame0 = static_cast<int>(blockIdx.x / kCluster) * kFrames;
  const int per = (v + kCluster - 1) / kCluster;
  Chunks s;
  s.v_lo = min(v, rank * per);
  s.v_hi = min(v, s.v_lo + per);
  s.chunks = dp / kKc;
  const int tiles = (s.v_hi - s.v_lo + kTileV - 1) / kTileV;   // 0: no rows here
  s.per_level = tiles * s.chunks;
  const int total = n_q * s.per_level;

  // the first kStages - 1 chunks load while the residuals are set up; one
  // commit group per chunk slot, empty past the end, keeps the count even
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < total) stage<VEC>(cb_s + g * kTileV * kCbStride, cb, s, g, d, v);
    cp_async_commit();
  }
  // r = x, zero past d and past the last frame; r_s[k][f] at k·16 + f
  for (int e = tid; e < dp * kFrames; e += kThreads) {
    const int f = e % kFrames, k = e / kFrames, fr = frame0 + f;
    r_s[e] = (fr < n && k < d) ? x[static_cast<size_t>(fr) * d + k] : 0.f;
  }

  int g = 0;                 // the chunk being scored
  for (int q = 0; q < n_q; ++q) {
    const float* cbq = cb + static_cast<size_t>(q) * v * d;
    float best_s[kFramesPerThread];
    int best_i[kFramesPerThread];
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
      best_s[f] = -INFINITY;
      best_i[f] = INT_MAX;
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int t0 = s.v_lo + tile * kTileV, rows = min(kTileV, s.v_hi - t0);
      float acc[kFramesPerThread][kRowsPerThread], nrm[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int row = tv + kRowGroups * j;
        nrm[j] = row < rows ? norms[static_cast<size_t>(q) * v + t0 + row] : 0.f;
#pragma unroll
        for (int f = 0; f < kFramesPerThread; ++f) acc[f][j] = 0.f;
      }
      for (int c = 0; c < s.chunks; ++c, ++g) {
        // chunk g has landed, and every thread is done with chunk g - 1,
        // whose buffer takes chunk g + kStages - 1
        cp_async_wait<kStages - 2>();
        __syncthreads();
        if (g + kStages - 1 < total)
          stage<VEC>(cb_s + ((g + kStages - 1) % kStages) * kTileV * kCbStride, cb, s,
                     g + kStages - 1, d, v);
        cp_async_commit();
        const float* w_s = cb_s + (g % kStages) * kTileV * kCbStride;
        const float* rc = r_s + (c * kKc) * kFrames + tf * kFramesPerThread;
#pragma unroll 2
        for (int kk = 0; kk < kKc; kk += 4) {
          float4 w[kRowsPerThread];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            w[j] = *reinterpret_cast<const float4*>(w_s + (tv + kRowGroups * j) * kCbStride + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 ra = *reinterpret_cast<const float4*>(rc + (kk + u) * kFrames);
            const float4 rb = *reinterpret_cast<const float4*>(rc + (kk + u) * kFrames + 4);
            const float rv[kFramesPerThread] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
              const float wu = u == 0 ? w[j].x : u == 1 ? w[j].y : u == 2 ? w[j].z : w[j].w;
#pragma unroll
              for (int f = 0; f < kFramesPerThread; ++f) acc[f][j] = fmaf(rv[f], wu, acc[f][j]);
            }
          }
        }
      }
      // this tile's rows, in ascending order: a strictly higher score wins
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int row = tv + kRowGroups * j;
        if (row < rows) {
#pragma unroll
          for (int f = 0; f < kFramesPerThread; ++f) {
            const float sc = 2.f * acc[f][j] - nrm[j];
            if (sc > best_s[f]) {
              best_s[f] = sc;
              best_i[f] = t0 + row;
            }
          }
        }
      }
    }
    // the block's best per frame: over the warp's lanes, then its two warps
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best_s[f], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[f], off);
        if (beats(os, oi, best_s[f], best_i[f])) {
          best_s[f] = os;
          best_i[f] = oi;
        }
      }
    }
    if (lane == 0)
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f)
        red[warp * kFramesPerThread + f] = {best_s[f], best_i[f]};
    __syncthreads();
    Cand* mine = cand + (q & 1) * kFrames;
    if (tid < kFrames) {
      const int gr = tid / kFramesPerThread, fl = tid % kFramesPerThread;
      Cand a = red[(2 * gr) * kFramesPerThread + fl];
      const Cand b = red[(2 * gr + 1) * kFramesPerThread + fl];
      if (beats(b.s, b.i, a.s, a.i)) a = b;
      mine[tid] = a;
    }
    cluster.sync();          // every block's candidates are written
    {
      // thread (f, r) reads block r's candidate for frame f; the eight
      // lanes of a frame then reduce by shuffles, in any order: `beats`
      // breaks ties by index
      const int f = tid / kCluster, r = tid % kCluster;
      Cand best = cluster.map_shared_rank(mine, r)[f];
#pragma unroll
      for (int off = kCluster / 2; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best.s, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best.i, off);
        if (beats(os, oi, best.s, best.i)) best = {os, oi};
      }
      if (r == 0) {
        // no row scored (non-finite inputs): row 0 keeps the update in range
        const int idx = best.i < v ? best.i : 0;
        idx_s[f] = idx;
        if (rank == 0 && frame0 + f < n)
          codes[static_cast<size_t>(frame0 + f) * n_q + q] = idx;
      }
    }
    __syncthreads();
    // r -= cb[idx]
    if (VEC) {
      // element e is float4 e / 16 of row idx_s[e % 16]: a warp reads 16
      // rows x 32 bytes, whole sectors; every load of a pass is issued
      // before the first is used
      const int n4 = d / 4, all = n4 * kFrames;
      for (int e0 = tid; e0 < all; e0 += kThreads * kUpdateLoads) {
        float4 row[kUpdateLoads];
#pragma unroll
        for (int u = 0; u < kUpdateLoads; ++u) {
          const int e = e0 + u * kThreads;
          if (e < all)
            row[u] = __ldg(reinterpret_cast<const float4*>(
                               cbq + static_cast<size_t>(idx_s[e % kFrames]) * d) +
                           e / kFrames);
        }
#pragma unroll
        for (int u = 0; u < kUpdateLoads; ++u) {
          const int e = e0 + u * kThreads;
          if (e < all) {
            float* rr = r_s + 4 * (e / kFrames) * kFrames + e % kFrames;
            rr[0] -= row[u].x;
            rr[kFrames] -= row[u].y;
            rr[2 * kFrames] -= row[u].z;
            rr[3 * kFrames] -= row[u].w;
          }
        }
      }
    } else {
#pragma unroll 8
      for (int e = tid; e < d * kFrames; e += kThreads) {
        const int f = e % kFrames, k = e / kFrames;
        r_s[e] -= cbq[static_cast<size_t>(idx_s[f]) * d + k];
      }
    }
    __syncthreads();
  }
  cluster.sync();            // no block leaves while another reads its candidates
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory of one block for dimension d, in bytes.
size_t smem_bytes(int d) {
  const int dp = (d + kKc - 1) / kKc * kKc;
  return sizeof(float) * (static_cast<size_t>(kStages) * kTileV * kCbStride +
                          static_cast<size_t>(dp) * kFrames) +
         sizeof(Cand) * (2 * kFrames + kWarps * kFramesPerThread) + sizeof(int) * kFrames;
}

// opted[dev]: the largest dynamic shared memory this kernel was opted in to
// on device dev, so cudaFuncSetAttribute (a costly host call) runs once per
// device and larger size, not once per launch
template <bool VEC>
cudaError_t launch(int dev, const float* x, const float* cb, const float* norms, int* codes,
                   int n, int d, int n_q, int v, cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  auto kernel = rvq_encode_kernel<VEC>;
  const size_t bytes = smem_bytes(d);
  if (dev >= kMaxDevices || opted[dev] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = bytes;
  }
  const int clusters = (n + kFrames - 1) / kFrames;
  kernel<<<clusters * kCluster, kThreads, bytes, stream>>>(x, cb, norms, codes, n, d, n_q, v);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for dimension d, in bytes.
extern "C" int codec_rvq_encode_smem_bytes(int d) { return static_cast<int>(smem_bytes(d)); }

// x f32 [n, d], cb f32 [n_q, v, d], norms f32 [n_q, v] → codes int32 [n, n_q].
// Returns a cudaError_t (0 = launched).
extern "C" int codec_rvq_encode(const void* x, const void* cb, const void* norms, void* codes,
                                int n, int d, int n_q, int v, void* stream) {
  if (n < 1 || d < 1 || n_q < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cbf = static_cast<const float*>(cb);
  const float* nf = static_cast<const float*>(norms);
  int* out = static_cast<int*>(codes);
  return static_cast<int>(vec ? launch<true>(dev, xf, cbf, nf, out, n, d, n_q, v, s)
                              : launch<false>(dev, xf, cbf, nf, out, n, d, n_q, v, s));
}
