// Fused residual vector quantization search (Euclidean RVQ encode) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/rvq_pallas.py::rvq_encode_fused
// (_rvq_kernel). For each frame x[n] (f32 [N, D]) the residual r starts at
// x and, for each level q of the codebooks (f32 [n_q, V, D], with the row
// norms norms[q, v] = sum_d cb[q, v, d]^2 from the caller):
//   score_v = 2 * (r . cb_v) - norm_v,   idx = first argmax_v,   r -= cb[idx]
// codes[n, q] = idx (int32 [N, n_q]). Ties go to the lowest v in every
// reduction, as torch.argmax and jnp.argmax do. The subtraction is the
// reference's take-and-subtract, elementwise in f32, so the residual is
// bit for bit the plain version's whenever the codes agree.
//
// The products run on the tensor cores in split f32 (tf32x3.cuh: three
// TF32 passes, relative error near 1e-6, the counterpart of the TPU
// kernel's Precision.HIGHEST); small-integer inputs give exact products
// and the plain version's codes bit for bit.
//
// What bounds it on this card: 2·N·V·D·n_q operations, three passes each
// (Mimi at 20 s b1: 8.1 GFLOP, 0.049 ms at 495 TFLOP/s TF32, 0.12 ms at 67
// TFLOP/s f32 FMA), and a chain of n_q levels: level q+1 needs every
// frame's index at level q, so each level pays a reduction across blocks
// and a residual update before its first product. At N 250 a level is
// about half products and half that chain (tools/rvq_phases.py).
//
// How the design answers that. A thread-block cluster of 8 blocks takes F
// frames (32, 16 or 8) and splits V 8 ways; ops/rvq_cuda.py::plan picks F
// by N (an H100 holds 15 clusters of 8 at once: N up to 240 runs as 16
// frames a cluster in one round, N 250 as 8 clusters of 32 frames rather
// than a 16th cluster of 16 waiting for an SM; a cluster of 16 blocks,
// of which the card holds 7, was slower at every N). In a block,
// one producer warp streams the codebook slice by TMA (2-D tensor map, 256
// rows x 32 columns a box, 128-byte swizzle, rows past V and columns past D
// filled with zeros) through a ring of mbarrier-guarded stages and runs on
// across row tiles and levels, so the next level's first chunks are in
// flight while a level is reduced. Two consumer warpgroups score 128 rows
// each with wgmma m64nFk8: A, the codebook rows, comes from the stage by
// ldmatrix and is split in registers (two k8 steps in flight); B, the
// residual's split hi and lo, lives in shared memory as wgmma's K-major
// 128-byte-swizzled tiles, written once per level. The split rounds with
// integer operations: cvt.rna on every loaded operand had made the
// conversion unit the limit. The block's best (score, index) per frame is
// pushed to every block of the cluster with st.async, which completes on
// the receiver's mbarrier: no cluster barrier inside the level loop, only
// a wait on the block's own barrier for 8 x F candidates. The winners'
// rows then arrive by bulk copy into shared memory, and one pass updates
// the residual and writes its split.
//
// Its limits: the residual's split and the winners' rows share shared
// memory with the stages, so 32 frames take D up to 320 and 16 frames up
// to 480. For larger D, 8 frames with two stages read the winners' rows
// from L2 in the update instead of staging them: D up to 2560. The caller
// raises beyond, and pads to d % 4 == 0 with 16-byte aligned codebooks
// for the tensor map.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

using tf32x3::ldsm_x4;
using tf32x3::smem_u32;
using tf32x3::split;
using tf32x3::split_exact;

constexpr int kCluster = 8;                       // blocks per cluster: V split 8 ways
constexpr int kWarps = 8;                         // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;         // + the producer warp
constexpr int kTileV = 256;                       // rows per row tile: two warpgroups
                                                  // x two m64 tiles
constexpr int kKc = 32;                           // columns per chunk: one 128-byte row
constexpr int kChunkBytes = kTileV * kKc * 4;     // one TMA box

// stages of the codebook ring: as many as shared memory holds beside F
// frames' residual at D 256; 8 frames (large D) keep two
__host__ __device__ constexpr int stages(int f) { return f == 32 ? 3 : f == 16 ? 4 : 2; }

// whether the winners' rows are staged in shared memory by bulk copy (32
// and 16 frames) or read from L2 by the update (8 frames, large D)
__host__ __device__ constexpr bool rows_staged(int f) { return f != 8; }

struct Cand {
  float s;
  int i;
};

// (s, i) beats (bs, bi): a higher score, or an equal one at a lower index
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; kCluster: with
// acquire at cluster scope, for data other blocks wrote
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (kCluster)
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

// box (c0, c1) of a 2-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes into shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// c into dst in block `rank` of the cluster, completing 8 bytes on that
// block's bar
__device__ __forceinline__ void push(Cand* dst, uint64_t* bar, int rank, Cand c) {
  uint32_t d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          d),
      "r"(__float_as_uint(c.s)), "r"(c.i), "r"(b)
      : "memory");
}

// the consumer warps alone
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The block's shared memory for F frames and dimension d, in bytes from a
// 1024-byte boundary: the stages [S][256][32] (swizzled), the residual as
// its exact split hi and lo, each [dp / 32][F][32] in the 128-byte swizzle
// (wgmma's K-major B), the winners' rows [F][dp] f32 (rows_staged) or
// indices [F] int, the candidates [2][8][F], the warps' candidates [8][F],
// then the mbarriers full[S], empty[S], xchg[2], rows.
struct Layout {
  int dp, hi, lo, rows, cand, red, bars, total;
};

__host__ __device__ inline Layout layout(int f, int d) {
  Layout l;
  l.dp = round_up(d, kKc);
  l.hi = stages(f) * kChunkBytes;
  l.lo = l.hi + 4 * f * l.dp;
  l.rows = l.lo + 4 * f * l.dp;
  l.cand = l.rows + 4 * f * (rows_staged(f) ? l.dp : 1);
  l.red = l.cand + 8 * 2 * kCluster * f;
  l.bars = l.red + 8 * kWarps * f;
  l.total = l.bars + 8 * (2 * stages(f) + 3);
  return l;
}

// where element (frame f, column k) of the residual's hi or lo lies, in
// floats: column chunk k / 32 holds F rows of 128 bytes, 16-byte word
// (k % 32) / 4 of row f at word ((k % 32) / 4) ^ (f % 8)
template <int F>
__device__ __forceinline__ int res_at(int f, int k) {
  return (k >> 5) * F * kKc + f * kKc + ((((k & 31) >> 2) ^ (f & 7)) << 2) + (k & 3);
}

// the compiler must not move accesses of v across an asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    rvq_encode_kernel(const __grid_constant__ CUtensorMap cb_map, const float* __restrict__ x,
                      const float* __restrict__ cb, const float* __restrict__ norms,
                      int* __restrict__ codes, int n, int d, int n_q, int v) {
  constexpr int S = stages(F);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const Layout L = layout(F, d);
  float* hi = reinterpret_cast<float*>(base + L.hi);
  float* lo = reinterpret_cast<float*>(base + L.lo);
  float* rows_s = reinterpret_cast<float*>(base + L.rows);
  int* win = reinterpret_cast<int*>(base + L.rows);   // !rows_staged(F)
  Cand* cand = reinterpret_cast<Cand*>(base + L.cand);
  Cand* red = reinterpret_cast<Cand*>(base + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + S;
  uint64_t* xchg = empty + S;
  uint64_t* rowbar = xchg + 2;

  cg::cluster_group cluster = cg::this_cluster();
  constexpr int cl = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int frame0 = static_cast<int>(blockIdx.x / cl) * F;
  const int per = (v + cl - 1) / cl;
  const int v_lo = min(v, rank * per), v_hi = min(v, v_lo + per);
  const int tiles = (v_hi - v_lo + kTileV - 1) / kTileV;   // 0: no rows here
  const int chunks = L.dp / kKc;
  const int per_level = tiles * chunks;
  const int total = n_q * per_level;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init(&xchg[0], 1);
    mbar_init(&xchg[1], 1);
    mbar_init(rowbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the residual r = x as hi + lo; zero past d and past the last frame
  for (int e = tid; e < F * L.dp; e += kThreads) {
    const int f = e / L.dp, k = e % L.dp, fr = frame0 + f;
    const float val = (fr < n && k < d) ? x[static_cast<size_t>(fr) * d + k] : 0.f;
    uint32_t h, l;
    split_exact(val, h, l);
    hi[res_at<F>(f, k)] = __uint_as_float(h);
    lo[res_at<F>(f, k)] = __uint_as_float(l);
  }
  __syncthreads();
  // each level's exchange barrier expects CL x F candidates of 8 bytes
  const uint32_t xchg_bytes = static_cast<uint32_t>(8 * cl * F);
  if (tid == 0) {
    mbar_expect(&xchg[0], xchg_bytes);
    if (n_q > 1) mbar_expect(&xchg[1], xchg_bytes);
  }
  cluster.sync();            // every block's barriers are ready for pushes

  if (warp == kWarps) {
    // the producer: chunk g is level g / per_level, row tile
    // (g % per_level) / chunks, columns 32·(g % chunks)
    if (lane == 0) {
      for (int g = 0; g < total; ++g) {
        const int slot = g % S;
        mbar_wait<false>(&empty[slot], ((g / S) & 1) ^ 1);
        const int q = g / per_level, rem = g % per_level;
        mbar_expect(&full[slot], kChunkBytes);
        tensor_copy(base + slot * kChunkBytes, &cb_map, (rem % chunks) * kKc,
                    q * v + v_lo + (rem / chunks) * kTileV, &full[slot]);
      }
    }
    __syncwarp();
  } else {
    // warpgroup wg scores rows 128·wg + 64·t + [0, 64) of a row tile as
    // m-tile t (t = 0, 1); warp w holds rows 16·(w % 4) + [0, 16) of each
    // as wgmma's A, loaded by ldmatrix (rows 8·(j & 1) + (lane & 7), 16-byte
    // word 2·ks + (j >> 1), where the 128-byte swizzle put it) and split
    // in registers. B, the residual's hi or lo, is F frames x 32 columns
    // of one chunk
    constexpr int NF = F / 4;        // frames a lane's accumulators cover
    const int gq = lane >> 2, tq = lane & 3, j = lane >> 3;
    const int wg = warp >> 2, wrow = 128 * wg + 16 * (warp & 3);
    const int a_row = wrow + (lane & 7) + ((j & 1) << 3), a_half = j >> 1;
    const uint32_t hi_u = smem_u32(hi), lo_u = smem_u32(lo);
    int g = 0;               // the chunk being scored
    for (int q = 0; q < n_q; ++q) {
      // frame 8·i + 2·tq + e is slot 2·i + e
      float best_s[NF];
      int best_i[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        best_s[f] = -INFINITY;
        best_i[f] = INT_MAX;
      }
      for (int tile = 0; tile < tiles; ++tile) {
        const int t0 = v_lo + tile * kTileV, rows = min(kTileV, v_hi - t0);
        // this lane's rows wrow + 64·t + 8·h + gq
        float nrm[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wrow + 64 * t + 8 * h + gq;
            nrm[t][h] = row < rows ? norms[static_cast<size_t>(q) * v + t0 + row] : 0.f;
          }
        // hi·hi, and the two cross passes, in separate sums
        float acc[2][F / 2], acs[2][F / 2];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < F / 2; ++i) acc[t][i] = acs[t][i] = 0.f;
        uint32_t ah[2][2][4], al[2][2][4];     // [buffer][m-tile][fragment]
        for (int c = 0; c < chunks; ++c, ++g) {
          const int slot = g % S;
          mbar_wait<false>(&full[slot], (g / S) & 1);
          // [phase 0: wait]
          const uint32_t st = smem_u32(base + slot * kChunkBytes);
          // a k8 step's A in buffer ks % 2: its products run while the next
          // step's A is loaded and split; wait_group 1 frees the buffer the
          // step after next reuses
#pragma unroll
          for (int ks = 0; ks < kKc / 8; ++ks) {
            uint32_t(&h)[2][4] = ah[ks & 1];
            uint32_t(&l)[2][4] = al[ks & 1];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int row = a_row + 64 * t;
              uint32_t raw[4];
              ldsm_x4(raw, st + row * 128 + (((2 * ks + a_half) ^ (row & 7)) << 4));
#pragma unroll
              for (int u = 0; u < 4; ++u) split(__uint_as_float(raw[u]), h[t][u], l[t][u]);
            }
            if (ks == kKc / 8 - 1) {
              // the stage is in registers: release it to the producer
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[slot]);
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              fence_regs(acc[t]);
              fence_regs(acs[t]);
            }
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            const uint32_t off = c * F * kKc * 4 + ks * 32;
            const uint64_t bh = tf32x3::desc_sw128(hi_u + off);
            const uint64_t bl = tf32x3::desc_sw128(lo_u + off);
#pragma unroll
            for (int t = 0; t < 2; ++t) tf32x3::wgmma_tf32<F>(acs[t], l[t], bh);
#pragma unroll
            for (int t = 0; t < 2; ++t) tf32x3::wgmma_tf32<F>(acc[t], h[t], bh);
#pragma unroll
            for (int t = 0; t < 2; ++t) tf32x3::wgmma_tf32<F>(acs[t], h[t], bl);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int t = 0; t < 2; ++t) {
                fence_regs(ah[b][t]);
                fence_regs(al[b][t]);
              }
          }
          // [phase 1: score]
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          fence_regs(acc[t]);
          fence_regs(acs[t]);
        }
        // this tile's rows, in ascending order: a strictly higher score wins
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wrow + 64 * t + 8 * h + gq;
            if (row < rows) {
#pragma unroll
              for (int i = 0; i < F / 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int x = 4 * i + 2 * h + e;
                  const float sc = 2.f * (acc[t][x] + acs[t][x]) - nrm[t][h];
                  if (sc > best_s[2 * i + e]) {
                    best_s[2 * i + e] = sc;
                    best_i[2 * i + e] = t0 + row;
                  }
                }
            }
          }
      }
      // the warp's best per frame over the lanes of its eight row groups
#pragma unroll
      for (int f = 0; f < NF; ++f) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float os = __shfl_xor_sync(0xffffffffu, best_s[f], off);
          const int oi = __shfl_xor_sync(0xffffffffu, best_i[f], off);
          if (beats(os, oi, best_s[f], best_i[f])) {
            best_s[f] = os;
            best_i[f] = oi;
          }
        }
      }
      if (gq == 0)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          red[warp * F + 8 * (f >> 1) + 2 * tq + (f & 1)] = {best_s[f], best_i[f]};
      consumer_sync();
      // thread (frame f, block dst): the block's best for f over its eight
      // warps, pushed to block dst's candidates [q & 1][rank][f]
      Cand* cq = cand + (q & 1) * kCluster * F;
      for (int e = tid; e < F * cl; e += kConsumers) {
        const int f = e % F, dst = e / F;
        Cand b = red[f];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const Cand o = red[w * F + f];
          if (beats(o.s, o.i, b.s, b.i)) b = o;
        }
        push(&cq[rank * F + f], &xchg[q & 1], dst, b);
      }
      // [phase 2: reduce]
      mbar_wait<true>(&xchg[q & 1], (q >> 1) & 1);
      if (tid == 0) {
        if (q + 2 < n_q) mbar_expect(&xchg[q & 1], xchg_bytes);
        if (rows_staged(F)) mbar_expect(rowbar, static_cast<uint32_t>(4 * F * d));
      }
      if (tid < F) {
        // over the blocks in rank order (ascending rows); `beats` breaks
        // ties by index all the same
        Cand b = cq[tid];
        for (int rr = 1; rr < cl; ++rr) {
          const Cand o = cq[rr * F + tid];
          if (beats(o.s, o.i, b.s, b.i)) b = o;
        }
        // no row scored (non-finite inputs): row 0 keeps the update in range
        const int idx = b.i < v ? b.i : 0;
        if (rank == 0 && frame0 + tid < n) codes[static_cast<size_t>(frame0 + tid) * n_q + q] = idx;
        if (rows_staged(F)) {
          // the winner's row, by the copy engine; the previous level's
          // reads of this buffer are ordered before it
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bulk_copy(rows_s + tid * L.dp, cb + (static_cast<size_t>(q) * v + idx) * d, 4 * d,
                    rowbar);
        } else {
          win[tid] = idx;
        }
      }
      if (rows_staged(F))
        mbar_wait<false>(rowbar, q & 1);
      else
        consumer_sync();
      // [phase 3: exchange]
      // r -= cb[idx], kept as its exact split: element e is float4
      // e % (d / 4) of frame e / (d / 4)
      const int d4 = d / 4;
#pragma unroll 4
      for (int e = tid; e < F * d4; e += kConsumers) {
        const int f = e / d4, k = 4 * (e % d4);
        const int at = res_at<F>(f, k);
        const float4 h = *reinterpret_cast<const float4*>(hi + at);
        const float4 l = *reinterpret_cast<const float4*>(lo + at);
        const float4 w =
            rows_staged(F)
                ? *reinterpret_cast<const float4*>(rows_s + f * L.dp + k)
                : __ldg(reinterpret_cast<const float4*>(
                      cb + (static_cast<size_t>(q) * v + win[f]) * d + k));
        uint4 nh, nl;
        split_exact((h.x + l.x) - w.x, nh.x, nl.x);
        split_exact((h.y + l.y) - w.y, nh.y, nl.y);
        split_exact((h.z + l.z) - w.z, nh.z, nl.z);
        split_exact((h.w + l.w) - w.w, nh.w, nl.w);
        *reinterpret_cast<uint4*>(hi + at) = nh;
        *reinterpret_cast<uint4*>(lo + at) = nl;
      }
      consumer_sync();
      // [phase 4: update]
    }
  }
  cluster.sync();            // no block leaves while a push to it may be in flight
}

constexpr int kMaxDevices = 64;

size_t smem_bytes(int f, int d) { return 1024 + static_cast<size_t>(layout(f, d).total); }

// opted[dev]: the largest dynamic shared memory this kernel was opted in to
// on device dev, so cudaFuncSetAttribute (a costly host call) runs once per
// device and larger size, not once per launch
template <int F>
cudaError_t opt_in(int dev, size_t bytes) {
  static size_t opted[kMaxDevices] = {};
  if (dev < kMaxDevices && opted[dev] >= bytes) return cudaSuccess;
  auto kernel = rvq_encode_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = bytes;
  return err;
}

cudaLaunchConfig_t config(int blocks, size_t bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int F>
cudaError_t launch(int dev, const CUtensorMap& map, const float* x, const float* cb,
                   const float* norms, int* codes, int n, int d, int n_q, int v,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(F, d);
  cudaError_t err = opt_in<F>(dev, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config((n + F - 1) / F * kCluster, bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, rvq_encode_kernel<F>, map, x, cb, norms, codes, n, d, n_q, v);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// The codebooks as a [n_q·v, d] f32 tensor, read in boxes of 128 rows x 32
// columns in the 128-byte swizzle. The last few maps are kept, keyed by
// pointer and shape: a model calls with the same two codebooks again and
// again, and encoding a map is a host call of its own.
bool tensor_map(CUtensorMap* map, const float* cb, int d, int rows) {
  struct Entry {
    const float* p;
    int d, rows;
    CUtensorMap map;
  };
  constexpr int kKept = 8;
  static Entry kept[kKept] = {};
  static int next = 0;
  static std::mutex lock;
  const std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : kept)
    if (e.p == cb && e.d == d && e.rows == rows) {
      *map = e.map;
      return true;
    }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kKc, kTileV};
  const cuuint32_t estrides[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(cb), dims, strides, box,
         estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  kept[next] = {cb, d, rows, *map};
  next = (next + 1) % kKept;
  return true;
}

}  // namespace

// Dynamic shared memory of one block for `frames` frames and dimension d,
// in bytes.
extern "C" int codec_rvq_encode_smem_bytes(int frames, int d) {
  return static_cast<int>(smem_bytes(frames, d));
}

// How many clusters of the `frames` kernel (8 blocks each) the current
// device holds at once for dimension d (cudaOccupancyMaxActiveClusters),
// in *out. Returns a cudaError_t.
extern "C" int codec_rvq_encode_max_clusters(int frames, int d, int* out) {
  if ((frames != 8 && frames != 16 && frames != 32) || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(frames, d);
  err = frames == 32 ? opt_in<32>(dev, bytes)
        : frames == 16 ? opt_in<16>(dev, bytes)
                       : opt_in<8>(dev, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(kCluster * 64, bytes, nullptr, &attr);
  err = frames == 32 ? cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<32>, &cfg)
        : frames == 16 ? cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<16>, &cfg)
                       : cudaOccupancyMaxActiveClusters(out, rvq_encode_kernel<8>, &cfg);
  return static_cast<int>(err);
}

// x f32 [n, d], cb f32 [n_q, v, d], norms f32 [n_q, v] → codes int32 [n, n_q];
// `frames` (32, 16 or 8) per cluster of 8 blocks (ops/rvq_cuda.py::plan).
// d % 4 == 0 and cb 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int codec_rvq_encode(const void* x, const void* cb, const void* norms, void* codes,
                                int n, int d, int n_q, int v, int frames, void* stream) {
  if (n < 1 || d < 1 || n_q < 1 || v < 1 || d % 4 ||
      (frames != 8 && frames != 16 && frames != 32) || reinterpret_cast<uintptr_t>(cb) % 16 ||
      static_cast<long long>(n_q) * v >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* cbf = static_cast<const float*>(cb);
  CUtensorMap map;
  if (!tensor_map(&map, cbf, d, n_q * v)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(norms);
  int* out = static_cast<int*>(codes);
  return static_cast<int>(
      frames == 32 ? launch<32>(dev, map, xf, cbf, nf, out, n, d, n_q, v, s)
      : frames == 16 ? launch<16>(dev, map, xf, cbf, nf, out, n, d, n_q, v, s)
                     : launch<8>(dev, map, xf, cbf, nf, out, n, d, n_q, v, s));
}
