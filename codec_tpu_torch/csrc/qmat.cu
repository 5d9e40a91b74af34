// Dequantizing matrix products over packed GGUF weights for Hopper (sm_90a).
//
// Replaces the TPU kernels codec_tpu/ops/qmat_pallas.py:171 q8_0_matmul
// (_q8_kernel) and :200 q4_k_matmul (_q4k_kernel): y[m, out] = x[m, in] @
// dequant(W)[out, in]^T in f32, for the llama backbone's layer matrices
// at m <= 32 rows (one per decode step, up to 32 for a bucketed prefill).
// The weights stay packed in device memory (ops/qmat.py, natural order):
//   Q8_0: qs int8 [out, in], scale f32 [out, in/32]
//   Q4_K: qs uint8 [out, in/2] (the 16 bytes of 32-group g hold element
//         32g+j in the low nibble and 32g+16+j in the high one),
//         scale and minv f32 [out, in/32]
// x is f32 or bf16, contiguous [m, in]; y is f32 [m, out].
//
// What bounds them on this card. At m = 1 each packed weight byte feeds
// 1.8 (Q8_0, 1.125 B/weight) or 2.7 (Q4_K, 0.75 B/weight) FLOP, far below
// the ~20 FLOP per byte at which 67 TFLOP/s of f32 FMA outruns 3.35 TB/s:
// the bytes of the packed weights bound them, and a real forward finds
// every matrix cold in HBM. At m = 16-32 the FMAs (2·m·in·out) bound them.
// Three things stand in the way: the instructions spent per weight (an
// int→float conversion, I2F, issues at 16 per clock per SM against 128 for
// f32 FMAs, so one I2F per weight alone takes longer than Q4_K's bound),
// too few bytes in flight (~1 µs of HBM latency at 3.35 TB/s needs ~25 KB
// in flight per SM), and, for the small matrices, the fixed latency of a
// launch that a card-filling grid has to hide.
//
// How the design answers that.
//  1. Exact dequantization at full rate, no I2F: a byte permute builds the
//     float 2^23 + u from a byte u (__byte_perm into 0x4B0000uu), and one
//     subtraction gives u exactly (Q8_0's signed bytes go in as q ^ 0x80
//     and come out minus 2^23 + 128). The scale and min are applied once
//     per 32-group, in the TPU kernel's factorised form
//     (qmat_pallas.py:19,209): s·Σq·x − mn·Σx for Q4_K, s·Σq·x for Q8_0,
//     with Σq·x an f32 FMA chain over the group and Σx per group computed
//     once per block when x is staged. That is two instructions per weight
//     besides the FMA, against four in the form q·s − mn per weight. With
//     x a one-hot row Σq·x = q and Σx = 1 exactly, so the products and the
//     difference, each explicitly rounded (__fmul_rn, __fsub_rn: nvcc may
//     not contract them), give GGUF's dequantized weight bit for bit.
//  2. Weights streamed through shared memory. A block owns 32 output rows
//     and one slice of K, walked in chunks of kc columns through a ring of
//     1-4 stages (up to 72 KB of Q8_0, 48 KB of Q4_K at kc = 512). One
//     producer thread fills a stage with a handful of 2-D bulk tensor
//     copies (cp.async.bulk.tensor through tensor maps made on the host
//     per launch: boxes of 32 rows × 128 bytes of qs, one box of 32 rows
//     of scales, one of mins), which complete on the stage's mbarrier,
//     while four consumer warps work on the stages that have landed and
//     release each through a second mbarrier. The producer starts after
//     the block's first barrier, so that its copies overlap the
//     consumers' staging of x. A bulk copy per row (cp.async.bulk) would
//     take 64-96 copy instructions per stage, which the copy engine works
//     through one at a time: the first chunk then lands late. The boxes
//     keep it to 3-6. qs boxes land in the 128-byte swizzle, so the 8
//     rows a quarter-warp reads at one K position sit in distinct banks.
//     Tensor maps need 16-byte row strides: a Q8_0 width with
//     in % 128 != 0 (scale rows not 16-byte aligned) takes the cp.async
//     instantiation of the same kernel (the producer warp's 16-byte pieces
//     of qs and 4-byte scales, into the same swizzled layout, completing
//     on the same mbarrier), chosen by shape before the launch.
//  3. x staged once per block in shared memory, as f32 (bf16 converted
//     once), in passes of at most 64 KB. Each consumer thread keeps 4
//     output rows × up to 8 rows of x in registers at the same K position,
//     so one x value read from shared memory feeds 4 rows' FMAs, and the 8
//     lanes of a quarter-warp read the same x (a broadcast).
//  4. Cluster split-K. The K slices of a row tile are the blocks of one
//     thread-block cluster (1-8 blocks, plan.split). Each block reduces its
//     threads' partial sums in a fixed order (shuffles over a warp's K
//     positions, then its warps through shared memory) and stores them
//     into a slot of the cluster's first block through distributed shared
//     memory; one thread per block then arrives, releasing at cluster
//     scope, on that block's mbarrier, and the first block, once all have
//     arrived, sums the slots in rank order and writes y: one launch, no
//     atomics, no cluster-wide barrier at the end, results bit-identical
//     from run to run. A cluster costs about as much as a block's slice of
//     ~2048 columns saves (tools/qmat_plans.py on the H100), so the plan
//     takes the fewest slices that put 64 blocks of at most 4096 columns
//     on the card: 512 rows × 2048 in 16 row tiles × 4 slices, 2048 ×
//     8192 in 64 × 2.
//  5. m up to 32 in buckets 1/2/4/8/16/32; above 8 the rows of x are split
//     over the consumer warps (2 or 4 groups of 8), each dequantizing its
//     own copy of the weights. Tensor cores are not used: bf16 or TF32
//     operands cannot hold the f32 tolerance of 1e-4·max|plain|.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;                          // output rows per block
constexpr int kRowGroups = 8;                      // lanes along rows
constexpr int kRowsPerThread = kRows / kRowGroups; // 4
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;          // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;
constexpr int kBox = 128;                          // qs bytes per box row
constexpr int kBoxBytes = kRows * kBox;            // one swizzled qs box
constexpr int kXPad = 4;                           // floats after a staged x row

enum Kind { kQ8 = 0, kQ4K = 1 };

struct Args {
  CUtensorMap tm_qs, tm_sc, tm_mn;                 // BULK only
  const void* x;
  const uint8_t* qs;
  const float* scale;
  float* y;
  int m, in, out, kc, xk, kslice, stages, split;
};

// Byte offsets of the dynamic shared memory from its 1024-aligned base:
// 2·kMaxStages mbarriers, the stages (qs boxes, then scales, then mins),
// x (whose space takes the consumers' partial sums after the loop), Σx per
// group (Q4_K), and the cluster's slots (split > 1).
struct Layout {
  int sc_off, mn_off, stage_bytes, x_stride;
  int off_stages, off_x, off_xs, off_slots, total;
};

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

__host__ __device__ inline Layout layout(int kind, int mb, int kc, int xk, int stages,
                                         int split) {
  Layout l;
  l.sc_off = round_up(kind == kQ8 ? kc : kc / 2, kBox) * kRows;
  l.mn_off = l.sc_off + kRows * kc / 8;
  l.stage_bytes = round_up(l.mn_off + (kind == kQ4K ? kRows * kc / 8 : 0), 1024);
  l.x_stride = xk + kXPad;
  const int mt = mb < 8 ? mb : 8;
  const int x_bytes = 4 * mb * l.x_stride;
  const int red_bytes = 4 * 4 * mt * kRows;       // (4 / MG)·mb·kRows floats
  l.off_stages = 1024;
  l.off_x = l.off_stages + stages * l.stage_bytes;
  l.off_xs = l.off_x + round_up(x_bytes > red_bytes ? x_bytes : red_bytes, 128);
  l.off_slots = l.off_xs + round_up(kind == kQ4K ? 4 * mb * (xk / 32) : 0, 128);
  l.total = l.off_slots + (split > 1 ? 4 * split * mb * kRows : 0) + 1024;  // + alignment
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the consumer warps alone
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// one arrival, releasing at cluster scope, on bar in the cluster's block 0
__device__ __forceinline__ void mbar_arrive_remote0(uint64_t* bar) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(remote) : "r"(smem_u32(bar)));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte b of w as the float 2^23 + byte: exact
__device__ __forceinline__ float magic(uint32_t w, int b) {
  return __int_as_float(static_cast<int>(__byte_perm(w, 0x4B000000u, 0x7540u | b)));
}

// 16-byte piece p (of kBox / 16 per box row) of row r in the 128-byte
// swizzle the tensor copies write: piece p of a box row sits at p ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int byte) {
  return (byte / kBox) * kBoxBytes + r * kBox + ((((byte % kBox) >> 4) ^ (r & 7)) << 4);
}

// One thread's tensor copies of the chunk at column k0 into stage s
template <int KIND>
__device__ __forceinline__ void issue_chunk(const Args& a, unsigned char* base, const Layout& l,
                                            uint64_t* full, int s, int row0, int k0) {
  const int qbytes = KIND == kQ8 ? a.kc : a.kc / 2;  // per row and chunk
  unsigned char* st = base + l.off_stages + s * l.stage_bytes;
  mbar_arrive_expect_tx(full + s, kRows * (qbytes + a.kc / 8 * (KIND == kQ4K ? 2 : 1)));
  const int q0 = KIND == kQ8 ? k0 : k0 / 2;
  for (int b = 0; b < qbytes; b += kBox)
    tensor_copy(st + (b / kBox) * kBoxBytes, &a.tm_qs, q0 + b, row0, full + s);
  tensor_copy(st + l.sc_off, &a.tm_sc, k0 / 32, row0, full + s);
  if (KIND == kQ4K) tensor_copy(st + l.mn_off, &a.tm_mn, k0 / 32, row0, full + s);
}

// The producer warp: chunk c of the block's K slice into stage c % stages,
// once the consumers have released that stage's previous chunk.
template <int KIND, bool BULK>
__device__ __forceinline__ void produce(const Args& a, unsigned char* base, const Layout& l,
                                        uint64_t* full, uint64_t* empty, int row0, int k_lo,
                                        int lane) {
  const int qbytes = KIND == kQ8 ? a.kc : a.kc / 2;  // per row and chunk
  const int groups = a.kc / 32;
  // Counters, not divisions: a runtime integer division costs an I2F
  int s = 0, phase = 0;
  for (int k0 = k_lo; k0 < k_lo + a.kslice; k0 += a.kc) {
    if (phase) mbar_wait(empty + s, (phase - 1) & 1);
    unsigned char* st = base + l.off_stages + s * l.stage_bytes;
    if (BULK) {
      if (lane == 0) issue_chunk<KIND>(a, base, l, full, s, row0, k0);
      __syncwarp();
    } else {
      const int rows = min(kRows, a.out - row0);
      const uint8_t* qsrc = a.qs + static_cast<size_t>(row0) * a.in + k0;
      const float* ssrc = a.scale + static_cast<size_t>(row0) * (a.in / 32) + k0 / 32;
      float* sc = reinterpret_cast<float*>(st + l.sc_off);
      for (int r = 0; r < rows; ++r) {
        for (int p = 16 * lane; p < qbytes; p += 16 * 32)
          cp_async16(st + swizzled(r, p), qsrc + static_cast<size_t>(r) * a.in + p);
        for (int g = lane; g < groups; g += 32)
          cp_async4(sc + r * groups + g, ssrc + static_cast<size_t>(r) * (a.in / 32) + g);
      }
      cp_async_arrive(full + s);
    }
    if (++s == a.stages) {
      s = 0;
      ++phase;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_x(const Args& a, float* x_s, int mb, int stride, int k0,
                                        int cols, int t);

template <>
__device__ __forceinline__ void stage_x<float>(const Args& a, float* x_s, int mb, int stride,
                                               int k0, int cols, int t) {
  const float* x = static_cast<const float*>(a.x);
  for (int i = 0; i < mb; ++i)
    for (int k = 4 * t; k < cols; k += 4 * kConsumers) {
      const float4 v = i < a.m ? __ldg(reinterpret_cast<const float4*>(
                                     x + static_cast<size_t>(i) * a.in + k0 + k))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(x_s + i * stride + k) = v;
    }
}

template <>
__device__ __forceinline__ void stage_x<__nv_bfloat16>(const Args& a, float* x_s, int mb,
                                                       int stride, int k0, int cols, int t) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  for (int i = 0; i < mb; ++i)
    for (int k = 8 * t; k < cols; k += 8 * kConsumers) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (i < a.m)
        u = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(i) * a.in + k0 + k));
      float* d = x_s + i * stride + k;
#pragma unroll
      for (int h = 0; h < 4; ++h) {                // a bf16 is an f32's high half
        const uint32_t w = word(u, h);
        d[2 * h] = __uint_as_float(w << 16);
        d[2 * h + 1] = __uint_as_float(w & 0xFFFF0000u);
      }
    }
}

// The consumer warps: every chunk of the slice, then the block's sums in
// the x space as red [4 / MG][MB][kRows] (rows past m hold the zero rows of
// x's bucket).
template <int KIND, int MB, typename T>
__device__ __forceinline__ void consume(const Args& a, unsigned char* base, const Layout& l,
                                        uint64_t* full, uint64_t* empty, int k_lo, int warp,
                                        int lane) {
  constexpr int MT = MB < 8 ? MB : 8;                // rows of x per thread
  constexpr int MG = MB / MT;                        // groups of x rows
  constexpr int KG = 16 / MG;                        // threads along K
  constexpr int RT = kRowsPerThread;
  const int t = warp * 32 + lane;
  const int rg = lane % kRowGroups;
  const int mg = warp % MG;
  const int kg = lane / kRowGroups + 4 * (warp / MG);
  float* x_s = reinterpret_cast<float*>(base + l.off_x);
  float* xs_s = reinterpret_cast<float*>(base + l.off_xs);
  const int xgroups = a.xk / 32;
  const int groups = a.kc / 32;

  float acc[MT][RT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;

  int s = 0, phase = 0;                              // the stage of the next chunk
  for (int p0 = 0; p0 < a.kslice; p0 += a.xk) {
    if (p0) consumer_sync();                         // the last pass's x is read
    stage_x<T>(a, x_s, MB, l.x_stride, k_lo + p0, a.xk, t);
    consumer_sync();
    if (KIND == kQ4K) {
      // Σx per (x row i, group g), the MB·xgroups pairs spread over the
      // consumers (stepped without divisions). A group is 8 float4s, and
      // each lane starts at its own, so that the 8 lanes of a quarter-warp
      // (groups 128 bytes apart) read 8 distinct 16-byte bank groups
      int i = 0, g = t;
      while (g >= xgroups) g -= xgroups, ++i;
      while (i < MB) {
        const float4* xr = reinterpret_cast<const float4*>(x_s + i * l.x_stride + 32 * g);
        float v = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 q = xr[(u + lane) & 7];
          v += q.x;
          v += q.y;
          v += q.z;
          v += q.w;
        }
        xs_s[i * xgroups + g] = v;
        for (g += kConsumers; g >= xgroups;) g -= xgroups, ++i;
      }
      consumer_sync();
    }
    for (int cg0 = 0; cg0 < xgroups; cg0 += groups) {  // a chunk's first group
      mbar_wait(full + s, phase & 1);
      const unsigned char* st = base + l.off_stages + s * l.stage_bytes;
      const float* sc = reinterpret_cast<const float*>(st + l.sc_off);
      const float* mn = reinterpret_cast<const float*>(st + l.mn_off);
      for (int g = kg; g < groups; g += KG) {
        const int gx = cg0 + g;                      // group within the pass
        uint4 q[RT][KIND == kQ8 ? 2 : 1];
        float s_[RT], m_[RT];
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int r = rg + kRowGroups * j;
          if constexpr (KIND == kQ8) {
            q[j][0] = *reinterpret_cast<const uint4*>(st + swizzled(r, 32 * g));
            q[j][1] = *reinterpret_cast<const uint4*>(st + swizzled(r, 32 * g + 16));
          } else {
            q[j][0] = *reinterpret_cast<const uint4*>(st + swizzled(r, 16 * g));
          }
          s_[j] = sc[r * groups + g];
          m_[j] = KIND == kQ4K ? mn[r * groups + g] : 0.f;
        }
        float qx[MT][RT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) qx[i][j] = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {             // elements 4·c4 .. 4·c4+3
          float w[RT][4];
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            uint32_t v;
            float bias;
            if constexpr (KIND == kQ8) {
              v = word(q[j][c4 / 4], c4 % 4) ^ 0x80808080u;
              bias = 8388736.0f;                     // 2^23 + 128
            } else {
              v = c4 < 4 ? word(q[j][0], c4) & 0x0F0F0F0Fu
                         : (word(q[j][0], c4 - 4) >> 4) & 0x0F0F0F0Fu;
              bias = 8388608.0f;                     // 2^23
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) w[j][b] = magic(v, b) - bias;
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(
                x_s + (mg * MT + i) * l.x_stride + 32 * gx + 4 * c4);
#pragma unroll
            for (int j = 0; j < RT; ++j) {
              qx[i][j] = fmaf(w[j][0], xv.x, qx[i][j]);
              qx[i][j] = fmaf(w[j][1], xv.y, qx[i][j]);
              qx[i][j] = fmaf(w[j][2], xv.z, qx[i][j]);
              qx[i][j] = fmaf(w[j][3], xv.w, qx[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xsum = KIND == kQ4K ? xs_s[(mg * MT + i) * xgroups + gx] : 0.f;
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            const float v = __fmul_rn(s_[j], qx[i][j]);
            acc[i][j] += KIND == kQ4K ? __fsub_rn(v, __fmul_rn(m_[j], xsum)) : v;
          }
        }
      }
      mbar_arrive(empty + s);                        // done with this stage
      if (++s == a.stages) {
        s = 0;
        ++phase;
      }
    }
  }
  // the warp's 4 K positions (lanes 8 apart) by shuffles, then the warps
  // of an x-row group through red [KG / 4][MB][kRows]: a fixed order
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
    }
  consumer_sync();                                   // x is no longer read
  float* red = x_s;
  if (lane < kRowGroups) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j)
        red[((warp / MG) * MB + mg * MT + i) * kRows + rg + kRowGroups * j] = acc[i][j];
  }
  consumer_sync();
}

template <int KIND, bool BULK, int MB, typename T>
__device__ __forceinline__ void qmat_body(const Args& a) {
  constexpr int KW = 4 / (MB / (MB < 8 ? MB : 8));  // warps per x-row group
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzled boxes need a 1024-byte-aligned base
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  const int split = a.split;
  const int rank = blockIdx.x;                       // the cluster spans the grid's x
  const int row0 = blockIdx.y * kRows;
  const int k_lo = rank * a.kslice;
  const Layout l = layout(KIND, MB, a.kc, a.xk, a.stages, split);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxStages;
  uint64_t* done = empty + kMaxStages;               // block 0's: the other blocks' slots
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == kConsumers) {                   // the producer's first lane
    if (BULK) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a.tm_qs))
                   : "memory");
    }
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, BULK ? 1 : 32);
      mbar_init(empty + s, kConsumers);
    }
    if (split > 1 && rank == 0) mbar_init(done, split - 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (split > 1) cluster_arrive_relaxed();           // waited for before the slots are written
  __syncthreads();
  if (warp == kConsumerWarps) {
    produce<KIND, BULK>(a, base, l, full, empty, row0, k_lo, lane);
    // tensor copies complete without their thread; cp.async ones land first
    if (!BULK) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  consume<KIND, MB, T>(a, base, l, full, empty, k_lo, warp, lane);
  // the consumers from here on. red [KW][MB][kRows] in the x space:
  // summed over K in a fixed order
  const float* red = reinterpret_cast<const float*>(base + l.off_x);
  if (split == 1) {
    for (int e = threadIdx.x; e < MB * kRows; e += kConsumers) {
      const int i = e / kRows, r = e % kRows;
      if (i < a.m && row0 + r < a.out) {
        float v = red[e];
#pragma unroll
        for (int k = 1; k < KW; ++k) v += red[k * MB * kRows + e];
        a.y[static_cast<size_t>(i) * a.out + row0 + r] = v;
      }
    }
    return;
  }
  // split-K: every block's sums into its slot of the first block, which
  // sums the slots in rank order
  cg::cluster_group cluster = cg::this_cluster();
  float* slots = reinterpret_cast<float*>(base + l.off_slots);
  cluster_wait();                                    // every block has started
  float* dst = cluster.map_shared_rank(slots, 0) + rank * MB * kRows;
  for (int e = threadIdx.x; e < MB * kRows; e += kConsumers) {
    float v = red[e];
#pragma unroll
    for (int k = 1; k < KW; ++k) v += red[k * MB * kRows + e];
    dst[e] = v;
  }
  consumer_sync();                                   // the block's slot is written
  if (rank != 0) {
    if (threadIdx.x == 0) mbar_arrive_remote0(done);
    return;
  }
  mbar_wait_cluster(done, 0);                        // every other block's slot
  for (int e = threadIdx.x; e < MB * kRows; e += kConsumers) {
    const int i = e / kRows, r = e % kRows;
    if (i < a.m && row0 + r < a.out) {
      float v = slots[e];
#pragma unroll
      for (int b = 1; b < kMaxSplit; ++b)
        if (b < split) v += slots[b * MB * kRows + e];
      a.y[static_cast<size_t>(i) * a.out + row0 + r] = v;
    }
  }
}

template <bool BULK, int MB, typename T>
__global__ void __launch_bounds__(kThreads, 1) q8_0_matmul_kernel(const __grid_constant__ Args a) {
  qmat_body<kQ8, BULK, MB, T>(a);
}

template <int MB, typename T>
__global__ void __launch_bounds__(kThreads, 1) q4_k_matmul_kernel(const __grid_constant__ Args a) {
  qmat_body<kQ4K, true, MB, T>(a);
}

constexpr int kMaxDevices = 64;

template <void (*kernel)(const Args)>
cudaError_t launch(int kind, int mb, const Args& a, cudaStream_t stream) {
  // opted[dev]: the largest dynamic shared memory this kernel was opted in
  // to on device dev (cudaFuncSetAttribute is a costly host call)
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int bytes = layout(kind, mb, a.kc, a.xk, a.stages, a.split).total;
  if (dev >= kMaxDevices || opted[dev] < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split, (a.out + kRows - 1) / kRows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// m rounded up to its register bucket
#define QMAT_BUCKETS(CALL)            \
  if (a.m <= 1) return CALL(1);       \
  if (a.m <= 2) return CALL(2);       \
  if (a.m <= 4) return CALL(4);       \
  if (a.m <= 8) return CALL(8);       \
  if (a.m <= 16) return CALL(16);     \
  return CALL(32)

template <bool BULK, typename T>
cudaError_t dispatch_q8(const Args& a, cudaStream_t s) {
#define Q8_CALL(MB) launch<q8_0_matmul_kernel<BULK, MB, T>>(kQ8, MB, a, s)
  QMAT_BUCKETS(Q8_CALL);
#undef Q8_CALL
}

template <typename T>
cudaError_t dispatch_q4k(const Args& a, cudaStream_t s) {
#define Q4K_CALL(MB) launch<q4_k_matmul_kernel<MB, T>>(kQ4K, MB, a, s)
  QMAT_BUCKETS(Q4K_CALL);
#undef Q4K_CALL
}

// The plan's invariants (ops/qmat_cuda.py::plan): K splits into `split`
// equal slices of whole chunks of kc columns, x passes of xk columns are
// whole chunks, and tensor copies (bulk: Q4_K, or Q8_0 with in % 128 == 0)
// take whole 128-column chunks.
bool plan_ok(int kind, const Args& a, bool bulk) {
  if (a.m < 1 || a.m > 32 || a.out < 1 || a.in < 32 || a.in % 32) return false;
  if (kind == kQ4K && a.in % 256) return false;
  if (a.split < 1 || a.split > kMaxSplit || a.in % a.split) return false;
  if (a.kc < 32 || a.kc % (bulk ? 128 : 32) || a.kslice % a.kc) return false;
  if (kind == kQ4K && a.kc % 256) return false;     // whole qs boxes
  if (a.xk < a.kc || a.xk % a.kc || a.kslice % a.xk) return false;
  return a.stages >= 1 && a.stages <= kMaxStages && a.stages * a.kc <= a.kslice;
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

// A [rows, cols] row-major tensor of `elem`-byte elements, read in boxes of
// kRows rows × box_cols (qs: 128 bytes in the 128-byte swizzle)
bool tensor_map(CUtensorMap* map, const void* p, bool f32, uint64_t cols, uint64_t rows,
                uint32_t box_cols) {
  const EncodeTiled fn = encode_tiled();
  const uint64_t elem = f32 ? 4 : 1;
  if (fn == nullptr || reinterpret_cast<uintptr_t>(p) % 16 || (cols * elem) % 16) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, static_cast<cuuint32_t>(kRows)};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(p), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// dtype of x: 0 = f32, 1 = bf16; split, kc, xk, stages: the launch plan
// (ops/qmat_cuda.py::plan). Returns a cudaError_t (0 = launched).
extern "C" int codec_q8_0_matmul(const void* x, const void* qs, const void* scale, void* y,
                                 int m, int in_dim, int out_dim, int dtype, int split,
                                 int kc, int xk, int stages, void* stream) {
  Args a{};
  a.x = x;
  a.qs = static_cast<const uint8_t*>(qs);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.m = m, a.in = in_dim, a.out = out_dim, a.kc = kc, a.xk = xk, a.stages = stages;
  a.split = split;
  a.kslice = split > 0 ? in_dim / split : 0;
  const bool bulk = in_dim % 128 == 0;
  if (!plan_ok(kQ8, a, bulk) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    if (!tensor_map(&a.tm_qs, qs, false, in_dim, out_dim, kBox) ||
        !tensor_map(&a.tm_sc, scale, true, in_dim / 32, out_dim, kc / 32))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dtype == 0 ? dispatch_q8<true, float>(a, s)
                                       : dispatch_q8<true, __nv_bfloat16>(a, s));
  }
  return static_cast<int>(dtype == 0 ? dispatch_q8<false, float>(a, s)
                                     : dispatch_q8<false, __nv_bfloat16>(a, s));
}

extern "C" int codec_q4_k_matmul(const void* x, const void* qs, const void* scale,
                                 const void* minv, void* y, int m, int in_dim, int out_dim,
                                 int dtype, int split, int kc, int xk, int stages,
                                 void* stream) {
  Args a{};
  a.x = x;
  a.qs = static_cast<const uint8_t*>(qs);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.m = m, a.in = in_dim, a.out = out_dim, a.kc = kc, a.xk = xk, a.stages = stages;
  a.split = split;
  a.kslice = split > 0 ? in_dim / split : 0;
  if (!plan_ok(kQ4K, a, true) || (dtype != 0 && dtype != 1) ||
      !tensor_map(&a.tm_qs, qs, false, in_dim / 2, out_dim, kBox) ||
      !tensor_map(&a.tm_sc, scale, true, in_dim / 32, out_dim, kc / 32) ||
      !tensor_map(&a.tm_mn, minv, true, in_dim / 32, out_dim, kc / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch_q4k<float>(a, s)
                                     : dispatch_q4k<__nv_bfloat16>(a, s));
}
