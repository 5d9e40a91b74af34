// Building blocks of the DAC residual-unit kernels (seanet_res.cu) for
// Hopper (sm_90a): a ring of weight tiles fed by TMA (cp.async.bulk.tensor,
// completing on mbarriers) from a producer warpgroup, and the two tile
// policies of the [rows, C_in] x [C_in, C_out] products that eight consumer
// warps run on it: f32 on the FMA units (Fma) and bf16 or f16 on the tensor
// cores through wgmma (Wg). Everything is in an anonymous namespace: each source
// that includes this header compiles its own copy. SNAC's 1x1 runs on them
// too (seanet_res.cu::codec_snac_res_unit); SNAC's chain keeps its own
// building blocks (seanet_tiles.cuh).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumers = 256;                  // 8 warps: two warpgroups
constexpr int kBlockThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 1024;             // full[] and empty[] barriers
constexpr int kBoxBytes = 8192;                 // one [64][64] bf16 weight box

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

// box (c0, c1, c2) of a 3-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// fetch a tensor map's descriptor ahead of its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the consumer warps alone
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The producer warpgroup gives up registers (one thread of it issues the
// copies) and the two consumer warpgroups take them: 2 x 128 x CONSUMER +
// 128 x PRODUCER registers, within the 168 a thread of the 384 gets at
// launch.
template <int PRODUCER>
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER) : "memory");
}
template <int CONSUMER>
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The ring of weight tiles: stage s holds one (pass, input chunk, tap)
// step's tile; full[s] completes when the tile has landed (the producer's
// expect_tx and TMA's bytes), empty[s] when all eight consumer warps are
// done with it. Producer and consumers walk the same steps in the same
// order, each with its own copy of (stage, phase).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* tiles;
  int stages, stage_bytes;
  int stage = 0;
  uint32_t phase = 0;
  __device__ unsigned char* tile() const { return tiles + stage * stage_bytes; }
  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A's row r from channel k on (k a multiple of 16 bytes): with kSwz, a TMA
// box of 128-byte rows in the 128-byte swizzle (16-byte chunk c of row r
// lies at chunk c ^ (r % 8); the box starts on a 1024-byte boundary), else
// rows of a_stride elements.
template <bool kSwz, typename Op>
__device__ __forceinline__ const Op* a_at(const Op* A, int a_stride, int r, int k) {
  constexpr int kPer = 16 / sizeof(Op);     // elements per 16-byte chunk
  if constexpr (kSwz)
    return A + r * (128 / sizeof(Op)) + (((k / kPer) ^ (r & 7)) * kPer) + k % kPer;
  else
    return A + r * a_stride + k;
}

// -- tile policies -----------------------------------------------------------
//
// A block's consumers compute a [kM, kNP] pass of a product; input
// channels come in chunks of kKc (128 bytes), as A [rows][kKc] in Op (a_at:
// TMA's swizzled slots, or the chain's padded rows of kAStride), the
// weights of each (chunk, tap) step as W [kKc][kNP] through the ring.
// each(acc, f) calls f(row, col, value) for every output the thread holds
// (value a float&).

// f32 on the FMA units. Warp w owns rows 32 (w % kWM) + [0, 32) and
// columns 64 (w / kWM) + [0, 64); its lanes form a 4 x 8 grid, lane l
// owning rows l % 4 + 4 i and columns 4 (l / 4) + j, 32 + 4 (l / 4) + j
// (i < 8, j < 4): 8 x 8 outputs. Per 4 input channels a lane reads 8
// float4 of A (one per row; the 4 consecutive rows of a load fall in
// distinct bank groups, by the swizzle or the padded stride, each read by
// 8 lanes at once) and per channel 2 float4 of W (the 8 column groups fill
// 128 contiguous bytes): 4 loads and 4 shared-memory wavefronts per 64
// FFMA.
template <int WN>
struct Fma {
  static_assert(WN == 1 || WN == 2 || WN == 4, "1, 2 or 4 warps along N");
  using Op = float;
  static constexpr int kWM = kConsumerWarps / WN;
  static constexpr int kM = 32 * kWM, kNP = 64 * WN, kKc = 32;
  static constexpr int kAStride = kKc + 4;
  static constexpr int kStageBytes = kKc * kNP * 4;
  static constexpr int kBoxCols = kNP, kBoxes = 1;
  static constexpr bool kSwizzle = false;
  struct Acc {
    float v[8][8];
  };
  __device__ static int row(int i) {
    return ((threadIdx.x >> 5) % kWM) * 32 + (threadIdx.x & 3) + 4 * i;
  }
  __device__ static int col(int j) {
    return ((threadIdx.x >> 5) / kWM) * 64 + 4 * ((threadIdx.x & 31) >> 2) + (j & 3) +
           32 * (j >> 2);
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.0f;
  }
  // acc[i][j] += sum_k A[row(i) + shift][k] W[k][col(j)] over kKc k; A
  // as a_at reads it
  template <bool kSwz>
  __device__ static void accumulate(Acc& acc, const Op* A, int a_stride, int shift,
                                    const Op* W) {
    const int r0 = row(0) + shift;
    const Op* w_base = W + col(0);
#pragma unroll 2
    for (int k = 0; k < kKc; k += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_at<kSwz>(A, a_stride, r0 + 4 * i, k));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(w_base + (k + kk) * kNP);
        const float4 w1 = *reinterpret_cast<const float4*>(w_base + (k + kk) * kNP + 32);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(av, w[j], acc.v[i][j]);
        }
      }
    }
  }
  template <typename F>
  __device__ static void each(Acc& acc, F f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(row(i), col(j), acc.v[i][j]);
  }
  // f(row, col, v0, v1) for the pairs of adjacent columns (col even)
  template <typename F>
  __device__ static void each_pair(Acc& acc, F f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 2) f(row(i), col(j), acc.v[i][j], acc.v[i][j + 1]);
  }
  // the same with v0, v1 as float&
  template <typename F>
  __device__ static void each_pair_ref(Acc& acc, F f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 2) f(row(i), col(j), acc.v[i][j], acc.v[i][j + 1]);
  }
};

#define SEANET_WGMMA_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

template <typename Op>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (std::is_same_v<Op, __half>) SEANET_WGMMA_N64("f16");
  else SEANET_WGMMA_N64("bf16");
}

#define SEANET_WGMMA_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

template <typename Op>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (std::is_same_v<Op, __half>) SEANET_WGMMA_N128("f16");
  else SEANET_WGMMA_N128("bf16");
}

#define SEANET_WGMMA_N192(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1))

template <typename Op>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (std::is_same_v<Op, __half>) SEANET_WGMMA_N192("f16");
  else SEANET_WGMMA_N192("bf16");
}

// bf16 or f16 (OpT) on the tensor cores: wgmma m64nNPk16, f32 accumulators. Warpgroup g
// (warps 4g-4g+3) owns rows 64 MT g + [0, 64 MT) in MT tiles of 64 rows,
// warp w the 16 rows 16 (w % 4) + [0, 16) of each. A comes from
// registers, by ldmatrix at any row: a tap's shift j d need not fall on the
// 8-row atom a shared-memory descriptor must start on. B, the weight tile
// [64 ci][kNP co], comes from shared memory through a descriptor: TMA wrote
// it as kNP / 64 boxes [64][64] in the 128-byte swizzle with C_out
// contiguous (MN-major: the transpose bit). acc.v[t][4 i + 2 h + e] is row
// g + 8 h of the warp's 16 in tile t, column 8 i + 2 q + e (g = lane / 4,
// q = lane % 4): wgmma's accumulator layout. MT = 2 halves the weight bytes
// per product (256 rows share each tile) at the cost of NP accumulator
// registers per thread.
template <int NP, int MT, typename OpT = __nv_bfloat16>
struct Wg {
  static_assert(NP == 64 || NP == 128 || NP == 192, "64 to 192 columns");
  static_assert(MT == 1 || MT == 2, "one or two 64-row tiles per warpgroup");
  static_assert(MT * NP <= 256, "at most 128 accumulators a thread");
  using Op = OpT;
  static constexpr int kM = 128 * MT, kNP = NP, kKc = 64;
  static constexpr int kAStride = kKc + 8;   // 144-byte rows: an ldmatrix's 8 rows
                                             // fall in distinct bank groups
  static constexpr int kStageBytes = kKc * NP * 2;
  static constexpr int kBoxCols = 64, kBoxes = NP / 64;
  static constexpr bool kSwizzle = true;
  struct Acc {
    float v[MT][NP / 2];
  };
  __device__ static int row0(int t) {
    const int w = threadIdx.x >> 5;
    return 64 * MT * (w >> 2) + 64 * t + 16 * (w & 3);
  }
  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc.v[t][i] = 0.0f;
  }
  // the compiler must not move accesses of acc across the asynchronous
  // product (CUTLASS's warpgroup_fence_operand)
  __device__ static void fence(Acc& acc) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) asm volatile("" : "+f"(acc.v[t][i])::"memory");
  }
  // B's descriptor: start address, leading offset = the next 64 output
  // columns (the next box), stride offset = the next 8 input channels
  // (1024 bytes), 128-byte swizzle
  __device__ static uint64_t desc(uint32_t addr) {
    return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
           static_cast<uint64_t>(kBoxBytes >> 4) << 16 |
           static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
  }
  __device__ static void mma(float (&d)[NP / 2], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (NP == 64) wgmma_n64<Op>(d, a, b);
    else if constexpr (NP == 128) wgmma_n128<Op>(d, a, b);
    else wgmma_n192<Op>(d, a, b);
  }
  // acc += A[rows + shift][0:64] @ W over the stage's 64 input channels;
  // A as a_at reads it
  template <bool kSwz>
  __device__ static void accumulate(Acc& acc, const Op* A, int a_stride, int shift,
                                    const Op* W) {
    const int lane = threadIdx.x & 31;
    uint32_t a[MT][4][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      // lanes 0-15 address rows 0-15 at column 16 ks, lanes 16-31 at 16 ks + 8
      const int r = row0(t) + (lane & 15) + shift;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[t][ks][0]), "=r"(a[t][ks][1]), "=r"(a[t][ks][2]), "=r"(a[t][ks][3])
                     : "r"(smem_u32(a_at<kSwz>(A, a_stride, r, 16 * ks + 8 * (lane >> 4)))));
    }
    const uint32_t w = smem_u32(W);
    fence(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int t = 0; t < MT; ++t) mma(acc.v[t], a[t][ks], desc(w + ks * 2048));  // 16 rows of 128 B
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence(acc);
    // keep the A fragments unmodified until the product has read them
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        asm volatile("" ::"r"(a[t][ks][0]), "r"(a[t][ks][1]), "r"(a[t][ks][2]),
                     "r"(a[t][ks][3])
                     : "memory");
  }
  template <typename F>
  __device__ static void each(Acc& acc, F f) {
    const int lane = threadIdx.x & 31, c = 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < NP / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            f(row0(t) + (lane >> 2) + 8 * h, 8 * i + c + e, acc.v[t][4 * i + 2 * h + e]);
  }
  // f(row, col, v0, v1) for the pairs of adjacent columns (col even)
  template <typename F>
  __device__ static void each_pair(Acc& acc, F f) {
    const int lane = threadIdx.x & 31, c = 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < NP / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(row0(t) + (lane >> 2) + 8 * h, 8 * i + c, acc.v[t][4 * i + 2 * h],
            acc.v[t][4 * i + 2 * h + 1]);
  }
  // the same with v0, v1 as float&
  template <typename F>
  __device__ static void each_pair_ref(Acc& acc, F f) {
    const int lane = threadIdx.x & 31, c = 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < NP / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(row0(t) + (lane >> 2) + 8 * h, 8 * i + c, acc.v[t][4 * i + 2 * h],
            acc.v[t][4 * i + 2 * h + 1]);
  }
};

// -- the product --------------------------------------------------------------

// What the consumers read A from: the chunk's row 0 and its row stride.
template <typename Op>
struct AView {
  const Op* p;
  int stride;
};

// The consumers' side of one product over a [P::kM, C] row block:
// out[r][co] = sum_j sum_ci A[r + j dil][ci] W[j][ci][co] for co in
// [co_begin, co_end), pass by pass of P::kNP columns. src.stage(ci0) stages (or points at) the input
// channels [ci0, ci0 + kKc) and returns an AView; src.prefetch(ci0), called
// once every consumer is past stage(), starts loading the next chunk (the
// caller prefetches the first); epi(acc, co0) takes each pass's sums.
template <typename P, typename Src, typename Epi>
__device__ __forceinline__ void product(Ring& ring, int c_len, int co_begin, int co_end,
                                        int taps, int dil, Src& src, Epi epi) {
  const int lane = threadIdx.x & 31;
  for (int co0 = co_begin; co0 < co_end; co0 += P::kNP) {
    typename P::Acc acc;
    P::zero(acc);
    for (int ci0 = 0; ci0 < c_len; ci0 += P::kKc) {
      consumer_sync();                       // the last chunk's A is read
      const auto a = src.stage(ci0);
      consumer_sync();                       // ... and this one's is staged
      if (ci0 + P::kKc < c_len) src.prefetch(ci0 + P::kKc);
      else if (co0 + P::kNP < co_end) src.prefetch(0);
      for (int j = 0; j < taps; ++j) {
        mbar_wait(ring.full + ring.stage, ring.phase);
        P::template accumulate<false>(acc, a.p, a.stride, j * dil,
                                      reinterpret_cast<const typename P::Op*>(ring.tile()));
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty + ring.stage);
        ring.advance();
      }
    }
    epi(acc, co0);
  }
}

// The producer's side: one thread loads the weight tile of each (pass,
// chunk, tap) step, taps tap0 + [0, taps) of `map`.
template <typename P>
__device__ __forceinline__ void produce_w(Ring& ring, const CUtensorMap* map, int co0, int ci0,
                                          int tap) {
  mbar_wait(ring.empty + ring.stage, ring.phase ^ 1);
  mbar_arrive_expect_tx(ring.full + ring.stage, P::kStageBytes);
#pragma unroll
  for (int b = 0; b < P::kBoxes; ++b)
    tensor_copy(ring.tile() + b * (P::kStageBytes / P::kBoxes), map, co0 + b * P::kBoxCols,
                ci0, tap, ring.full + ring.stage);
  ring.advance();
}

template <typename P>
__device__ __forceinline__ void produce(Ring& ring, const CUtensorMap* map, int c_len,
                                        int co_begin, int co_end, int taps, int tap0) {
  for (int co0 = co_begin; co0 < co_end; co0 += P::kNP)
    for (int ci0 = 0; ci0 < c_len; ci0 += P::kKc)
      for (int j = 0; j < taps; ++j) produce_w<P>(ring, map, co0, ci0, tap0 + j);
}

// A product whose A also comes by TMA: a second ring (aring) of slots
// holding rows [row0, row0 + a_rows) of channels [ci0, ci0 + kKc) of a
// [B, T, C'] tensor (`amap`, boxes of kARows 128-byte rows in the 128-byte
// swizzle; rows outside [0, T) fill zeros), one slot per input chunk. The
// consumers' side: no block barrier at all.
constexpr int kARows = 64;

__host__ __device__ constexpr int a_slot_bytes(int rows) {
  return (rows + kARows - 1) / kARows * kARows * 128;
}

template <typename P, typename Epi>
__device__ __forceinline__ void product_tma(Ring& wring, Ring& aring, int c_len, int co_begin,
                                            int co_end, int taps, int dil, Epi epi) {
  using Op = typename P::Op;
  const int lane = threadIdx.x & 31;
  for (int co0 = co_begin; co0 < co_end; co0 += P::kNP) {
    typename P::Acc acc;
    P::zero(acc);
    for (int ci0 = 0; ci0 < c_len; ci0 += P::kKc) {
      mbar_wait(aring.full + aring.stage, aring.phase);
      const Op* A = reinterpret_cast<const Op*>(aring.tile());
      for (int j = 0; j < taps; ++j) {
        mbar_wait(wring.full + wring.stage, wring.phase);
        P::template accumulate<true>(acc, A, 0, j * dil,
                                     reinterpret_cast<const Op*>(wring.tile()));
        __syncwarp();
        if (lane == 0) mbar_arrive(wring.empty + wring.stage);
        wring.advance();
      }
      if (lane == 0) mbar_arrive(aring.empty + aring.stage);
      aring.advance();
    }
    epi(acc, co0);
  }
}

template <typename P>
__device__ __forceinline__ void produce_tma(Ring& wring, Ring& aring, const CUtensorMap* wmap,
                                            const CUtensorMap* amap, int c_len, int co_begin,
                                            int co_end, int taps, int row0, int a_rows,
                                            int batch) {
  const int boxes = (a_rows + kARows - 1) / kARows;
  for (int co0 = co_begin; co0 < co_end; co0 += P::kNP)
    for (int ci0 = 0; ci0 < c_len; ci0 += P::kKc) {
      mbar_wait(aring.empty + aring.stage, aring.phase ^ 1);
      mbar_arrive_expect_tx(aring.full + aring.stage, boxes * kARows * 128);
      for (int b = 0; b < boxes; ++b)
        tensor_copy(aring.tile() + b * kARows * 128, amap, ci0, row0 + b * kARows, batch,
                    aring.full + aring.stage);
      aring.advance();
      for (int j = 0; j < taps; ++j) produce_w<P>(wring, wmap, co0, ci0, j);
    }
}

// -- host side -------------------------------------------------------------

__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }

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

// The tensor-map element type of an operand type
template <typename Op>
constexpr CUtensorMapDataType map_type() {
  if constexpr (std::is_same_v<Op, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else if constexpr (std::is_same_v<Op, __half>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  else return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The weights [taps, cw, cw] (C_out contiguous) as P's tensor map: boxes
// of P::kBoxCols output columns x P::kKc input channels x 1 tap; reads past
// cw (the last chunk or pass) fill zeros.
template <typename P>
bool weight_map(CUtensorMap* map, const void* w, int cw, int taps) {
  const EncodeTiled fn = encode_tiled();
  const uint64_t elem = sizeof(typename P::Op);
  if (fn == nullptr || reinterpret_cast<uintptr_t>(w) % 16 || (cw * elem) % 16) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cw), static_cast<cuuint64_t>(cw),
                              static_cast<cuuint64_t>(taps)};
  const cuuint64_t strides[2] = {cw * elem, static_cast<cuuint64_t>(cw) * cw * elem};
  const cuuint32_t box[3] = {P::kBoxCols, P::kKc, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, map_type<typename P::Op>(), 3, const_cast<void*>(w), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            P::kSwizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Activations [batch, t_len, cw] (a multiple of 16 bytes per row) as the
// A tensor map: boxes of kKc channels (128 bytes) x kARows rows x 1 in the
// 128-byte swizzle; reads outside the tensor fill zeros.
template <typename P>
bool activation_map(CUtensorMap* map, const void* a, int cw, int t_len, int batch) {
  const EncodeTiled fn = encode_tiled();
  const uint64_t elem = sizeof(typename P::Op);
  if (fn == nullptr || reinterpret_cast<uintptr_t>(a) % 16 || (cw * elem) % 16) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cw), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {cw * elem, static_cast<cuuint64_t>(t_len) * cw * elem};
  const cuuint32_t box[3] = {P::kKc, kARows, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, map_type<typename P::Op>(), 3, const_cast<void*>(a), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch kernel<<<grid, kBlockThreads, bytes>>>(args). opted[dev] is the
// largest size this kernel was opted in to on device dev, so
// cudaFuncSetAttribute (a costly call) runs once per kernel, device and
// larger size.
template <typename Kernel, typename Args>
cudaError_t launch_block(Kernel kernel, const Args& args, dim3 grid, size_t bytes,
                         size_t* opted, int max_devices, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= max_devices || opted[dev] < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < max_devices) opted[dev] = bytes;
  }
  kernel<<<grid, kBlockThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
