// Split-f32 products on Hopper's tensor cores (sm_90a), shared by
// rvq_encode.cu and flash_sdpa_window.cu.
//
// An f32 value x is split into a TF32 high part hi = rna(x) (10 mantissa
// bits, rounded to nearest) and a low part lo = rna(x - hi); x - hi is exact
// in f32, so hi + lo keeps about 21 of x's 24 significant bits. A product
// a·b then takes three tensor-core passes with f32 accumulation,
//   a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
// leaving out only a_lo·b_lo (2^-22 of |a·b|) and the rounding of the parts:
// a relative error near 1e-6, the counterpart of the TPU's
// Precision.HIGHEST (the MXU's multi-pass bf16 emulation of f32). No pass
// runs plain one-pass TF32. Where a and b are small integers, lo is 0 and
// every product is exact.
//
// Fragments follow the PTX ISA's mma.m16n8k8 (.tf32) and mma.m16n8k16
// (.bf16 and .f16) layouts, with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row)   a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col)    b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8)        c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// ldmatrix (b16 8 x 8 matrices) loads f32 A and B fragments too: lane l of
// matrix j gets the 32-bit word (row l / 4, word l % 4) of an 8-row x
// 16-byte tile, which is (g, t) above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32, to nearest with ties away from zero: the value of
// cvt.rna.tf32.f32 for finite x, in two full-rate integer operations (add
// half a TF32 ulp to the magnitude, clear the 13 bits TF32 drops) where the
// conversion runs at a quarter of the rate; splitting every operand as it
// is loaded made the conversions the kernels' limit
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x → (hi, lo), both TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x → (hi, lo) with hi + lo == x exactly: lo = x - hi is left unrounded
// (13 bits past TF32, which the tensor cores do not read). A residual kept
// as (hi, lo) is its own f32 value.
__device__ __forceinline__ void split_exact(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// four 8-row x 16-byte matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a · b, one m16n8k8 TF32 pass
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b in split f32: the three passes, small terms first
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4], uint32_t b0_hi, uint32_t b1_hi,
                                       uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// c += a · b, one m16n8k16 bf16 pass (exact products, f32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b, one m16n8k16 f16 pass (exact products, f32 sums)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the m16n8k16 pass of a 16-bit operand type T (bf16 or f16)
template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) mma_f16(c, a, b0, b1);
  else mma_bf16(c, a, b0, b1);
}

// wgmma m64nNk8 TF32 with A (16 rows x 8 per warp, the m16n8k8 A
// layout) from registers and B [N][k] K-major from shared memory through
// desc: d += a · b. d[4i + 2h + e] is row g + 8h of the warp's 16, column
// 8i + 2t + e.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the descriptor of a K-major B in the 128-byte swizzle: rows of 128 bytes,
// 8-row atoms 1024 bytes apart; addr advances by 32 bytes per k8 step
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// two f32 → one bf16x2 word (x in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) → bf16 hi and lo words: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// two f32 → one f16x2 word (x in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_f16(float x, float y) {
  const __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) → f16 hi and lo words: hi = f16(x), lo = f16(x - hi)
__device__ __forceinline__ void split_f16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 hf = __half22float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f16(x - hf.x, y - hf.y);
}

// the split of a 16-bit operand type T (bf16 or f16)
template <typename T>
__device__ __forceinline__ void split_16(float x, float y, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same_v<T, __half>) split_f16(x, y, hi, lo);
  else split_bf16(x, y, hi, lo);
}

}  // namespace tf32x3
