// Dequantizing matrix products over packed GGUF weights for Hopper (sm_90a).
//
// Replaces the TPU kernels codec_tpu/ops/qmat_pallas.py::q8_0_matmul
// (_q8_kernel) and ::q4_k_matmul (_q4k_kernel): y[m, out] = x[m, in] @
// dequant(W)[out, in]^T in f32, for the llama backbone's layer matrices
// at m <= 32 rows (one per decode step, up to 32 for a bucketed prefill).
// The weights stay packed in device memory (ops/qmat.py, natural order):
//   Q8_0: qs int8 [out, in], scale f32 [out, in/32]
//   Q4_K: qs uint8 [out, in/2] (the 16 bytes of 32-group g hold element
//         32g+j in the low nibble and 32g+16+j in the high one),
//         scale and minv f32 [out, in/32]
// x is f32 or bf16, contiguous [m, in]; y is f32 [m, out].
//
// What bounds them on this card: at m <= 32 each packed weight byte is
// used for at most 32 (Q8_0) or 64 (Q4_K) multiply-adds, far below the
// ~20 FLOP per byte the f32 FMA units need to outrun 3.35 TB/s, so both
// are bound by the bytes of the packed weights (1.125 B/weight for Q8_0,
// 0.75 for Q4_K). x is at most 32 rows of 8192 floats and stays in
// L1/L2.
//
// How the design answers that: one warp per output row, eight rows per
// block, so each weight byte is read once, by one lane, in a 16-byte
// load (Q8_0: half a group; Q4_K: one whole group with its one scale and
// min). The lane dequantizes in registers and keeps the m partial sums in
// registers (m rounded up to a compile-time bucket); a warp shuffle
// reduces them and lane 0 writes y. Dequantized weights stay f32 (the TPU
// kernel rounds x and w to bf16 for its MXU; this one does not) and are
// computed with explicitly rounded multiplies and subtractions, so nvcc
// cannot contract q*s - m into an FMA: they equal GGUF's dequantized
// values bit for bit. Split-K for the narrow k/v matrices (512 rows fill
// 64 of 132 SMs) and more loads in flight are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // output rows per block
constexpr int THREADS = WARPS * 32;

// eight consecutive x values as f32 (p 16-byte aligned for f32, 16-byte
// aligned for the eight bf16)
__device__ __forceinline__ void load_x8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// acc[i] += w[0..N) . x[i, off..off+N) for the first m rows
template <int MB, int N, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[MB], const float (&w)[N],
                                           const T* __restrict__ x, int m,
                                           int in, int off) {
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    if (i < m) {
      const T* xr = x + (size_t)i * in + off;
#pragma unroll
      for (int c = 0; c < N / 8; ++c) {
        float xv[8];
        load_x8(xr + 8 * c, xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i] = fmaf(w[8 * c + j], xv[j], acc[i]);
      }
    }
  }
}

template <int MB>
__device__ __forceinline__ void reduce_store(float (&acc)[MB], float* __restrict__ y,
                                             int m, int out, int row, int lane) {
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    if (i < m) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) y[(size_t)i * out + row] = v;
    }
  }
}

template <int MB, typename T>
__global__ void __launch_bounds__(THREADS)
q8_0_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ qs,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int m, int in, int out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= out) return;                       // whole warps leave together
  const int4* qrow = reinterpret_cast<const int4*>(qs + (size_t)row * in);
  const float* srow = scale + (size_t)row * (in / 32);
  float acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i] = 0.f;
  for (int c = lane; c < in / 16; c += 32) {    // 16 weights: half a group
    const int4 raw = __ldg(qrow + c);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    const float s = __ldg(srow + (c >> 1));
    float w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __fmul_rn(static_cast<float>(q[j]), s);
    accumulate<MB, 16>(acc, w, x, m, in, 16 * c);
  }
  reduce_store<MB>(acc, y, m, out, row, lane);
}

template <int MB, typename T>
__global__ void __launch_bounds__(THREADS)
q4_k_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qs,
                   const float* __restrict__ scale, const float* __restrict__ minv,
                   float* __restrict__ y, int m, int in, int out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= out) return;
  const uint4* qrow = reinterpret_cast<const uint4*>(qs + (size_t)row * (in / 2));
  const float* srow = scale + (size_t)row * (in / 32);
  const float* mrow = minv + (size_t)row * (in / 32);
  float acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i] = 0.f;
  for (int g = lane; g < in / 32; g += 32) {    // one 32-group per load
    const uint4 raw = __ldg(qrow + g);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    const float s = __ldg(srow + g);
    const float mn = __ldg(mrow + g);
    float w[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      w[j] = __fsub_rn(__fmul_rn(static_cast<float>(b[j] & 15), s), mn);
      w[16 + j] = __fsub_rn(__fmul_rn(static_cast<float>(b[j] >> 4), s), mn);
    }
    accumulate<MB, 32>(acc, w, x, m, in, 32 * g);
  }
  reduce_store<MB>(acc, y, m, out, row, lane);
}

template <int MB, typename T>
int launch_q8(const void* x, const void* qs, const void* scale, void* y, int m,
              int in, int out, cudaStream_t s) {
  q8_0_matmul_kernel<MB, T><<<(out + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qs),
      static_cast<const float*>(scale), static_cast<float*>(y), m, in, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MB, typename T>
int launch_q4k(const void* x, const void* qs, const void* scale, const void* minv,
               void* y, int m, int in, int out, cudaStream_t s) {
  q4_k_matmul_kernel<MB, T><<<(out + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(qs),
      static_cast<const float*>(scale), static_cast<const float*>(minv),
      static_cast<float*>(y), m, in, out);
  return static_cast<int>(cudaGetLastError());
}

// m rounded up to its register bucket
#define QMAT_BUCKETS(CALL)             \
  if (m <= 1) return CALL(1);          \
  if (m <= 2) return CALL(2);          \
  if (m <= 4) return CALL(4);          \
  if (m <= 8) return CALL(8);          \
  if (m <= 16) return CALL(16);        \
  if (m <= 32) return CALL(32);        \
  return static_cast<int>(cudaErrorInvalidValue)

template <typename T>
int dispatch_q8(const void* x, const void* qs, const void* scale, void* y, int m,
                int in, int out, cudaStream_t s) {
#define Q8_CALL(MB) launch_q8<MB, T>(x, qs, scale, y, m, in, out, s)
  QMAT_BUCKETS(Q8_CALL);
#undef Q8_CALL
}

template <typename T>
int dispatch_q4k(const void* x, const void* qs, const void* scale, const void* minv,
                 void* y, int m, int in, int out, cudaStream_t s) {
#define Q4K_CALL(MB) launch_q4k<MB, T>(x, qs, scale, minv, y, m, in, out, s)
  QMAT_BUCKETS(Q4K_CALL);
#undef Q4K_CALL
}

}  // namespace

// dtype of x: 0 = f32, 1 = bf16. Returns a cudaError_t (0 = launched).
extern "C" int codec_q8_0_matmul(const void* x, const void* qs, const void* scale,
                                 void* y, int m, int in_dim, int out_dim, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || in_dim < 32 || in_dim % 32 || out_dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_q8<float>(x, qs, scale, y, m, in_dim, out_dim, s);
  if (dtype == 1) return dispatch_q8<__nv_bfloat16>(x, qs, scale, y, m, in_dim, out_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int codec_q4_k_matmul(const void* x, const void* qs, const void* scale,
                                 const void* minv, void* y, int m, int in_dim,
                                 int out_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || in_dim < 256 || in_dim % 256 || out_dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_q4k<float>(x, qs, scale, minv, y, m, in_dim, out_dim, s);
  if (dtype == 1)
    return dispatch_q4k<__nv_bfloat16>(x, qs, scale, minv, y, m, in_dim, out_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
