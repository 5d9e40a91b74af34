// Building blocks of the SEANet residual-unit kernels for Hopper (sm_90a),
// shared by seanet_res.cu (DAC's dense units) and snac_res.cu (SNAC's
// depthwise units): the snake, cp.async weight tiles, the two tile
// policies of a [32, C] x [C, C] product (f32 on the FMA units, bf16 on
// mma.sync), the 1x1 conv over a 32-row block, and the launch helpers.
// Everything is in an anonymous namespace: each source that includes this
// header compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kRows = 32;           // rows of one row block
constexpr int kKc = 32;             // input channels staged per step
constexpr int kMaxUnits = 4;        // units one chain launch takes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// v as the dtype T holds it: f32 unchanged, bf16 and f16 rounded to nearest
// even
template <typename T> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half(v));
}

// sin^2(y): period-pi range reduction, odd Taylor series on [-pi/2, pi/2];
// the constants are the f32 roundings of the reference's double ones.
__device__ __forceinline__ float sin2(float y) {
  const float pi = static_cast<float>(3.14159265358979323846);
  const float inv_pi = static_cast<float>(1.0 / 3.14159265358979323846);
  const float r = y - pi * rintf(y * inv_pi);
  const float r2 = r * r;
  const float s = r * (1.0f + r2 * (static_cast<float>(-1.0 / 6.0) +
                  r2 * (static_cast<float>(1.0 / 120.0) +
                  r2 * (static_cast<float>(-1.0 / 5040.0) +
                  r2 * static_cast<float>(1.0 / 362880.0)))));
  return s * s;
}

__device__ __forceinline__ float snake(float v, float a, float inv_a) {
  return v + sin2(a * v) * inv_a;
}

__host__ __device__ constexpr int pad_channels(int c) { return (c + kKc - 1) / kKc * kKc; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage the weight tile Ws[k][n] = w[ci0 + k][co0 + n] for k < 32,
// n < BN (row stride `stride`), zero outside [0, C) x [0, C). With C a
// multiple of a 16-byte vector the copies are asynchronous (cp.async; the
// caller waits with cp_async_wait_all), else plain loads and stores.
template <int BN, int STRIDE, typename Op>
__device__ __forceinline__ void load_w(Op* Ws, const Op* __restrict__ w, int c_len, int ci0,
                                       int co0) {
  constexpr int kVec = 16 / sizeof(Op);
  if (c_len % kVec == 0) {
    constexpr int kChunks = BN / kVec;
    for (int idx = threadIdx.x; idx < kKc * kChunks; idx += kThreads) {
      const int k = idx / kChunks, n = (idx - k * kChunks) * kVec;
      const int ci = ci0 + k, co = co0 + n;
      const bool valid = ci < c_len && co < c_len;
      cp_async16(Ws + k * STRIDE + n, valid ? w + (size_t)ci * c_len + co : w, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < kKc * BN; idx += kThreads) {
      const int k = idx / BN, n = idx - k * BN;
      const int ci = ci0 + k, co = co0 + n;
      Ws[k * STRIDE + n] = (ci < c_len && co < c_len) ? w[(size_t)ci * c_len + co] : Op(0.0f);
    }
  }
  cp_async_commit();
}

// -- tile policies: how the block's 256 threads split a [32, BN] pass ---------
//
// Each thread holds acc[kR][kC] f32 accumulators for the pass; element
// (i, n) is the output at row row(i) of the row block and column col(n) of
// the pass. A tile stages its operands in shared memory as Op: the snaked
// input chunk A [32 + 2 halo][a_stride], the snaked hidden S [32][s_stride],
// and weight tiles W. Strides and sizes are in elements of Op.

// f32 on the FMA units. The 8 warps split the 32 rows into groups of TM
// rows (TM = 4: 8 groups; TM = 8: 4 groups, each over two column halves);
// lane l owns columns l + 32 n of its warp's half. Per input channel a
// warp reads TM broadcast activations and TN weights free of bank
// conflicts for TM * TN FMAs per lane, so TM = 8 keeps the FMA units
// busier where C is wide. W is staged [k][n] with row stride BN.
template <int TM, int TN>
struct FmaTile {
  static_assert(TM == 4 || TM == 8, "4 or 8 rows per warp");
  static constexpr int kGroups = kRows / TM, kHalves = 8 / kGroups;
  using Op = float;
  static constexpr int kR = TM, kC = TN, kBN = kHalves * 32 * TN;
  static constexpr int kAStride = kKc;
  static constexpr int kWStride = kBN;
  __host__ __device__ static constexpr int a_elems(int halo) {
    return (kRows + 2 * halo) * kAStride;
  }
  static constexpr int kWElems = kKc * kWStride;
  __host__ __device__ static constexpr int s_stride(int c) { return pad_channels(c); }
  __device__ static int row(int i) { return ((threadIdx.x >> 5) % kGroups) * TM + i; }
  __device__ static int col(int n) {
    return ((threadIdx.x >> 5) / kGroups) * 32 * TN + (threadIdx.x & 31) + 32 * n;
  }

  // acc[i][n] += sum_k A[row(i) + shift][k] * Ws[k][col(n)] over kKc k
  __device__ static void accumulate(float (&acc)[kR][kC], const Op* A, int a_stride,
                                    int shift, const Op* Ws) {
    const Op* a_rows = A + (row(0) + shift) * a_stride;
    const Op* w_cols = Ws + col(0);
#pragma unroll 8
    for (int k = 0; k < kKc; ++k) {
      float a[kR], w[kC];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = a_rows[i * a_stride + k];
#pragma unroll
      for (int n = 0; n < kC; ++n) w[n] = w_cols[k * kWStride + 32 * n];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int n = 0; n < kC; ++n) acc[i][n] = fmaf(a[i], w[n], acc[i][n]);
    }
  }
};

// bf16 on the tensor cores: mma.sync m16n8k16 with f32 accumulation. Warp w
// owns all 32 rows (two m16 tiles) and NT n8 tiles, columns
// [8 NT w, 8 NT (w + 1)). acc[2 mi + h][2 nj + e] is row 16 mi + g + 8 h,
// column 8 NT w + 8 nj + 2 q + e (g = lane / 4, q = lane % 4), the mma's
// accumulator layout. Rows are padded by 8 elements (16 bytes) so the eight
// row addresses of each ldmatrix fall in distinct bank groups. W is staged
// [k][n] as in global memory and read transposed by ldmatrix.trans.
template <int NT>
struct MmaTile {
  using Op = __nv_bfloat16;
  static constexpr int kR = 4, kC = 2 * NT, kBN = 64 * NT;
  static constexpr int kAStride = kKc + 8;
  static constexpr int kWStride = kBN + 8;
  __host__ __device__ static constexpr int a_elems(int halo) {
    return (kRows + 2 * halo) * kAStride;
  }
  static constexpr int kWElems = kKc * kWStride;
  __host__ __device__ static constexpr int s_stride(int c) { return pad_channels(c) + 8; }
  __device__ static int row(int i) {
    return (i >> 1) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (i & 1);
  }
  __device__ static int col(int n) {
    return (threadIdx.x >> 5) * 8 * NT + (n >> 1) * 8 + 2 * (threadIdx.x & 3) + (n & 1);
  }

  // acc += A[rows + shift][0:kKc] @ Ws[cols][0:kKc]^T
  __device__ static void accumulate(float (&acc)[kR][kC], const Op* A, int a_stride,
                                    int shift, const Op* Ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // lanes 0-15 address rows 0-15 at column kk, lanes 16-31 at kk + 8
        const Op* p = A + (shift + 16 * mi + (lane & 15)) * a_stride + kk + 8 * (lane >> 4);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[mi][0]), "=r"(a[mi][1]), "=r"(a[mi][2]), "=r"(a[mi][3])
                     : "r"(smem_addr(p)));
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        // lanes 0-15 address rows k = kk..kk+15 at column n0; transposed,
        // the two 8 x 8 blocks are the fragments of k-halves kk, kk + 8
        const Op* p = Ws + (kk + (lane & 15)) * kWStride + warp * 8 * NT + 8 * nj;
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(smem_addr(p)));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[2 * mi][2 * nj]), "+f"(acc[2 * mi][2 * nj + 1]),
                "+f"(acc[2 * mi + 1][2 * nj]), "+f"(acc[2 * mi + 1][2 * nj + 1])
              : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]), "r"(b0),
                "r"(b1));
        }
      }
    }
  }
};

// The 1x1 conv of one unit over one 32-row block: epi(acc, co0) receives
// acc[i][n] = sum_ci S[row(i)][ci] w2[ci][co0 + col(n)]. The weight tile of
// the next input-channel step loads into the other half of Ws (cp.async)
// while the current one computes.
template <typename Tile, typename T, typename Epi>
__device__ __forceinline__ void pointwise_conv(const typename Tile::Op* S,
                                               typename Tile::Op* Ws,
                                               const T* __restrict__ w2, int c_len, Epi epi) {
  constexpr int BN = Tile::kBN, WS = Tile::kWStride;
  for (int co0 = 0; co0 < c_len; co0 += BN) {
    float acc[Tile::kR][Tile::kC];
#pragma unroll
    for (int i = 0; i < Tile::kR; ++i)
#pragma unroll
      for (int n = 0; n < Tile::kC; ++n) acc[i][n] = 0.0f;
    __syncthreads();                         // Ws is free
    load_w<BN, WS>(Ws, w2, c_len, 0, co0);
    for (int ci0 = 0, step = 0; ci0 < c_len; ci0 += kKc, ++step) {
      cp_async_wait_all();
      __syncthreads();                       // this step's tile is staged, the
                                             // other half of Ws is free
      if (ci0 + kKc < c_len)
        load_w<BN, WS>(Ws + ((step + 1) & 1) * Tile::kWElems, w2, c_len, ci0 + kKc, co0);
      Tile::accumulate(acc, S + ci0, Tile::s_stride(c_len), 0,
                       Ws + (step & 1) * Tile::kWElems);
    }
    epi(acc, co0);
  }
}

constexpr int kMaxDevices = 64;

// Launch with `bytes` of dynamic shared memory. opted[dev] is the largest
// size this kernel was opted in to on device dev, so cudaFuncSetAttribute
// (a costly call) runs once per kernel, device and larger size.
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& args, dim3 grid, size_t bytes, size_t* opted,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || opted[dev] < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = bytes;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// The tile: rows per warp (f32: TM = 4 or 8; bf16: 32) and the pass width
// TN (f32) or NT (bf16); see ops/seanet_cuda.py::tile_width.
// Launch<T, Tile>::run(args, batch, stream) launches the kernel.
template <template <typename, typename> class Launch, typename Args>
cudaError_t dispatch(const Args& a, int batch, int rows, int width, int dtype,
                     cudaStream_t s) {
  if (dtype == 0 && rows == 8) {
    switch (width) {
      case 4: return Launch<float, FmaTile<8, 4>>::run(a, batch, s);
      case 6: return Launch<float, FmaTile<8, 6>>::run(a, batch, s);
      case 8: return Launch<float, FmaTile<8, 8>>::run(a, batch, s);
    }
  } else if (dtype == 0 && rows == 4) {
    switch (width) {
      case 1: return Launch<float, FmaTile<4, 1>>::run(a, batch, s);
      case 2: return Launch<float, FmaTile<4, 2>>::run(a, batch, s);
      case 3: return Launch<float, FmaTile<4, 3>>::run(a, batch, s);
      case 4: return Launch<float, FmaTile<4, 4>>::run(a, batch, s);
      case 6: return Launch<float, FmaTile<4, 6>>::run(a, batch, s);
      case 8: return Launch<float, FmaTile<4, 8>>::run(a, batch, s);
    }
  } else if (dtype == 1 && rows == kRows) {
    switch (width) {
      case 1: return Launch<__nv_bfloat16, MmaTile<1>>::run(a, batch, s);
      case 2: return Launch<__nv_bfloat16, MmaTile<2>>::run(a, batch, s);
      case 3: return Launch<__nv_bfloat16, MmaTile<3>>::run(a, batch, s);
      case 4: return Launch<__nv_bfloat16, MmaTile<4>>::run(a, batch, s);
      case 6: return Launch<__nv_bfloat16, MmaTile<6>>::run(a, batch, s);
    }
  }
  return cudaErrorInvalidValue;
}

bool valid_shape(int batch, int t_len, int c, int k) {
  return batch >= 1 && batch <= 65535 && t_len >= 1 && c >= 1 && k >= 1 && k % 2 == 1;
}

}  // namespace
