// SNAC's depthwise residual units for Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/seanet_pallas.py::snac_res_chain
// (_dw_chain_kernel). One residual unit is
//     out = x + conv1x1(snake(dwconv_K,d(snake(x, a1)) + b1, a2)) + b2
// where dwconv_K,d is a depthwise (per-channel) dilated conv with symmetric
// zero padding (K-1)*d/2 and snake(v, a) = v + sin^2(a v)/(a + eps), for
// any sign of a. x and out are contiguous [B, T, C]; w1 holds the
// per-channel taps [N, K, C]; w2 is [N, C, C] (in, out); vec holds six f32
// rows per unit: a1, 1/(a1+eps), b1, a2, 1/(a2+eps), b2.
//
// Numerics, as the TPU kernel: the snaked input, the depthwise taps and
// their sums are f32 in both dtypes (bf16 taps are widened exactly; the
// snaked input is never rounded to bf16). The snaked hidden S feeds the
// 1x1 conv in x's dtype (bf16: rounded to nearest even): f32 operands on
// plain f32 FMAs (no TF32: the parity path), or bf16 operands with f32 sums
// on the tensor cores. The branch is added to x in f32 and the sum rounded
// to x's dtype once; the chain keeps its residual f32 across its units.
//
// A unit, the form every SNAC decode and encode launches
// (ops/seanet_cuda.py::snac_res_units: one unit per call of the wrapper),
// is two kernels in stream order:
//  1. the depthwise pass here (snac_dw_kernel): x -> S = Op(snake(b1 +
//     sum_j w1[j] snake(x, a1)[t + (j - (K-1)/2) d], a2)), written once as
//     [B, T, cw] in x's dtype. Per element it reads and writes 2-4 bytes
//     each and runs two snakes and K FMA, some 40 instructions: in f32 it
//     is bound by its bytes, in bf16 by instruction issue as much as by
//     bytes. A block stages 32 channels of its rows and their halo by
//     cp.async, all at once, and snakes them once into f32 in shared
//     memory (zeros outside [0, T) of its batch row). Its rows are a
//     multiple of 4 d, so each of the d residue classes (rows t, t + d,
//     ...) splits into items of 4 outputs: a thread reads the 4 + K - 1
//     rows an item's taps need once (not K per output), keeps the taps and
//     the per-channel rows in registers and stores 4 channels per row. K is
//     a template parameter (1, 3, 5 or 7), so the tap loops carry no test.
//  2. the 1x1 conv: csrc/seanet_res.cu's product launch (seanet_gemm.cuh),
//     S and x by TMA into a persistent block per SM, f32 on the FMA units
//     (bound by them), bf16 on wgmma (bound by its bytes at SNAC's widths:
//     it reads S and x and writes out, 2 C FLOP per 6 bytes, below the
//     tensor cores' ridge), with SNAC's epilogue (snac_res_1x1_kernel: the
//     f32 branch added to x, one rounding), two x tiles where they fit, and
//     tiles whose rows all lie in [0, T) taken by column pairs with no test
//     per row: at SNAC's narrow widths a tile's product is short, and its
//     epilogue's chain of tests and loads had held the 1x1 back.
//     codec_snac_res_unit there launches both.
// The bound PERF.md holds a unit's time to stays the fused function's
// (tools/seanet_times.py::res_work(..., depthwise=True): x read and out
// written once), whatever implements it. These five passes over the
// activations (x and S read, S and out written, x read again) against
// its two leave bf16, which is bound by bytes there, at most about 13%
// of it (2/15 for a block of three units).
//
// The chain kernel (N > 1 units in one launch) keeps its f32 state in
// shared memory across its units and walks each unit in 32-row blocks,
// staging the snaked input chunk by chunk (depthwise_conv) and running
// the SEANet tiles' 1x1 (seanet_tiles.cuh); its state leaves one or two
// blocks per SM, so a decode does not take it (three unit launches are
// faster at every SNAC width). It serves callers that ask for N > 1 units
// in one pass.

#include "seanet_tiles.cuh"

namespace {

struct SnacArgs {
  const void* x;
  void* out;
  const void* w1;                   // [N, K, C]
  const void* w2;                   // [N, C, C]
  const float* vec;                 // [N, 6, C]
  int t_len, c, k, n_units, tile;
  int dilation[kMaxUnits];
};

// Shared memory of the buffers every kernel has, in bytes
// (ops/seanet_cuda.py computes the same sums to pick the chain's tile): S
// and two weight tiles in the tile's operand type, and the f32 input
// chunk A [32 + 2 halo, 32].
template <typename Tile>
size_t dw_common_bytes(int c, int halo) {
  using Op = typename Tile::Op;
  return sizeof(Op) * ((size_t)kRows * Tile::s_stride(c) + 2 * Tile::kWElems) +
         sizeof(float) * (size_t)(kRows + 2 * halo) * kKc;
}

// The depthwise dilated conv of one unit over one 32-row block, then bias
// and snake: S[r][c] = Op(snake(b1[c] + sum_j w1[j][c] A[r + j d][c], a2)).
// load_a(A, ci0) stages the snaked f32 input rows [0, 32 + 2 halo) of
// channels [ci0, ci0 + 32), row stride 32. Lane l of warp w owns channel
// ci0 + l at rows w, w + 8, w + 16, w + 24: its taps stay in registers and
// a warp reads one row of 32 channels at a time. Pad channels of S are
// zero. Ends with S complete.
template <typename Tile, typename T, typename LoadA>
__device__ __forceinline__ void depthwise_conv(typename Tile::Op* S, float* A,
                                               const T* __restrict__ w1,
                                               const float* __restrict__ vec, int c_len,
                                               int k_len, int dilation, LoadA load_a) {
  constexpr int kPer = kRows / (kThreads / 32);
  const int s_stride = Tile::s_stride(c_len);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* b1 = vec + 2 * c_len;
  const float* a2 = vec + 3 * c_len;
  const float* ia2 = vec + 4 * c_len;
  for (int ci0 = 0; ci0 < c_len; ci0 += kKc) {
    __syncthreads();                         // A is free, and so is S
    load_a(A, ci0);
    __syncthreads();                         // A is staged
    const int c = ci0 + lane;
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
    if (c < c_len) {
      const float* a = A + warp * kKc + lane;
      for (int j = 0; j < k_len; ++j) {
        const float w = to_f32(w1[(size_t)j * c_len + c]);
        const float* aj = a + j * dilation * kKc;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] = fmaf(w, aj[i * 8 * kKc], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = snake(acc[i] + b1[c], a2[c], ia2[c]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) store(S + (warp + 8 * i) * s_stride + c, acc[i]);
  }
  __syncthreads();                           // S is complete
}

// N units; block (blockIdx.x, blockIdx.y) owns rows [tile blockIdx.x,
// +tile) of batch row blockIdx.y and reads them with a halo of
// sum_u (K-1) d_u / 2 rows on each side.
template <typename T, typename Tile>
__global__ void __launch_bounds__(kThreads)
snac_res_chain_kernel(SnacArgs args) {
  using Op = typename Tile::Op;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_len = args.c, t_len = args.t_len, k_len = args.k, tile = args.tile;
  int halo = 0;
  for (int u = 0; u < args.n_units; ++u) halo += (k_len - 1) * args.dilation[u] / 2;
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * t_len * c_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.out) + base;
  // cur rows have an odd stride, so a warp touching 32 rows of one column
  // hits 32 banks; its size is rounded up to 16 bytes, so the buffers
  // behind it stay aligned for cp.async and ldmatrix
  float* cur = reinterpret_cast<float*>(smem);
  const int cs = c_len | 1;
  const size_t cur_floats = ((size_t)(tile + 2 * halo) * cs + 3) / 4 * 4;
  Op* S = reinterpret_cast<Op*>(cur + cur_floats);
  Op* Ws = S + kRows * Tile::s_stride(c_len);
  float* A = reinterpret_cast<float*>(Ws + 2 * Tile::kWElems);

  // cur row r holds position t0 - halo + r; zero outside [0, T)
  int len = tile + 2 * halo;
  for (size_t idx = threadIdx.x; idx < (size_t)len * c_len; idx += kThreads) {
    const int r = static_cast<int>(idx / c_len), c = static_cast<int>(idx % c_len);
    const int pos = t0 - halo + r;
    cur[(size_t)r * cs + c] = (pos >= 0 && pos < t_len)
                                  ? to_f32(x[(size_t)pos * c_len + c]) : 0.0f;
  }

  int off = 0;                               // rows consumed on the left
  for (int u = 0; u < args.n_units; ++u) {
    const int d = args.dilation[u];
    const int h = (k_len - 1) * d / 2;
    const int l_out = len - 2 * h;
    const float* vec = args.vec + (size_t)u * 6 * c_len;
    const T* w1 = static_cast<const T*>(args.w1) + (size_t)u * k_len * c_len;
    const T* w2 = static_cast<const T*>(args.w2) + (size_t)u * c_len * c_len;
    const float* b2 = vec + 5 * c_len;
    const bool last = u == args.n_units - 1;
    off += h;
    for (int rb = 0; rb < l_out; rb += kRows) {
      const int a_rows = kRows + 2 * h;
      auto load_a = [&](float* As, int ci0) {
        for (int idx = threadIdx.x; idx < a_rows * kKc; idx += kThreads) {
          const int r = rb + idx / kKc, ci = ci0 + idx % kKc;
          As[idx] = (r < len && ci < c_len)
                        ? snake(cur[(size_t)r * cs + ci], vec[ci], vec[c_len + ci]) : 0.0f;
        }
      };
      depthwise_conv<Tile>(S, A, w1, vec, c_len, k_len, d, load_a);

      // new cur[r] = cur[r + h] + y[r]; read every residual of the pass
      // before any thread overwrites a row
      auto epi = [&](float (&acc)[Tile::kR][Tile::kC], int co0) {
        float res[Tile::kR][Tile::kC];
#pragma unroll
        for (int i = 0; i < Tile::kR; ++i) {
          const int r = rb + Tile::row(i);
#pragma unroll
          for (int n = 0; n < Tile::kC; ++n) {
            const int co = co0 + Tile::col(n);
            res[i][n] = (r < l_out && co < c_len)
                            ? cur[(size_t)(r + h) * cs + co] + (acc[i][n] + b2[co]) : 0.0f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < Tile::kR; ++i) {
          const int r = rb + Tile::row(i);
          const int pos = t0 - halo + off + r;
          const bool keep = last || (pos >= 0 && pos < t_len);
#pragma unroll
          for (int n = 0; n < Tile::kC; ++n) {
            const int co = co0 + Tile::col(n);
            if (r < l_out && co < c_len) cur[(size_t)r * cs + co] = keep ? res[i][n] : 0.0f;
          }
        }
      };
      pointwise_conv<Tile>(S, Ws, w2, c_len, epi);
    }
    len = l_out;
  }
  __syncthreads();
  for (size_t idx = threadIdx.x; idx < (size_t)tile * c_len; idx += kThreads) {
    const int r = static_cast<int>(idx / c_len), c = static_cast<int>(idx % c_len);
    if (t0 + r < t_len) store(out + (size_t)(t0 + r) * c_len + c, cur[(size_t)r * cs + c]);
  }
}

template <typename T, typename Tile>
struct SnacLaunch {
  static cudaError_t run(const SnacArgs& a, int batch, cudaStream_t s) {
    int halo = 0, halo_max = 0;
    for (int u = 0; u < a.n_units; ++u) {
      const int h = (a.k - 1) * a.dilation[u] / 2;
      halo += h;
      halo_max = h > halo_max ? h : halo_max;
    }
    const size_t cur_floats = ((size_t)(a.tile + 2 * halo) * (a.c | 1) + 3) / 4 * 4;
    const size_t bytes = cur_floats * sizeof(float) + dw_common_bytes<Tile>(a.c, halo_max);
    const dim3 grid((a.t_len + a.tile - 1) / a.tile, batch);
    static size_t opted[kMaxDevices] = {};
    return launch(snac_res_chain_kernel<T, Tile>, a, grid, bytes, opted, s);
  }
};

// -- the depthwise pass --------------------------------------------------------

constexpr int kDwQuads = 8;                   // a block's 32 channels, 4 a thread
constexpr int kDwGroups = kThreads / kDwQuads;
constexpr int kDwOut = 4;                     // outputs of one residue class an item computes
constexpr int kDwMaxTaps = 7;                 // K = 1, 3, 5 or 7

struct DwArgs {
  const void* x;                    // [B, T, C]
  const void* w1;                   // taps [K, C]
  const float* vec;                 // [6, C]
  void* s;                          // the snaked hidden [B, T, cw]
  int t_len, c, cw, k, dilation, rows, async_x;
};

// A: f32 rows [rows + 2 halo] of kDwQuads float4; in bf16 followed by the
// raw rows as they land (64 bytes each)
__host__ __device__ constexpr int dw_smem_bytes(int rows, int halo, int elem) {
  return (rows + 2 * halo) * kDwQuads * (16 + (elem == 4 ? 0 : 4 * elem));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, const float4& v) {
  const __half2 lo = __floats2half2_rn(v.x, v.y);
  const __half2 hi = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// elements [c, c + 4) of a per-channel row of length c_len, zeros past it
template <typename T>
__device__ __forceinline__ float4 channels4(const T* __restrict__ row, int c, int c_len) {
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < c_len ? to_f32(row[c + e]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 snake4(const float4& v, const float4& a, const float4& ia) {
  return make_float4(snake(v.x, a.x, ia.x), snake(v.y, a.y, ia.y), snake(v.z, a.z, ia.z),
                     snake(v.w, a.w, ia.w));
}

__device__ __forceinline__ void fma4(float4& acc, const float4& w, const float4& a) {
  acc.x = fmaf(w.x, a.x, acc.x);
  acc.y = fmaf(w.y, a.y, acc.y);
  acc.z = fmaf(w.z, a.z, acc.z);
  acc.w = fmaf(w.w, a.w, acc.w);
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) owns rows [rows blockIdx.x,
// +rows) and channels [32 blockIdx.y, +32) of batch row blockIdx.z; thread
// (q, g) = (threadIdx.x % 8, threadIdx.x / 8) owns channels 32 blockIdx.y
// + 4 q + [0, 4). A holds snake(x, a1) at positions t0 - halo + i, i <
// rows + 2 halo: the rows land by cp.async, all at once (bf16 into `raw`
// behind A), and are snaked in place. Item i of the rows / 4 items:
// residue class rho and first member k0, outputs at tile rows rho + d (k0
// + v), v < 4, whose K taps lie at A rows rho + d (k0 + v + j). Pad
// channels [C, cw) come out zero: their taps and per-channel rows are
// zero, and snake(0, 0, 0) = 0. K is a template parameter: the tap loops
// unroll without a test per tap.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 3) snac_dw_kernel(const DwArgs args) {
  extern __shared__ float4 A[];
  const int c_len = args.c, cw = args.cw, t_len = args.t_len, d = args.dilation;
  const int rows = args.rows, halo = (K - 1) * d / 2;
  const int a_rows = rows + 2 * halo;
  const int t0 = blockIdx.x * rows;
  const size_t base = (size_t)blockIdx.z * t_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base * c_len;
  T* __restrict__ s = static_cast<T*>(args.s) + base * cw;
  const float* __restrict__ vec = args.vec;
  const int q = threadIdx.x % kDwQuads, g = threadIdx.x / kDwQuads;
  const int c0 = blockIdx.y * 4 * kDwQuads, c = c0 + 4 * q;

  const float4 a1 = channels4(vec, c, c_len), ia1 = channels4(vec + c_len, c, c_len);
  if (args.async_x) {
    // every 16-byte chunk of the block's rows at once (zeros outside [0, T)
    // and past C); f32 lands in A, bf16 in `raw` behind it. Thread k of
    // a row's kChunks copies chunk k of rows i0, i0 + kThreads / kChunks, ...
    constexpr int kPer = 16 / sizeof(T), kChunks = 4 * kDwQuads / kPer;
    constexpr int kStep = kThreads / kChunks;
    T* raw = sizeof(T) == sizeof(float) ? reinterpret_cast<T*>(A)
                                        : reinterpret_cast<T*>(A + a_rows * kDwQuads);
    const int k = threadIdx.x % kChunks, ch = c0 + k * kPer;
    const bool in_c = ch < c_len;
    for (int i = threadIdx.x / kChunks; i < a_rows; i += kStep) {
      const int pos = t0 - halo + i;
      const bool valid = in_c && pos >= 0 && pos < t_len;
      cp_async16(raw + (i * kChunks + k) * kPer, valid ? x + (size_t)pos * c_len + ch : x,
                 valid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = g; i < a_rows; i += kDwGroups)
      A[i * kDwQuads + q] = snake4(load4(raw + (i * kDwQuads + q) * 4), a1, ia1);
  } else {
    // rows whose channels are no multiple of 16 bytes: element by element
    for (int i = g; i < a_rows; i += kDwGroups) {
      const int pos = t0 - halo + i;
      const float4 v = pos >= 0 && pos < t_len ? channels4(x + (size_t)pos * c_len, c, c_len)
                                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      A[i * kDwQuads + q] = snake4(v, a1, ia1);
    }
  }
  __syncthreads();
  if (c >= cw) return;

  const T* __restrict__ w1 = static_cast<const T*>(args.w1);
  float4 w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = channels4(w1 + (size_t)j * c_len, c, c_len);
  const float4 b1 = channels4(vec + 2 * c_len, c, c_len);
  const float4 a2 = channels4(vec + 3 * c_len, c, c_len);
  const float4 ia2 = channels4(vec + 4 * c_len, c, c_len);
  const int per_class = rows / d / kDwOut;    // items per residue class
  for (int item = g; item < rows / kDwOut; item += kDwGroups) {
    const int rho = item / per_class;
    const int r0 = rho + d * kDwOut * (item - rho * per_class);
    const float4* a_rows_of_item = A + r0 * kDwQuads + q;
    const int a_step = d * kDwQuads;
    // row m of the item's rows feeds output v through tap m - v
    float4 acc[kDwOut];
#pragma unroll
    for (int v = 0; v < kDwOut; ++v) acc[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int m = 0; m < kDwOut + K - 1; ++m) {
      const float4 a = a_rows_of_item[m * a_step];
#pragma unroll
      for (int v = 0; v < kDwOut; ++v)
        if (m - v >= 0 && m - v < K) fma4(acc[v], w[m - v], a);
    }
    T* out = s + (size_t)(t0 + r0) * cw + c;
#pragma unroll
    for (int v = 0; v < kDwOut; ++v) {
      const float4 h = make_float4(acc[v].x + b1.x, acc[v].y + b1.y, acc[v].z + b1.z,
                                   acc[v].w + b1.w);
      if (t0 + r0 + v * d < t_len) store4(out + (size_t)v * d * cw, snake4(h, a2, ia2));
    }
  }
}

template <typename T, int K>
cudaError_t launch_dw(const DwArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.t_len + a.rows - 1) / a.rows, (a.cw + 4 * kDwQuads - 1) / (4 * kDwQuads),
                  batch);
  static size_t opted[kMaxDevices] = {};
  return launch(snac_dw_kernel<T, K>, a, grid,
                dw_smem_bytes(a.rows, (K - 1) * a.dilation / 2, sizeof(T)), opted, stream);
}

// K = 1, 3, 5 or 7 taps
template <typename T>
cudaError_t dispatch_dw(const DwArgs& a, int batch, cudaStream_t stream) {
  switch (a.k) {
    case 1: return launch_dw<T, 1>(a, batch, stream);
    case 3: return launch_dw<T, 3>(a, batch, stream);
    case 5: return launch_dw<T, 5>(a, batch, stream);
    case 7: return launch_dw<T, 7>(a, batch, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows, width: the 1x1's tile (see
// dispatch); dilations: n_units host ints; tile: rows of state per block
// (a multiple of 32). Launches the chain kernel. Returns a cudaError_t (0 =
// success).
extern "C" int codec_snac_res_chain(const void* x, const void* w1, const void* w2,
                                    const float* vec, void* out, int batch, int t_len, int c,
                                    int k, int n_units, const int* dilations, int tile,
                                    int rows, int width, int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || n_units < 1 || n_units > kMaxUnits ||
      tile < kRows || tile % kRows != 0)
    return cudaErrorInvalidValue;
  SnacArgs a{x, out, w1, w2, vec, t_len, c, k, n_units, tile, {0, 0, 0, 0}};
  for (int u = 0; u < n_units; ++u) {
    if (dilations[u] < 1) return cudaErrorInvalidValue;
    a.dilation[u] = dilations[u];
  }
  return dispatch<SnacLaunch>(a, batch, rows, width, dtype, static_cast<cudaStream_t>(stream));
}

// The depthwise pass of one unit: x [B, T, C] -> the snaked hidden s [B, T,
// cw] (cw >= C a multiple of 4, s 16-byte aligned), w1 the taps [K, C] (K
// odd, at most 7), vec [6, C]; rows: rows per block, a multiple of 4
// dilation. Returns a cudaError_t (0 = success).
extern "C" int codec_snac_dw(const void* x, const void* w1, const float* vec, void* s,
                             int batch, int t_len, int c, int cw, int k, int dilation, int rows,
                             int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || k > kDwMaxTaps || dilation < 1 || cw < c ||
      cw % 4 != 0 || rows < kDwOut * dilation || rows % (kDwOut * dilation) != 0 ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const DwArgs a{x, w1, vec, s, t_len, c, cw, k, dilation, rows,
                 (c * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) return dispatch_dw<__half>(a, batch, st);
  return dtype == 0 ? dispatch_dw<float>(a, batch, st) : dispatch_dw<__nv_bfloat16>(a, batch, st);
}

// The depthwise pass's dynamic shared memory in bytes (dtype as above).
extern "C" int codec_snac_dw_smem_bytes(int k, int dilation, int rows, int dtype) {
  return dw_smem_bytes(rows, (k - 1) * dilation / 2,
                       dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
}
