// Fused depthwise residual units of the SNAC decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/seanet_pallas.py::snac_res_chain
// (_dw_chain_kernel). One residual unit is
//     out = x + conv1x1(snake(dwconv_K,d(snake(x, a1)) + b1, a2)) + b2
// where dwconv_K,d is a depthwise (per-channel) dilated conv with symmetric
// zero padding (K-1)*d/2 and snake(v, a) = v + sin^2(a v)/(a + eps), for
// any sign of a. The chain kernel computes N units (SNAC: dilations 1, 3,
// 9) in one pass with its f32 state resident in shared memory; the unit
// kernel computes one unit (N = 1) staging its input from device memory.
// x and out are contiguous [B, T, C]; w1 holds the per-channel taps
// [N, K, C]; w2 is [N, C, C] (in, out); vec holds six f32 rows per unit:
// a1, 1/(a1+eps), b1, a2, 1/(a2+eps), b2.
//
// Numerics, as the TPU kernel: the snaked input, the depthwise taps and
// their sums are f32 in both dtypes (bf16 taps are widened exactly). The
// snaked hidden feeds the 1x1 conv in x's dtype: f32 operands on plain f32
// FMAs (no TF32: the parity path), or bf16 operands with f32 sums on the
// tensor cores (mma.sync). The residual is added in f32 and rounded to x's
// dtype once per launch; the chain keeps it f32 across its units.
//
// What bounds it on this card: per activation element a unit does 2*C FLOP
// of 1x1 conv, 2*K of depthwise taps and two snakes, and reads and writes
// one element (8 bytes in f32). At SNAC's widths (C = 64..512) that is
// 16-128 FLOP per byte: above the f32 FMA ridge (67 TFLOP/s over 3.35
// TB/s = 20 FLOP/byte) from C = 64 on, so f32 is bound by arithmetic; in
// bf16 the 1x1 runs on the tensor cores (ridge near 295 FLOP/byte), so a
// unit is bound by its bytes. The design keeps activations out of device
// memory between units; its 1x1 is the SEANet kernels' tile (one 32-row
// block, weight tiles double-buffered with cp.async), which is where later
// work (wgmma, TMA) makes it fast.
//
// How the design answers that: a thread block of 256 threads owns 32 rows
// (unit) or a tile of rows (chain) of one batch row and all C channels.
// The depthwise conv has no channel contraction, so it runs on the FMA
// units in f32: input channels go in chunks of 32, snaked once into
// shared memory with their halo (A, f32), and each thread sums the K taps
// of one channel over 4 rows into the snaked hidden S [32, C] in x's
// dtype. The 1x1 conv then reads S through the tile policy. The chain
// keeps cur [tile + 2*halo, C | 1] in f32 in shared memory and walks each
// unit in 32-row blocks, updating cur in place, re-zeroing rows outside
// [0, T) between units as the global computation's zero padding requires.
// Its state grows with C (at C = 512 not even 32 rows fit) and leaves one
// or two blocks per SM, where the unit kernel runs three to six: on an
// H100 three unit launches beat the chain at every SNAC width, so a decode
// launches the unit kernel three times per block
// (ops/seanet_cuda.py::snac_res_units), and the chain serves callers that
// ask for N > 1 units in one pass.

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

// One unit (N = 1); block (blockIdx.x, blockIdx.y) owns rows
// [32 blockIdx.x, +32) of batch row blockIdx.y.
template <typename T, typename Tile>
__global__ void __launch_bounds__(kThreads)
snac_res_unit_kernel(SnacArgs args) {
  using Op = typename Tile::Op;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_len = args.c, t_len = args.t_len, d = args.dilation[0];
  const int halo = (args.k - 1) * d / 2;
  const int t0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * t_len * c_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.out) + base;
  const float* __restrict__ vec = args.vec;
  Op* S = reinterpret_cast<Op*>(smem);
  Op* Ws = S + kRows * Tile::s_stride(c_len);
  float* A = reinterpret_cast<float*>(Ws + 2 * Tile::kWElems);

  const int a_rows = kRows + 2 * halo;
  auto load_a = [&](float* As, int ci0) {
    for (int idx = threadIdx.x; idx < a_rows * kKc; idx += kThreads) {
      const int r = idx / kKc, ci = ci0 + idx % kKc;
      const int pos = t0 - halo + r;
      float v = 0.0f;
      if (pos >= 0 && pos < t_len && ci < c_len)
        v = snake(to_f32(x[(size_t)pos * c_len + ci]), vec[ci], vec[c_len + ci]);
      As[idx] = v;
    }
  };
  depthwise_conv<Tile>(S, A, static_cast<const T*>(args.w1), vec, c_len, args.k, d, load_a);

  const float* b2 = vec + 5 * c_len;
  auto epi = [&](float (&acc)[Tile::kR][Tile::kC], int co0) {
#pragma unroll
    for (int i = 0; i < Tile::kR; ++i) {
      const int t = t0 + Tile::row(i);
      if (t >= t_len) continue;
#pragma unroll
      for (int n = 0; n < Tile::kC; ++n) {
        const int co = co0 + Tile::col(n);
        if (co >= c_len) continue;
        const size_t at = (size_t)t * c_len + co;
        store(out + at, to_f32(x[at]) + (acc[i][n] + b2[co]));
      }
    }
  };
  pointwise_conv<Tile>(S, Ws, static_cast<const T*>(args.w2), c_len, epi);
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
    if (a.n_units == 1) {
      const int halo = (a.k - 1) * a.dilation[0] / 2;
      const dim3 grid((a.t_len + kRows - 1) / kRows, batch);
      static size_t opted[kMaxDevices] = {};
      return launch(snac_res_unit_kernel<T, Tile>, a, grid, dw_common_bytes<Tile>(a.c, halo),
                    opted, s);
    }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows, width: the 1x1's tile (see
// dispatch); dilations: n_units host ints. n_units = 1 launches the unit
// kernel (tile is ignored); n_units > 1 the chain kernel with `tile` rows
// per block (a multiple of 32). Returns a cudaError_t (0 = success).
extern "C" int codec_snac_res_chain(const void* x, const void* w1, const void* w2,
                                    const float* vec, void* out, int batch, int t_len, int c,
                                    int k, int n_units, const int* dilations, int tile,
                                    int rows, int width, int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || n_units < 1 || n_units > kMaxUnits ||
      (n_units > 1 && (tile < kRows || tile % kRows != 0)))
    return cudaErrorInvalidValue;
  SnacArgs a{x, out, w1, w2, vec, t_len, c, k, n_units, tile, {0, 0, 0, 0}};
  for (int u = 0; u < n_units; ++u) {
    if (dilations[u] < 1) return cudaErrorInvalidValue;
    a.dilation[u] = dilations[u];
  }
  return dispatch<SnacLaunch>(a, batch, rows, width, dtype, static_cast<cudaStream_t>(stream));
}
