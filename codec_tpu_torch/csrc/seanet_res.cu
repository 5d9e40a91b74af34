// Fused SEANet residual units of the DAC decoder for Hopper (sm_90a).
//
// Replaces the TPU kernels codec_tpu/ops/seanet_pallas.py::seanet_res_unit
// (_unit_kernel) and ::seanet_res_chain (_chain_kernel). One residual unit
// is
//     out = x + conv1x1(snake(conv_kK,d(snake(x, a1)) + b1, a2)) + b2
// with symmetric zero padding (K-1)*d/2 and snake(v, a) = v + sin^2(a v)/(a + eps).
// The unit kernel computes one unit; the chain kernel computes N units
// (DAC: dilations 1, 3, 9) in one pass, its f32 state resident in shared
// memory. x and out are contiguous [B, T, C]; w1 is WIO [K, C, C]
// (C_out contiguous), w2 is [C, C] (in, out); the chain takes them stacked
// over a leading unit dim. vec holds six f32 rows per unit: a1, 1/(a1+eps),
// b1, a2, 1/(a2+eps), b2. The snake uses the reference's sin^2 formula
// (range reduction by pi, odd Taylor series; _sin2 in the TPU file).
//
// Numerics. f32 activations run on f32 operands and plain f32 FMAs (no
// TF32, no rounding): the parity path. bf16 activations compute what the
// TPU kernel computes: both convs' operands are bf16 (the snaked input and
// the snaked hidden rounded to nearest even, and the bf16 weights), their
// products are summed in f32 on the tensor cores, the unit kernel adds the
// bf16-rounded branch to x in bf16, and the chain keeps its residual in
// f32 across units.
//
// What bounds it on this card: a unit does 2*(K+1)*C FLOP per activation
// element (16*C for K = 7; 12 kFLOP at C = 768) and reads and writes
// about 8 bytes of it in f32, so it sits far above the memory roofline:
// it is bound by arithmetic. In f32 that arithmetic runs on the FMA units
// (TF32 is not allowed on the parity path), where this design is limited
// by the shared-memory wavefronts of its inner loop; in bf16 it runs on
// the tensor cores through mma.sync, limited by ldmatrix traffic and the
// barriers between weight tiles. wgmma with TMA-fed tiles and 64-row
// blocks is where later work makes it fast.
//
// How the design answers that: a thread block of 256 threads owns a
// T tile of one batch row and all C channels, as an implicit GEMM. Output
// channels go in passes of BN columns and input channels in chunks of 32
// that are snaked once and staged in shared memory with their halo. The
// weight tile of each (chunk, tap) step is double-buffered: cp.async
// copies the next one while the current one computes (the weights stay
// resident in the 50 MB L2). The tile policy sets how the 32 x BN pass is
// split: in f32 (FmaTile) each warp owns 4 rows (8 where C is wide) and
// each lane TN columns strided by 32, so weight reads are free of bank
// conflicts and activation reads are broadcasts; in bf16 (MmaTile) each
// warp owns all 32 rows and NT tiles of 8 columns, fed by ldmatrix from
// rows padded to dodge bank conflicts. The snaked hidden of the dilated
// conv, [32, C], stays in shared memory and feeds the 1x1 conv; x is read
// once and out written once. The chain kernel keeps its state
// cur [tile + 2*halo, C] in f32 in shared memory and walks each unit in
// 32-row blocks, updating cur in place (a row block only overwrites rows
// that no later row block reads); the valid region shrinks by
// 2*(K-1)*d/2 per unit, and between units rows outside [0, T) are set back
// to zero as the global computation's zero padding requires. On this card
// the chain recomputes halo rows that three unit launches do not, so the
// wrappers' gate runs it only where a wide tile of its state fits. The
// snake, the tile policies, the 1x1 conv and the launch helpers live in
// seanet_tiles.cuh, which snac_res.cu shares.

#include "seanet_tiles.cuh"

namespace {

struct UnitArgs {
  const void* x;
  void* out;
  const void* w1;                   // [K, C, C]
  const void* w2;                   // [C, C]
  const float* vec;                 // [6, C]
  int t_len, c, k, dilation;
};

struct ChainArgs {
  const void* x;
  void* out;
  const void* w1;                   // [N, K, C, C]
  const void* w2;                   // [N, C, C]
  const float* vec;                 // [N, 6, C]
  int t_len, c, k, n_units, tile;
  int dilation[kMaxUnits];
};

// Shared memory of the buffers every kernel has, in bytes (the wrappers in
// ops/seanet_cuda.py compute the same sums to pick the chain's tile).
template <typename Tile>
size_t common_bytes(int c, int halo) {
  using Op = typename Tile::Op;
  return sizeof(Op) * ((size_t)kRows * Tile::s_stride(c)  // S
                       + Tile::a_elems(halo)                // A
                       + 2 * Tile::kWElems);                // W, two
}

// The dilated conv of one unit over one 32-row block, then bias and
// snake: S[r][co] = Op(snake(sum_j sum_ci A[r + j d][ci] w1[j][ci][co]
// + b1[co], a2)). load_a(As, ci0) stages the snaked input rows
// [0, 32 + 2 halo) of channels [ci0, ci0 + 32). The weight tile of the
// next (chunk, tap) step loads into the other half of Ws while the current
// one computes. Ends with S complete.
template <typename Tile, typename T, typename LoadA>
__device__ __forceinline__ void dilated_conv(typename Tile::Op* S, typename Tile::Op* As,
                                             typename Tile::Op* Ws, const T* __restrict__ w1,
                                             const float* __restrict__ vec, int c_len,
                                             int k_len, int dilation, LoadA load_a) {
  constexpr int BN = Tile::kBN, WS = Tile::kWStride;
  const int cp = pad_channels(c_len), s_stride = Tile::s_stride(c_len);
  const float* b1 = vec + 2 * c_len;
  const float* a2 = vec + 3 * c_len;
  const float* ia2 = vec + 4 * c_len;
  const size_t tap = (size_t)c_len * c_len;
  for (int co0 = 0; co0 < cp; co0 += BN) {
    float acc[Tile::kR][Tile::kC];
#pragma unroll
    for (int i = 0; i < Tile::kR; ++i)
#pragma unroll
      for (int n = 0; n < Tile::kC; ++n) acc[i][n] = 0.0f;
    __syncthreads();                         // Ws is free
    load_w<BN, WS>(Ws, w1, c_len, 0, co0);
    int step = 0;
    for (int ci0 = 0; ci0 < c_len; ci0 += kKc) {
      __syncthreads();                       // As is free
      load_a(As, ci0);
      for (int j = 0; j < k_len; ++j, ++step) {
        cp_async_wait_all();                 // this step's weight tile
        __syncthreads();                     // ... and As are staged, and the
                                             // other half of Ws is free
        if (j + 1 < k_len)
          load_w<BN, WS>(Ws + ((step + 1) & 1) * Tile::kWElems, w1 + (j + 1) * tap, c_len,
                         ci0, co0);
        else if (ci0 + kKc < c_len)
          load_w<BN, WS>(Ws + ((step + 1) & 1) * Tile::kWElems, w1, c_len, ci0 + kKc, co0);
        Tile::accumulate(acc, As, Tile::kAStride, j * dilation,
                         Ws + (step & 1) * Tile::kWElems);
      }
    }
#pragma unroll
    for (int n = 0; n < Tile::kC; ++n) {
      const int co = co0 + Tile::col(n);
      if (co >= cp) continue;
#pragma unroll
      for (int i = 0; i < Tile::kR; ++i) {
        float v = 0.0f;                      // pad channels stay zero
        if (co < c_len) v = snake(acc[i][n] + b1[co], a2[co], ia2[co]);
        store(S + Tile::row(i) * s_stride + co, v);
      }
    }
  }
  __syncthreads();                           // S is complete
}


// One residual unit; block (blockIdx.x, blockIdx.y) owns rows
// [32 blockIdx.x, +32) of batch row blockIdx.y.
template <typename T, typename Tile>
__global__ void __launch_bounds__(kThreads)
seanet_res_unit_kernel(UnitArgs args) {
  using Op = typename Tile::Op;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_len = args.c, t_len = args.t_len;
  const int halo = (args.k - 1) * args.dilation / 2;
  const int t0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * t_len * c_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.out) + base;
  const float* __restrict__ vec = args.vec;
  Op* S = reinterpret_cast<Op*>(smem);
  Op* As = S + kRows * Tile::s_stride(c_len);
  Op* Ws = As + Tile::a_elems(halo);

  const int a_rows = kRows + 2 * halo;
  auto load_a = [&](Op* A, int ci0) {
    for (int idx = threadIdx.x; idx < a_rows * kKc; idx += kThreads) {
      const int r = idx / kKc, k = idx % kKc;
      const int pos = t0 - halo + r, ci = ci0 + k;
      float v = 0.0f;
      if (pos >= 0 && pos < t_len && ci < c_len)
        v = snake(to_f32(x[(size_t)pos * c_len + ci]), vec[ci], vec[c_len + ci]);
      store(A + r * Tile::kAStride + k, v);
    }
  };
  dilated_conv<Tile>(S, As, Ws, static_cast<const T*>(args.w1), vec, c_len, args.k,
                     args.dilation, load_a);

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
        // the branch in x's dtype, then the residual (as the reference)
        const float y = round_to<T>(acc[i][n] + b2[co]);
        store(out + at, to_f32(x[at]) + y);
      }
    }
  };
  pointwise_conv<Tile>(S, Ws, static_cast<const T*>(args.w2), c_len, epi);
}

// N residual units; block (blockIdx.x, blockIdx.y) owns rows
// [tile blockIdx.x, +tile) of batch row blockIdx.y and reads them with a
// halo of sum_u (K-1) d_u / 2 rows on each side.
template <typename T, typename Tile>
__global__ void __launch_bounds__(kThreads)
seanet_res_chain_kernel(ChainArgs args) {
  using Op = typename Tile::Op;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_len = args.c, t_len = args.t_len, k_len = args.k, tile = args.tile;
  int halo = 0, halo_max = 0;
  for (int u = 0; u < args.n_units; ++u) {
    const int h = (k_len - 1) * args.dilation[u] / 2;
    halo += h;
    halo_max = max(halo_max, h);
  }
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * t_len * c_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.out) + base;
  // cur rows have an odd stride, so a warp touching 32 rows of one column
  // hits 32 banks; its size is rounded up to 16 bytes, so the tile's
  // buffers behind it stay aligned for cp.async and ldmatrix
  float* cur = reinterpret_cast<float*>(smem);
  const int cs = c_len | 1;
  const size_t cur_floats = ((size_t)(tile + 2 * halo) * cs + 3) / 4 * 4;
  Op* S = reinterpret_cast<Op*>(cur + cur_floats);
  Op* As = S + kRows * Tile::s_stride(c_len);
  Op* Ws = As + Tile::a_elems(halo_max);

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
    const T* w1 = static_cast<const T*>(args.w1) + (size_t)u * k_len * c_len * c_len;
    const T* w2 = static_cast<const T*>(args.w2) + (size_t)u * c_len * c_len;
    const float* b2 = vec + 5 * c_len;
    const bool last = u == args.n_units - 1;
    off += h;
    for (int rb = 0; rb < l_out; rb += kRows) {
      const int a_rows = kRows + 2 * h;
      auto load_a = [&](Op* A, int ci0) {
        for (int idx = threadIdx.x; idx < a_rows * kKc; idx += kThreads) {
          const int r = rb + idx / kKc, k = idx % kKc, ci = ci0 + k;
          float v = 0.0f;
          if (r < len && ci < c_len)
            v = snake(cur[(size_t)r * cs + ci], vec[ci], vec[c_len + ci]);
          store(A + (idx / kKc) * Tile::kAStride + k, v);
        }
      };
      dilated_conv<Tile>(S, As, Ws, w1, vec, c_len, k_len, d, load_a);

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
cudaError_t launch_unit(const UnitArgs& a, int batch, cudaStream_t s) {
  const int halo = (a.k - 1) * a.dilation / 2;
  const dim3 grid((a.t_len + kRows - 1) / kRows, batch);
  static size_t opted[kMaxDevices] = {};
  return launch(seanet_res_unit_kernel<T, Tile>, a, grid, common_bytes<Tile>(a.c, halo),
                opted, s);
}

template <typename T, typename Tile>
cudaError_t launch_chain(const ChainArgs& a, int batch, cudaStream_t s) {
  int halo = 0, halo_max = 0;
  for (int u = 0; u < a.n_units; ++u) {
    const int h = (a.k - 1) * a.dilation[u] / 2;
    halo += h;
    halo_max = h > halo_max ? h : halo_max;
  }
  const size_t cur_floats = ((size_t)(a.tile + 2 * halo) * (a.c | 1) + 3) / 4 * 4;
  const size_t bytes = cur_floats * sizeof(float) + common_bytes<Tile>(a.c, halo_max);
  const dim3 grid((a.t_len + a.tile - 1) / a.tile, batch);
  static size_t opted[kMaxDevices] = {};
  return launch(seanet_res_chain_kernel<T, Tile>, a, grid, bytes, opted, s);
}


template <typename T, typename Tile>
struct UnitLaunch {
  static cudaError_t run(const UnitArgs& a, int batch, cudaStream_t s) {
    return launch_unit<T, Tile>(a, batch, s);
  }
};

template <typename T, typename Tile>
struct ChainLaunch {
  static cudaError_t run(const ChainArgs& a, int batch, cudaStream_t s) {
    return launch_chain<T, Tile>(a, batch, s);
  }
};


}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows, width: the tile (see dispatch).
// Returns a cudaError_t (0 = success).
extern "C" int codec_seanet_res_unit(const void* x, const void* w1, const void* w2,
                                     const float* vec, void* out, int batch, int t_len,
                                     int c, int k, int dilation, int rows, int width,
                                     int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || dilation < 1) return cudaErrorInvalidValue;
  const UnitArgs a{x, out, w1, w2, vec, t_len, c, k, dilation};
  return dispatch<UnitLaunch>(a, batch, rows, width, dtype,
                              static_cast<cudaStream_t>(stream));
}

// dilations: n_units host ints; tile: rows per block (a multiple of 32).
extern "C" int codec_seanet_res_chain(const void* x, const void* w1, const void* w2,
                                      const float* vec, void* out, int batch, int t_len,
                                      int c, int k, int n_units, const int* dilations,
                                      int tile, int rows, int width, int dtype,
                                      void* stream) {
  if (!valid_shape(batch, t_len, c, k) || n_units < 1 || n_units > kMaxUnits ||
      tile < kRows || tile % kRows != 0)
    return cudaErrorInvalidValue;
  ChainArgs a{x, out, w1, w2, vec, t_len, c, k, n_units, tile, {0, 0, 0, 0}};
  for (int u = 0; u < n_units; ++u) {
    if (dilations[u] < 1) return cudaErrorInvalidValue;
    a.dilation[u] = dilations[u];
  }
  return dispatch<ChainLaunch>(a, batch, rows, width, dtype,
                               static_cast<cudaStream_t>(stream));
}

// The current device's opt-in shared memory per block, in bytes.
extern "C" int codec_smem_per_block_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
