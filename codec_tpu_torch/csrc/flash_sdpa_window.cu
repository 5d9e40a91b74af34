// Causal sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/attn_pallas.py::flash_sdpa_window
// (_flash_kernel). Query i attends to key j iff  i - window < j <= i  and
// j < T; window <= 0 means pure causal. q, k, v, o are contiguous
// [B*H, T, D] in f32 or bf16; o has the input dtype. Softmax statistics
// and the accumulator are f32. f32 inputs run on plain f32 FMAs (never
// TF32); bf16 inputs are widened to f32 when staged in shared memory.
//
// What bounds it on this card: for the Mimi decoder transformer
// (D = 64, window 250, T = 500..1500, B*H = 8..32) one block computes
// 64 x ~300 scores of depth 64 — about 2.5 MFLOP against ~100 KB of K/V
// reads, far below the tensor cores' operations-per-byte line, and the
// grid is only 64..256 blocks. So the kernel is bound by memory latency
// and by the shared-memory traffic of its inner loops, not by tensor
// throughput.
//
// How the design answers that: each block owns one (b*h, 64-query) tile
// and visits only the key tiles that intersect the band, so work and
// traffic are O(T * window), never O(T^2), and the [T, T] logits and mask
// never touch device memory. K and V tiles of 32 keys are staged once in
// shared memory (rows padded so the inner loops are free of bank
// conflicts) and reused by all 64 queries. Four threads share a query
// row: each computes the scores of 8 keys, the row's max and sum are
// combined with two warp shuffles, and each thread accumulates a quarter
// of the output row in registers. wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 32;            // keys per shared-memory tile
constexpr int TPR = 4;            // threads per query row
constexpr int NT = BQ * TPR;      // threads per block
constexpr int KPT = BK / TPR;     // keys scored by one thread per tile
constexpr float NEG_INF = -1e30f; // the masked logit of the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], all f32
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) * (int)sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_sdpa_window_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int t_len, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * D;
  constexpr int DPT = D / TPR;    // output columns owned by one thread

  const int tid = threadIdx.x;
  const int r = tid / TPR;        // query row within the tile
  const int c = tid % TPR;        // lane within the row's group of four
  const size_t base = (size_t)blockIdx.x * t_len * D;
  const int q0 = blockIdx.y * BQ;
  const int qi = q0 + r;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int row = idx / D, col = idx % D, t = q0 + row;
    Qs[row * (D + 1) + col] = t < t_len ? to_f32(q[base + (size_t)t * D + col]) : 0.f;
  }

  // key tiles that intersect the band of this query tile
  const int k_first = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int k_last = min(q0 + BQ, t_len) - 1;
  const int kt_lo = k_first / BK, kt_hi = k_last / BK;

  float m_i = NEG_INF, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int u = 0; u < DPT; ++u) acc[u] = 0.f;
  const float* qrow = Qs + r * (D + 1);
  float* prow = Ps + r * (BK + 1);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the previous tile is no longer read
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int row = idx / D, col = idx % D, t = k0 + row;
      const bool ok = t < t_len;  // rows past T stay finite (zero)
      const size_t g = base + (size_t)t * D + col;
      Ks[row * (D + 1) + col] = ok ? to_f32(k[g]) : 0.f;
      Vs[row * D + col] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores of keys c, c + TPR, ... of this tile against query qi
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] = fmaf(qd, Ks[(c + i * TPR) * (D + 1) + d], s[i]);
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kj = k0 + c + i * TPR;
      const bool ok = kj <= qi && kj < t_len && (window <= 0 || kj > qi - window);
      s[i] = ok ? s[i] * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[i]);
    }
    // the four lanes of a row are adjacent lanes of one warp
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m_i, m_tile);
    float l_tile = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      l_tile += p;
      prow[c + i * TPR] = p;
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
    // As in the reference, a row whose keys so far are all masked sums
    // exp(0) terms; the first visible key (the diagonal at the latest)
    // makes alpha exactly 0 and clears them.
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + l_tile;
    m_i = m_new;
#pragma unroll
    for (int u = 0; u < DPT; ++u) acc[u] *= alpha;
    __syncwarp();                 // the row's probabilities are visible

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + c;
#pragma unroll
      for (int u = 0; u < DPT; ++u) acc[u] = fmaf(p, vrow[u * TPR], acc[u]);
    }
  }

  if (qi < t_len) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* orow = o + base + (size_t)qi * D + c;
#pragma unroll
    for (int u = 0; u < DPT; ++u) store(orow + u * TPR, acc[u] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int t_len, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_sdpa_window_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t_len + BQ - 1) / BQ);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o),
                                      t_len, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int codec_flash_sdpa_window(const void* q, const void* k, const void* v, void* o,
                                       int bh, int t_len, int d, int window, float scale,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dtype == 0) return launch<64, float>(q, k, v, o, bh, t_len, window, scale, s);
  if (d == 64 && dtype == 1) return launch<64, __nv_bfloat16>(q, k, v, o, bh, t_len, window, scale, s);
  if (d == 128 && dtype == 0) return launch<128, float>(q, k, v, o, bh, t_len, window, scale, s);
  if (d == 128 && dtype == 1) return launch<128, __nv_bfloat16>(q, k, v, o, bh, t_len, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* codec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
