// Causal sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel codec_tpu/ops/attn_pallas.py::flash_sdpa_window
// (_flash_kernel). q and o are contiguous [B*H, Tq, D], k and v [B*H, Tk, D]
// with Tk >= Tq, in f32, bf16 or f16, D 64 or 128; o has the input dtype. Query
// i sits at key position p = Tk - Tq + i and attends to key j iff
// k_start <= j <= p  and  p - window < j  (window <= 0: no window). With
// Tk == Tq and k_start == 0 that is causal self-attention; a streaming step
// passes the carried keys of the last window - 1 positions before its own
// (Tk > Tq) and masks with k_start the carried slots that hold positions
// before the stream began. Softmax
// statistics and the accumulator are f32. Masked logits are -1e30, as in
// the reference, which also fixes its masked-row behaviour: a row whose
// keys so far are all masked sums exp(0) terms, and the first visible key
// (the diagonal at the latest) makes their weight exactly 0.
//
// Both products run on the tensor cores with mma.sync (tf32x3.cuh). f32:
// QK^T and PV in split f32, three TF32 passes each (relative error near
// 1e-6, the reference's Precision.HIGHEST). bf16 and f16: QK^T on
// m16n8k16 (exact products, f32 sums); PV keeps P at f32 accuracy as the
// reference does (f32 p times v at HIGHEST): P = P_hi + P_lo in the input's
// 16-bit type, two passes, V exact.
//
// What bounds it on this card: for the Mimi transformers (D 64, window
// 250, T 500..1500, B*H 8..32) the work is small, 0.19 GFLOP at 20 s b1
// (2.9 µs at 67 TFLOP/s f32 FMA, 1.2 µs for the three TF32 passes at 495
// TFLOP/s), and the inputs are 1 MB. What costs is latency: how many warps
// are in flight and how long a key tile's chain of copy, products and
// softmax takes; and, past T 500, the L2 traffic of re-reading each key
// tile once per query tile whose band it meets.
//
// How the design answers that: a block takes BQ queries (16, or 32 in f32
// at D 64: two m16 row tiles per warp) of one (b, h). Its four warps share
// the query tile and split the key tiles (16 keys) that intersect the band
// round-robin, so only the band is ever visited; each warp streams its own
// tiles by cp.async into a private double buffer (no block barrier in the
// key loop), keeps its own (m, l, accumulator), and the four partial
// softmaxes are merged through shared memory at the end. Each K and V
// fragment, loaded and split once, serves every row tile of the warp. The
// online softmax works on the accumulator fragments; in f32 the PV pass
// reorders each 8-key step (fragment column t is key 2t, t + 4 is key
// 2t + 1) so that the score fragments are the probability fragments
// without a shuffle. Query rows per block and warps per block were picked
// from a sweep on the card (PERF.md §6, "Sweeps"): 32 rows in f32 at D 64 (B1 H8
// T500 is then 128 blocks) halve the key tiles' reads and beat 16 rows at
// every timed shape; bf16 keeps 16 rows (256 blocks). A Mimi streaming step
// (Tq 2-10 queries against 249 carried keys plus its own) fills one query
// tile per (b, h), most of whose rows are past Tq: 8 blocks at b1, each
// walking the 16 key tiles of the band. That is right and simple, not fast
// (PERF.md §6 has its time beside its bound).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32x3.cuh"

namespace {

using tf32x3::ldsm_x4;
using tf32x3::ldsm_x4_trans;
using tf32x3::mma_3x;
using tf32x3::mma_16;
using tf32x3::smem_u32;
using tf32x3::split;
using tf32x3::split_16;

constexpr int BK = 16;            // keys per tile
constexpr float NEG_INF = -1e30f; // the masked logit of the reference

template <typename T>
struct Elem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kPad = kF32 ? 4 : 8;      // 16 bytes past each staged row
  static constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte copy
};

// A block: MT m16 row tiles of queries (BQ = 16·MT), shared by W warps that
// split the band's key tiles. Shared memory, in bytes: the query tile (f32:
// hi and lo [BQ][D + 4]; bf16: [BQ][D + 8]), the merge's statistics
// [3][W][BQ] f32 (m, l, weights), then per warp two K and two V tiles
// [16][D + pad]; a warp's accumulator [BQ][D + 8] f32 takes its own tiles'
// place for the merge. MT at D 64 and W are the sweep's picks (PERF.md §6;
// tools/mimi_times.py --what attn_tiles builds copies with others).
template <int D, typename T>
struct Cfg {
  static constexpr int MT = D != 64 ? 1 : Elem<T>::kF32 ? 2 : 1;
  static constexpr int W = 4;
  static constexpr int BQ = 16 * MT, NT = 32 * W;
  static constexpr int kRow = D + Elem<T>::kPad;
  static constexpr int kQ = (Elem<T>::kF32 ? 2 : 1) * BQ * kRow * (int)sizeof(T);
  static constexpr int kStats = 4 * 3 * W * BQ;
  static constexpr int kTile = BK * kRow * (int)sizeof(T);
  static constexpr int kWarp = 4 * kTile;        // K and V, double buffered
  static constexpr int kAcc = BQ * (D + 8) * 4;
  static constexpr int kWarpBytes = kWarp > kAcc ? kWarp : kAcc;
  static constexpr int kTotal = kQ + kStats + W * kWarpBytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the warp stages keys [k0, k0 + 16) of K and V; rows past Tk are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k, const T* v, size_t base,
                                          int k0, int t_len, int lane) {
  constexpr int kPieces = D / Elem<T>::kVec, kRow = Cfg<D, T>::kRow;
#pragma unroll
  for (int e = lane; e < BK * kPieces; e += 32) {
    const int row = e / kPieces, col = (e % kPieces) * Elem<T>::kVec, t = k0 + row;
    const bool ok = t < t_len;
    const size_t g = ok ? base + static_cast<size_t>(t) * D + col : base;
    cp_async16(ks + row * kRow + col, k + g, ok ? 16 : 0);
    cp_async16(vs + row * kRow + col, v + g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <int D, typename T>
__global__ void __launch_bounds__(Cfg<D, T>::NT)
flash_sdpa_window_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         int t_q, int t_k, int k_start, int window, float scale) {
  using C = Cfg<D, T>;
  constexpr bool kF32 = Elem<T>::kF32;
  constexpr int MT = C::MT, W = C::W, BQ = C::BQ, NT = C::NT;
  constexpr int kRow = C::kRow, NDT = D / 8;   // output n-tiles of 8 columns
  extern __shared__ __align__(16) uint8_t smem[];
  T* q_s = reinterpret_cast<T*>(smem);                       // f32: hi, then lo
  float* stats = reinterpret_cast<float*>(smem + C::kQ);     // m, l, weights [W][BQ]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3, j = lane >> 3;
  uint8_t* mine = smem + C::kQ + C::kStats + warp * C::kWarpBytes;
  T* k_s = reinterpret_cast<T*>(mine);                       // [2][16][kRow]
  T* v_s = k_s + 2 * BK * kRow;                              // [2][16][kRow]

  const size_t q_base = static_cast<size_t>(blockIdx.x) * t_q * D;
  const size_t k_base = static_cast<size_t>(blockIdx.x) * t_k * D;
  const int q0 = blockIdx.y * BQ, q_off = t_k - t_q;   // query i at key q_off + i
  // key tiles that intersect the band of this query tile, dealt to the
  // warps round-robin
  const int k_first = window > 0 ? max(q_off + q0 - window + 1, k_start) : k_start;
  const int k_last = q_off + min(q0 + BQ, t_q) - 1;
  const int kt_lo = k_first / BK, kt_hi = k_last / BK;
  int kt = kt_lo + warp;
  if (kt <= kt_hi) load_tile<D, T>(k_s, v_s, k, v, k_base, kt * BK, t_k, lane);
  cp_async_commit();

  // the query tile (f32: its split); rows past Tq are zero
  for (int e = tid; e < BQ * D; e += NT) {
    const int row = e / D, col = e % D, t = q0 + row;
    const T val = t < t_q ? q[q_base + static_cast<size_t>(t) * D + col] : T(0.f);
    if constexpr (kF32) {
      uint32_t h, l;
      split(to_f32(val), h, l);
      reinterpret_cast<uint32_t*>(q_s)[row * kRow + col] = h;
      reinterpret_cast<uint32_t*>(q_s)[(BQ + row) * kRow + col] = l;
    } else {
      q_s[row * kRow + col] = val;
    }
  }
  __syncthreads();

  // rows 16·mt + gq + 8·h of the tile: their running max, this lane's part
  // of their sums, and the accumulator fragments (c0, c1 row gq; c2, c3 row
  // gq + 8 of m-tile mt)
  float m_r[MT][2], l_r[MT][2], acc[MT][NDT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[mt][h] = NEG_INF;
      l_r[mt][h] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nd][c] = 0.f;
  }
  // ldmatrix rows: A (the query tile) 8·(j & 1) + (lane & 7), 16-byte word
  // (j >> 1); B (a K tile) 8·(j >> 1) + (lane & 7), word (j & 1)
  const int a_row = (lane & 7) + ((j & 1) << 3), b_row = (lane & 7) + ((j >> 1) << 3);
  const uint32_t qa = smem_u32(q_s) + (a_row * kRow) * sizeof(T) + ((j >> 1) << 4);
  constexpr uint32_t kMtBytes = 16 * kRow * sizeof(T);      // one m-tile of the query tile
  constexpr uint32_t kLoBytes = BQ * kRow * sizeof(T);      // f32: hi to lo

  for (int i = 0; kt <= kt_hi; ++i, kt += W) {
    const int buf = i & 1;
    if (kt + W <= kt_hi)
      load_tile<D, T>(k_s + (buf ^ 1) * BK * kRow, v_s + (buf ^ 1) * BK * kRow, k, v, k_base,
                      (kt + W) * BK, t_k, lane);
    cp_async_commit();
    cp_async_wait1();         // this lane's copies of tile i have landed
    __syncwarp();             // and every lane's
    const T* kb = k_s + buf * BK * kRow;
    const T* vb = v_s + buf * BK * kRow;
    const uint32_t kbase = smem_u32(kb) + (b_row * kRow) * sizeof(T) + ((j & 1) << 4);

    // S = Q K^T: per m-tile 16 queries x 16 keys, two n-tiles of 8 keys;
    // each K fragment serves every m-tile
    float s[MT][2][4] = {};
    if constexpr (kF32) {
      // at most eight k8 steps unrolled: D 128 spilled when all were
#pragma unroll 8
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t braw[4], bh[4], bl[4];
        ldsm_x4(braw, kbase + ks * 32);
#pragma unroll
        for (int u = 0; u < 4; ++u) split(__uint_as_float(braw[u]), bh[u], bl[u]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ah[4], al[4];
          ldsm_x4(ah, qa + mt * kMtBytes + ks * 32);
          ldsm_x4(al, qa + kLoBytes + mt * kMtBytes + ks * 32);
          mma_3x(s[mt][0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3x(s[mt][1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, kbase + ks * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, qa + mt * kMtBytes + ks * 32);
          mma_16<T>(s[mt][0], a, b[0], b[1]);
          mma_16<T>(s[mt][1], a, b[2], b[3]);
        }
      }
    }

    // mask, scale and the online softmax on the fragments; s[mt][nt][2h + c]
    // is row q0 + 16·mt + gq + 8h (key position q_off + that), key
    // kt·16 + 8nt + 2tq + c
    const int k0 = kt * BK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float m_t[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = q_off + q0 + 16 * mt + gq + 8 * h, kj = k0 + 8 * nt + 2 * tq + c;
            const bool ok = kj <= qi && kj >= k_start && kj < t_k &&
                            (window <= 0 || kj > qi - window);
            float& x = s[mt][nt][2 * h + c];
            x = ok ? x * scale : NEG_INF;
            m_t[h] = fmaxf(m_t[h], x);
          }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the quad's four lanes hold row gq + 8h
        m_t[h] = fmaxf(m_t[h], __shfl_xor_sync(0xffffffffu, m_t[h], 1));
        m_t[h] = fmaxf(m_t[h], __shfl_xor_sync(0xffffffffu, m_t[h], 2));
        const float m_new = fmaxf(m_r[mt][h], m_t[h]);
        alpha[h] = expf(m_r[mt][h] - m_new);
        m_r[mt][h] = m_new;
        l_r[mt][h] *= alpha[h];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& x = s[mt][nt][c];
          x = expf(x - m_r[mt][c >> 1]);
          l_r[mt][c >> 1] += x;
        }
#pragma unroll
      for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nd][c] *= alpha[c >> 1];
    }

    // acc += P V; each V fragment serves every m-tile
    if constexpr (kF32) {
      // 8-key step nt: fragment column tq is key 2tq, column tq + 4 is key
      // 2tq + 1, so a = (c0, c2, c1, c3) of the score fragment and b reads
      // V rows 2tq and 2tq + 1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split(s[mt][nt][0], ph[mt][0], pl[mt][0]);
          split(s[mt][nt][2], ph[mt][1], pl[mt][1]);
          split(s[mt][nt][1], ph[mt][2], pl[mt][2]);
          split(s[mt][nt][3], ph[mt][3], pl[mt][3]);
        }
        const float* v0 = reinterpret_cast<const float*>(vb) + (8 * nt + 2 * tq) * kRow + gq;
#pragma unroll
        for (int nd = 0; nd < NDT; ++nd) {
          uint32_t b0h, b0l, b1h, b1l;
          split(v0[8 * nd], b0h, b0l);
          split(v0[kRow + 8 * nd], b1h, b1l);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3x(acc[mt][nd], ph[mt], pl[mt], b0h, b1h, b0l, b1l);
        }
      }
    } else {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_16<T>(s[mt][0][0], s[mt][0][1], ph[mt][0], pl[mt][0]);
        split_16<T>(s[mt][0][2], s[mt][0][3], ph[mt][1], pl[mt][1]);
        split_16<T>(s[mt][1][0], s[mt][1][1], ph[mt][2], pl[mt][2]);
        split_16<T>(s[mt][1][2], s[mt][1][3], ph[mt][3], pl[mt][3]);
      }
      // V [key][d] through ldmatrix.trans: keys 8·(j & 1) + (lane & 7),
      // columns 8·(2·pair + (j >> 1))
      const uint32_t vbase = smem_u32(vb) + (a_row * kRow) * 2 + ((j >> 1) << 4);
#pragma unroll
      for (int pair = 0; pair < NDT / 2; ++pair) {
        uint32_t b[4];
        ldsm_x4_trans(b, vbase + pair * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16<T>(acc[mt][2 * pair], pl[mt], b[0], b[1]);
          mma_16<T>(acc[mt][2 * pair], ph[mt], b[0], b[1]);
          mma_16<T>(acc[mt][2 * pair + 1], pl[mt], b[2], b[3]);
          mma_16<T>(acc[mt][2 * pair + 1], ph[mt], b[2], b[3]);
        }
      }
    }
    __syncwarp();             // every lane is done with this buffer
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // merge the warps' partial softmaxes: warp w's (m, l) and its
  // accumulator, then out = sum_w e^(m_w - M) acc_w / sum_w e^(m_w - M) l_w
  float* acc_s = reinterpret_cast<float*>(mine);   // [BQ][D + 8]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (tq == 0) {
        stats[warp * BQ + 16 * mt + gq + 8 * h] = m_r[mt][h];
        stats[(W + warp) * BQ + 16 * mt + gq + 8 * h] = l;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(acc_s + (16 * mt + gq + 8 * h) * (D + 8) + 8 * nd + 2 * tq) =
            make_float2(acc[mt][nd][2 * h], acc[mt][nd][2 * h + 1]);
  __syncthreads();
  // row r's weight of warp w over the denominator, at stats[(2W + w)·BQ + r]
  if (tid < BQ) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, stats[w * BQ + tid]);
    float f[W], l = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      f[w] = expf(stats[w * BQ + tid] - mx);
      l += f[w] * stats[(W + w) * BQ + tid];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int w = 0; w < W; ++w) stats[(2 * W + w) * BQ + tid] = f[w] * inv;
  }
  __syncthreads();
  const float* acc0 = reinterpret_cast<const float*>(smem + C::kQ + C::kStats);
  // the output rows' base, read again from %ctaid rather than kept live
  // across the key loop: kept, it made the f32 D 128 instance spill
  uint32_t bx;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  const size_t o_base = static_cast<size_t>(bx) * t_q * D;
  for (int e = tid; e < BQ * D / 4; e += NT) {
    const int row = e / (D / 4), col = 4 * (e % (D / 4)), t = q0 + row;
    if (t >= t_q) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float wt = stats[(2 * W + w) * BQ + row];
      const float4 a = *reinterpret_cast<const float4*>(
          acc0 + (w * C::kWarpBytes) / 4 + row * (D + 8) + col);
      sum.x += wt * a.x;
      sum.y += wt * a.y;
      sum.z += wt * a.z;
      sum.w += wt * a.w;
    }
    T* out = o + o_base + static_cast<size_t>(t) * D + col;
    store(out, sum.x);
    store(out + 1, sum.y);
    store(out + 2, sum.z);
    store(out + 3, sum.w);
  }
}

constexpr int kMaxDevices = 64;

// opted[dev]: whether this kernel was opted in to its dynamic shared memory
// on device dev, so cudaFuncSetAttribute (a costly host call) runs once per
// device, not once per launch
template <int D, typename T>
cudaError_t launch(int dev, const void* q, const void* k, const void* v, void* o, int bh,
                   int t_q, int t_k, int k_start, int window, float scale,
                   cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  using C = Cfg<D, T>;
  constexpr int bytes = C::kTotal;
  auto kernel = flash_sdpa_window_kernel<D, T>;
  if (dev >= kMaxDevices || !opted[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const dim3 grid(bh, (t_q + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), t_q, t_k,
                                      k_start, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for head dim d and dtype (0 = float32,
// 1 = bfloat16, 2 = float16), in bytes; 0 for a pair the kernel does not take.
extern "C" int codec_flash_sdpa_window_smem_bytes(int d, int dtype) {
  if (d == 64 && dtype == 0) return Cfg<64, float>::kTotal;
  if (d == 64 && dtype == 1) return Cfg<64, __nv_bfloat16>::kTotal;
  if (d == 64 && dtype == 2) return Cfg<64, __half>::kTotal;
  if (d == 128 && dtype == 0) return Cfg<128, float>::kTotal;
  if (d == 128 && dtype == 1) return Cfg<128, __nv_bfloat16>::kTotal;
  if (d == 128 && dtype == 2) return Cfg<128, __half>::kTotal;
  return 0;
}

// q, o [bh, t_q, d]; k, v [bh, t_k, d] with t_k >= t_q >= 1 and
// 0 <= k_start <= t_k - t_q; dtype: 0 = float32, 1 = bfloat16, 2 = float16;
// q, k, v, o
// 16-byte aligned. Returns a cudaError_t (0 = success).
extern "C" int codec_flash_sdpa_window(const void* q, const void* k, const void* v, void* o,
                                       int bh, int t_q, int t_k, int k_start, int d,
                                       int window, float scale, int dtype, void* stream) {
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  if (bh < 1 || t_q < 1 || t_k < t_q || k_start < 0 || k_start > t_k - t_q)
    return cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dtype == 0)
    return launch<64, float>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  if (d == 64 && dtype == 1)
    return launch<64, __nv_bfloat16>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  if (d == 64 && dtype == 2)
    return launch<64, __half>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  if (d == 128 && dtype == 0)
    return launch<128, float>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  if (d == 128 && dtype == 1)
    return launch<128, __nv_bfloat16>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  if (d == 128 && dtype == 2)
    return launch<128, __half>(dev, q, k, v, o, bh, t_q, t_k, k_start, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* codec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
