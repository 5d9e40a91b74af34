// Fused SEANet residual units of the DAC decoder for Hopper (sm_90a).
//
// Replaces the TPU kernels codec_tpu/ops/seanet_pallas.py::seanet_res_unit
// (_unit_kernel) and ::seanet_res_chain (_chain_kernel). One residual unit
// is
//     out = x + conv1x1(snake(conv_kK,d(snake(x, a1)) + b1, a2)) + b2
// with symmetric zero padding (K-1)*d/2 and snake(v, a) = v + sin^2(a v)/(a + eps).
// The unit computes one unit; the chain computes N units (DAC: dilations
// 1, 3, 9) in one launch, its f32 state resident in shared memory. x and
// out are contiguous [B, T, C]; w1 is WIO [K, C, C] (C_out contiguous), w2
// is [C, C] (in, out); the chain takes them stacked over a leading unit
// dim. vec holds six f32 rows per unit: a1, 1/(a1+eps), b1, a2, 1/(a2+eps),
// b2. The snake uses the reference's sin^2 formula (range reduction by pi,
// odd Taylor series; _sin2 in the TPU file). The wrappers pass weights
// whose rows are a multiple of 16 bytes (cw >= C; ops/seanet_cuda.py pads
// the rare width that is not).
//
// Numerics. f32 activations run on f32 operands and plain f32 FMAs (no
// TF32, no rounding): the parity path. bf16 activations compute what the
// TPU kernel computes: both convs' operands are bf16 (the snaked input and
// the snaked hidden rounded to nearest even, and the bf16 weights), their
// products are summed in f32 on the tensor cores, the unit adds the
// bf16-rounded branch to x in bf16, and the chain keeps its residual in
// f32 across units.
//
// What bounds it on this card: a unit does 2*(K+1)*C FLOP per activation
// element (16*C for K = 7; 12 kFLOP at C = 768) and reads and writes about
// 8 bytes of it in f32, so it sits far above the memory roofline: it is
// bound by arithmetic, on the FMA units in f32 (67 TFLOP/s) and on the
// tensor cores in bf16 (989 TFLOP/s). Three things stood between the
// earlier design (32-row blocks, cp.async weight tiles behind a block
// barrier per step, mma.sync) and that bound: every 32 rows fetched all of
// a unit's 8 C^2 weights from L2 (32 FLOP per byte in bf16, 16 in f32), its
// f32 inner loop spent 14 shared-memory loads per 48 FMAs, and each output
// pass snaked and staged its input again behind block barriers.
//
// How the design answers that (seanet_gemm.cuh holds the pieces). A unit
// is three launches. The snake kernel writes xs = snake(x, a1) once per
// element (in x's dtype: bf16 rounds as the reference does), into rows of
// cw channels. The dilated conv reads xs and writes the snaked hidden
// S = snake(conv + b1, a2) [B, T, cw] to device memory; the 1x1 conv reads
// S and x and writes out. S and xs cost about 4 T C sizeof(x) bytes of
// device memory traffic (74 MB at C = 768 in bf16, some 22 us of HBM time,
// most of it served by the L2); S in shared memory would need 196 KB at
// C = 768 in bf16 for 128 rows, beside the rings. xs is dead before the
// 1x1 writes out, so the wrapper puts xs in out's memory (where cw = C):
// a unit holds one buffer more than x and out, S. The wrapper counts one
// launch per unit all the same (seanet_res_unit.launches counts wrapper
// calls that launch).
//
// A product launch has one block per SM, each of one producer warpgroup
// and two consumer warpgroups (setmaxnreg moves the producer's registers
// to the consumers), and each walks over tiles of kM rows of one batch row
// and one output pass of kNP columns, so that the producer streams the
// next tile's operands while the consumers finish a tile. One producer
// thread streams, by TMA (cp.async.bulk.tensor into shared
// memory, completing on an mbarrier per stage; the consumers release a
// stage through a second mbarrier), the weight tile of each (input chunk,
// tap) step through a ring of 4 stages and the A rows of each input chunk,
// [kM + 2 halo rows][128 bytes] in the 128-byte swizzle, through a ring of
// 2 slots: the consumers wait on no block barrier in the main loop, and
// the tensor maps' zero fill covers the halo past [0, T), the ragged last
// chunk and pass, and the rows of another batch row. The consumers' tile
// policy: f32 (Fma) gives each lane 8 x 8 outputs on a 4 x 8 lane grid and
// reads both operands as float4 (4 loads and 4 wavefronts per 64 FFMA);
// bf16 (Wg) runs wgmma m64nNk16 (N = 64-192) per warpgroup on 64 or 128
// rows, B (the weights) from the swizzled ring through a descriptor with
// the transpose bit (w1's C_out is contiguous: MN-major), A from
// registers, loaded by ldmatrix from the swizzled slot at any row: tap j
// reads the rows shifted by j d, which a shared-memory descriptor (it must
// start on an 8-row swizzle atom) cannot. The tile (rows x columns per
// tile, ops/seanet_cuda.py::unit_tile) is chosen per launch so that its
// rounds over the SMs compute the fewest outputs; each weight byte from L2
// feeds 2 kM / sizeof(weight) FLOP: 128-256 in bf16, 32-128 in f32. The
// epilogue computes all of a thread's values (its loads in flight together)
// before it stores any; the 1x1's residual x arrives as a tile by TMA
// during the product.
//
// SNAC's depthwise units run their 1x1 on the same product
// (codec_snac_res_unit: snac_res.cu's depthwise pass writes S, then
// snac_res_1x1_kernel reads S and x) with SNAC's epilogue, which adds the
// f32 branch to x and rounds once; where they fit, two x tiles, so that
// the next tile's x lands while the consumers finish a tile; and a tile
// whose rows all lie in [0, T) by column pairs with no test per row. At
// SNAC's narrow widths a tile's product is short: the epilogue's chain of
// tests and single loads had held the 1x1 back.
//
// The chain keeps what only it does: its state cur [tile + 2 halo, C] in
// f32 in shared memory across its units, S for one row block in shared
// memory, A snaked from cur by the consumers. It walks each unit in kM-row
// blocks, updating cur in place (a row block only overwrites rows that no
// later row block reads; it reads all its residuals before any consumer
// overwrites one); the valid region shrinks by 2 (K-1) d/2 per unit, and
// between units rows outside [0, T) are set back to zero as the global
// computation's zero padding requires. It recomputes halo rows that the
// unit launches do not and stages its A behind block barriers; the
// wrappers' gate (use_chain) takes it only where it measured closest to
// three unit launches.

#include "seanet_tiles.cuh"
#include "seanet_gemm.cuh"

namespace {

constexpr int kUnitStages = 4;      // weight stages of the unit's ring
constexpr int kChainStages = 2;     // the chain's (its state needs the room)

struct UnitArgs {
  CUtensorMap w;                    // this launch's weights: w1 [K, cw, cw] or w2 [1, cw, cw]
  CUtensorMap a;                    // its A: xs or S [B, T, cw]
  CUtensorMap xm;                   // the 1x1's x [B, T, C], when x_map
  const void* x;                    // [B, T, C]
  void* s;                          // the snaked hidden S [B, T, cw], in x's dtype
  void* out;                        // [B, T, C]
  const float* vec;                 // [6, C]
  int t_len, c, cw, taps, dilation, x_map, batch;
};

struct ChainArgs {
  CUtensorMap w1, w2;               // [N K, cw, cw], [N, cw, cw]
  const void* x;
  void* out;
  const float* vec;                 // [N, 6, C]
  int t_len, c, k, n_units, tile;
  int dilation[kMaxUnits];
};

// Byte offsets of the dynamic shared memory from its 1024-aligned base:
// the barriers, the ring, the A buffers, and the chain's S and state (the
// wrappers in ops/seanet_cuda.py compute the same sums).
struct Layout {
  int ring, a, s, state, total;
};

__host__ __device__ inline Layout make_layout(int stages, int stage_bytes, int a_bytes,
                                              int s_bytes, int state_bytes) {
  Layout l;
  l.ring = kBarrierBytes;
  l.a = l.ring + stages * stage_bytes;
  l.s = l.a + round_up(a_bytes, 16);
  l.state = l.s + round_up(s_bytes, 16);
  l.total = l.state + round_up(state_bytes, 16) + 1024;  // + the base's alignment
  return l;
}

// The unit's A ring: slots of [kM + 2 halo rows, rounded up to a box][128
// bytes], two for the dilated conv (7 taps of work per slot), four for the
// 1x1 (one) where they fit beside its x_slots x tiles [kM][kNP] (boxes of
// 64 rows x 128 bytes in the 128-byte swizzle, when the TMA can read x).
constexpr int kSmemLimit = 232448;          // an H100's opt-in bytes per block

template <typename P>
__host__ __device__ constexpr int x_tile_bytes() {
  return P::kM * P::kNP * static_cast<int>(sizeof(typename P::Op));
}

template <typename P>
__host__ __device__ constexpr int a_slots(bool pointwise, int x_slots = 1) {
  return pointwise && kBarrierBytes + kUnitStages * P::kStageBytes +
                              4 * a_slot_bytes(P::kM) + x_slots * x_tile_bytes<P>() +
                              1024 <= kSmemLimit
             ? 4
             : 2;
}

template <typename P>
__host__ __device__ inline Layout unit_layout(int halo, bool pointwise, int x_slots = 1) {
  return make_layout(kUnitStages, P::kStageBytes,
                     a_slots<P>(pointwise, x_slots) * a_slot_bytes(P::kM + 2 * halo),
                     pointwise ? x_slots * x_tile_bytes<P>() : 0, 0);
}

// S's row stride in the chain: C rounded up to a chunk, plus 16 bytes
template <typename P>
__host__ __device__ inline int s_stride(int c) {
  return round_up(c, P::kKc) + 16 / static_cast<int>(sizeof(typename P::Op));
}

// The chain's: A [kM + 2 halo_max][kAStride], S [kM][s_stride] and the f32
// state [tile + 2 halo_sum][C | 1]
template <typename P>
__host__ __device__ inline Layout chain_layout(int c, int halo_max, int halo_sum, int tile) {
  const int op = sizeof(typename P::Op);
  return make_layout(kChainStages, P::kStageBytes, (P::kM + 2 * halo_max) * P::kAStride * op,
                     P::kM * s_stride<P>(c) * op, (tile + 2 * halo_sum) * (c | 1) * 4);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + (1024 - smem_u32(raw) % 1024) % 1024;
}

// The ring of `stages` stages of `bytes` at smem + offset, its barriers
// (full, empty) at bars[0, 2 kMaxStages) initialised by thread 0. The
// caller ends the set-up with fence.mbarrier_init and a block barrier.
__device__ __forceinline__ Ring init_ring(unsigned char* smem, uint64_t* bars, int offset,
                                          int stages, int bytes) {
  Ring ring{bars, bars + kMaxStages, smem + offset, stages, bytes};
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kConsumerWarps);
    }
  return ring;
}

__device__ __forceinline__ void rings_ready() {
  if (threadIdx.x == 0) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
}

// two adjacent values in one store (p 2-element aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// two adjacent values in one load (p 2-element aligned)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// The snake of x, xs = Op(snake(x, a1)) (bf16: rounded to nearest even),
// the dilated conv's input, into rows of cw channels (zeros past C): once
// per element, not once per row block and output pass. A thread takes
// 16 bytes of consecutive channels of a row (cw is a multiple), loaded
// whole where x's rows are 16-byte multiples.
template <typename T>
__global__ void __launch_bounds__(256) seanet_snake_kernel(const T* __restrict__ x,
                                                           T* __restrict__ xs,
                                                           const float* __restrict__ vec,
                                                           size_t rows, int c_len, int cw) {
  constexpr int kVec = 16 / sizeof(T);
  const int groups = cw / kVec;
  const bool whole = c_len % kVec == 0;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows * groups;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / groups;
    const int c0 = static_cast<int>(i - r * groups) * kVec;
    T in[kVec], res[kVec];
    if (whole) {
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + r * c_len + c0);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) in[k] = c0 + k < c_len ? x[r * c_len + c0 + k] : T(0.0f);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int ci = c0 + k;
      store(res + k, ci < c_len ? snake(to_f32(in[k]), vec[ci], vec[c_len + ci]) : 0.0f);
    }
    *reinterpret_cast<uint4*>(xs + r * cw + c0) = *reinterpret_cast<const uint4*>(res);
  }
}

// One product launch of a unit: the dilated conv (xs -> S) or, kPointwise,
// the 1x1 conv (S -> out), A and the weights both by TMA. A tile is kM rows
// of one batch row and one output pass of kNP columns; the launch has one
// block per SM, each taking tiles blockIdx.x, + gridDim.x, ..., passes
// outermost (so that the tiles in flight share their weights in L2). The
// rings run on across tiles: the producer streams the next tile's A and
// weights while the consumers finish a tile. For the 1x1, a second
// producer thread copies each tile's x once the consumers are done with
// the previous one. kSnac (SNAC's 1x1, at the tiles of dispatch_snac_tile):
// the 1x1 adds the f32 branch to x and rounds the sum once (SNAC's
// reference), where DAC's rounds the branch to x's dtype before it adds x
// (DAC's reference; in f32 the two are the same); two x tiles (DAC's 1x1
// keeps one, with four A slots where they fit); and a tile whose rows all
// lie in [0, T) is taken by column pairs with no test per row.
template <typename T, typename P, bool kPointwise, bool kSnac>
__device__ __forceinline__ void unit_body(const UnitArgs& args) {
  static_assert(sizeof(T) == sizeof(typename P::Op), "f32 on Fma, bf16 and f16 on Wg");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int c_len = args.c, cw = args.cw, t_len = args.t_len;
  const int halo = (args.taps - 1) * args.dilation / 2;
  const int row_tiles = (t_len + P::kM - 1) / P::kM;
  const int n_tiles = row_tiles * args.batch * ((cw + P::kNP - 1) / P::kNP);
  // tile i: rows [t0, t0 + kM) of batch row b, columns [co0, co1)
  auto tile = [&](int i, int& t0, int& b, int& co0, int& co1) {
    t0 = i % row_tiles * P::kM;
    b = i / row_tiles % args.batch;
    co0 = i / row_tiles / args.batch * P::kNP;
    co1 = min(co0 + P::kNP, cw);
  };
  constexpr int kXSlots = kSnac ? 2 : 1;
  static_assert(!kSnac || kBarrierBytes + kUnitStages * P::kStageBytes +
                                   2 * a_slot_bytes(P::kM) + 2 * x_tile_bytes<P>() + 1024 <=
                               kSmemLimit,
                "two x tiles fit beside two A slots at SNAC's tiles");
  const Layout l = unit_layout<P>(halo, kPointwise, kXSlots);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* x_full = bars + 4 * kMaxStages;  // the 1x1's x tiles have landed
  uint64_t* x_empty = x_full + kXSlots;      // ... and are read
  Ring wring = init_ring(smem, bars, l.ring, kUnitStages, P::kStageBytes);
  Ring aring = init_ring(smem, bars + 2 * kMaxStages, l.a, a_slots<P>(kPointwise, kXSlots),
                         a_slot_bytes(P::kM + 2 * halo));
  constexpr int kXCols = 128 / sizeof(T), kXBoxes = P::kNP / kXCols;  // per 64 rows
  const bool x_tile = kPointwise && args.x_map;
  if (x_tile && threadIdx.x == 0) {
#pragma unroll
    for (int slot = 0; slot < kXSlots; ++slot) {
      mbar_init(x_full + slot, 1);
      mbar_init(x_empty + slot, kConsumerWarps);
    }
  }
  rings_ready();
  if (threadIdx.x >= kConsumers) {
    producer_registers<56>();
    int t0, b, co0, co1;
    if (threadIdx.x == kConsumers) {
      prefetch_map(&args.w);
      prefetch_map(&args.a);
      for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
        tile(i, t0, b, co0, co1);
        produce_tma<P>(wring, aring, &args.w, &args.a, cw, co0, co1, args.taps, t0 - halo,
                       P::kM + 2 * halo, b);
      }
    } else if (x_tile && threadIdx.x == kConsumers + 32) {
      prefetch_map(&args.xm);
      Ring xring{x_full, x_empty, smem + l.s, kXSlots, x_tile_bytes<P>()};
      for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
        tile(i, t0, b, co0, co1);
        mbar_wait(xring.empty + xring.stage, xring.phase ^ 1);
        mbar_arrive_expect_tx(xring.full + xring.stage, P::kM * P::kNP * sizeof(T));
        for (int br = 0; br < P::kM / kARows; ++br)
          for (int bc = 0; bc < kXBoxes; ++bc)
            tensor_copy(xring.tile() + (br * kXBoxes + bc) * kARows * 128, &args.xm,
                        co0 + bc * kXCols, t0 + br * kARows, b, xring.full + xring.stage);
        xring.advance();
      }
    }
    return;
  }
  consumer_registers<224>();
  const float* __restrict__ vec = args.vec;
  Ring xring{x_full, x_empty, smem + l.s, kXSlots, x_tile_bytes<P>()};
  for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
    int t0, b, co0, co1;
    tile(i, t0, b, co0, co1);
    const size_t base = (size_t)b * t_len;
    if constexpr (!kPointwise) {
      // S = the snaked hidden, zeros in the pad channels [C, cw); every load
      // before the first store
      T* __restrict__ s = static_cast<T*>(args.s) + base * cw;
      const float* b1 = vec + 2 * c_len;
      const float* a2 = vec + 3 * c_len;
      const float* ia2 = vec + 4 * c_len;
      auto epi = [&](typename P::Acc& acc, int c0) {
        P::each(acc, [&](int, int col, float& v) {
          const int co = c0 + col;
          v = co < c_len ? snake(v + b1[co], a2[co], ia2[co]) : 0.0f;
        });
        P::each_pair(acc, [&](int r, int col, float v0, float v1) {
          const int t = t0 + r, co = c0 + col;
          if (t < t_len && co < cw) store2(s + (size_t)t * cw + co, v0, v1);  // cw is even
        });
      };
      product_tma<P>(wring, aring, cw, co0, co1, args.taps, args.dilation, epi);
    } else {
      // the branch in x's dtype, then the residual (as the reference); x
      // from the tile the producer copied (else from device memory), every
      // load before the first store
      const T* __restrict__ x = static_cast<const T*>(args.x) + base * c_len;
      T* __restrict__ out = static_cast<T*>(args.out) + base * c_len;
      const float* b2 = vec + 5 * c_len;
      auto epi = [&](typename P::Acc& acc, int c0) {
        if (x_tile) mbar_wait(xring.full + xring.stage, xring.phase);
        const T* xt = reinterpret_cast<const T*>(xring.tile());
        // SNAC: a tile whose rows all lie in [0, T) (x as a tile, C even)
        // takes pairs of columns with no test per row, so that a thread's
        // loads are in flight together
        bool whole = false;
        if constexpr (kSnac) whole = x_tile && t0 + P::kM <= t_len && c_len % 2 == 0;
        if (whole) {
          if constexpr (kSnac)
            P::each_pair_ref(acc, [&](int r, int col, float& v0, float& v1) {
              if (c0 + col >= c_len) return;
              const T* box = xt + ((r / kARows) * kXBoxes + col / kXCols) * kARows * kXCols;
              const float2 xv = load2(a_at<true>(box, 0, r % kARows, col % kXCols));
              v0 = xv.x + (v0 + b2[c0 + col]);
              v1 = xv.y + (v1 + b2[c0 + col + 1]);
            });
        } else {
          P::each(acc, [&](int r, int col, float& v) {
            const int t = t0 + r, co = c0 + col;
            if (t >= t_len || co >= c_len) return;
            const T* box = xt + ((r / kARows) * kXBoxes + col / kXCols) * kARows * kXCols;
            const float xv = x_tile ? to_f32(*a_at<true>(box, 0, r % kARows, col % kXCols))
                                    : to_f32(x[(size_t)t * c_len + co]);
            if constexpr (kSnac) v = xv + (v + b2[co]);
            else v = xv + round_to<T>(v + b2[co]);
          });
        }
        if (x_tile) {
          __syncwarp();
          if ((threadIdx.x & 31) == 0) mbar_arrive(xring.empty + xring.stage);
          xring.advance();
        }
        if (whole) {
          if constexpr (kSnac)
            P::each_pair(acc, [&](int r, int col, float v0, float v1) {
              if (c0 + col < c_len) store2(out + (size_t)(t0 + r) * c_len + c0 + col, v0, v1);
            });
        } else {
          P::each_pair(acc, [&](int r, int col, float v0, float v1) {
            const int t = t0 + r, co = c0 + col;
            T* o = out + (size_t)t * c_len + co;
            if (t >= t_len || co >= c_len) return;
            if (c_len % 2 == 0) {
              store2(o, v0, v1);
            } else {
              store(o, v0);
              if (co + 1 < c_len) store(o + 1, v1);
            }
          });
        }
      };
      product_tma<P>(wring, aring, cw, co0, co1, 1, 0, epi);
    }
  }
}

template <typename T, typename P, bool kPointwise>
__global__ void __launch_bounds__(kBlockThreads, 1)
seanet_res_unit_kernel(const __grid_constant__ UnitArgs args) {
  unit_body<T, P, kPointwise, false>(args);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kBlockThreads, 1)
snac_res_1x1_kernel(const __grid_constant__ UnitArgs args) {
  unit_body<T, P, true, true>(args);
}

// The chain's dilated-conv A: the snake of its state's rows
// [rb, rb + kM + 2 h), zero past the valid length.
template <typename P>
struct SnakedState {
  using Op = typename P::Op;
  const float* cur;
  const float* vec;
  Op* A;
  int cs, rb, len, h, c_len;
  __device__ void prefetch(int) {}
  __device__ AView<Op> stage(int ci0) {
    const int rows = P::kM + 2 * h;
    for (int idx = threadIdx.x; idx < rows * P::kKc; idx += kConsumers) {
      const int r = idx / P::kKc, k = idx - r * P::kKc, ci = ci0 + k;
      float v = 0.0f;
      if (rb + r < len && ci < c_len)
        v = snake(cur[(size_t)(rb + r) * cs + ci], vec[ci], vec[c_len + ci]);
      store(A + r * P::kAStride + k, v);
    }
    return {A, P::kAStride};
  }
};

// The chain's 1x1 A: S itself.
template <typename P>
struct InPlace {
  using Op = typename P::Op;
  const Op* S;
  int stride;
  __device__ void prefetch(int) {}
  __device__ AView<Op> stage(int ci0) { return {S + ci0, stride}; }
};

// N residual units; block (blockIdx.x, blockIdx.y) owns rows
// [tile blockIdx.x, +tile) of batch row blockIdx.y and reads them with a
// halo of sum_u (K-1) d_u / 2 rows on each side.
template <typename T, typename P>
__global__ void __launch_bounds__(kBlockThreads, 1)
seanet_res_chain_kernel(const __grid_constant__ ChainArgs args) {
  using Op = typename P::Op;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int c_len = args.c, t_len = args.t_len, k_len = args.k, tile = args.tile;
  int halo = 0, halo_max = 0;
  for (int u = 0; u < args.n_units; ++u) {
    const int h = (k_len - 1) * args.dilation[u] / 2;
    halo += h;
    halo_max = max(halo_max, h);
  }
  const Layout l = chain_layout<P>(c_len, halo_max, halo, tile);
  Ring ring = init_ring(smem, reinterpret_cast<uint64_t*>(smem), l.ring, kChainStages,
                        P::kStageBytes);
  rings_ready();
  if (threadIdx.x >= kConsumers) {
    producer_registers<72>();               // its loop over units and row blocks
    if (threadIdx.x == kConsumers) {
      int len = tile + 2 * halo;
      for (int u = 0; u < args.n_units; ++u) {
        const int l_out = len - (k_len - 1) * args.dilation[u];
        for (int rb = 0; rb < l_out; rb += P::kM) {
          produce<P>(ring, &args.w1, c_len, 0, c_len, k_len, u * k_len);
          produce<P>(ring, &args.w2, c_len, 0, c_len, 1, u);
        }
        len = l_out;
      }
    }
    return;
  }
  consumer_registers<216>();
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * t_len * c_len;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.out) + base;
  // cur rows have an odd stride, so consumers touching one column of
  // consecutive rows hit distinct banks
  const int cs = c_len | 1, ss = s_stride<P>(c_len), cp = round_up(c_len, P::kKc);
  Op* A = reinterpret_cast<Op*>(smem + l.a);
  Op* S = reinterpret_cast<Op*>(smem + l.s);
  float* cur = reinterpret_cast<float*>(smem + l.state);

  // cur row r holds position t0 - halo + r; zero outside [0, T). A thread
  // loads kBatch values before it stores them, so their loads are in
  // flight together.
  int len = tile + 2 * halo;
  constexpr int kBatch = 8;
  for (int first = threadIdx.x; first < len * c_len; first += kConsumers * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * kConsumers, r = idx / c_len, pos = t0 - halo + r;
      v[b] = idx < len * c_len && pos >= 0 && pos < t_len
                 ? to_f32(x[(size_t)pos * c_len + idx - r * c_len]) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * kConsumers, r = idx / c_len;
      if (idx < len * c_len) cur[r * cs + idx - r * c_len] = v[b];
    }
  }

  int off = 0;                               // rows consumed on the left
  for (int u = 0; u < args.n_units; ++u) {
    const int d = args.dilation[u];
    const int h = (k_len - 1) * d / 2;
    const int l_out = len - 2 * h;
    const float* vec = args.vec + (size_t)u * 6 * c_len;
    const float* b1 = vec + 2 * c_len;
    const float* a2 = vec + 3 * c_len;
    const float* ia2 = vec + 4 * c_len;
    const float* b2 = vec + 5 * c_len;
    const bool last = u == args.n_units - 1;
    off += h;
    for (int rb = 0; rb < l_out; rb += P::kM) {
      SnakedState<P> src{cur, vec, A, cs, rb, len, h, c_len};
      // S = the snaked hidden, zero in the pad channels [C, cp)
      auto epi1 = [&](typename P::Acc& acc, int co0) {
        P::each(acc, [&](int, int col, float& v) {
          const int co = co0 + col;
          v = co < c_len ? snake(v + b1[co], a2[co], ia2[co]) : 0.0f;
        });
        P::each(acc, [&](int r, int col, float& v) {
          if (co0 + col < cp) store(S + r * ss + co0 + col, v);
        });
      };
      product<P>(ring, c_len, 0, c_len, k_len, d, src, epi1);

      // new cur[r] = cur[r + h] + y[r]: every consumer reads its residuals
      // before any overwrites a row
      InPlace<P> hidden{S, ss};
      auto epi2 = [&](typename P::Acc& acc, int co0) {
        P::each(acc, [&](int r, int col, float& v) {
          const int row = rb + r, co = co0 + col;
          v = (row < l_out && co < c_len) ? cur[(size_t)(row + h) * cs + co] + (v + b2[co])
                                          : 0.0f;
        });
        consumer_sync();
        P::each(acc, [&](int r, int col, float v) {
          const int row = rb + r, co = co0 + col;
          const int pos = t0 - halo + off + row;
          if (row < l_out && co < c_len)
            cur[(size_t)row * cs + co] = (last || (pos >= 0 && pos < t_len)) ? v : 0.0f;
        });
      };
      product<P>(ring, c_len, 0, c_len, 1, 0, hidden, epi2);
    }
    len = l_out;
  }
  consumer_sync();
  for (size_t idx = threadIdx.x; idx < (size_t)tile * c_len; idx += kConsumers) {
    const int r = static_cast<int>(idx / c_len), c = static_cast<int>(idx % c_len);
    if (t0 + r < t_len) store(out + (size_t)(t0 + r) * c_len + c, cur[(size_t)r * cs + c]);
  }
}

// -- host side -------------------------------------------------------------

struct UnitCall {
  const void *x, *w1, *w2;
  const float* vec;
  void *xs, *s, *out;
  int batch, t_len, c, cw, k, dilation, sms;
  cudaStream_t stream;
};

struct ChainCall {
  const void *x, *w1, *w2;
  const float* vec;
  void* out;
  int batch, t_len, c, cw, k, n_units, tile;
  int dilation[kMaxUnits];
  cudaStream_t stream;
};

// One block per SM, or per tile where there are fewer tiles
template <typename P>
dim3 unit_grid(const UnitCall& u) {
  const long tiles = (long)((u.t_len + P::kM - 1) / P::kM) * u.batch *
                     ((u.cw + P::kNP - 1) / P::kNP);
  return dim3(static_cast<unsigned>(tiles < u.sms ? tiles : u.sms));
}

// The 1x1 conv: S -> out, x by TMA where its rows are 16-byte multiples
// (DAC's, or with kSnac SNAC's)
template <typename T, typename P, bool kSnac>
cudaError_t launch_pointwise(UnitArgs& a, const UnitCall& u) {
  if (!weight_map<P>(&a.w, u.w2, u.cw, 1) ||
      !activation_map<P>(&a.a, u.s, u.cw, u.t_len, u.batch))
    return cudaErrorInvalidValue;
  a.taps = 1, a.dilation = 0;
  a.x_map = activation_map<P>(&a.xm, u.x, u.c, u.t_len, u.batch);
  static size_t opted[kMaxDevices] = {};
  if constexpr (kSnac)
    return launch_block(snac_res_1x1_kernel<T, P>, a, unit_grid<P>(u),
                        unit_layout<P>(0, true, 2).total, opted, kMaxDevices, u.stream);
  else
    return launch_block(seanet_res_unit_kernel<T, P, true>, a, unit_grid<P>(u),
                        unit_layout<P>(0, true).total, opted, kMaxDevices, u.stream);
}

template <typename T, typename P>
struct UnitLaunch {
  static cudaError_t run(const UnitCall& u) {
    UnitArgs a{};
    T* xs = static_cast<T*>(u.xs);
    a.x = u.x, a.s = u.s, a.out = u.out, a.vec = u.vec;
    a.t_len = u.t_len, a.c = u.c, a.cw = u.cw, a.batch = u.batch;
    // the snake: x -> xs
    constexpr int kVec = 16 / sizeof(T);      // cw is a multiple
    const size_t rows = (size_t)u.batch * u.t_len;
    const size_t blocks = (rows * (u.cw / kVec) + 255) / 256;
    seanet_snake_kernel<T><<<blocks < 8192 ? blocks : 8192, 256, 0, u.stream>>>(
        static_cast<const T*>(u.x), xs, u.vec, rows, u.c, u.cw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the dilated conv: xs -> S
    if (!weight_map<P>(&a.w, u.w1, u.cw, u.k) ||
        !activation_map<P>(&a.a, xs, u.cw, u.t_len, u.batch))
      return cudaErrorInvalidValue;
    a.taps = u.k, a.dilation = u.dilation;
    static size_t opted_conv[kMaxDevices] = {};
    err = launch_block(seanet_res_unit_kernel<T, P, false>, a, unit_grid<P>(u),
                       unit_layout<P>((u.k - 1) * u.dilation / 2, false).total, opted_conv,
                       kMaxDevices, u.stream);
    if (err != cudaSuccess) return err;
    return launch_pointwise<T, P, false>(a, u);
  }
};

// SNAC's 1x1 (after codec_snac_dw has written S)
template <typename T, typename P>
struct SnacPointwiseLaunch {
  static cudaError_t run(const UnitCall& u) {
    UnitArgs a{};
    a.x = u.x, a.s = u.s, a.out = u.out, a.vec = u.vec;
    a.t_len = u.t_len, a.c = u.c, a.cw = u.cw, a.batch = u.batch;
    return launch_pointwise<T, P, true>(a, u);
  }
};

template <typename T, typename P>
struct ChainLaunch {
  static cudaError_t run(const ChainCall& c) {
    ChainArgs a{};
    if (!weight_map<P>(&a.w1, c.w1, c.cw, c.n_units * c.k) ||
        !weight_map<P>(&a.w2, c.w2, c.cw, c.n_units))
      return cudaErrorInvalidValue;
    a.x = c.x, a.out = c.out, a.vec = c.vec, a.t_len = c.t_len, a.c = c.c, a.k = c.k;
    a.n_units = c.n_units, a.tile = c.tile;
    int halo = 0, halo_max = 0;
    for (int u = 0; u < c.n_units; ++u) {
      a.dilation[u] = c.dilation[u];
      const int h = (c.k - 1) * c.dilation[u] / 2;
      halo += h;
      halo_max = h > halo_max ? h : halo_max;
    }
    const dim3 grid((c.t_len + c.tile - 1) / c.tile, c.batch);
    static size_t opted[kMaxDevices] = {};
    return launch_block(seanet_res_chain_kernel<T, P>, a, grid,
                        chain_layout<P>(c.c, halo_max, halo, c.tile).total, opted, kMaxDevices,
                        c.stream);
  }
};

// kind 0: the unit's dilated conv at `halo`; 1: its 1x1; 2: the chain
// (halo: its largest unit halo, halo_sum: their sum); 3: SNAC's 1x1 (its
// tiles only)
struct SmemQuery {
  int kind, c, halo, halo_sum, tile;
};

template <typename T, typename P>
struct SmemBytes {
  static int run(const SmemQuery& q) {
    if (q.kind == 2) return chain_layout<P>(q.c, q.halo, q.halo_sum, q.tile).total;
    if (q.kind == 3) return unit_layout<P>(0, true, 2).total;
    return unit_layout<P>(q.kind == 1 ? 0 : q.halo, q.kind == 1).total;
  }
};

// The 16-bit tiles of dispatch_tile in operand type H (bf16 or f16)
template <template <typename, typename> class Launch, typename H, typename Call>
auto dispatch_tile16(const Call& c, int rows, int cols)
    -> decltype(Launch<float, Fma<1>>::run(c)) {
  using R = decltype(Launch<float, Fma<1>>::run(c));
  if (rows == 128) {
    switch (cols) {
      case 64: return Launch<H, Wg<64, 1, H>>::run(c);
      case 128: return Launch<H, Wg<128, 1, H>>::run(c);
      case 192: return Launch<H, Wg<192, 1, H>>::run(c);
    }
  } else if (rows == 256 && cols == 128) {
    return Launch<H, Wg<128, 2, H>>::run(c);
  }
  return static_cast<R>(cudaErrorInvalidValue);
}

// The tile (ops/seanet_cuda.py::unit_tile): rows per block and columns per
// pass; f32 on Fma (256 x 64, 128 x 128, 64 x 256), bf16 and f16 on Wg (128
// x 64, 128 x 128, 128 x 192, 256 x 128): each the fastest at some DAC
// width, batch or length on an H100 (tools/seanet_times.py --what tiles;
// f16 takes bf16's tiles: both are 2-byte operands).
template <template <typename, typename> class Launch, typename Call>
auto dispatch_tile(const Call& c, int rows, int cols, int dtype)
    -> decltype(Launch<float, Fma<1>>::run(c)) {
  using R = decltype(Launch<float, Fma<1>>::run(c));
  if (dtype == 0) {
    if (rows == 256 && cols == 64) return Launch<float, Fma<1>>::run(c);
    if (rows == 128 && cols == 128) return Launch<float, Fma<2>>::run(c);
    if (rows == 64 && cols == 256) return Launch<float, Fma<4>>::run(c);
  } else if (dtype == 1) {
    return dispatch_tile16<Launch, __nv_bfloat16>(c, rows, cols);
  } else if (dtype == 2) {
    return dispatch_tile16<Launch, __half>(c, rows, cols);
  }
  return static_cast<R>(cudaErrorInvalidValue);
}

// SNAC's 1x1 tile (ops/seanet_cuda.py::snac_tile): f32 256 x 64 or 128 x
// 128, bf16 and f16 128 x 64 or 128 x 128, the unit's tiles that won the
// SNAC sweep (tools/seanet_times.py --what snac_tiles; f16 takes bf16's).
template <template <typename, typename> class Launch, typename Call>
auto dispatch_snac_tile(const Call& c, int rows, int cols, int dtype)
    -> decltype(Launch<float, Fma<1>>::run(c)) {
  using R = decltype(Launch<float, Fma<1>>::run(c));
  using B = __nv_bfloat16;
  using H = __half;
  if (dtype == 0 && rows == 256 && cols == 64) return Launch<float, Fma<1>>::run(c);
  if (dtype == 0 && rows == 128 && cols == 128) return Launch<float, Fma<2>>::run(c);
  if (dtype == 1 && rows == 128 && cols == 64) return Launch<B, Wg<64, 1>>::run(c);
  if (dtype == 1 && rows == 128 && cols == 128) return Launch<B, Wg<128, 1>>::run(c);
  if (dtype == 2 && rows == 128 && cols == 64) return Launch<H, Wg<64, 1, H>>::run(c);
  if (dtype == 2 && rows == 128 && cols == 128) return Launch<H, Wg<128, 1, H>>::run(c);
  return static_cast<R>(cudaErrorInvalidValue);
}

// The chain's tile (ops/seanet_cuda.py::chain_block): bf16 and f16 128 x
// 64; f32 the unit's tile whose one pass covers C.
cudaError_t dispatch_chain(const ChainCall& c, int rows, int cols, int dtype) {
  using B = __nv_bfloat16;
  using H = __half;
  if (dtype == 1 && rows == 128 && cols == 64) return ChainLaunch<B, Wg<64, 1>>::run(c);
  if (dtype == 2 && rows == 128 && cols == 64) return ChainLaunch<H, Wg<64, 1, H>>::run(c);
  if (dtype == 0 && rows == 256 && cols == 64) return ChainLaunch<float, Fma<1>>::run(c);
  if (dtype == 0 && rows == 128 && cols == 128) return ChainLaunch<float, Fma<2>>::run(c);
  if (dtype == 0 && rows == 64 && cols == 256) return ChainLaunch<float, Fma<4>>::run(c);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The weights' rows: cw >= C channels of 16-byte multiples
bool weights_ok(int c, int cw, int dtype) {
  return cw >= c && cw % (dtype == 0 ? 4 : 8) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; rows, cols: the tile
// (dispatch_tile);
// xs, s: B T cw elements of x's dtype each (snake(x) and the snaked
// hidden S); xs is dead once the dilated conv is done, so it may be out's
// memory when cw = C; w1, w2 padded to cw channels. Three launches in
// stream order. Returns a cudaError_t (0 = success).
extern "C" int codec_seanet_res_unit(const void* x, const void* w1, const void* w2,
                                     const float* vec, void* xs, void* s, void* out, int batch,
                                     int t_len, int c, int cw, int k, int dilation, int rows,
                                     int cols, int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || dilation < 1 || !weights_ok(c, cw, dtype) ||
      !aligned16(xs) || !aligned16(s) || xs == s)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const UnitCall u{x, w1, w2, vec, xs, s, out, batch, t_len, c, cw, k, dilation, sms,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_tile<UnitLaunch>(u, rows, cols, dtype);
}

// SNAC's depthwise pass (snac_res.cu)
extern "C" int codec_snac_dw(const void* x, const void* w1, const float* vec, void* s,
                             int batch, int t_len, int c, int cw, int k, int dilation, int rows,
                             int dtype, void* stream);

// One SNAC unit: the depthwise pass (x -> s, dw_rows rows per block; w1
// the taps [K, C]), then the 1x1 (s, x -> out) at the tile (rows, cols) of
// dispatch_snac_tile; s: B T cw elements of x's dtype, w2 padded to cw.
// Two launches in stream order. Returns a cudaError_t (0 = success).
extern "C" int codec_snac_res_unit(const void* x, const void* w1, const void* w2,
                                   const float* vec, void* s, void* out, int batch, int t_len,
                                   int c, int cw, int k, int dilation, int dw_rows, int rows,
                                   int cols, int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || dilation < 1 || !weights_ok(c, cw, dtype) ||
      !aligned16(s))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(
      codec_snac_dw(x, w1, vec, s, batch, t_len, c, cw, k, dilation, dw_rows, dtype, stream));
  if (err != cudaSuccess) return err;
  const UnitCall u{x, w1, w2, vec, nullptr, s, out, batch, t_len, c, cw, k, dilation, sms,
                   static_cast<cudaStream_t>(stream)};
  return dispatch_snac_tile<SnacPointwiseLaunch>(u, rows, cols, dtype);
}

// dilations: n_units host ints; tile: rows per block (a multiple of 32).
extern "C" int codec_seanet_res_chain(const void* x, const void* w1, const void* w2,
                                      const float* vec, void* out, int batch, int t_len,
                                      int c, int cw, int k, int n_units,
                                      const int* dilations, int tile, int rows, int cols,
                                      int dtype, void* stream) {
  if (!valid_shape(batch, t_len, c, k) || n_units < 1 || n_units > kMaxUnits ||
      tile < kRows || tile % kRows != 0 || !weights_ok(c, cw, dtype))
    return cudaErrorInvalidValue;
  ChainCall a{x, w1, w2, vec, out, batch, t_len, c, cw, k, n_units, tile, {0, 0, 0, 0},
              static_cast<cudaStream_t>(stream)};
  for (int u = 0; u < n_units; ++u) {
    if (dilations[u] < 1) return cudaErrorInvalidValue;
    a.dilation[u] = dilations[u];
  }
  return dispatch_chain(a, rows, cols, dtype);
}

// The dynamic shared memory of one launch, in bytes (kind as SmemQuery);
// -1 for a tile that does not exist.
extern "C" int codec_seanet_smem_bytes(int kind, int c, int halo, int halo_sum, int tile,
                                       int rows, int cols, int dtype) {
  const SmemQuery q{kind, c, halo, halo_sum, tile};
  const int bytes = kind == 3 ? dispatch_snac_tile<SmemBytes>(q, rows, cols, dtype)
                              : dispatch_tile<SmemBytes>(q, rows, cols, dtype);
  return bytes == static_cast<int>(cudaErrorInvalidValue) ? -1 : bytes;
}

// The current device's opt-in shared memory per block, in bytes.
extern "C" int codec_smem_per_block_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
