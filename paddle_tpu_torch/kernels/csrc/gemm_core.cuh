// A persistent TMA + wgmma GEMM core for Hopper (sm_90a), bf16 operands
// with f32 accumulation, its epilogue run from the accumulator registers.
// Used by fused_mlp.cu's wgmma routes: the SwiGLU and GeLU backwards' dX
// and dW products (namespaces sw, ge) and both forwards' products (fw:
// the activation product, whose epilogue applies the GeLU or the SwiGLU
// gate, and the down product into the f32 sum across ffn chunks). Included
// after hopper.cuh; everything here lives in an anonymous namespace, once
// per library.
//
// C [M, N] = A [M, K] . B [K, N], each operand read by TMA in its own
// layout: K-major (K contiguous: A as [M][K], B as [N][K] in device
// memory) or MN-major (A as [K][M], B as [K][N]), the latter through
// wgmma's transpose bits, so no transpose is ever written. Every tensor
// map has [64][64] boxes in the 128-byte swizzle; elements past a map's
// edge arrive as zeros and stores past it are clipped, so any M, N, K (a
// multiple of 8 where it is the inner extent: TMA's 16-byte strides) and
// a product may be a window of a larger tensor by giving it a map whose
// edge is the window's.
//   - Block tile 128 x BN (BN 64 to 256) x 64. 288 threads: warps 0-7
//     are two consumer warpgroups of 64 rows each, warp 8 the producer,
//     whose lane 0 keeps a ring of S stages full (a full and an empty
//     mbarrier per stage, expect_tx bytes).
//   - The grid is persistent: one block per SM walks the output tiles t =
//     blockIdx.x, + gridDim.x, ... in the grouped order of tile_of
//     (kGroupM row tiles sweep the column tiles together, so the blocks in
//     flight share A's and B's tiles in L2). Producer and consumers walk
//     the same tiles, so the ring runs on across tiles: the next tile's
//     loads overlap this tile's epilogue.
//   - Each consumer warpgroup multiplies its 64 rows by wgmma m64nBNk16
//     from shared memory into BN / 2 f32 registers a thread, one group of
//     products in flight while the previous stage is released.
//   - The epilogue (a functor) sets the accumulator before the tile's k
//     loop (init: zeros, or a partial sum carried in device memory) and
//     takes it from the registers after: thread t of a warpgroup holds
//     rows 16 (t / 32) + (t % 32) / 4 + 8h of the warpgroup's 64, columns
//     8n + 2 (t % 4) + e, as acc[4n + 2h + e]. An output is staged per
//     warpgroup in the 128-byte swizzle and stored by TMA (bf16:
//     stage_bf16, store_boxes; an f32 sum across launches: EpiSum, which
//     stores or reduce-adds it).
//   - Two halves: ksplit runs K twice, the first half from maps a0 / b0,
//     the second from a1 / b1 (one product over [A0 | A1] . [B0; B1]);
//     nsplit runs N twice, B and the output from b0 / o0, then b1 / o1
//     (two products sharing A in one launch).
//   - Paired B (the template flag PAIR, off in every other instantiation):
//     a stage of B holds BN / 2 columns of b0, then the same columns of b1,
//     so one m64nBN product computes A . B0 and A . B1 side by side over
//     output tiles BN / 2 wide; thread t then holds column j of the first
//     at acc[4n + 2h + e] and of the second at acc[4(n + BN / 16) + 2h + e]
//     (the SwiGLU forward's gate and up products, combined in registers).
//   - No atomics and no split-K: each output tile has one writer and sums
//     its k steps in one order, so a call repeats bit for bit.
//   - Every mbarrier wait traps after ~2^35 cycles (hopper.cuh).

#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace {
namespace gc {

constexpr int kBM = 128;  // output tile rows: two consumer warpgroups of 64
constexpr int kBK = 64;   // k step: one 128-byte swizzle row of bf16
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kBox = 64 * 64;         // a [64][64] bf16 TMA box, 8 KB
constexpr int kBoxBytes = kBox * 2;   // the wgmma descriptor's LBO of an MN-major operand
constexpr int kGroupM = 8;            // row tiles of a raster group

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// tile t of a num_m x num_n grid: groups of kGroupM row tiles (the last
// group may be short), each walked column tile by column tile, row tile
// fastest within a column
__host__ __device__ inline void tile_of(int t, int num_m, int num_n, int& mt, int& nt) {
  const int per = kGroupM * num_n;
  const int first = t / per * kGroupM;
  const int rows = num_m - first < kGroupM ? num_m - first : kGroupM;
  const int r = t - t / per * per;
  mt = first + r % rows;
  nt = r / rows;
}

// the product's extents: m, n, k of one half (see ksplit, nsplit above)
struct Shape {
  int m, n, k;
  int ksplit, nsplit;
};

template <int BN> struct Tile {
  int m0, n0, half;  // half: the N half (nsplit), else 0
  __device__ Tile(const Shape& s, int t) {
    const int nh = cdiv(s.n, BN);
    int mt, nt;
    tile_of(t, cdiv(s.m, kBM), nh * (s.nsplit ? 2 : 1), mt, nt);
    half = nt / nh;
    m0 = mt * kBM;
    n0 = (nt - half * nh) * BN;
  }
};

template <int BN> __host__ __device__ inline int tiles(const Shape& s) {
  return cdiv(s.m, kBM) * cdiv(s.n, BN) * (s.nsplit ? 2 : 1);
}
__host__ __device__ inline int ksteps(const Shape& s) {
  return cdiv(s.k, kBK) * (s.ksplit ? 2 : 1);
}

template <int BN, int S> struct Smem {
  __nv_bfloat16 a[S][kBM * kBK];  // kBM / 64 boxes
  __nv_bfloat16 b[S][kBK * BN];   // BN / 64 boxes
  __nv_bfloat16 out[2][64 * BN];  // a warpgroup's bf16 output, BN / 64 boxes
  uint64_t full[S], empty[S];
};

template <int S> __device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == S) stage = 0, phase ^= 1;
}

// the 64-row boxes of one operand tile of ROWS rows (A: kBM, B: BN) at
// (row0 in M or N, k0) from a map of its layout
template <bool MN, int ROWS>
__device__ __forceinline__ void load_operand(__nv_bfloat16* dst, const CUtensorMap* map,
                                             uint64_t* bar, int row0, int k0) {
#pragma unroll
  for (int h = 0; h < ROWS / 64; ++h) {
    const int r = row0 + 64 * h;
    tma_load_2d(dst + h * kBox, map, bar, MN ? r : k0, MN ? k0 : r);
  }
}

// the wgmma descriptor of k step kk (16 deep) of an operand tile: K-major
// rows step 32 bytes along the swizzled row; MN-major boxes are [64 k][64
// mn], the k step 16 rows down, the next 64 mn one box (LBO) on
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(const __nv_bfloat16* base, int kk) {
  return MN ? desc_sw128(base + kk * 16 * 64, kBoxBytes) : desc_sw128(base + kk * 16, 16);
}

// The producer warp's lane 0: every k step of every tile of this block
// into the ring (PAIR: B's stage from b0, then b1, over the tile's TN
// columns).
template <bool AMN, bool BMN, int BN, int S, bool PAIR>
__device__ void produce(Smem<BN, S>& sm, const CUtensorMap& a0, const CUtensorMap& a1,
                        const CUtensorMap& b0, const CUtensorMap& b1, const Shape& s) {
  constexpr int TN = PAIR ? BN / 2 : BN;  // the output tile's width
  const int nkh = cdiv(s.k, kBK), nk = ksteps(s), nt = tiles<TN>(s);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile<TN> tl(s, t);
    for (int kt = 0; kt < nk; ++kt) {
      const int hk = kt >= nkh;  // the second K half (ksplit)
      const int k0 = (kt - hk * nkh) * kBK;
      mbar_wait(&sm.empty[stage], phase ^ 1);
      mbar_arrive_tx(&sm.full[stage], (kBM + BN) * kBK * 2);
      load_operand<AMN, kBM>(sm.a[stage], hk ? &a1 : &a0, &sm.full[stage], tl.m0, k0);
      if constexpr (PAIR) {
        load_operand<BMN, TN>(sm.b[stage], &b0, &sm.full[stage], tl.n0, k0);
        load_operand<BMN, TN>(sm.b[stage] + TN * kBK, &b1, &sm.full[stage], tl.n0, k0);
      } else {
        load_operand<BMN, BN>(sm.b[stage], (hk || tl.half) ? &b1 : &b0, &sm.full[stage], tl.n0,
                              k0);
      }
      advance<S>(stage, phase);
    }
  }
}

// A consumer warpgroup's product of one tile: nk k steps from the ring
// added to acc, each stage released once its products are done.
template <bool AMN, bool BMN, int BN, int S>
__device__ __forceinline__ void mainloop(Smem<BN, S>& sm, int nk, int& stage, uint32_t& phase,
                                         float (&acc)[BN / 2]) {
  const int wgi = threadIdx.x >> 7;
  int prev = 0;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&sm.full[stage], phase);
    fence_regs(acc);
    wgmma_fence();
    const __nv_bfloat16* a = sm.a[stage] + wgi * kBox;  // the warpgroup's 64 rows
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_smem<BN, AMN, BMN>(acc, operand_desc<AMN>(a, kk), operand_desc<BMN>(sm.b[stage], kk),
                               1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&sm.empty[prev]);
    prev = stage;
    advance<S>(stage, phase);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (nk > 0) mbar_arrive(&sm.empty[prev]);
}

// This thread's place in a warpgroup's accumulator: rows row, row + 8 of
// the warpgroup's 64, columns 8n + col (+ 1).
struct Frag {
  int row, col;
  __device__ Frag() {
    const int t = threadIdx.x & 127, lane = t & 31;
    row = (t >> 5) * 16 + (lane >> 2);
    col = 2 * (lane & 3);
  }
};

// the byte offset of the pair (row, 8n + col) in [64][64] boxes of bf16
// in the 128-byte swizzle, box n / 8 (conflict-free: the eight rows of a
// warp's store land in eight different 16-byte chunks)
__device__ __forceinline__ int swizzled(int row, int n, int col) {
  return (n >> 3) * kBoxBytes + row * 128 + (((n & 7) ^ (row & 7)) << 4) + 2 * col;
}

// acc -> bf16 into a warpgroup's staging boxes
template <int BN>
__device__ __forceinline__ void stage_bf16(char* ob, const float (&acc)[BN / 2], const Frag& f) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(ob + swizzled(f.row + 8 * h, n, f.col)) =
          pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
}

// Before a warpgroup stages its output: its stores of the previous tile
// have read the staging boxes.
__device__ __forceinline__ void out_acquire(int wgi) {
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  bar_sync(1 + wgi, 128);
}
// After staging: the boxes handed to the TMA unit; true in the thread
// that issues the stores.
__device__ __forceinline__ bool out_release(int wgi) {
  fence_proxy_async();
  bar_sync(1 + wgi, 128);
  return (threadIdx.x & 127) == 0;
}
// `boxes` staged [64][64] boxes to (col0 + 64 b, row0) of a map, committed
__device__ __forceinline__ void store_boxes(const CUtensorMap& map, const char* ob, int boxes,
                                            int col0, int row0) {
  for (int b = 0; b < boxes; ++b) tma_store_2d(&map, ob + b * kBoxBytes, col0 + 64 * b, row0);
  bulk_commit();
}

// Epilogues: init(acc, tile, warpgroup) sets the accumulator before the
// k loop; operator() takes it after, with the warpgroup's staging boxes.
// Both run in every consumer thread. (fused_mlp.cu's fw namespace holds
// the forwards' own: the activations, the bias, the dropout.)
template <int N> __device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// round(C) in bf16 to o0 (o1 for the second N half)
struct EpiStore {
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>&, int) const {
    zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const Tile<BN>& tl,
                                             int wgi, char* ob, const CUtensorMap& o0,
                                             const CUtensorMap& o1) const {
    out_acquire(wgi);
    stage_bf16<BN>(ob, acc, Frag());
    if (out_release(wgi)) store_boxes(tl.half ? o1 : o0, ob, BN / 64, tl.n0, tl.m0 + 64 * wgi);
  }
};

// An f32 [m, n] sum in device memory across calls, through o1 (its f32
// map, [64][32] boxes): the first call stores C, the later ones add C to
// it by the TMA unit's reduce-add (each element has one writer a call and
// the calls run in stream order: the same sums in the same order, the
// same bits). C leaves in two passes of BN / 2 columns through the
// warpgroup's staging boxes (BN / 64 f32 boxes a pass). The last call
// takes EpiSumLast instead.
struct EpiSum {
  int first;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>&, int) const {
    zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const Tile<BN>& tl,
                                             int wgi, char* ob, const CUtensorMap&,
                                             const CUtensorMap& o1) const {
    const Frag f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      out_acquire(wgi);
#pragma unroll
      for (int nn = 0; nn < BN / 8; ++nn) {
        if (nn / (BN / 16) != pass) continue;
        const int col = 8 * nn + f.col - pass * (BN / 2);  // in the pass's columns
        const int byte = (col & 31) * 4;                    // in its box's 128-byte row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = f.row + 8 * h;
          *reinterpret_cast<float2*>(ob + (col >> 5) * kBoxBytes + row * 128 +
                                     (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)) =
              make_float2(acc[4 * nn + 2 * h], acc[4 * nn + 2 * h + 1]);
        }
      }
      if (out_release(wgi)) {
        for (int b = 0; b < BN / 64; ++b) {
          const int col0 = tl.n0 + pass * (BN / 2) + 32 * b, row0 = tl.m0 + 64 * wgi;
          if (first) {
            tma_store_2d(&o1, ob + b * kBoxBytes, col0, row0);
          } else {
            tma_reduce_add_2d(&o1, ob + b * kBoxBytes, col0, row0);
          }
        }
        bulk_commit();
      }
    }
  }
};

// The last call on the sum (buf, row stride ld): the k loop starts from
// it, loaded into the accumulator registers, and round(sum + C) goes in
// bf16 to o0. Its own type: an epilogue type that can load the
// accumulator slows its kernel's k loop even where the load is never
// taken (scripts/swiglu_bwd_variants.py, sum_can_load), so only this one
// call pays.
struct EpiSumLast {
  const float* buf;
  size_t ld;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>& tl, int wgi) const {
    const Frag f;
    const int row0 = tl.m0 + 64 * wgi + f.row, col0 = tl.n0 + f.col;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * nn;  // n is even: col + 1 < n too
        const float2 v = row < m && col < n
                             ? *reinterpret_cast<const float2*>(buf + (size_t)row * ld + col)
                             : make_float2(0.f, 0.f);
        acc[4 * nn + 2 * h] = v.x, acc[4 * nn + 2 * h + 1] = v.y;
      }
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const Tile<BN>& tl,
                                             int wgi, char* ob, const CUtensorMap& o0,
                                             const CUtensorMap& o1) const {
    EpiStore{}(acc, tl, wgi, ob, o0, o1);
  }
};

// The core kernel: grid = min(tiles, SMs) persistent blocks.
template <bool AMN, bool BMN, int BN, int S, typename Epi, bool PAIR = false>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
                      const __grid_constant__ CUtensorMap b0, const __grid_constant__ CUtensorMap b1,
                      const __grid_constant__ CUtensorMap o0, const __grid_constant__ CUtensorMap o1,
                      const Shape s, const Epi epi) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem<BN, S>& sm = *reinterpret_cast<Smem<BN, S>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 1);            // the producer's expect_tx
      mbar_init(&sm.empty[st], kConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce<AMN, BMN, BN, S, PAIR>(sm, a0, a1, b0, b1, s);
    __syncwarp();
    return;
  }
  constexpr int TN = PAIR ? BN / 2 : BN;
  const int wgi = threadIdx.x >> 7, nk = ksteps(s), nt = tiles<TN>(s);
  char* ob = reinterpret_cast<char*>(sm.out[wgi]);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < nt; t += gridDim.x) {
    const Tile<TN> tl(s, t);
    float acc[BN / 2];
    epi.init(acc, tl, wgi);
    mainloop<AMN, BMN, BN, S>(sm, nk, stage, phase, acc);
    epi(acc, tl, wgi, ob, o0, o1);
  }
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int BN, int S> constexpr size_t smem_bytes() {
  return sizeof(Smem<BN, S>) + 1024;  // + the slack of the 1024-byte alignment
}

// the SMs of the current device (the persistent grid's size)
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The map of a bf16 matrix window: `outer` rows of `inner` contiguous
// elements, rows `row_bytes` apart, [64][64] boxes.
inline int map_2d(CUtensorMap* map, const void* base, int inner, int outer, size_t row_bytes) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {64, 64};
  return tensor_map_bf16(map, base, 2, dims, strides, box);
}

// The same for an f32 matrix: [64][32] boxes (128-byte rows).
inline int map_2d_f32(CUtensorMap* map, const void* base, int inner, int outer,
                      size_t row_bytes) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {32, 64};
  return tensor_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 2, dims, strides, box);
}

// One launch of the core on a persistent grid; maps a0, a1, b0, b1, o0,
// o1 (unused halves may repeat a map).
template <bool AMN, bool BMN, int BN, int S, typename Epi, bool PAIR = false>
int run(const CUtensorMap (&m)[6], const Shape& s, const Epi& epi, cudaStream_t stream) {
  static_assert(smem_bytes<BN, S>() <= kMaxSmem, "shared memory of a block");
  static_assert(!PAIR || BN % 128 == 0, "a paired B stage holds whole boxes of each half");
  const int nt = tiles<PAIR ? BN / 2 : BN>(s), sms = sm_count();
  if (nt == 0) return 0;
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto kernel = wgmma_gemm_kernel<AMN, BMN, BN, S, Epi, PAIR>;
  constexpr size_t bytes = smem_bytes<BN, S>();
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  if (rc) return rc;
  kernel<<<std::min(nt, sms), kThreads, bytes, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], s,
                                                         epi);
  return (int)cudaGetLastError();
}

}  // namespace gc
}  // namespace
