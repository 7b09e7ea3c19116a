// Fused projection + bias + residual + LayerNorm, forward and backward:
//   y = LayerNorm(res + (x . W + b)) * gamma + beta,  x [R, Hin], W [Hin, Hout]
// (the attention output projection folded into BERT's post-LN sublayer close).
//
// Replaces the TPU kernels of paddle_tpu/kernels/mlp_fusion.py:
//   _proj_ln_fwd_kernel :714 (launched by _proj_ln_fwd :827) -> proj_ln_fwd_*,
//                                                 proj_ln_fwd_cluster_bf16
//   _proj_ln_bwd_kernel :751 (launched by _proj_ln_bwd :851) -> proj_ln_bwd_*,
//                         proj_ln_bwd_cluster_bf16 (each + sum_parts)
// both entered through fused_proj_ln_2d :913 (the custom_vjp of :878).
// Two routes (kernels/mlp_fusion.py pl_route): the cluster route below
// (bf16, Hout a multiple of 256 up to 1024, Hin % 8 == 0, 16-byte aligned
// tensors: every model path's case) and the generic kernels described
// first (f32, the parity runs, and every other shape).
// x, W, res contiguous, float32 or bfloat16 (one dtype); b, gamma, beta
// [Hout] come in as f32, as the reference broadcasts them (_rows).
//
//   forward:  p = x . W (f32 accumulation); z = drop(p + b) + res in f32;
//             mean = sum(z) / Hout; var = sum((z - mean)^2) / Hout (two
//             passes, :735-738); rstd = rsqrt(var + eps);
//             y = round((z - mean) * rstd * gamma + beta); mean, rstd [R] f32.
//   backward: p and z recomputed the same way; x^ = (z - mean) * rstd with
//             the saved stats; gw = g * gamma; c1 = mean(gw); c2 =
//             mean(gw * x^); dz = (gw - c1 - x^ * c2) * rstd, written f32
//             as dz and, dropped, as dp = drop(dz) (the reference's two f32
//             outputs, :857-858); dgamma = sum_r g * x^
//             and dbeta = sum_r g in f32 (:790-793). The caller computes
//             dx = dp . W^T, dW = x^T . dp and db = sum_r dp in f32 outside
//             the kernel, as the reference does (:895-904).
// round() is the rounding to the I/O dtype; drop(x) is x without dropout,
// and with it (dropout_p > 0, the DROP instantiations; the dropout-free
// ones are the code they were) keep ? x * f32(1 / (1 - p)) : 0 (:735-739,
// :778-788), common.cuh's keep-mask keyed (row / block_r, 0, 0) at the
// index (row % block_r) * Hout + c, block_r being the reference's row
// tile (mlp_blocks :118) whatever rows a block here owns; the backward
// regenerates it from the seed pair. The key is a kernel parameter of
// its own: held inside Args it raised the dropout-free forward's register
// use and slowed it on an H100 (chip_smoke.py's phase 21 times it).
//
// Bound: bytes. At BERT-base training shapes (R = 16384, Hin = Hout = 768,
// bf16) the forward's product is 2 R Hin Hout = 19.3 GFLOP (19.5 us at 989
// TFLOP/s) against 75.5 MB moved once (x, res, y: 22.5 us at 3.35 TB/s); the
// backward moves x, res, g and the two f32 outputs (176 MB, 52.6 us) and
// recomputes the same product.
//
// Design: a block owns BM = 32 rows and every one of the Hout columns, so
// the row's LayerNorm runs in the block and the projected [R, Hout] tensor
// never reaches device memory, as on the TPU. The f32 [32, Hout] product
// lives in shared memory (96.5 KB at Hout = 768, 128.5 KB at 1024; Hout is
// limited by what 227 KB holds beside the operand ring: proj_ln_max_hout).
// The product is walked in column chunks of NC = 256, each through the
// GEMM main loop of common.cuh that the fused MLP kernels run (fused_mlp.cu),
// with a 32 x 256 block tile: a cp.async ring of (x, W) tiles (16-byte
// copies, zero-filled past the edges: any R, Hin, Hout, no padding in device
// memory; scalar copies when a stride or pointer is not 16-byte aligned)
// feeds, in bf16, ldmatrix + mma.sync m16n8k16 with f32 accumulators in
// registers (8 warps, each 32 rows x 32 columns of the chunk), and in f32
// scalar FMA (parity runs). The tile is 32 rows, not the MLP's 128: the
// f32 row tile of 128 rows would not fit in shared memory. The epilogue
// runs one warp per row: z into the shared tile, then mean, the centred
// variance and y (forward) or c1, c2 and dz (backward). The backward's
// dgamma and dbeta are summed per block, column by column over its 32 rows
// in order, into an f32 workspace [ceil(R / 32), 2, Hout] that common.cuh's
// sum_parts sums in a fixed order: no atomics, every call gives the same
// bits.
// CUDA launches per call: forward 1, backward 2.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 32;        // rows a block owns
constexpr int NC = 256;       // columns of one product chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the product's block tile: BM rows x NC columns, 8 warps of 32 x 32
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> : TileCfg<BM, NC, 32, 3, 32, 32> {};
template <> struct Cfg<float> : TileCfg<BM, NC, 16, 2, 32, 32> {};
static_assert(Cfg<float>::THREADS == kThreads && Cfg<__nv_bfloat16>::THREADS == kThreads,
              "one block size for the product and the epilogue");
template <typename T> __host__ __device__ constexpr size_t ring() {
  return ring_bytes<T, Cfg<T>, false, false>();
}

// row stride of the f32 tile: Hout + 4
__host__ __device__ constexpr int lds_of(int hout) { return hout + 4; }
template <typename T> __host__ __device__ constexpr size_t smem_bytes(int hout) {
  return ring<T>() + (size_t)BM * lds_of(hout) * sizeof(float);
}
template <typename T> int max_hout() {
  return (int)((kMaxSmem - ring<T>()) / (BM * sizeof(float))) - 4;
}

struct Args {
  const void* x;
  const void* w;
  const float* bias;
  const void* res;
  const float* gamma;
  const float* beta;   // forward
  void* y;             // forward
  float* mean;         // forward: written; backward: read
  float* rstd;
  const void* g;       // backward
  float* dz;           // backward
  float* dp;           // backward
  float* part;         // backward: [ceil(R / BM), 2, Hout]
  int r, hin, hout, vec;
  float eps;
};

// S[0:BM, 0:Hout] = x[m0:m0+BM, :] . W, f32, chunk by chunk of NC columns
// through common.cuh's main loop
template <typename T>
__device__ void product(const Args& p, char* smem, float* S, int m0) {
  Operands<T> o;
  o.a = static_cast<const T*>(p.x), o.lda = p.hin;
  o.b = static_cast<const T*>(p.w), o.ldb = p.hout;
  o.m = p.r, o.n = p.hout, o.k = p.hin, o.vec = p.vec;
  const int lds = lds_of(p.hout);
  for (int n0 = 0; n0 < p.hout; n0 += NC)
    mainloop<T, Cfg<T>, false, false>(o, smem, S + n0, lds, min(NC, p.hout - n0), m0, n0);
}

// S row r (of the block) -> drop(S + b) + res: z, the LayerNorm's input,
// in place
template <typename T, bool DROP>
__device__ __forceinline__ float z_in_place(const Args& p, const Drop& drop, float* srow,
                                            const T* res, RowKey rk, int c) {
  float z = srow[c] + p.bias[c];
  if (DROP) z = dropped(row_keep(drop, rk, c), z, drop);
  z += to_f(res[c]);
  srow[c] = z;
  return z;
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads) proj_ln_fwd_kernel(Args p, Drop drop) {
  extern __shared__ __align__(128) char smem[];
  float* S = reinterpret_cast<float*>(smem + ring<T>());
  const int m0 = blockIdx.x * BM;
  product<T>(p, smem, S, m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lds = lds_of(p.hout);
  for (int rr = warp; rr < BM; rr += kWarps) {
    const int row = m0 + rr;
    if (row >= p.r) break;
    float* srow = S + rr * lds;
    const T* res = static_cast<const T*>(p.res) + (size_t)row * p.hout;
    const RowKey rk = DROP ? row_key(drop, row) : RowKey{0u, 0u};
    float s = 0.f;
    for (int c = lane; c < p.hout; c += 32) s += z_in_place<T, DROP>(p, drop, srow, res, rk, c);
    const float mean = warp_sum(s) / p.hout;
    float v = 0.f;
    for (int c = lane; c < p.hout; c += 32) {
      const float d = srow[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / p.hout + p.eps);
    T* y = static_cast<T*>(p.y) + (size_t)row * p.hout;
    for (int c = lane; c < p.hout; c += 32)
      y[c] = from_f<T>((srow[c] - mean) * rstd * p.gamma[c] + p.beta[c]);
    if (lane == 0) {
      p.mean[row] = mean;
      p.rstd[row] = rstd;
    }
  }
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads) proj_ln_bwd_kernel(Args p, Drop drop) {
  extern __shared__ __align__(128) char smem[];
  float* S = reinterpret_cast<float*>(smem + ring<T>());
  const int m0 = blockIdx.x * BM;
  product<T>(p, smem, S, m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lds = lds_of(p.hout);
  const T* g = static_cast<const T*>(p.g);
  for (int rr = warp; rr < BM; rr += kWarps) {
    const int row = m0 + rr;
    if (row >= p.r) break;
    float* srow = S + rr * lds;
    const T* res = static_cast<const T*>(p.res) + (size_t)row * p.hout;
    const T* grow = g + (size_t)row * p.hout;
    const float mean = p.mean[row], rstd = p.rstd[row];
    const RowKey rk = DROP ? row_key(drop, row) : RowKey{0u, 0u};
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < p.hout; c += 32) {
      const float xh = (z_in_place<T, DROP>(p, drop, srow, res, rk, c) - mean) * rstd;
      srow[c] = xh;  // x^ stays in the tile for the column sums
      const float gw = to_f(grow[c]) * p.gamma[c];
      s1 += gw;
      s2 += gw * xh;
    }
    const float c1 = warp_sum(s1) / p.hout, c2 = warp_sum(s2) / p.hout;
    float* dz = p.dz + (size_t)row * p.hout;
    float* dp = p.dp + (size_t)row * p.hout;
    for (int c = lane; c < p.hout; c += 32) {
      const float d = (to_f(grow[c]) * p.gamma[c] - c1 - srow[c] * c2) * rstd;
      dz[c] = d;
      dp[c] = DROP ? dropped(row_keep(drop, rk, c), d, drop) : d;
    }
  }
  __syncthreads();
  // dgamma, dbeta over the block's rows, in row order, column by column
  const int rows = min(BM, p.r - m0);
  float* part = p.part + (size_t)blockIdx.x * 2 * p.hout;
  for (int c = threadIdx.x; c < p.hout; c += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const float gf = to_f(g[(size_t)(m0 + rr) * p.hout + c]);
      sg += gf * S[rr * lds + c];
      sb += gf;
    }
    part[c] = sg;
    part[p.hout + c] = sb;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, Args& p, const Drop& d, void* stream) {
  if (p.r < 1 || p.hin < 1 || p.hout < 2 || p.hout % 2 || p.hout > max_hout<T>())
    return (int)cudaErrorInvalidValue;
  if (d.rows < 0 || (d.rows > 0 && d.cols != p.hout)) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  p.vec = (p.hin % V == 0 && p.hout % V == 0 && aligned16(p.x) && aligned16(p.w)) ? 1 : 0;
  const size_t bytes = smem_bytes<T>(p.hout);
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  if (rc) return rc;
  kernel<<<(p.r + BM - 1) / BM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(Args& p, const Drop& d, void* stream) {
  return launch<T>(d.rows ? proj_ln_fwd_kernel<T, true> : proj_ln_fwd_kernel<T, false>, p, d,
                   stream);
}

template <typename T>
int launch_bwd(Args& p, const Drop& d, float* sums, void* stream) {
  int rc = launch<T>(d.rows ? proj_ln_bwd_kernel<T, true> : proj_ln_bwd_kernel<T, false>, p, d,
                     stream);
  if (rc) return rc;
  const int cols = 2 * p.hout;
  return sum_parts(p.part, (p.r + BM - 1) / BM, cols, sums, cols, nullptr, 8,
                   static_cast<cudaStream_t>(stream));
}

// --------------------------------------------------------------------------
// the cluster route: bf16, Hout a multiple of 256 up to kMaxHout
// --------------------------------------------------------------------------
//
// A cluster of kCtas = 4 blocks owns a row tile of kRows = 128 rows; block
// `rank` of the cluster owns the columns [rank NW, (rank + 1) NW), NW =
// Hout / 4 (192 at BERT-base's 768). So the f32 row [128, Hout] lives in
// the registers of the four blocks and never in shared or device memory
// (the generic kernels' f32 row tile in shared memory is what bounds their
// Hout and their 32-row tile).
//   - Warp roles: 288 threads; warps 0-7 are two consumer warpgroups of 64
//     rows each, warp 8 the producer. Its lane 0 keeps a ring of S (x, W)
//     k steps full by TMA (4 stages in the forward, 3 in the backward; a
//     full and an empty mbarrier per stage, expect_tx bytes): x's [128, 64]
//     tile K-major and the block's W slice [64, NW] as NW / 64 boxes of
//     [64][64] (W is [Hin, Hout] row-major: MN-major), both in the 128-byte
//     swizzle. Rows past R and k past Hin arrive as zeros (the maps'
//     bounds), so any R and any Hin % 8 == 0. Each block reads only its own
//     W slice: a call reads W once per 128-row tile from L2 (151 MB at
//     BERT-base's shape) instead of once per 32 rows (604 MB). Once the
//     ring's first fill is issued, the producer loads the epilogue's row
//     tiles (res, and g in the backward) by TMA into shared memory, so their
//     device-memory reads overlap the product.
//   - Each consumer warpgroup multiplies its 64 rows by wgmma m64nNWk16
//     (A K-major, B through wgmma's transpose, LBO stepping between the
//     64-column boxes) into NW / 2 f32 registers a thread, keeping one
//     group of products in flight while the previous stage is released.
//   - One product pass, then the epilogue in registers: a thread holds rows
//     r, r + 8 at columns 8n + 2c, 8n + 2c + 1 (c = lane % 4), so a row's
//     sum over the block's columns is a sum in the thread and two shuffles
//     in its quad. The four blocks' partials cross the cluster once through
//     distributed shared memory: each block writes its partials of each row
//     into its own shared memory, barrier.cluster, and every block reads
//     the four in rank order (the same sums, the same bits, in every block).
//     Forward: z = drop(acc + b) + res; each block's row sum and its sum of
//     squares about its own mean, combined by Chan et al.'s pairwise update
//     into the mean and the two-pass variance of the whole row (:735-738,
//     in another order) -> rstd; y = round((z - mean) rstd gamma + beta);
//     rank 0 writes mean, rstd. Backward: z as above; x^ = (z - mean) rstd
//     from the saved stats; gw = g gamma; sum gw -> c1, sum gw x^ -> c2;
//     dz = (gw - c1 - x^ c2) rstd, written as dres = round(dz) (the cast of
//     dz the reference's caller makes, :905), and dp = drop(dz) as the pair
//     hi = bf16(dp), lo = bf16(dp - hi) (hi + lo is dp to ~2^-17 relative,
//     in the bytes of one f32 tensor): the caller's dx = dp W^T and dW =
//     x^T dp run as bf16 tensor-core products over the pair with f32
//     accumulation. No f32 [R, Hout] tensor reaches device memory.
//     The column sums dgamma = sum g x^, dbeta = sum g and db = sum dp over
//     the block's 128 rows, from the unrounded f32 values, in a fixed order
//     (the thread's two rows, the warp's eight row groups by xor shuffles,
//     then the eight warps in order through shared memory), into an f32
//     workspace [ceil(R / 128), 3, Hout] that sum_parts sums: no atomics,
//     two calls give the same bits.
//   - Outputs leave through shared memory: each 64-column box of y (or of
//     dres, hi and lo) is staged in the 128-byte swizzle where the ring
//     was, then stored by TMA while the next box is computed.
//   - Dropout (the DROP instantiations) hashes each element by row_key /
//     row_keep, keyed by the reference's row tile, never by the 128-row
//     tile here, before the product; the bits wait in shared memory (in
//     registers they made the backward spill). The key stays a kernel
//     parameter of its own.
//   - Every mbarrier wait traps after ~2^35 cycles (hopper.cuh).
// Where the time goes on an H100 (scripts/proj_ln_cluster_probe.py times
// copies of this file with parts of the epilogue cut; PERF.md): the output
// stores and the cluster exchange are the largest parts; one block per SM
// and no persistent schedule, so one row tile's epilogue does not overlap
// the next one's loads (later work, with TMA multicast of x).
// CUDA launches per call: forward 1, backward 2 (+ sum_parts).

namespace cl {

constexpr int kRows = 128;  // a cluster's row tile
constexpr int kCtas = 4;    // blocks of a cluster: Hout / 4 columns each
constexpr int kBK = 64;     // k step: 64 bf16, one 128-byte swizzle row
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kWarps = kConsumers / 32;
// NW = 192: 96 accumulator registers a thread, no spills. At NW = 256
// (Hout 1024) ptxas spilled under its cap of 168 registers a thread (the
// registers of a whole warpgroup at 288 threads), and the backward's ring,
// res and g tiles would not fit in 227 KB of shared memory: the route
// stops here
constexpr int kMaxHout = 768;

// A block's shared memory: the ring of S stages, the epilogue's row tiles
// (res, and g in the backward) as NW / 64 x 2 boxes of [64][64] bf16 in
// the 128-byte swizzle, the vectors, the row partials and the barriers.
// After the product the ring (and res's tile) hold the output tiles on
// their way out, as the same boxes, then the backward's column partials.
template <int NW, bool BWD> struct Smem {
  static constexpr int S = BWD ? 3 : 4;  // stages: the backward's second row tile takes one
  static constexpr int NT = BWD ? 2 : 1;
  __nv_bfloat16 x[S][kRows * kBK];
  __nv_bfloat16 w[S][kBK * NW];  // NW / 64 boxes of [kBK][64]
  __nv_bfloat16 tile[NT][kRows * NW];
  float vec[3][NW];     // b, gamma, beta of the block's columns
  float rowp[2][kRows];  // the block's partial sums of each row
  uint32_t keep[NW / 64][kConsumers];  // dropout: each consumer thread's mask bits
  uint64_t full[S], empty[S], rows;
};
// bytes of the output tiles staged in the ring: y, or dres, hi and lo
template <int NW, bool BWD> __host__ __device__ constexpr int staged_bytes() { return (BWD ? 3 : 1) * kRows * NW * 2; }

// y (forward), dres and the pair [R, 2, Hout] (hi then lo; backward) are
// written through tensor maps
struct Args {
  const float* bias;
  const __nv_bfloat16* res;
  const float* gamma;
  const float* beta;         // forward
  float* mean;               // forward: written; backward: read
  float* rstd;
  const __nv_bfloat16* g;    // backward
  float* part;               // backward: [ceil(R / kRows), 3, Hout]
  int r, hin, hout;
  float eps;
};

template <int S> __device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == S) stage = 0, phase ^= 1;
}

// the sum of a row's four partials (at p in each block's shared memory),
// in rank order
__device__ __forceinline__ float cluster_total(const float* p) {
  float t = ld_cluster(p, 0);
#pragma unroll
  for (uint32_t q = 1; q < kCtas; ++q) t += ld_cluster(p, q);
  return t;
}

// a thread's two rows' sums over its quad of lanes: the block's partials
__device__ __forceinline__ void quad_sum(float (&s)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
}

// The block's setup and product: the barriers, the block's columns of b,
// gamma (and beta), then the producer's ring or the consumers' wgmma loop
// into acc (consumer threads; the producer warp returns false). Once the
// ring's first fill is on its way the producer loads the epilogue's row
// tiles (res; g: `tg`, null in the forward), which arrive while the
// product runs.
template <int NW, bool BWD>
__device__ __forceinline__ bool product(Smem<NW, BWD>& sm, const CUtensorMap& tx,
                                        const CUtensorMap& tw, const CUtensorMap& tres,
                                        const CUtensorMap* tg, const Args& a, int row0,
                                        int col0, float (&acc)[NW / 2]) {
  using Sm = Smem<NW, BWD>;
  constexpr int NB = NW / 64;  // 64-column boxes of a W tile
  const int nk = (a.hin + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < Sm::S; ++st) {
      mbar_init(&sm.full[st], 1);            // the producer's expect_tx
      mbar_init(&sm.empty[st], kConsumers);  // every consumer thread
    }
    mbar_init(&sm.rows, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < NW; i += kThreads) {
    sm.vec[0][i] = a.bias[col0 + i];
    sm.vec[1][i] = a.gamma[col0 + i];
    if (!BWD) sm.vec[2][i] = a.beta[col0 + i];
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_arrive_tx(&sm.full[stage], (kRows + NW) * kBK * 2);
        tma_load_2d(sm.x[stage], &tx, &sm.full[stage], kt * kBK, row0);
        for (int cb = 0; cb < NB; ++cb)
          tma_load_2d(sm.w[stage] + cb * kBK * 64, &tw, &sm.full[stage], col0 + cb * 64,
                      kt * kBK);
        advance<Sm::S>(stage, phase);
        if (kt == min(nk, Sm::S) - 1) {
          mbar_arrive_tx(&sm.rows, Sm::NT * kRows * NW * 2);
          for (int t = 0; t < Sm::NT; ++t)
            for (int cb = 0; cb < NB; ++cb)
              for (int half = 0; half < 2; ++half)
                tma_load_2d(sm.tile[t] + (cb * 2 + half) * 64 * 64, t ? tg : &tres, &sm.rows,
                            col0 + cb * 64, row0 + half * 64);
        }
      }
    }
    __syncwarp();
    return false;
  }

  const int wgi = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&sm.full[stage], phase);
    fence_regs(acc);
    wgmma_fence();
    const __nv_bfloat16* xs = sm.x[stage] + wgi * 64 * kBK;  // the warpgroup's 64 rows
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_smem<NW, 0, 1>(acc, desc_sw128(xs + kk * 16, 16),
                           desc_sw128(sm.w[stage] + kk * 16 * 64, kBK * 128), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&sm.empty[prev]);
    prev = stage;
    advance<Sm::S>(stage, phase);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_wait(&sm.rows, 0);
  return true;
}

// This thread's place in the accumulator: rows lr, lr + 8 of the tile
// (rr, rr + 8 of its warpgroup's 64), columns 8n + 2c + e of the block's
// slice; acc[4n + 2h + e] is row lr + 8h, column 8n + 2c + e.
struct Place {
  int lr[2], row[2];
  bool live[2];
  int c, rr, wgi, slot;  // slot: the warp among the 8 consumer warps (16 rows each)
  __device__ Place(int row0, int r) {
    const int t = threadIdx.x, lane = t & 31;
    slot = t >> 5;
    wgi = t >> 7;
    c = lane & 3;
    lr[0] = slot * 16 + (lane >> 2);
    lr[1] = lr[0] + 8;
    rr = lr[0] - wgi * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + lr[h];
      live[h] = row[h] < r;
    }
  }
};

// A row tile in shared memory, as the maps' boxes hold it: per 64
// columns and warpgroup a [64][64] bf16 box in the 128-byte swizzle. The
// byte offset of this thread's two values of row rr + 8h at columns
// 8n + 2c, + 1 (conflict-free: the eight rows of a warp's access land in
// eight different 16-byte chunks).
__device__ __forceinline__ int box_at(int n, int h, const Place& pl) {
  const int row = pl.rr + 8 * h;
  return ((((n >> 3) * 2 + pl.wgi) << 13) + row * 128 + (((n & 7) ^ (row & 7)) << 4) + 4 * pl.c);
}
__device__ __forceinline__ float2 tile_at(const __nv_bfloat16* tile, int n, int h,
                                          const Place& pl) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const char*>(tile) + box_at(n, h, pl)));
}
// output tile `o` staged in the ring
template <int NW>
__device__ __forceinline__ void stage(char* ring, int o, int n, int h, const Place& pl,
                                      uint32_t v) {
  *reinterpret_cast<uint32_t*>(ring + o * kRows * NW * 2 + box_at(n, h, pl)) = v;
}

// The warpgroup's box cb (64 columns) of output tile `o` to device
// memory (one thread): column col of the map; rows past R are not written.
template <int NW>
__device__ __forceinline__ void store_box(const CUtensorMap& map, const char* ring, int o,
                                          int cb, const Place& pl, int col, int row0) {
  tma_store_2d(&map, ring + o * kRows * NW * 2 + ((cb * 2 + pl.wgi) << 13), col + cb * 64,
               row0 + pl.wgi * 64);
}
// a box staged by the whole warpgroup, handed to the TMA unit
__device__ __forceinline__ bool box_staged(const Place& pl) {
  fence_proxy_async();
  bar_sync(2 + pl.wgi, 128);
  return (threadIdx.x & 127) == 0;
}

// The dropout mask of a consumer thread's elements into shared memory:
// bit i % 32 of its word i / 32 is element i's keep bit (acc's order).
// Reckoned before the product, while the first stages are on their way;
// held in shared memory, not in registers, which the epilogue needs.
template <int NW, bool BWD>
__device__ __forceinline__ void keep_bits(Smem<NW, BWD>& sm, const Drop& drop, const Place& pl,
                                          int col0) {
  if (threadIdx.x >= kConsumers) return;
  const RowKey rk[2] = {row_key(drop, pl.row[0]), row_key(drop, pl.row[1])};
#pragma unroll
  for (int j = 0; j < NW / 64; ++j) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int i = 32 * j + b, n = i >> 2, h = (i >> 1) & 1, e = i & 1;
      word |= (uint32_t)row_keep(drop, rk[h], col0 + 8 * n + 2 * pl.c + e) << b;
    }
    sm.keep[j][threadIdx.x] = word;
  }
}
template <int NW, bool BWD>
__device__ __forceinline__ bool kept(const Smem<NW, BWD>& sm, int i) {
  return (sm.keep[i >> 5][threadIdx.x] >> (i & 31)) & 1u;
}

// acc -> z = drop(acc + b) + res in place (res's tile: rows past R are 0)
template <int NW, bool BWD, bool DROP>
__device__ __forceinline__ void z_in_place(float (&acc)[NW / 2], const Smem<NW, BWD>& sm,
                                           const Drop& drop, const Place& pl) {
#pragma unroll
  for (int n = 0; n < NW / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = 8 * n + 2 * pl.c;
      const float2 rv = tile_at(sm.tile[0], n, h, pl);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * h + e;
        float z = acc[i] + sm.vec[0][cl + e];
        if (DROP) z = dropped(kept(sm, i), z, drop);
        acc[i] = z + (e ? rv.y : rv.x);
      }
    }
}

template <int NW, bool DROP>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
    proj_ln_fwd_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tw,
                               const __grid_constant__ CUtensorMap tres,
                               const __grid_constant__ CUtensorMap ty, const Args a,
                               const Drop drop) {
  extern __shared__ __align__(1024) char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every tile starts on such a boundary
  Smem<NW, false>& sm = *reinterpret_cast<Smem<NW, false>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const uint32_t rank = cluster_rank();
  const int row0 = (blockIdx.x / kCtas) * kRows, col0 = rank * NW;
  const Place pl(row0, a.r);
  if (DROP) keep_bits(sm, drop, pl, col0);
  float acc[NW / 2];
  if (!product<NW, false>(sm, tx, tw, tres, nullptr, a, row0, col0, acc)) {
    cluster_sync();  // the producer warp takes part in the epilogue's two barriers
    cluster_sync();
    return;
  }
  z_in_place<NW, false, DROP>(acc, sm, drop, pl);

  // each row's sum and centred sum of squares over the block's columns,
  // then combined over the four blocks in one exchange (Chan et al.'s
  // pairwise update: the two-pass variance of the whole row, :735-738)
  float s[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) s[(i >> 1) & 1] += acc[i];
  quad_sum(s);
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const float d = acc[i] - s[(i >> 1) & 1] / NW;
    m2[(i >> 1) & 1] += d * d;
  }
  quad_sum(m2);
  if (pl.c == 0) {
    sm.rowp[0][pl.lr[0]] = s[0], sm.rowp[0][pl.lr[1]] = s[1];
    sm.rowp[1][pl.lr[0]] = m2[0], sm.rowp[1][pl.lr[1]] = m2[1];
  }
  cluster_sync();  // also: both warpgroups' products are done, the ring is free
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sq[kCtas];
#pragma unroll
    for (int q = 0; q < kCtas; ++q) sq[q] = ld_cluster(&sm.rowp[0][pl.lr[h]], q);
    float t = sq[0];
#pragma unroll
    for (int q = 1; q < kCtas; ++q) t += sq[q];
    mean[h] = t / a.hout;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < kCtas; ++q) {
      const float d = sq[q] / NW - mean[h];
      var += ld_cluster(&sm.rowp[1][pl.lr[h]], q) + NW * d * d;
    }
    rstd[h] = rsqrtf(var / a.hout + a.eps);
  }
  cluster_arrive();  // done with the peers' shared memory

  // y, staged and stored box by box: a box's stores drain while the next is computed
  char* ring = reinterpret_cast<char*>(sm.x);
#pragma unroll
  for (int cb = 0; cb < NW / 64; ++cb) {
#pragma unroll
    for (int n = 8 * cb; n < 8 * cb + 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cl = 8 * n + 2 * pl.c;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = (acc[4 * n + 2 * h + e] - mean[h]) * rstd[h] * sm.vec[1][cl + e] +
                 sm.vec[2][cl + e];
        stage<NW>(ring, 0, n, h, pl, pack_bf16(o[0], o[1]));
      }
    if (box_staged(pl)) {
      store_box<NW>(ty, ring, 0, cb, pl, col0, row0);
      bulk_commit();
    }
  }
  if (rank == 0 && pl.c == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (pl.live[h]) a.mean[pl.row[h]] = mean[h], a.rstd[pl.row[h]] = rstd[h];
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  cluster_wait();  // no block leaves while a peer may still read its partials
}

template <int NW, bool DROP>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
    proj_ln_bwd_cluster_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tw,
                               const __grid_constant__ CUtensorMap tres,
                               const __grid_constant__ CUtensorMap tg,
                               const __grid_constant__ CUtensorMap tdres,
                               const __grid_constant__ CUtensorMap tpair, const Args a,
                               const Drop drop) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem<NW, true>& sm = *reinterpret_cast<Smem<NW, true>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const uint32_t rank = cluster_rank();
  const int tile = blockIdx.x / kCtas;
  const int row0 = tile * kRows, col0 = rank * NW;
  const Place pl(row0, a.r);
  if (DROP) keep_bits(sm, drop, pl, col0);  // also dp's mask
  float acc[NW / 2];
  if (!product<NW, true>(sm, tx, tw, tres, &tg, a, row0, col0, acc)) {
    cluster_sync();  // the producer warp takes part in the epilogue's two barriers
    cluster_sync();
    return;
  }
  z_in_place<NW, true, DROP>(acc, sm, drop, pl);
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows past R: x^ = 0, so they add nothing below
    mean[h] = pl.live[h] ? a.mean[pl.row[h]] : 0.f;
    rstd[h] = pl.live[h] ? a.rstd[pl.row[h]] : 0.f;
  }
  // x^ in place; sum gw and sum gw x^ over the block's columns
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NW / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = 8 * n + 2 * pl.c;
      const float2 gv = tile_at(sm.tile[1], n, h, pl);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[4 * n + 2 * h + e];
        v = (v - mean[h]) * rstd[h];
        const float gw = (e ? gv.y : gv.x) * sm.vec[1][cl + e];
        s1[h] += gw;
        s2[h] += gw * v;
      }
    }
  quad_sum(s1);
  quad_sum(s2);
  if (pl.c == 0) {
    sm.rowp[0][pl.lr[0]] = s1[0], sm.rowp[0][pl.lr[1]] = s1[1];
    sm.rowp[1][pl.lr[0]] = s2[0], sm.rowp[1][pl.lr[1]] = s2[1];
  }
  cluster_sync();  // also: both warpgroups' products are done, the ring is free
  float c1[2], c2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c1[h] = cluster_total(&sm.rowp[0][pl.lr[h]]) / a.hout;
    c2[h] = cluster_total(&sm.rowp[1][pl.lr[h]]) / a.hout;
  }
  cluster_arrive();  // done with the peers' shared memory

  // dz, staged as dres (tile 0) and the pair's hi (1) and lo (2); the
  // column sums of g x^, g and dp over the 128 rows, each warp's into
  // colp [8][3][NW] past the staged tiles
  char* ring = reinterpret_cast<char*>(sm.x);
  auto colp = reinterpret_cast<float(*)[3][NW]>(ring + staged_bytes<NW, true>());
#pragma unroll
  for (int n = 0; n < NW / 8; ++n) {
    const int cl = 8 * n + 2 * pl.c;
    float col[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 gv = tile_at(sm.tile[1], n, h, pl);
      float dz[2], hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gf = e ? gv.y : gv.x, xh = acc[4 * n + 2 * h + e];
        dz[e] = (gf * sm.vec[1][cl + e] - c1[h] - xh * c2[h]) * rstd[h];
        const int i = 4 * n + 2 * h + e;
        const float dp = DROP ? dropped(kept(sm, i), dz[e], drop) : dz[e];
        hi[e] = __bfloat162float(__float2bfloat16_rn(dp));
        lo[e] = dp - hi[e];
        col[0][e] += gf * xh;
        col[1][e] += gf;
        col[2][e] += dp;
      }
      stage<NW>(ring, 0, n, h, pl, pack_bf16(dz[0], dz[1]));
      stage<NW>(ring, 1, n, h, pl, pack_bf16(hi[0], hi[1]));
      stage<NW>(ring, 2, n, h, pl, pack_bf16(lo[0], lo[1]));
    }
    // over the warp's eight row groups: the lanes of one c
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = col[q][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        col[q][e] = v;
      }
    if ((threadIdx.x & 31) < 4) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        colp[pl.slot][q][cl] = col[q][0], colp[pl.slot][q][cl + 1] = col[q][1];
    }
    // a box of 64 columns staged: its stores drain while the next is computed
    if ((n & 7) == 7 && box_staged(pl)) {
      const int cb = n >> 3;
      store_box<NW>(tdres, ring, 0, cb, pl, col0, row0);
      store_box<NW>(tpair, ring, 1, cb, pl, col0, row0);
      store_box<NW>(tpair, ring, 2, cb, pl, a.hout + col0, row0);
      bulk_commit();
    }
  }
  bar_sync(1, kConsumers);  // every warp's column partials
  float* part = a.part + (size_t)tile * 3 * a.hout + col0;
  for (int i = threadIdx.x; i < 3 * NW; i += kConsumers) {
    const int q = i / NW, cl = i - q * NW;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += colp[w][q][cl];
    part[(size_t)q * a.hout + cl] = s;
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_read();
  cluster_wait();  // no block leaves while a peer may still read its partials
}

// the tensor maps of a call: x, W, res, then y (forward) or g, dres, pair
struct Maps {
  CUtensorMap m[6];
};

template <int NW, bool BWD, bool DROP>
int launch_nw(const Maps& mp, const Args& a, const Drop& d, cudaStream_t stream) {
  using Sm = Smem<NW, BWD>;
  static_assert(sizeof(Sm) + 1024 <= kMaxSmem, "shared memory of a block");
  // the staged output tiles (and the backward's column partials) fit in
  // the ring and res's tile, which the epilogue is done with; g's stays
  static_assert(staged_bytes<NW, BWD>() + (BWD ? kWarps * 3 * NW * 4 : 0) <=
                    sizeof(Sm::x) + sizeof(Sm::w) + kRows * NW * 2,
                "the staged tiles fit where the ring and res's tile were");
  const size_t bytes = sizeof(Sm) + 1024;  // + the slack of the 1024-byte alignment
  const int grid = (a.r + kRows - 1) / kRows * kCtas;
  int rc;
  if constexpr (BWD) {
    auto kernel = proj_ln_bwd_cluster_kernel<NW, DROP>;
    if ((rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bytes)))
      return rc;
    kernel<<<grid, kThreads, bytes, stream>>>(mp.m[0], mp.m[1], mp.m[2], mp.m[3], mp.m[4],
                                              mp.m[5], a, d);
  } else {
    auto kernel = proj_ln_fwd_cluster_kernel<NW, DROP>;
    if ((rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bytes)))
      return rc;
    kernel<<<grid, kThreads, bytes, stream>>>(mp.m[0], mp.m[1], mp.m[2], mp.m[3], a, d);
  }
  return (int)cudaGetLastError();
}

// the map of a row-major [rows, cols] bf16 tensor, boxes of 64 columns x
// box_rows rows
int map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tensor_map_bf16(map, base, 2, dims, strides, box);
}

// out: y (forward) or dres; pair: the backward's [R, 2 Hout]
template <bool BWD>
int launch(const void* x, const void* w, void* out, void* pair, const Args& a, const Drop& d,
           float* sums, void* stream) {
  if (a.r < 1 || a.hin < 1 || a.hin % 8 || a.hout < 256 || a.hout % 256 || a.hout > kMaxHout ||
      !aligned16(x) || !aligned16(w) || !aligned16(a.res) || !aligned16(out) ||
      (BWD && (!aligned16(a.g) || !aligned16(pair))))
    return (int)cudaErrorInvalidValue;
  if (d.rows < 0 || (d.rows > 0 && d.cols != a.hout)) return (int)cudaErrorInvalidValue;
  Maps mp;
  int rc;
  if ((rc = map_2d(&mp.m[0], x, a.r, a.hin, kRows)) ||
      (rc = map_2d(&mp.m[1], w, a.hin, a.hout, kBK)) ||
      (rc = map_2d(&mp.m[2], a.res, a.r, a.hout, 64)))
    return rc;
  if (BWD) {
    if ((rc = map_2d(&mp.m[3], a.g, a.r, a.hout, 64)) ||
        (rc = map_2d(&mp.m[4], out, a.r, a.hout, 64)) ||
        (rc = map_2d(&mp.m[5], pair, a.r, 2 * a.hout, 64)))
      return rc;
  } else if ((rc = map_2d(&mp.m[3], out, a.r, a.hout, 64))) {
    return rc;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.hout / kCtas) {
#define PL_NW(NW)                                                                  \
  case NW:                                                                         \
    rc = d.rows ? launch_nw<NW, BWD, true>(mp, a, d, st)                           \
                : launch_nw<NW, BWD, false>(mp, a, d, st);                         \
    break;
    PL_NW(64)
    PL_NW(128)
    PL_NW(192)
#undef PL_NW
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc || !BWD) return rc;
  const int cols = 3 * a.hout;
  return sum_parts(a.part, (a.r + kRows - 1) / kRows, cols, sums, cols, nullptr, 8, st);
}

}  // namespace cl

}  // namespace

extern "C" {

// The dropout key of both: the seed pair, the keep threshold,
// f32(1 / (1 - p)) and the reference's row tile (drop_rows = block_r,
// drop_cols = Hout); drop_rows 0: no dropout.
//
// y [R, Hout] in the dtype; mean, rstd [R] f32
#define PL_FWD(SUFFIX, T)                                                                    \
  int proj_ln_fwd_##SUFFIX(const void* x, const void* w, const void* b, const void* res,     \
                           const void* gamma, const void* beta, void* y, void* mean,         \
                           void* rstd, int r, int hin, int hout, float eps, unsigned s0,     \
                           unsigned s1, unsigned thresh, float inv, int drop_rows,           \
                           int drop_cols, void* stream) {                                    \
    Args p{};                                                                                \
    p.x = x, p.w = w, p.bias = static_cast<const float*>(b), p.res = res;                    \
    p.gamma = static_cast<const float*>(gamma), p.beta = static_cast<const float*>(beta);    \
    p.y = y, p.mean = static_cast<float*>(mean), p.rstd = static_cast<float*>(rstd);         \
    p.r = r, p.hin = hin, p.hout = hout, p.eps = eps;                                        \
    return launch_fwd<T>(p, Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, stream);       \
  }
PL_FWD(f32, float)
PL_FWD(bf16, __nv_bfloat16)

// dz, dp [R, Hout] f32; part: f32 workspace [ceil(R / 32), 2, Hout]; sums
// [2, Hout] f32: dgamma, dbeta
#define PL_BWD(SUFFIX, T)                                                                    \
  int proj_ln_bwd_##SUFFIX(const void* x, const void* w, const void* b, const void* res,     \
                           const void* gamma, const void* mean, const void* rstd,            \
                           const void* g, void* dz, void* dp, void* part, void* sums, int r, \
                           int hin, int hout, unsigned s0, unsigned s1, unsigned thresh,     \
                           float inv, int drop_rows, int drop_cols, void* stream) {          \
    Args p{};                                                                                \
    p.x = x, p.w = w, p.bias = static_cast<const float*>(b), p.res = res;                    \
    p.gamma = static_cast<const float*>(gamma);                                              \
    p.mean = static_cast<float*>(const_cast<void*>(mean));                                   \
    p.rstd = static_cast<float*>(const_cast<void*>(rstd));                                   \
    p.g = g, p.dz = static_cast<float*>(dz), p.dp = static_cast<float*>(dp);                 \
    p.part = static_cast<float*>(part), p.r = r, p.hin = hin, p.hout = hout;                 \
    return launch_bwd<T>(p, Drop{s0, s1, thresh, inv, drop_rows, drop_cols},                \
                         static_cast<float*>(sums), stream);                                 \
  }
PL_BWD(f32, float)
PL_BWD(bf16, __nv_bfloat16)

// The cluster route, bf16 only: Hout a multiple of 256 up to
// proj_ln_cluster_max_hout(), Hin % 8 == 0, x, W, res (and g) 16-byte
// aligned; anything else is refused. The forward takes proj_ln_fwd's
// arguments. The backward writes dres [R, Hout] (res's dtype) and pair
// [R, 2, Hout] (hi, lo of dp) in place of dz and dp; part: f32 workspace
// [ceil(R / 128), 3, Hout]; sums [3, Hout] f32: dgamma, dbeta, db.
int proj_ln_fwd_cluster_bf16(const void* x, const void* w, const void* b, const void* res,
                             const void* gamma, const void* beta, void* y, void* mean,
                             void* rstd, int r, int hin, int hout, float eps, unsigned s0,
                             unsigned s1, unsigned thresh, float inv, int drop_rows,
                             int drop_cols, void* stream) {
  cl::Args a{};
  a.bias = static_cast<const float*>(b), a.res = static_cast<const __nv_bfloat16*>(res);
  a.gamma = static_cast<const float*>(gamma), a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<float*>(mean), a.rstd = static_cast<float*>(rstd);
  a.r = r, a.hin = hin, a.hout = hout, a.eps = eps;
  return cl::launch<false>(x, w, y, nullptr, a, Drop{s0, s1, thresh, inv, drop_rows, drop_cols},
                           nullptr, stream);
}

int proj_ln_bwd_cluster_bf16(const void* x, const void* w, const void* b, const void* res,
                             const void* gamma, const void* mean, const void* rstd,
                             const void* g, void* dres, void* pair, void* part, void* sums,
                             int r, int hin, int hout, unsigned s0, unsigned s1,
                             unsigned thresh, float inv, int drop_rows, int drop_cols,
                             void* stream) {
  cl::Args a{};
  a.bias = static_cast<const float*>(b), a.res = static_cast<const __nv_bfloat16*>(res);
  a.gamma = static_cast<const float*>(gamma);
  a.mean = static_cast<float*>(const_cast<void*>(mean));
  a.rstd = static_cast<float*>(const_cast<void*>(rstd));
  a.g = static_cast<const __nv_bfloat16*>(g), a.part = static_cast<float*>(part);
  a.r = r, a.hin = hin, a.hout = hout;
  return cl::launch<true>(x, w, dres, pair, a, Drop{s0, s1, thresh, inv, drop_rows, drop_cols},
                          static_cast<float*>(sums), stream);
}

int proj_ln_cluster_max_hout() { return cl::kMaxHout; }
int proj_ln_cluster_rows() { return cl::kRows; }

int proj_ln_max_hout_f32() { return max_hout<float>(); }
int proj_ln_max_hout_bf16() { return max_hout<__nv_bfloat16>(); }
int proj_ln_rows_per_block() { return BM; }

}  // extern "C"
