// Fused projection + bias + residual + LayerNorm, forward and backward:
//   y = LayerNorm(res + (x . W + b)) * gamma + beta,  x [R, Hin], W [Hin, Hout]
// (the attention output projection folded into BERT's post-LN sublayer close).
//
// Replaces the TPU kernels of paddle_tpu/kernels/mlp_fusion.py:
//   _proj_ln_fwd_kernel :714 (launched by _proj_ln_fwd :827) -> proj_ln_fwd_*
//   _proj_ln_bwd_kernel :751 (launched by _proj_ln_bwd :851) -> proj_ln_bwd_*
//                                                               (+ sum_parts)
// both entered through fused_proj_ln_2d :913 (the custom_vjp of :878).
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
// wgmma, TMA, a W tile shared between blocks (clusters) and a persistent
// schedule are left for later work.

#include "common.cuh"

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

int proj_ln_max_hout_f32() { return max_hout<float>(); }
int proj_ln_max_hout_bf16() { return max_hout<__nv_bfloat16>(); }
int proj_ln_rows_per_block() { return BM; }

}  // extern "C"
