// Flash attention, forward and backward: causal, or not causal with an
// optional key-padding bias; with or without attention-probability
// dropout.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   _fwd_kernel :167 (launched by _fwd :272)      -> flash_fwd_kernel
//   _dq_kernel  :329 (launched by _bwd :539/:580) -> flash_dq_kernel
//   _dkv_kernel :420 (launched by _bwd :602)      -> flash_dkv_kernel
// all entered through flash_attention_bshd :722. Layout [BH, S, D]
// contiguous, D <= 256, float32 or bfloat16 (one dtype for every tensor).
//
//   forward: s = round(q * scale) . k^T (f32); masked entries -1e30;
//            online softmax in f32 (m, l); O = sum p_T . v / l, written in
//            q's dtype; lse = m + log(l), with l == 0 -> 1 (:265-268).
//   dQ:      p = exp(q . round(k * scale)^T - lse); dp = dO . v^T;
//            ds = round(p * (dp - delta)); dQ = ds . round(k * scale).
//   dKV:     p = exp(round(q * scale) . k^T - lse); dV = round(p)^T . dO;
//            ds = round(p * (dp - delta)); dK = ds^T . round(q * scale).
// kv_bias (non-causal only): one f32 row [Sk] per batch, the row of
// batch bh / heads, added to the f32 scaled scores before the row max in
// all three kernels (:211, :367, :458); the caller canonicalises masked
// entries to -1e30 (:790). A KV tile whose bias entries are all <= -5e29
// (_NEG_INF / 2) is skipped, as the reference skips its block (:253, :402,
// :512): its p = exp(-1e30 - m) is exactly 0 against any row that sees a
// key, so skipping it changes nothing (a row that sees no key at all is
// undefined, as in the reference, :736). In the dK/dV kernel the block's
// own kv rows carry the bias; a block whose rows are all masked writes
// dK = dV = 0.
// round() is the rounding to the input dtype where the reference casts
// (:196, :357, :384, :448, :485); delta = rowsum(dO * O) in f32 comes in
// from the caller, as the reference computes it outside its kernels (:551).
// The scale itself stays f32 (the reference's weak-typed constant is
// rounded to bf16 with the operand; in f32 the two are the same).
// Dropout (dropout_p > 0, the DROP instantiations; the dropout-free ones
// are the code they were): common.cuh's keep-mask keyed (bh, r / BQ,
// c / BK) by the reference's logical tile (BQ, BK) (_auto_blocks :672,
// clamped as _fwd clamps it), never by this file's tiles. The forward
// keeps m, l and lse undropped and feeds keep ? p * inv : 0 to the product
// with v (:220-229); dQ and dK/dV regenerate the mask from the seed pair
// (no mask is stored) and take dp = keep ? dp * inv : 0 (:377-383,
// :484), dV the dropped p (:474-476); delta is unchanged. The hash costs
// ~12 integer operations per score element and pass, on the CUDA cores.
//
// Bound: operations. At GPT-3 1.3B training shapes (B=4, NH=16, S=2048,
// D=128, bf16, causal) the forward is two products over half the S x S
// scores, 2 * S^2 * D * BH = 68.7 GFLOP, 0.069 ms at 989 TFLOP/s, against
// 0.040 ms to move q, k, v and o once at 3.35 TB/s; the backward's five
// products take 0.174 ms. Scalar FMA on the CUDA cores would run tens of
// times over that, so the bf16 kernels do every product on the tensor
// cores (nvcuda::wmma 16x16x16 bf16 fragments, f32 accumulation, which
// compile to mma.sync). The f32 variant exists for parity and uses scalar
// FMA.
//
// Design (no TPU artifacts: no 8-lane lse/delta rows, no d padding in
// device memory, no sequential-grid carries, no tuning table). The TPU's
// sequential grid axis becomes a loop inside the block; blocks run in
// parallel:
//   - a block owns one tile of b rows (64 for bf16 with D <= 128, else
//     32) and runs b/16 warps; each warp owns 16 rows of the tile;
//   - the forward and dQ grids are (q tiles, BH), each block looping over
//     KV tiles up to the causal diagonal, heaviest q tiles launched first;
//     the dKV grid is (kv tiles, BH), looping over q tiles from the
//     diagonal on;
//   - operand tiles are staged in shared memory with padded rows (D padded
//     to a multiple of 16 with zeros there, ragged rows zero-filled: the
//     kernels never read or write past S); the running accumulators (O,
//     dQ, dK, dV) and the score tiles live in shared memory as f32, so no
//     assumption is made about the layout of a wmma accumulator fragment;
//   - only tiles that cross the causal diagonal or the ragged tail are
//     masked (the reference's _causal_split, :78-85); tiles wholly above
//     the diagonal are skipped.
// wgmma, TMA, register-resident accumulators and warp specialisation are
// left for later work.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // flash_attention.py:61, never -inf
constexpr int kMaxD = 256;

// Shapes and strides shared by the three kernels. All tiles are b rows.
struct Geo {
  int bh, sq, sk, d;
  int dp;    // d rounded up to 16 (zero columns in shared memory only)
  int b;     // tile rows, a multiple of 16
  int ldt;   // row stride of the dtype tiles (q, k, v, dO): dp + 8
  int lds;   // row stride of the f32 score tiles: b + 4
  int ldp;   // row stride of the dtype score tiles: b + 8
  int ldo;   // row stride of the f32 accumulators: dp + 4
  int causal;
  int vec;   // 16-byte loads: d % 16 == 0 and every pointer aligned
  int heads; // q heads per batch row of the bias
  float scale;
  Drop drop; // drop.rows 0: no dropout
};

constexpr float kSkipBelow = kNegInf / 2;  // a tile is skipped when no bias entry exceeds it

// The bias of kv columns [col0, col0 + b) into dst (-1e30 past sk); true
// when some entry exceeds kSkipBelow. Every thread of the block calls it
// (it ends with a barrier that also publishes dst).
__device__ bool load_bias_tile(float* dst, const float* __restrict__ brow, int col0, const Geo& g) {
  int live = 0;
  for (int idx = threadIdx.x; idx < g.b; idx += blockDim.x) {
    const int col = col0 + idx;
    const float v = col < g.sk ? brow[col] : kNegInf;
    dst[idx] = v;
    live |= v > kSkipBelow;
  }
  return __syncthreads_or(live) != 0;
}

// Carves one block's dynamic shared memory; every buffer starts on a
// 128-byte boundary. Run on the host with base 0 to get the size.
struct Arena {
  uintptr_t base;
  size_t off;
  __host__ __device__ explicit Arena(uintptr_t b) : base(b), off(0) {}
  template <typename U> __host__ __device__ U* take(size_t n) {
    U* p = reinterpret_cast<U*>(base + off);
    off += (n * sizeof(U) + 127) & ~size_t(127);
    return p;
  }
};

template <typename T> struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *o, *row, *bias;
  __host__ __device__ size_t carve(uintptr_t base, const Geo& g) {
    Arena a(base);
    q = a.take<T>((size_t)g.b * g.ldt);
    k = a.take<T>((size_t)g.b * g.ldt);
    v = a.take<T>((size_t)g.b * g.ldt);
    s = a.take<float>((size_t)g.b * g.lds);
    p = a.take<T>((size_t)g.b * g.ldp);
    o = a.take<float>((size_t)g.b * g.ldo);
    row = a.take<float>(g.b);
    bias = a.take<float>(g.b);
    return a.off;
  }
};

template <typename T> struct DqSmem {
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *acc, *lse, *delta, *bias;
  __host__ __device__ size_t carve(uintptr_t base, const Geo& g) {
    Arena a(base);
    q = a.take<T>((size_t)g.b * g.ldt);
    dout = a.take<T>((size_t)g.b * g.ldt);
    k = a.take<T>((size_t)g.b * g.ldt);
    v = a.take<T>((size_t)g.b * g.ldt);
    s = a.take<float>((size_t)g.b * g.lds);
    dp = a.take<float>((size_t)g.b * g.lds);
    ds = a.take<T>((size_t)g.b * g.ldp);
    acc = a.take<float>((size_t)g.b * g.ldo);
    lse = a.take<float>(g.b);
    delta = a.take<float>(g.b);
    bias = a.take<float>(g.b);
    return a.off;
  }
};

template <typename T> struct DkvSmem {
  T *k, *v, *q, *dout, *pt;
  float *st, *dpt, *dk, *dv, *lse, *delta;
  __host__ __device__ size_t carve(uintptr_t base, const Geo& g) {
    Arena a(base);
    k = a.take<T>((size_t)g.b * g.ldt);
    v = a.take<T>((size_t)g.b * g.ldt);
    q = a.take<T>((size_t)g.b * g.ldt);
    dout = a.take<T>((size_t)g.b * g.ldt);
    st = a.take<float>((size_t)g.b * g.lds);
    dpt = a.take<float>((size_t)g.b * g.lds);
    pt = a.take<T>((size_t)g.b * g.ldp);
    dk = a.take<float>((size_t)g.b * g.ldo);
    dv = a.take<float>((size_t)g.b * g.ldo);
    lse = a.take<float>(g.b);
    delta = a.take<float>(g.b);
    return a.off;
  }
};

// C[16 x N] = (acc ? C : 0) + A[16 x K] . B[K x N], one warp, operands in
// shared memory. B(k, n) is B[k * ldb + n], or B[n * ldb + k] when BT.
// N and K are multiples of 16. Ends with __syncwarp(): C is visible to
// every lane of the warp.
template <bool BT>
__device__ __forceinline__ void warp_mma(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb, int N, int K,
                                         bool acc) {
  using namespace nvcuda;
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  for (int n0 = 0; n0 < N; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc) {
      wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(c, 0.0f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      wmma::load_matrix_sync(a, A + k0, lda);
      wmma::load_matrix_sync(bf, BT ? B + (size_t)n0 * ldb + k0 : B + (size_t)k0 * ldb + n0, ldb);
      wmma::mma_sync(c, a, bf, c);
    }
    wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
  }
  __syncwarp();
}

template <bool BT>
__device__ __forceinline__ void warp_mma(float* C, int ldc, const float* A, int lda,
                                         const float* B, int ldb, int N, int K, bool acc) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int r = idx / N, c = idx - r * N;
    float s = acc ? C[r * ldc + c] : 0.f;
    const float* a = A + r * lda;
    for (int k = 0; k < K; ++k) s += a[k] * (BT ? B[c * ldb + k] : B[k * ldb + c]);
    C[r * ldc + c] = s;
  }
  __syncwarp();
}

// Rows [row0, row0 + b) of one head's [rows, d] matrix into dst [b][ldt]:
// zero past `rows` and past d; with `scaled`, each element is multiplied
// by the scale in f32 and rounded back to T.
template <typename T>
__device__ void load_rows(T* dst, const T* __restrict__ src, int row0, int rows,
                          const Geo& g, bool scaled) {
  if (g.vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = g.dp / V;
    for (int idx = threadIdx.x; idx < g.b * cpr; idx += blockDim.x) {
      const int r = idx / cpr, c = (idx - r * cpr) * V;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < rows) {
        raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * g.d + c);
        if (scaled) {
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int t = 0; t < V; ++t) e[t] = from_f<T>(to_f(e[t]) * g.scale);
        }
      }
      *reinterpret_cast<uint4*>(dst + r * g.ldt + c) = raw;
    }
  } else {
    for (int idx = threadIdx.x; idx < g.b * g.dp; idx += blockDim.x) {
      const int r = idx / g.dp, c = idx - r * g.dp;
      float x = 0.f;
      if (row0 + r < rows && c < g.d) {
        x = to_f(src[(size_t)(row0 + r) * g.d + c]);
        if (scaled) x = to_f(from_f<T>(x * g.scale));
      }
      dst[r * g.ldt + c] = from_f<T>(x);
    }
  }
}

// Per-row values [row0, row0 + b) of a [rows] f32 vector, zero past rows.
__device__ void load_vec(float* dst, const float* __restrict__ src, int row0, int rows, int b) {
  for (int idx = threadIdx.x; idx < b; idx += blockDim.x)
    dst[idx] = row0 + idx < rows ? src[row0 + idx] : 0.f;
}

// Writes this warp's 16 accumulator rows (f32, times mul[row]) as T rows
// [row0 + 16 * warp, ...) of a [rows, d] matrix, rows < `rows` only.
template <typename T>
__device__ void store_rows(T* __restrict__ dst, const float* acc, int ldo, int row0, int rows,
                           int d, const float* div) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * d; idx += 32) {
    const int r = idx / d, c = idx - r * d;
    if (row0 + r < rows) {
      const float x = acc[r * ldo + c];
      dst[(size_t)(row0 + r) * d + c] = from_f<T>(div ? x / div[r] : x);
    }
  }
}

// --------------------------------------------------------------------------
// forward: grid (q tiles, BH)
// --------------------------------------------------------------------------

template <typename T, bool DROP>
__global__ void flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ bias,
                                 T* __restrict__ o, float* __restrict__ lse, Geo g) {
  extern __shared__ __align__(128) char smem[];
  FwdSmem<T> sm;
  sm.carve(reinterpret_cast<uintptr_t>(smem), g);
  const int nq = (g.sq + g.b - 1) / g.b;
  const int nk = (g.sk + g.b - 1) / g.b;
  const int i = nq - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = g.sk - g.sq;
  const T* kb = k + (size_t)bh * g.sk * g.d;
  const T* vb = v + (size_t)bh * g.sk * g.d;
  const float* brow = bias ? bias + (size_t)(bh / g.heads) * g.sk : nullptr;

  load_rows(sm.q, q + (size_t)bh * g.sq * g.d, i * g.b, g.sq, g, true);  // q * scale (:196)
  for (int idx = threadIdx.x; idx < g.b * g.ldo; idx += blockDim.x) sm.o[idx] = 0.f;

  // lanes 2r and 2r+1 of a warp own row r of its 16; each takes every other column
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int row_g = i * g.b + r;
  const T* q_w = sm.q + warp * 16 * g.ldt;
  float* s_w = sm.s + warp * 16 * g.lds;
  T* p_w = sm.p + warp * 16 * g.ldp;
  float* o_w = sm.o + warp * 16 * g.ldo;
  float* srow = sm.s + r * g.lds;
  T* prow = sm.p + r * g.ldp;
  float m = kNegInf, l = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (g.causal && j * g.b > (i + 1) * g.b - 1 + off) break;  // wholly above the diagonal
    const bool interior =
        (!g.causal || (j + 1) * g.b - 1 <= i * g.b + off) && (j + 1) * g.b <= g.sk;
    __syncthreads();  // every warp is done with the previous k, v tiles
    if (brow && !load_bias_tile(sm.bias, brow, j * g.b, g)) continue;  // fully masked (:253)
    load_rows(sm.k, kb, j * g.b, g.sk, g, false);
    load_rows(sm.v, vb, j * g.b, g.sk, g, false);
    __syncthreads();

    warp_mma<true>(s_w, g.lds, q_w, g.ldt, sm.k, g.ldt, g.b, g.dp, false);
    float mx = kNegInf;
    for (int c = half; c < g.b; c += 2) {
      float s = srow[c];
      if (brow) {
        s += sm.bias[c];  // the bias row, before the row max (:211)
        srow[c] = s;
      }
      if (!interior) {
        const int col = j * g.b + c;
        if (col >= g.sk || (g.causal && col > row_g + off)) {
          s = kNegInf;
          srow[c] = s;
        }
      }
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = half; c < g.b; c += 2) {
      const float p = expf(srow[c] - m_new);
      // p (dropped after the softmax: l takes the undropped p, :220-226)
      // cast to v's dtype before the product (:229)
      prow[c] = from_f<T>(DROP ? dropped(flash_keep(g.drop, bh, row_g, j * g.b + c), p, g.drop)
                               : p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    if (half == 0) sm.row[r] = alpha;
    __syncwarp();
    for (int idx = lane; idx < 16 * g.dp; idx += 32) {
      const int rr = idx / g.dp, c = idx - rr * g.dp;
      o_w[rr * g.ldo + c] *= sm.row[warp * 16 + rr];
    }
    __syncwarp();
    warp_mma<false>(o_w, g.ldo, p_w, g.ldp, sm.v, g.ldt, g.dp, g.b, true);
  }
  __syncthreads();  // the zeroed accumulator is visible even if no tile was visible

  const float safe_l = l == 0.f ? 1.f : l;  // (:266)
  if (half == 0) {
    sm.row[r] = safe_l;
    if (row_g < g.sq) lse[(size_t)bh * g.sq + row_g] = m + logf(safe_l);
  }
  __syncwarp();
  store_rows(o + (size_t)bh * g.sq * g.d, o_w, g.ldo, i * g.b + warp * 16, g.sq, g.d,
             sm.row + warp * 16);
}

// --------------------------------------------------------------------------
// dQ: grid (q tiles, BH)
// --------------------------------------------------------------------------

template <typename T, bool DROP>
__global__ void flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const float* __restrict__ bias, T* __restrict__ dq, Geo g) {
  extern __shared__ __align__(128) char smem[];
  DqSmem<T> sm;
  sm.carve(reinterpret_cast<uintptr_t>(smem), g);
  const int nq = (g.sq + g.b - 1) / g.b;
  const int nk = (g.sk + g.b - 1) / g.b;
  const int i = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = g.sk - g.sq;
  const size_t qoff = (size_t)bh * g.sq * g.d;
  const T* kb = k + (size_t)bh * g.sk * g.d;
  const T* vb = v + (size_t)bh * g.sk * g.d;
  const float* brow = bias ? bias + (size_t)(bh / g.heads) * g.sk : nullptr;

  load_rows(sm.q, q + qoff, i * g.b, g.sq, g, false);
  load_rows(sm.dout, dout + qoff, i * g.b, g.sq, g, false);
  load_vec(sm.lse, lse + (size_t)bh * g.sq, i * g.b, g.sq, g.b);
  load_vec(sm.delta, delta + (size_t)bh * g.sq, i * g.b, g.sq, g.b);
  for (int idx = threadIdx.x; idx < g.b * g.ldo; idx += blockDim.x) sm.acc[idx] = 0.f;

  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int row_g = i * g.b + r;
  const T* q_w = sm.q + warp * 16 * g.ldt;
  const T* do_w = sm.dout + warp * 16 * g.ldt;
  float* s_w = sm.s + warp * 16 * g.lds;
  float* dp_w = sm.dp + warp * 16 * g.lds;
  T* ds_w = sm.ds + warp * 16 * g.ldp;
  float* acc_w = sm.acc + warp * 16 * g.ldo;
  const float* srow = sm.s + r * g.lds;
  const float* dprow = sm.dp + r * g.lds;
  T* dsrow = sm.ds + r * g.ldp;

  for (int j = 0; j < nk; ++j) {
    if (g.causal && j * g.b > (i + 1) * g.b - 1 + off) break;
    const bool interior =
        (!g.causal || (j + 1) * g.b - 1 <= i * g.b + off) && (j + 1) * g.b <= g.sk;
    __syncthreads();
    if (brow && !load_bias_tile(sm.bias, brow, j * g.b, g)) continue;  // fully masked (:402)
    load_rows(sm.k, kb, j * g.b, g.sk, g, true);  // k * scale (:357)
    load_rows(sm.v, vb, j * g.b, g.sk, g, false);
    __syncthreads();
    const float lse_r = sm.lse[r], delta_r = sm.delta[r];

    warp_mma<true>(s_w, g.lds, q_w, g.ldt, sm.k, g.ldt, g.b, g.dp, false);    // q . ks^T
    warp_mma<true>(dp_w, g.lds, do_w, g.ldt, sm.v, g.ldt, g.b, g.dp, false);  // dO . v^T
    for (int c = half; c < g.b; c += 2) {
      float p = expf((brow ? srow[c] + sm.bias[c] : srow[c]) - lse_r);  // (:367)
      if (!interior) {
        const int col = j * g.b + c;
        if (col >= g.sk || (g.causal && col > row_g + off)) p = 0.f;
      }
      float dp = dprow[c];
      if (DROP) dp = dropped(flash_keep(g.drop, bh, row_g, j * g.b + c), dp, g.drop);  // (:383)
      dsrow[c] = from_f<T>(p * (dp - delta_r));  // (:384)
    }
    __syncwarp();
    warp_mma<false>(acc_w, g.ldo, ds_w, g.ldp, sm.k, g.ldt, g.dp, g.b, true);  // += ds . ks
  }
  __syncthreads();
  store_rows(dq + qoff, acc_w, g.ldo, i * g.b + warp * 16, g.sq, g.d, nullptr);
}

// --------------------------------------------------------------------------
// dK, dV: grid (kv tiles, BH); warp w owns kv rows [16w, 16w + 16) of the tile
// --------------------------------------------------------------------------

template <typename T, bool DROP>
__global__ void flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 const float* __restrict__ bias, T* __restrict__ dk,
                                 T* __restrict__ dv, Geo g) {
  extern __shared__ __align__(128) char smem[];
  DkvSmem<T> sm;
  sm.carve(reinterpret_cast<uintptr_t>(smem), g);
  const int nq = (g.sq + g.b - 1) / g.b;
  const int j = blockIdx.x;  // low kv tiles see the most q tiles: launched first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = g.sk - g.sq;
  const size_t qoff = (size_t)bh * g.sq * g.d;
  const size_t koff = (size_t)bh * g.sk * g.d;
  const float* brow = bias ? bias + (size_t)(bh / g.heads) * g.sk : nullptr;
  // every kv row of the block masked: dK = dV = 0, nothing to loop over (:512)
  const bool live = !brow || load_bias_tile(sm.lse, brow, j * g.b, g);

  load_rows(sm.k, k + koff, j * g.b, g.sk, g, false);
  load_rows(sm.v, v + koff, j * g.b, g.sk, g, false);
  for (int idx = threadIdx.x; idx < g.b * g.ldo; idx += blockDim.x) {
    sm.dk[idx] = 0.f;
    sm.dv[idx] = 0.f;
  }

  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int kv_g = j * g.b + r;
  const float bias_r = brow ? sm.lse[r] : 0.f;  // this kv row's bias
  const T* k_w = sm.k + warp * 16 * g.ldt;
  const T* v_w = sm.v + warp * 16 * g.ldt;
  float* st_w = sm.st + warp * 16 * g.lds;
  float* dpt_w = sm.dpt + warp * 16 * g.lds;
  T* pt_w = sm.pt + warp * 16 * g.ldp;
  float* dk_w = sm.dk + warp * 16 * g.ldo;
  float* dv_w = sm.dv + warp * 16 * g.ldo;
  float* strow = sm.st + r * g.lds;
  const float* dptrow = sm.dpt + r * g.lds;
  T* ptrow = sm.pt + r * g.ldp;

  for (int i = 0; i < (live ? nq : 0); ++i) {
    if (g.causal && j * g.b > (i + 1) * g.b - 1 + off) continue;  // q tile above the band
    const bool interior =
        (!g.causal || (j + 1) * g.b - 1 <= i * g.b + off) && (i + 1) * g.b <= g.sq;
    __syncthreads();
    load_rows(sm.q, q + qoff, i * g.b, g.sq, g, true);  // q * scale (:448)
    load_rows(sm.dout, dout + qoff, i * g.b, g.sq, g, false);
    load_vec(sm.lse, lse + (size_t)bh * g.sq, i * g.b, g.sq, g.b);
    load_vec(sm.delta, delta + (size_t)bh * g.sq, i * g.b, g.sq, g.b);
    __syncthreads();

    warp_mma<true>(st_w, g.lds, k_w, g.ldt, sm.q, g.ldt, g.b, g.dp, false);  // k . qs^T
    for (int c = half; c < g.b; c += 2) {
      float p = expf((brow ? strow[c] + bias_r : strow[c]) - sm.lse[c]);  // (:458)
      if (!interior) {
        const int qr = i * g.b + c;
        if (qr >= g.sq || (g.causal && kv_g > qr + off)) p = 0.f;
      }
      strow[c] = p;
      // dV takes the dropped p (:474-476); the mask's key is (q row, kv column)
      ptrow[c] = from_f<T>(DROP ? dropped(flash_keep(g.drop, bh, i * g.b + c, kv_g), p, g.drop)
                                : p);
    }
    __syncwarp();
    warp_mma<false>(dv_w, g.ldo, pt_w, g.ldp, sm.dout, g.ldt, g.dp, g.b, true);  // += p^T dO
    warp_mma<true>(dpt_w, g.lds, v_w, g.ldt, sm.dout, g.ldt, g.b, g.dp, false);  // v . dO^T
    for (int c = half; c < g.b; c += 2) {
      float dp = dptrow[c];
      if (DROP) dp = dropped(flash_keep(g.drop, bh, i * g.b + c, kv_g), dp, g.drop);  // (:484)
      ptrow[c] = from_f<T>(strow[c] * (dp - sm.delta[c]));  // ds^T (:485)
    }
    __syncwarp();
    warp_mma<false>(dk_w, g.ldo, pt_w, g.ldp, sm.q, g.ldt, g.dp, g.b, true);  // += ds^T qs
  }
  __syncthreads();
  store_rows(dk + koff, dk_w, g.ldo, j * g.b + warp * 16, g.sk, g.d, nullptr);
  store_rows(dv + koff, dv_w, g.ldo, j * g.b + warp * 16, g.sk, g.d, nullptr);
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

template <typename T>
int make_geo(Geo* g, int bh, int sq, int sk, int d, int causal, float scale, bool aligned,
             const void* bias, int heads, Drop drop) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (drop.rows < 0 || (drop.rows > 0 && drop.cols < 1)) return (int)cudaErrorInvalidValue;
  g->drop = drop;
  if (bias && (causal || heads < 1 || bh % heads)) return (int)cudaErrorInvalidValue;
  g->bh = bh;
  g->sq = sq;
  g->sk = sk;
  g->d = d;
  g->dp = (d + 15) / 16 * 16;
  g->b = (sizeof(T) == 2 && g->dp <= 128) ? 64 : 32;
  g->ldt = g->dp + 8;
  g->lds = g->b + 4;
  g->ldp = g->b + 8;
  g->ldo = g->dp + 4;
  g->causal = causal ? 1 : 0;
  g->vec = (aligned && d % 16 == 0) ? 1 : 0;
  g->heads = heads < 1 ? 1 : heads;
  g->scale = scale;
  return 0;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
               void* lse, int bh, int sq, int sk, int d, int causal, int heads, float scale,
               Drop drop, void* stream) {
  Geo g;
  int rc = make_geo<T>(&g, bh, sq, sk, d, causal, scale,
                       aligned16(q) && aligned16(k) && aligned16(v), bias, heads, drop);
  if (rc) return rc;
  const size_t bytes = FwdSmem<T>().carve(0, g);
  auto kernel = drop.rows ? flash_fwd_kernel<T, true> : flash_fwd_kernel<T, false>;
  if ((rc = prepare(kernel, bytes))) return rc;
  kernel<<<dim3((sq + g.b - 1) / g.b, bh), (g.b / 16) * 32, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), static_cast<float*>(lse), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* bias, void* dq, int bh, int sq, int sk, int d,
              int causal, int heads, float scale, Drop drop, void* stream) {
  Geo g;
  int rc = make_geo<T>(&g, bh, sq, sk, d, causal, scale,
                       aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout), bias,
                       heads, drop);
  if (rc) return rc;
  const size_t bytes = DqSmem<T>().carve(0, g);
  auto kernel = drop.rows ? flash_dq_kernel<T, true> : flash_dq_kernel<T, false>;
  if ((rc = prepare(kernel, bytes))) return rc;
  kernel<<<dim3((sq + g.b - 1) / g.b, bh), (g.b / 16) * 32, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias), static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* bias, void* dk, void* dv, int bh, int sq, int sk,
               int d, int causal, int heads, float scale, Drop drop, void* stream) {
  Geo g;
  int rc = make_geo<T>(&g, bh, sq, sk, d, causal, scale,
                       aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout), bias,
                       heads, drop);
  if (rc) return rc;
  const size_t bytes = DkvSmem<T>().carve(0, g);
  auto kernel = drop.rows ? flash_dkv_kernel<T, true> : flash_dkv_kernel<T, false>;
  if ((rc = prepare(kernel, bytes))) return rc;
  kernel<<<dim3((sk + g.b - 1) / g.b, bh), (g.b / 16) * 32, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bias: null, or [bh / heads, sk] f32 (non-causal only). The dropout key:
// the seed pair, the keep threshold, f32(1 / (1 - p)) and the reference's
// tile (drop_rows = BQ, drop_cols = BK); drop_rows 0: no dropout.
#define DROP_KEY Drop{s0, s1, thresh, inv, drop_rows, drop_cols}
#define FLASH_API(SUFFIX, T)                                                                 \
  int flash_fwd_##SUFFIX(const void* q, const void* k, const void* v, const void* bias,      \
                         void* o, void* lse, int bh, int sq, int sk, int d, int causal,      \
                         int heads, float scale, unsigned s0, unsigned s1,                   \
                         unsigned thresh, float inv, int drop_rows, int drop_cols,           \
                         void* stream) {                                                     \
    return launch_fwd<T>(q, k, v, bias, o, lse, bh, sq, sk, d, causal, heads, scale,         \
                         DROP_KEY, stream);                                                  \
  }                                                                                          \
  int flash_dq_##SUFFIX(const void* q, const void* k, const void* v, const void* dout,       \
                        const void* lse, const void* delta, const void* bias, void* dq,      \
                        int bh, int sq, int sk, int d, int causal, int heads, float scale,   \
                        unsigned s0, unsigned s1, unsigned thresh, float inv,                \
                        int drop_rows, int drop_cols, void* stream) {                        \
    return launch_dq<T>(q, k, v, dout, lse, delta, bias, dq, bh, sq, sk, d, causal, heads,   \
                        scale, DROP_KEY, stream);                                            \
  }                                                                                          \
  int flash_dkv_##SUFFIX(const void* q, const void* k, const void* v, const void* dout,      \
                         const void* lse, const void* delta, const void* bias, void* dk,     \
                         void* dv, int bh, int sq, int sk, int d, int causal, int heads,     \
                         float scale, unsigned s0, unsigned s1, unsigned thresh, float inv,  \
                         int drop_rows, int drop_cols, void* stream) {                       \
    return launch_dkv<T>(q, k, v, dout, lse, delta, bias, dk, dv, bh, sq, sk, d, causal,     \
                         heads, scale, DROP_KEY, stream);                                    \
  }
FLASH_API(f32, float)
FLASH_API(bf16, __nv_bfloat16)

}  // extern "C"
