// Flash attention, forward and backward: causal, or not causal with an
// optional key-padding bias; with or without attention-probability
// dropout.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   _fwd_kernel :167 (launched by _fwd :272)      -> flash_fwd_wgmma_kernel
//                                                    (bf16, D 64 and 128),
//                                                    flash_fwd_kernel (else)
//   _dq_kernel  :329 (launched by _bwd :539/:580) -> flash_dq_wgmma_kernel
//                                                    (bf16, D 64 and 128),
//                                                    flash_dq_kernel (else)
//   _dkv_kernel :420 (launched by _bwd :602)      -> flash_dkv_wgmma_kernel
//                                                    (bf16, D 64 and 128),
//                                                    flash_dkv_kernel (else)
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
// cores: the forward, dQ and dK/dV at D 64 and 128 (every model path)
// through wgmma (their designs below, after the generic kernels), the
// others through nvcuda::wmma 16x16x16 bf16 fragments, f32 accumulation,
// which compile to mma.sync. The f32 variant exists for parity and uses
// scalar FMA.
//
// Design of the generic kernels (flash_fwd_kernel, dQ, dK/dV; no TPU
// artifacts: no 8-lane lse/delta rows, no d padding in
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
// The bf16 kernels at D 64 and 128 (every model path) are redesigned for
// Hopper: the forward after the generic host side below, the backward
// (a pre-pass, dQ and dK/dV) at the end of the file.

#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"  // the wgmma forward's TMA, mbarrier and wgmma primitives

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

// --------------------------------------------------------------------------
// forward, bf16 at D = 64 and 128: TMA ring, warp-specialised wgmma
// --------------------------------------------------------------------------
//
// Persistent: one block per SM (at most one per q tile of 128 rows) walks
// the list of q tiles, heaviest causal tiles first, in a snake order
// (work_item). 288 threads: warps 0-7 are two consumer warpgroups of 64 q
// rows each, warp 8 the producer. Each tile is D / 64 column blocks of
// [rows][64] bf16 in the 128-byte swizzle (a TMA box's inner extent is at
// most 128 bytes), so a wgmma descriptor steps across the blocks at D = 128.
//   - The producer loads each q tile's Q by TMA into one of two buffers
//     (the next tile's while the consumers finish this one) and keeps a
//     ring of two K/V stages full (TMA, a full and an empty mbarrier per
//     stage, expect_tx bytes). The tensor maps are 3-D [BH, S, D]: rows
//     past S arrive as zeros, never as the next head's. It decides which
//     KV tiles a q tile visits (the causal band; with a bias, a tile whose
//     entries are all <= -5e29 is skipped) and publishes each tile's index,
//     and its bias row, in the stage; index -1 ends the q tile. So the
//     consumers follow the producer and the two cannot disagree on a skip.
//   - The consumers multiply their Q rows by the scale and round them to
//     bf16 in place (fence.proxy.async, then a warpgroup barrier, before
//     the first wgmma reads them). Per KV tile: S = Q K^T by wgmma
//     m64n128k16 from shared memory into registers; the bias and the masks
//     (only on tiles that cross the causal diagonal or the ragged tail) and
//     the online softmax in registers (a row lies in one quad of lanes: two
//     shuffles per reduction; exp2 with log2(e) applied to s - m, so a row
//     that sees only masked keys gets exp(0) as the plain version does); O
//     rescaled in registers between wgmma.wait_group and wgmma.fence; P to
//     bf16 in registers as the A operand of O += P V (the accumulator
//     layout of S is wgmma's A-fragment layout) with V straight from its
//     [BK, D] row-major tile through wgmma's transpose. Dropout hashes each
//     element of p in registers, keyed by the reference's logical tile
//     (common.cuh's FlashKey: shifts when the tile's sides are powers of
//     two, as on every model path).
//   - Epilogue: O / l as bf16 into the warpgroup's Q rows in the swizzled
//     layout, then TMA stores (rows past Sq are not written); lse as f32;
//     the Q buffer goes back to the producer once the stores have read it.
// Measured on an H100 (chip_smoke.py phase 8, PERF.md): ptxas caps every
// thread of a block at the registers of a whole warpgroup (168 here,
// 65536 / 384), and raising the consumers' share with setmaxnreg did not
// lift that cap (the same spills at every split), so the loop keeps one
// S tile, P and O live (<= 168 registers, no spills) and does not
// overlap tile t's softmax with tile t-1's P V product inside a
// warpgroup; the two warpgroups overlap each other's instead (ordering
// their products in turns, ping-pong, measured 3% slower). Every mbarrier
// wait traps after ~2^35 cycles, so a broken ring ends in a launch error
// instead of a hung card.

namespace wg {

constexpr int kBQ = 128, kBK = 128, kStages = 2;
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Smem {
  __nv_bfloat16 q[2][kBQ * D];          // by q tile, alternately; also its output tile
  __nv_bfloat16 k[kStages][kBK * D];
  __nv_bfloat16 v[kStages][kBK * D];
  float bias[kStages][kBK];
  int tile[kStages];                    // the KV tile in the stage; -1: the q tile's last
  uint64_t full[kStages], empty[kStages], qfull[2], qempty[2];
};

struct Args {
  const float* bias;  // null, or [bh / heads, sk]
  float* lse;
  int bh, sq, sk, heads, causal;
  float scale;
  Drop drop;
};

// The n-th q tile of this block (its position in the heaviest-first list,
// q tiles from the last down, all heads at each), or -1 past the list. The
// blocks take the list in a snake order (round n: block b, or gridDim.x - 1
// - b when n is odd), so each block's total stays within one q tile's work
// of every other's (kernels/flash_attention.py fwd_block_items mirrors it).
__device__ __forceinline__ int work_item(int n, int total) {
  const int g = gridDim.x;
  const int pos = n * g + ((n & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
  return pos < total ? pos : -1;
}

// the products: S (m64n128k16, A and B K-major in shared memory) and
// O += P V (A = P in registers, B = V MN-major through the transpose)
// the "+f" operands d[i] .. d[i + 7] of an accumulator
#define ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What the softmax of a tile needs to know besides the tile's index.
struct Tile {
  bool bias;
  int sk, causal, off;
  int diag;  // the block's first row + off: the last column it sees
  int row0;  // this thread's first row (the second is row0 + 8)
};

// The dropout of one tile's p in place (s[4n + e] at row row0 + 8 (e / 2),
// column j * kBK + 2c + 8n + e % 2): keep ? p * inv : 0, the key on
// FlashKey's shift path (POW2) or its division path.
template <bool POW2>
__device__ __forceinline__ void drop_tile(float (&s)[kBK / 2], const FlashKey& key,
                                          const uint32_t (&word)[2], const uint32_t (&idx0)[2],
                                          int j, const Drop& d) {
  const int col0 = j * kBK + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bits = key.bits<POW2>(word[e >> 1], idx0[e >> 1], col0 + 8 * n + (e & 1));
      s[4 * n + e] = dropped(bits < d.thresh, s[4 * n + e], d);
    }
}

// Tile j's scores s (this thread's 2 rows x 32 columns) into p in place:
// the bias row (before the row max, :211), the masks on a tile that
// crosses the causal diagonal or the ragged tail, the running max m (a row
// lies in one quad of lanes: two shuffles), alpha = exp(m_old - m), the
// running sum l of the undropped p (:220-226), then the dropout.
template <bool DROP>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const float* bias, int j,
                                             const Tile& t, const FlashKey& key,
                                             const uint32_t (&word)[2],
                                             const uint32_t (&idx0)[2], const Drop& d) {
  const int col0 = j * kBK + 2 * (threadIdx.x & 3);
  if (t.bias) {
    const float* bt = bias + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float2 b2 = *reinterpret_cast<const float2*>(bt + 8 * n);
      s[4 * n] += b2.x, s[4 * n + 1] += b2.y, s[4 * n + 2] += b2.x, s[4 * n + 3] += b2.y;
    }
  }
  if ((j + 1) * kBK > t.sk || (t.causal && (j + 1) * kBK - 1 > t.diag)) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * n + (e & 1), row = t.row0 + 8 * (e >> 1);
        if (col >= t.sk || (t.causal && col > row + t.off)) s[4 * n + e] = kNegInf;
      }
  }
  float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
  }
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2((s[4 * n + e] - m[e >> 1]) * kLog2e);
      sum[e >> 1] += p;
      s[4 * n + e] = p;
    }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
  if (DROP) {
    if (key.lr >= 0) {
      drop_tile<true>(s, key, word, idx0, j, d);
    } else {
      drop_tile<false>(s, key, word, idx0, j, d);
    }
  }
}

// p cast to v's dtype before the product (:229), as wgmma's A fragments:
// the accumulator layout of S is the A-fragment layout
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = round(q * scale) . k^T from the warpgroup's Q rows and a K stage
// (issued and committed, not waited)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBK / 2], const __nv_bfloat16* qw,
                                        const __nv_bfloat16* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, desc_sw128(qw + (kk >> 2) * kBQ * 64 + (kk & 3) * 16, 16),
                  desc_sw128(k + (kk >> 2) * kBK * 64 + (kk & 3) * 16, 16), kk > 0);
  wgmma_commit();
}

// O += P . V, V's [BK, D] tile read through wgmma's transpose (issued and
// committed, not waited)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBK / 16][4],
                                         const __nv_bfloat16* v) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = desc_sw128(v + kk * 16 * 64, kBK * 128);
    if constexpr (D == 128) {
      wgmma_rs_n128(o, pa[kk], dv);
    } else {
      wgmma_rs_n64(o, pa[kk], dv);
    }
  }
  wgmma_commit();
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kStages) stage = 0, phase ^= 1;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const Args a) {
  constexpr int CB = D / 64;  // 64-column blocks of a tile
  extern __shared__ __align__(1024) char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every tile starts on such a boundary
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nq = (a.sq + kBQ - 1) / kBQ;
  const int nk = (a.sk + kBK - 1) / kBK;
  const int total = nq * a.bh;
  const int off = a.sk - a.sq;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 32);           // the producer warp's lanes
      mbar_init(&sm.empty[st], kConsumers);  // every consumer thread
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.qfull[b], 1);
      mbar_init(&sm.qempty[b], 2);  // each warpgroup's storing thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp ----
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0;; ++n) {
      const int pos = work_item(n, total);
      if (pos < 0) break;
      const int i = nq - 1 - pos / a.bh, bh = pos % a.bh;  // the longest causal rows first
      const int qb = n & 1;
      mbar_wait(&sm.qempty[qb], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&sm.qfull[qb], kBQ * D * 2);
        for (int cb = 0; cb < CB; ++cb)
          tma_load(sm.q[qb] + cb * kBQ * 64, &tq, &sm.qfull[qb], cb * 64, i * kBQ, bh);
      }
      // KV tiles [0, nvis): with the causal band, up to the last valid row's diagonal
      const int last = min((i + 1) * kBQ, a.sq) - 1 + off;
      const int nvis = !a.causal ? nk : (last < 0 ? 0 : min(nk, last / kBK + 1));
      const float* brow = a.bias ? a.bias + (size_t)(bh / a.heads) * a.sk : nullptr;
      for (int j = 0; j < nvis; ++j) {
        float b[kBK / 32];
        if (brow) {
          bool live = false;
#pragma unroll
          for (int t = 0; t < kBK / 32; ++t) {
            const int col = j * kBK + lane + 32 * t;
            b[t] = col < a.sk ? brow[col] : kNegInf;
            live |= b[t] > kSkipBelow;
          }
          if (!__any_sync(0xffffffffu, live)) continue;  // fully masked (:253)
        }
        mbar_wait(&sm.empty[stage], phase ^ 1);
        if (brow) {
#pragma unroll
          for (int t = 0; t < kBK / 32; ++t) sm.bias[stage][lane + 32 * t] = b[t];
        }
        if (lane == 0) {
          sm.tile[stage] = j;
          mbar_arrive_tx(&sm.full[stage], 2 * kBK * D * 2);
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(sm.k[stage] + cb * kBK * 64, &tk, &sm.full[stage], cb * 64, j * kBK, bh);
            tma_load(sm.v[stage] + cb * kBK * 64, &tv, &sm.full[stage], cb * 64, j * kBK, bh);
          }
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        advance(stage, phase);
      }
      mbar_wait(&sm.empty[stage], phase ^ 1);  // the q tile's end: a stage of its own
      if (lane == 0) sm.tile[stage] = -1;
      mbar_arrive(&sm.full[stage]);
      advance(stage, phase);
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wgi = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int n = 0;; ++n) {
    const int pos = work_item(n, total);
    if (pos < 0) break;
    const int i = nq - 1 - pos / a.bh, bh = pos % a.bh;
    const int qb = n & 1;
    const int row0 = i * kBQ + wgi * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    __nv_bfloat16* qw = sm.q[qb] + wgi * 64 * 64;         // the warpgroup's rows of block 0

    // q * scale, rounded to bf16, in place (:196)
    mbar_wait(&sm.qfull[qb], (n >> 1) & 1);
    for (int idx = t; idx < CB * 64 * 8; idx += 128) {
      uint4* p = reinterpret_cast<uint4*>(qw + (idx >> 9) * kBQ * 64) + (idx & 511);
      uint4 raw = *p;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * a.scale);
      *p = raw;
    }
    fence_proxy_async();
    bar_sync(1 + wgi, 128);

    FlashKey key;
    uint32_t word[2] = {0u, 0u}, idx0[2] = {0u, 0u};
    if (DROP) {
      key = FlashKey(a.drop, bh);
      key.row(row0, word[0], idx0[0]);
      key.row(row0 + 8, word[1], idx0[1]);
    }

    float o[D / 2];
#pragma unroll
    for (int u = 0; u < D / 2; ++u) o[u] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    const Tile tl{a.bias != nullptr, a.sk, a.causal, off, i * kBQ + off, row0};
    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int j = *reinterpret_cast<volatile int*>(&sm.tile[stage]);
      if (j < 0) {
        mbar_arrive(&sm.empty[stage]);
        advance(stage, phase);
        break;
      }
      float s[kBK / 2];
      wgmma_fence();
      issue_s<D>(s, qw, sm.k[stage]);
      wgmma_wait();
      fence_regs(s);
      softmax_tile<DROP>(s, m, l, alpha, sm.bias[stage], j, tl, key, word, idx0, a.drop);
      uint32_t pa[kBK / 16][4];
      pack_p(s, pa);
#pragma unroll
      for (int u = 0; u < D / 2; ++u) o[u] *= alpha[(u >> 1) & 1];
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, sm.v[stage]);
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(&sm.empty[stage]);
      advance(stage, phase);
    }

    // epilogue: l summed over the quad; O / l into this warpgroup's Q rows
    // (swizzled as the output map expects), then one TMA store per block
    // of 64 columns; the Q buffer is free once the stores have read it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] == 0.f ? 1.f : l[r];  // (:266)
    }
    char* ob = reinterpret_cast<char*>(qw);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;  // within the warpgroup's 64
        char* dst = ob + (nn >> 3) * kBQ * 128 + row * 128 + (((nn & 7) ^ (row & 7)) << 4) + 4 * c;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * nn + 2 * r] / l[r], o[4 * nn + 2 * r + 1] / l[r]);
      }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < a.sq) a.lse[(size_t)bh * a.sq + row0 + 8 * r] = m[r] + logf(l[r]);
    }
    fence_proxy_async();
    bar_sync(1 + wgi, 128);
    if (t == 0) {
      for (int cb = 0; cb < CB; ++cb)
        tma_store(&to, ob + cb * kBQ * 128, cb * 64, i * kBQ + wgi * 64, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&sm.qempty[qb]);
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the map of a [bh, rows, d] bf16 tensor, boxes of 64 columns x box_rows rows
int tensor_map(CUtensorMap* map, const void* base, int bh, int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return tensor_map_bf16(map, base, 3, dims, strides, box);
}

// one block per SM (persistent), at most one per q tile
template <int D, bool DROP>
int launch(const CUtensorMap (&maps)[4], const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(Smem<D>) + 1024;  // + the slack of the 1024-byte alignment
  auto kernel = flash_fwd_wgmma_kernel<D, DROP>;
  int rc = prepare(kernel, bytes);
  if (rc) return rc;
  int dev, sms;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const long long items = (long long)((a.sq + kBQ - 1) / kBQ) * a.bh;
  kernel<<<(unsigned)(items < sms ? items : sms), kThreads, bytes, stream>>>(maps[0], maps[1],
                                                                           maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

}  // namespace wg

// bf16, d 64 or 128, every pointer 16-byte aligned (the route rule,
// kernels/flash_attention.py fwd_route); anything else is refused
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const void* bias, void* o,
                     void* lse, int bh, int sq, int sk, int d, int causal, int heads, float scale,
                     Drop drop, void* stream) {
  Geo g;
  int rc = make_geo<__nv_bfloat16>(&g, bh, sq, sk, d, causal, scale, true, bias, heads, drop);
  if (rc) return rc;
  if ((d != 64 && d != 128) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if ((rc = wg::tensor_map(&maps[0], q, bh, sq, d, wg::kBQ)) ||
      (rc = wg::tensor_map(&maps[1], k, bh, sk, d, wg::kBK)) ||
      (rc = wg::tensor_map(&maps[2], v, bh, sk, d, wg::kBK)) ||
      (rc = wg::tensor_map(&maps[3], o, bh, sq, d, 64)))
    return rc;
  const wg::Args a{static_cast<const float*>(bias), static_cast<float*>(lse), bh, sq, sk, g.heads,
                   g.causal, scale, drop};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return drop.rows ? wg::launch<128, true>(maps, a, st) : wg::launch<128, false>(maps, a, st);
  return drop.rows ? wg::launch<64, true>(maps, a, st) : wg::launch<64, false>(maps, a, st);
}

// --------------------------------------------------------------------------
// backward, bf16 at D = 64 and 128: a pre-pass, then dQ and dK/dV on TMA
// rings and wgmma with their accumulators in registers
// --------------------------------------------------------------------------
//
// Bound: operations (dQ three products, dK/dV four, over the visible
// (q, k) pairs; at the GPT shape 0.104 and 0.139 ms at 989 TFLOP/s against
// 0.05 ms of bytes). The generic kernels ran at 40-44x that bound: wmma
// products stored to shared memory after every 16x16 tile, f32 score and
// accumulator tiles in shared memory, synchronous loads by every thread.
// Here every product is wgmma from a TMA ring, its f32 result stays in
// registers and feeds the next product as its A fragments.
//   - Pre-pass (flash_bwd_prep_kernel, one launch per backward): qs =
//     round(q * scale) and ks = round(k * scale) in bf16, the operands the
//     reference rounds (:357, :448), and delta = rowsum(dO * O) in f32
//     (:551). So the two kernels below read their scaled operands by TMA
//     and never touch them in shared memory.
//   - dQ (flash_dq_wgmma_kernel): the forward's shape. A persistent block
//     per SM walks the q tiles of 128 rows heaviest-first in the snake
//     order (wg::work_item); its producer warp loads the tile's Q and dO
//     (double-buffered across q tiles) and streams 64-row Ks and V tiles
//     through a three-stage ring, publishing each tile's index and bias row
//     (the causal band up to the last valid row's diagonal; a bias tile
//     all <= -5e29 skipped). Two consumer warpgroups of 64 q rows: S =
//     Q Ks^T and dP = dO V^T (wgmma m64n64k16, both operands K-major in
//     shared memory, the two products in flight together), P = exp(S +
//     bias - lse) in registers while dP's product runs, the masks only on
//     tiles that cross the diagonal or the ragged tail, dP dropped, dS =
//     round(P (dP - delta)) packed in registers as the A fragments of dQ
//     += dS Ks (Ks through wgmma's transpose, as the forward's V). dQ
//     leaves as bf16 through the Q buffer's swizzled rows by TMA. At D 128
//     S, dP and dQ hold 32 + 32 + 64 registers a thread: 64-key tiles keep
//     the loop under ptxas's cap of 168 at 288 threads.
//   - dK/dV (flash_dkv_wgmma_kernel): a persistent block per SM walks the
//     (kv tile of 64 rows, head) items, low kv tiles first (they see the
//     most q tiles under causal). K and V stay resident (double-buffered
//     across items); the producer streams the kv tile's causal band of
//     64-row Qs and dO tiles with their lse and delta through a three-stage
//     ring. dK and dV, [64, D] each, would take 128 registers a thread in
//     one warpgroup beside S^T and dP^T, past the cap; so the two
//     warpgroups share the kv tile's 64 rows and split the products: the
//     first computes S^T = K Qs^T, P^T = exp(S^T + bias - lse) masked,
//     hands P^T (its sign the keep bit under dropout) to the second
//     through a double-buffered exchange in shared memory, and accumulates
//     dV += round(dropped P^T) dO; the second computes dP^T = V dO^T,
//     dS^T = round(P^T (dropped dP^T - delta)) and dK += dS^T Qs. Each
//     keeps one [64, D] accumulator, the products stay two apiece. A kv
//     tile whose bias hides every row visits no q tile and writes zeros
//     (:512). dV and dK leave by TMA through the K and V buffers (each
//     warpgroup the only reader of its own).
// The dropout mask is FlashKey's hash of (q row, kv column), keyed by the
// reference's tile as in the forward; in dK/dV the fragment's rows are kv
// rows and its columns q rows. No atomics: each output tile is written by
// one block, so the backward repeats bit for bit. Every mbarrier wait
// traps after ~2^35 cycles. Three ring stages in both kernels, and the
// producer reading lse and delta before it waits for a free stage, timed
// faster than two stages or reading them after the wait; the times, the
// bounds and ptxas's registers are in PERF.md (chip_smoke.py phases 2, 8
// and 22).

namespace bw {

using wg::ex2;
using wg::kLog2e;
using wg::work_item;

constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kBQ = 128, kBK = 64;   // dQ: q rows a block, keys a ring stage
constexpr int kBKV = 64, kBQ2 = 64;  // dK/dV: kv rows a block, q rows a ring stage
constexpr int kStagesQ = 3, kStagesKV = 3;  // ring stages: dQ's KV tiles, dK/dV's q tiles

#define ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8)
      : "l"(da), "l"(db), "r"(acc));
}
#undef ACC8

// C[64, N] = A B^T over D: the warpgroup's 64 rows of A (a tile of AROWS
// rows) and N rows of B from b (in a tile of 64 rows), both K-major
// (issued and committed, not waited)
template <int D, int AROWS, int N>
__device__ __forceinline__ void issue_abt(float (&c)[N / 2], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(a + (kk >> 2) * AROWS * 64 + (kk & 3) * 16, 16);
    const uint64_t db = desc_sw128(b + (kk >> 2) * 64 * 64 + (kk & 3) * 16, 16);
    if constexpr (N == 64) {
      wgmma_ss_n64(c, da, db, kk > 0);
    } else {
      wgmma_ss_n32(c, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// C[64, D] += A B: A the bf16 fragments of a [64, 16 KS] product, B KS x
// 16 rows from b of a [64, D] tile, read through wgmma's transpose (issued
// and committed, not waited)
template <int D, int KS>
__device__ __forceinline__ void issue_ab(float (&c)[D / 2], const uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 64, 64 * 128);
    if constexpr (D == 128) {
      wg::wgmma_rs_n128(c, a[kk], db);
    } else {
      wg::wgmma_rs_n64(c, a[kk], db);
    }
  }
  wgmma_commit();
}

// a [64, N] f32 accumulator as bf16 A fragments (its layout is theirs)
template <int N>
__device__ __forceinline__ void pack_frag(const float (&s)[N / 2], uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) pa[kk][u] = pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
}

// the keep bits of dQ's [64, W] step, element 4n + e (bit 4n + e): q row
// row0 + 8 (e / 2), key col0 + 8n + e % 2; a rolled loop, so that ptxas
// keeps few of its temporaries live
template <bool POW2, int W>
__device__ __forceinline__ uint32_t keep_dq(const FlashKey& key, int row0, int col0,
                                            const Drop& d) {
  uint32_t m = 0;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    uint32_t word, idx0;
    key.row(row0 + 8 * r, word, idx0);
#pragma unroll 1
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m |= (uint32_t)(key.bits<POW2>(word, idx0, col0 + 8 * n + h) < d.thresh)
             << (4 * n + 2 * r + h);
  }
  return m;
}

// the keep bits of dK/dV's transposed tile, element 4n + e (bit 4n + e):
// kv row kv0 + 8 (e / 2), q row q0 + 8n + e % 2
template <bool POW2>
__device__ __forceinline__ uint32_t keep_dkv(const FlashKey& key, int q0, int kv0,
                                             const Drop& d) {
  uint32_t m = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word, idx0;
      key.row(q0 + 8 * n + h, word, idx0);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m |= (uint32_t)(key.bits<POW2>(word, idx0, kv0 + 8 * r) < d.thresh) << (4 * n + 2 * r + h);
    }
  return m;
}

// a warpgroup's [64, D] f32 accumulator as bf16 into 64 rows of a tile in
// the 128-byte swizzle (column blocks `rows` * 128 bytes apart), as a TMA
// store reads them
template <int D>
__device__ __forceinline__ void stage_rows(char* ob, int rows, const float (&acc)[D / 2]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      char* dst = ob + (nn >> 3) * rows * 128 + row * 128 + (((nn & 7) ^ (row & 7)) << 4) + 4 * c;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * nn + 2 * r], acc[4 * nn + 2 * r + 1]);
    }
}

template <int S> __device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == S) stage = 0, phase ^= 1;
}

struct Args {
  const float* bias;   // null, or [bh / heads, sk]
  const float* lse;    // [bh, sq]
  const float* delta;  // [bh, sq]
  int bh, sq, sk, heads, causal;
  Drop drop;
};

// ---- pre-pass: qs, ks and delta ----

// Rows of 8-element chunks: q's chunk e -> qs and, from o and dout, its
// share of delta (the chunks of a row lie in one warp: D / 8 divides 32);
// then k's chunks -> ks.
__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      __nv_bfloat16* __restrict__ qs, __nv_bfloat16* __restrict__ ks,
                                      float* __restrict__ delta, long long qrows, long long krows,
                                      int d, float scale) {
  const int cpr = d / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nqc = qrows * cpr, nkc = krows * cpr;
  // whole warps to the end of the last one: the shuffles below
  for (long long e = first; e < (nqc + 31) / 32 * 32; e += stride) {
    const bool ok = e < nqc;
    float part = 0.f;
    if (ok) {
      uint4 raw = reinterpret_cast<const uint4*>(q)[e];
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16_rn(__bfloat162float(x[u]) * scale);
      reinterpret_cast<uint4*>(qs)[e] = raw;
      const uint4 a = reinterpret_cast<const uint4*>(o)[e];
      const uint4 b = reinterpret_cast<const uint4*>(dout)[e];
      const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&a);
      const __nv_bfloat16* z = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
      for (int u = 0; u < 8; ++u) part += __bfloat162float(y[u]) * __bfloat162float(z[u]);
    }
    for (int w = cpr / 2; w > 0; w >>= 1) part += __shfl_xor_sync(0xffffffffu, part, w);
    if (ok && e % cpr == 0) delta[e / cpr] = part;
  }
  for (long long e = first; e < nkc; e += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(k)[e];
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16_rn(__bfloat162float(x[u]) * scale);
    reinterpret_cast<uint4*>(ks)[e] = raw;
  }
}

// ---- dQ ----

template <int D> struct DqSmem {
  __nv_bfloat16 q[2][kBQ * D];  // by q tile, alternately; also its dQ tile
  __nv_bfloat16 dout[2][kBQ * D];
  __nv_bfloat16 k[kStagesQ][kBK * D];  // ks
  __nv_bfloat16 v[kStagesQ][kBK * D];
  float bias[kStagesQ][kBK];
  int tile[kStagesQ];  // the KV tile in the stage; -1: the q tile's last
  uint64_t full[kStagesQ], empty[kStagesQ], qfull[2], qempty[2];
};

template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq, const Args a) {
  constexpr int CB = D / 64;
  constexpr int W = (D == 128 && DROP) ? 32 : 64;  // keys a step of the tile
  extern __shared__ __align__(1024) char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nq = (a.sq + kBQ - 1) / kBQ;
  const int nk = (a.sk + kBK - 1) / kBK;
  const int total = nq * a.bh;
  const int off = a.sk - a.sq;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStagesQ; ++st) {
      mbar_init(&sm.full[st], 32);
      mbar_init(&sm.empty[st], kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.qfull[b], 1);
      mbar_init(&sm.qempty[b], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: Q and dO per q tile, the Ks/V ring ----
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0;; ++n) {
      const int pos = work_item(n, total);
      if (pos < 0) break;
      const int i = nq - 1 - pos / a.bh, bh = pos % a.bh;
      const int qb = n & 1;
      mbar_wait(&sm.qempty[qb], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&sm.qfull[qb], 2 * kBQ * D * 2);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load(sm.q[qb] + cb * kBQ * 64, &tq, &sm.qfull[qb], cb * 64, i * kBQ, bh);
          tma_load(sm.dout[qb] + cb * kBQ * 64, &tdo, &sm.qfull[qb], cb * 64, i * kBQ, bh);
        }
      }
      const int last = min((i + 1) * kBQ, a.sq) - 1 + off;
      const int nvis = !a.causal ? nk : (last < 0 ? 0 : min(nk, last / kBK + 1));
      const float* brow = a.bias ? a.bias + (size_t)(bh / a.heads) * a.sk : nullptr;
      for (int j = 0; j < nvis; ++j) {
        float b[kBK / 32];
        if (brow) {
          bool live = false;
#pragma unroll
          for (int t = 0; t < kBK / 32; ++t) {
            const int col = j * kBK + lane + 32 * t;
            b[t] = col < a.sk ? brow[col] : kNegInf;
            live |= b[t] > kSkipBelow;
          }
          if (!__any_sync(0xffffffffu, live)) continue;  // fully masked (:402)
        }
        mbar_wait(&sm.empty[stage], phase ^ 1);
        if (brow) {
#pragma unroll
          for (int t = 0; t < kBK / 32; ++t) sm.bias[stage][lane + 32 * t] = b[t];
        }
        if (lane == 0) {
          sm.tile[stage] = j;
          mbar_arrive_tx(&sm.full[stage], 2 * kBK * D * 2);
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(sm.k[stage] + cb * kBK * 64, &tk, &sm.full[stage], cb * 64, j * kBK, bh);
            tma_load(sm.v[stage] + cb * kBK * 64, &tv, &sm.full[stage], cb * 64, j * kBK, bh);
          }
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        advance<kStagesQ>(stage, phase);
      }
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) sm.tile[stage] = -1;
      mbar_arrive(&sm.full[stage]);
      advance<kStagesQ>(stage, phase);
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each ----
  const int wgi = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int n = 0;; ++n) {
    const int pos = work_item(n, total);
    if (pos < 0) break;
    const int i = nq - 1 - pos / a.bh, bh = pos % a.bh;
    const int qb = n & 1;
    const int row0 = i * kBQ + wgi * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const __nv_bfloat16* qw = sm.q[qb] + wgi * 64 * 64;
    const __nv_bfloat16* dw = sm.dout[qb] + wgi * 64 * 64;
    const float* lse_row = a.lse + (size_t)bh * a.sq;
    const float* delta_row = a.delta + (size_t)bh * a.sq;
    mbar_wait(&sm.qfull[qb], (n >> 1) & 1);

    float acc[D / 2];
#pragma unroll
    for (int u = 0; u < D / 2; ++u) acc[u] = 0.f;
    const int diag = i * kBQ + off;  // the block's first row + off
    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int j = *reinterpret_cast<volatile int*>(&sm.tile[stage]);
      if (j < 0) {
        mbar_arrive(&sm.empty[stage]);
        advance<kStagesQ>(stage, phase);
        break;
      }
      const __nv_bfloat16* kt = sm.k[stage];
      // the tile's keys in W-column steps: one step of 64, or two of 32
      // (a rolled loop) for D 128 under dropout, where ptxas spilled the
      // mask's work beside S, dP and dQ's 128 registers
#pragma unroll 1
      for (int h = 0; h < kBK / W; ++h) {
        const int col0 = j * kBK + h * W + 2 * c;
        const __nv_bfloat16* kh = kt + h * W * 64;  // the step's first key row
        // the mask's bits before the products: with S and dP in flight
        // its temporaries would not fit the registers (the key, lse and
        // delta are remade each tile for the same reason)
        uint32_t keep = 0xffffffffu;
        if (DROP) {
          const FlashKey key(a.drop, bh);
          keep = key.lr >= 0 ? keep_dq<true, W>(key, row0, col0, a.drop)
                             : keep_dq<false, W>(key, row0, col0, a.drop);
          asm volatile("" : "+r"(keep)::"memory");  // done before the products issue
        }
        float s[W / 2], dp[W / 2], lse2[2], dl[2];  // lse * log2(e), delta
        // S = q . ks^T first, so that p's exp runs while dP = dO . v^T's
        // product does; under dropout dP first, so that the mask's bits
        // and delta are spent before p's registers fill
        wgmma_fence();
        if (DROP) issue_abt<D, kBQ, W>(dp, dw, sm.v[stage] + h * W * 64);
        issue_abt<D, kBQ, W>(s, qw, kh);
        if (!DROP) issue_abt<D, kBQ, W>(dp, dw, sm.v[stage] + h * W * 64);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = row0 + 8 * r < a.sq;
          lse2[r] = ok ? lse_row[row0 + 8 * r] * kLog2e : 0.f;
          dl[r] = ok ? delta_row[row0 + 8 * r] : 0.f;
        }
        // p = exp(S + bias - lse) in place (:367), masked only on a step
        // that crosses the causal diagonal or the ragged tail
        auto probs = [&]() {
          if (a.bias) {
            const float* bt = sm.bias[stage] + h * W + 2 * c;
#pragma unroll
            for (int nn = 0; nn < W / 8; ++nn) {
              const float2 b2 = *reinterpret_cast<const float2*>(bt + 8 * nn);
              s[4 * nn] += b2.x, s[4 * nn + 1] += b2.y, s[4 * nn + 2] += b2.x,
                  s[4 * nn + 3] += b2.y;
            }
          }
#pragma unroll
          for (int e = 0; e < W / 2; ++e) s[e] = ex2(fmaf(s[e], kLog2e, -lse2[(e >> 1) & 1]));
          const int end = j * kBK + (h + 1) * W;
          if (end > a.sk || (a.causal && end - 1 > diag)) {
#pragma unroll
            for (int nn = 0; nn < W / 8; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = col0 + 8 * nn + (e & 1), row = row0 + 8 * (e >> 1);
                if (col >= a.sk || (a.causal && col > row + off)) s[4 * nn + e] = 0.f;
              }
          }
        };
        // dP dropped (:377-383), minus delta, in place
        auto dp_delta = [&]() {
#pragma unroll
          for (int e = 0; e < W / 2; ++e)
            dp[e] = (DROP ? dropped((keep >> e) & 1, dp[e], a.drop) : dp[e]) -
                    dl[(e >> 1) & 1];
        };
        wgmma_wait<1>();
        if (DROP) {
          fence_regs(dp);
          dp_delta();
        } else {
          fence_regs(s);
          probs();
        }
        wgmma_wait<0>();
        if (DROP) {
          fence_regs(s);
          probs();
        } else {
          fence_regs(dp);
          dp_delta();
        }
#pragma unroll
        for (int e = 0; e < W / 2; ++e) s[e] *= dp[e];  // ds (:384)
        uint32_t da[W / 16][4];
        pack_frag<W>(s, da);
        wgmma_fence();
        issue_ab<D, W / 16>(acc, da, kh);  // dQ += ds . ks
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(&sm.empty[stage]);
      advance<kStagesQ>(stage, phase);
    }

    // epilogue: dQ into this warpgroup's Q rows, then TMA stores; the Q and
    // dO buffers are free once the stores have read them
    char* ob = reinterpret_cast<char*>(sm.q[qb] + wgi * 64 * 64);
    stage_rows<D>(ob, kBQ, acc);
    fence_proxy_async();
    bar_sync(1 + wgi, 128);
    if (t == 0) {
      for (int cb = 0; cb < CB; ++cb)
        tma_store(&tdq, ob + cb * kBQ * 128, cb * 64, i * kBQ + wgi * 64, bh);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(&sm.qempty[qb]);
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- dK, dV ----

template <int D> struct DkvSmem {
  __nv_bfloat16 k[2][kBKV * D];  // by kv tile, alternately; also its dV tile
  __nv_bfloat16 v[2][kBKV * D];  // also its dK tile
  __nv_bfloat16 q[kStagesKV][kBQ2 * D];  // qs
  __nv_bfloat16 dout[kStagesKV][kBQ2 * D];
  float4 p[2][kBKV * kBQ2 / 4];  // P^T from the first warpgroup to the second
  float lse[kStagesKV][kBQ2];
  float delta[kStagesKV][kBQ2];
  int tile[kStagesKV];  // the q tile in the stage; -1: the kv tile's last
  uint64_t full[kStagesKV], empty[kStagesKV], kvfull[2], kvempty[2], pfull[2], pempty[2];
};

template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv, const Args a) {
  constexpr int CB = D / 64;
  extern __shared__ __align__(1024) char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nq = (a.sq + kBQ2 - 1) / kBQ2;
  const int nkv = (a.sk + kBKV - 1) / kBKV;
  const int total = nkv * a.bh;
  const int off = a.sk - a.sq;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStagesKV; ++st) {
      mbar_init(&sm.full[st], 32);
      mbar_init(&sm.empty[st], kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.kvfull[b], 1);
      mbar_init(&sm.kvempty[b], 2);
      mbar_init(&sm.pfull[b], 128);
      mbar_init(&sm.pempty[b], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: K and V per kv tile, the Qs/dO ring ----
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0;; ++n) {
      const int pos = work_item(n, total);
      if (pos < 0) break;
      const int j = pos / a.bh, bh = pos % a.bh;  // low kv tiles (the most q tiles) first
      const int kb = n & 1;
      mbar_wait(&sm.kvempty[kb], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&sm.kvfull[kb], 2 * kBKV * D * 2);
        for (int cb = 0; cb < CB; ++cb) {
          tma_load(sm.k[kb] + cb * kBKV * 64, &tk, &sm.kvfull[kb], cb * 64, j * kBKV, bh);
          tma_load(sm.v[kb] + cb * kBKV * 64, &tv, &sm.kvfull[kb], cb * 64, j * kBKV, bh);
        }
      }
      bool live = true;  // every kv row of the tile masked: dK = dV = 0 (:512)
      if (a.bias) {
        const float* brow = a.bias + (size_t)(bh / a.heads) * a.sk;
        bool any = false;
#pragma unroll
        for (int t = 0; t < kBKV / 32; ++t) {
          const int col = j * kBKV + lane + 32 * t;
          any |= col < a.sk && brow[col] > kSkipBelow;
        }
        live = __any_sync(0xffffffffu, any);
      }
      for (int i = 0; live && i < nq; ++i) {
        // q tile above the band: no valid row sees the tile's first kv row
        if (a.causal && j * kBKV > min((i + 1) * kBQ2, a.sq) - 1 + off) continue;
        float lt[kBQ2 / 32], dt[kBQ2 / 32];  // read before the wait: their latency hides
#pragma unroll
        for (int t = 0; t < kBQ2 / 32; ++t) {
          const int row = i * kBQ2 + lane + 32 * t;
          const bool ok = row < a.sq;
          lt[t] = ok ? a.lse[(size_t)bh * a.sq + row] : 0.f;
          dt[t] = ok ? a.delta[(size_t)bh * a.sq + row] : 0.f;
        }
        mbar_wait(&sm.empty[stage], phase ^ 1);
#pragma unroll
        for (int t = 0; t < kBQ2 / 32; ++t) {
          sm.lse[stage][lane + 32 * t] = lt[t];
          sm.delta[stage][lane + 32 * t] = dt[t];
        }
        if (lane == 0) {
          sm.tile[stage] = i;
          mbar_arrive_tx(&sm.full[stage], 2 * kBQ2 * D * 2);
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(sm.q[stage] + cb * kBQ2 * 64, &tq, &sm.full[stage], cb * 64, i * kBQ2, bh);
            tma_load(sm.dout[stage] + cb * kBQ2 * 64, &tdo, &sm.full[stage], cb * 64, i * kBQ2,
                     bh);
          }
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        advance<kStagesKV>(stage, phase);
      }
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) sm.tile[stage] = -1;
      mbar_arrive(&sm.full[stage]);
      advance<kStagesKV>(stage, phase);
    }
    return;
  }

  // ---- consumer warpgroups: both on the kv tile's 64 rows ----
  const int wgi = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  uint32_t pn = 0;  // P^T tiles exchanged so far
  for (int n = 0;; ++n) {
    const int pos = work_item(n, total);
    if (pos < 0) break;
    const int j = pos / a.bh, bh = pos % a.bh;
    const int kb = n & 1;
    const int kv0 = j * kBKV + warp * 16 + g;  // this thread's kv rows: kv0, kv0 + 8
    float acc[D / 2];  // dV in the first warpgroup, dK in the second
#pragma unroll
    for (int u = 0; u < D / 2; ++u) acc[u] = 0.f;
    mbar_wait(&sm.kvfull[kb], (n >> 1) & 1);

    if (wgi == 0) {
      // S^T, P^T, dV
      float b2[2] = {0.f, 0.f};  // this thread's kv rows' bias (:458)
      if (a.bias) {
        const float* brow = a.bias + (size_t)(bh / a.heads) * a.sk;
#pragma unroll
        for (int r = 0; r < 2; ++r) b2[r] = kv0 + 8 * r < a.sk ? brow[kv0 + 8 * r] : kNegInf;
      }
      for (;;) {
        mbar_wait(&sm.full[stage], phase);
        const int i = *reinterpret_cast<volatile int*>(&sm.tile[stage]);
        if (i < 0) {
          mbar_arrive(&sm.empty[stage]);
          advance<kStagesKV>(stage, phase);
          break;
        }
        float s[32];
        wgmma_fence();
        issue_abt<D, kBKV, kBQ2>(s, sm.k[kb], sm.q[stage]);  // S^T = k . qs^T
        const int q0 = i * kBQ2 + 2 * c;
        uint32_t keep = 0xffffffffu;  // the mask's bits, while the product runs
        if (DROP) {
          const FlashKey key(a.drop, bh);  // remade each tile: registers are short
          keep = key.lr >= 0 ? keep_dkv<true>(key, q0, kv0, a.drop)
                             : keep_dkv<false>(key, q0, kv0, a.drop);
        }
        wgmma_wait<0>();
        fence_regs(s);
        const float* ls = sm.lse[stage] + 2 * c;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nn);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nn + e] = ex2((s[4 * nn + e] + b2[e >> 1] - ((e & 1) ? l2.y : l2.x)) * kLog2e);
        }
        const bool masked = (a.causal && (j + 1) * kBKV - 1 > i * kBQ2 + off) ||
                            (i + 1) * kBQ2 > a.sq || (j + 1) * kBKV > a.sk;
        if (masked) {
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = q0 + 8 * nn + (e & 1), kr = kv0 + 8 * (e >> 1);
              if (qr >= a.sq || kr >= a.sk || (a.causal && kr > qr + off)) s[4 * nn + e] = 0.f;
            }
        }
        // P^T to the second warpgroup: the keep bit in the sign
        const int pb = pn & 1;
        mbar_wait(&sm.pempty[pb], ((pn >> 1) & 1) ^ 1);
        float4* pw = sm.p[pb] + t;
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = s[4 * q4 + e];
            x[e] = (DROP && !((keep >> (4 * q4 + e)) & 1)) ? -p : p;
          }
          pw[q4 * 128] = make_float4(x[0], x[1], x[2], x[3]);
        }
        mbar_arrive(&sm.pfull[pb]);
        ++pn;
        if (DROP) {  // dV takes the dropped p (:474-476)
#pragma unroll
          for (int e = 0; e < 32; ++e) s[e] = dropped((keep >> e) & 1, s[e], a.drop);
        }
        uint32_t pa[4][4];
        pack_frag<kBQ2>(s, pa);
        wgmma_fence();
        issue_ab<D, 4>(acc, pa, sm.dout[stage]);  // dV += p^T . dO
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&sm.empty[stage]);
        advance<kStagesKV>(stage, phase);
      }
    } else {
      // dP^T, dS^T, dK
      for (;;) {
        mbar_wait(&sm.full[stage], phase);
        const int i = *reinterpret_cast<volatile int*>(&sm.tile[stage]);
        if (i < 0) {
          mbar_arrive(&sm.empty[stage]);
          advance<kStagesKV>(stage, phase);
          break;
        }
        float dp[32];
        wgmma_fence();
        issue_abt<D, kBKV, kBQ2>(dp, sm.v[kb], sm.dout[stage]);  // dP^T = v . dO^T
        wgmma_wait<0>();
        fence_regs(dp);
        const int pb = pn & 1;
        mbar_wait(&sm.pfull[pb], (pn >> 1) & 1);
        const float4* pr = sm.p[pb] + t;
        const float* dls = sm.delta[stage] + 2 * c;
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) {
          const float4 x4 = pr[q4 * 128];
          const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * q4);
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = dp[4 * q4 + e];
            if (DROP) v = dropped(!signbit(x[e]), v, a.drop);  // (:484)
            dp[4 * q4 + e] = fabsf(x[e]) * (v - ((e & 1) ? d2.y : d2.x));  // (:485)
          }
        }
        mbar_arrive(&sm.pempty[pb]);
        ++pn;
        uint32_t da[4][4];
        pack_frag<kBQ2>(dp, da);
        wgmma_fence();
        issue_ab<D, 4>(acc, da, sm.q[stage]);  // dK += ds^T . qs
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&sm.empty[stage]);
        advance<kStagesKV>(stage, phase);
      }
    }

    // epilogue: dV through the K buffer (the first warpgroup its only
    // reader), dK through the V buffer (the second's); the buffers are
    // free once both stores have read them
    char* ob = reinterpret_cast<char*>(wgi == 0 ? sm.k[kb] : sm.v[kb]);
    stage_rows<D>(ob, kBKV, acc);
    fence_proxy_async();
    bar_sync(1 + wgi, 128);
    if (t == 0) {
      for (int cb = 0; cb < CB; ++cb)
        tma_store(wgi == 0 ? &tdv : &tdk, ob + cb * kBKV * 128, cb * 64, j * kBKV, bh);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(&sm.kvempty[kb]);
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- host side ----

int sms() {
  int dev, n;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <typename Kernel, typename... Maps>
int launch(Kernel kernel, size_t bytes, long long items, cudaStream_t stream, const Args& a,
           const Maps&... maps) {
  int rc = prepare(kernel, bytes);
  if (rc) return rc;
  const int n = sms();
  if (!n) return (int)cudaErrorInvalidDevice;
  kernel<<<(unsigned)(items < n ? items : n), kThreads, bytes, stream>>>(maps..., a);
  return (int)cudaGetLastError();
}

}  // namespace bw

// the pre-pass: qs, ks (bf16) and delta (f32)
int launch_bwd_prep(const void* q, const void* k, const void* o, const void* dout, void* qs,
                    void* ks, void* delta, int bh, int sq, int sk, int d, float scale,
                    void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (d != 64 && d != 128) || !delta)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {q, k, o, dout, qs, ks};
  for (const void* p : ptrs)
    if (!p || !aligned16(p)) return (int)cudaErrorInvalidValue;
  const int n = bw::sms();
  if (!n) return (int)cudaErrorInvalidDevice;
  const long long chunks = (long long)bh * (sq > sk ? sq : sk) * (d / 8);
  long long blocks = (chunks + 255) / 256;
  if (blocks > 8LL * n) blocks = 8LL * n;
  bw::flash_bwd_prep_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(qs), static_cast<__nv_bfloat16*>(ks),
      static_cast<float*>(delta), (long long)bh * sq, (long long)bh * sk, d, scale);
  return (int)cudaGetLastError();
}

// dQ from ks = round(k * scale) (the pre-pass's): bf16, d 64 or 128,
// 16-byte aligned pointers (kernels/flash_attention.py bwd_route)
int launch_dq_wgmma(const void* q, const void* ks, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* bias, void* dq, int bh,
                    int sq, int sk, int d, int causal, int heads, float scale, Drop drop,
                    void* stream) {
  Geo g;
  int rc = make_geo<__nv_bfloat16>(&g, bh, sq, sk, d, causal, scale, true, bias, heads, drop);
  if (rc) return rc;
  if ((d != 64 && d != 128) || !aligned16(q) || !aligned16(ks) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[5];
  if ((rc = wg::tensor_map(&m[0], q, bh, sq, d, bw::kBQ)) ||
      (rc = wg::tensor_map(&m[1], ks, bh, sk, d, bw::kBK)) ||
      (rc = wg::tensor_map(&m[2], v, bh, sk, d, bw::kBK)) ||
      (rc = wg::tensor_map(&m[3], dout, bh, sq, d, bw::kBQ)) ||
      (rc = wg::tensor_map(&m[4], dq, bh, sq, d, 64)))
    return rc;
  const bw::Args a{static_cast<const float*>(bias), static_cast<const float*>(lse),
                   static_cast<const float*>(delta), bh, sq, sk, g.heads, g.causal, drop};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = (long long)((sq + bw::kBQ - 1) / bw::kBQ) * bh;
#define DQ_LAUNCH(D, DR)                                                                    \
  bw::launch(bw::flash_dq_wgmma_kernel<D, DR>, sizeof(bw::DqSmem<D>) + 1024, items, st, a, \
             m[0], m[1], m[2], m[3], m[4])
  if (d == 128) return drop.rows ? DQ_LAUNCH(128, true) : DQ_LAUNCH(128, false);
  return drop.rows ? DQ_LAUNCH(64, true) : DQ_LAUNCH(64, false);
#undef DQ_LAUNCH
}

// dK, dV from qs = round(q * scale) (the pre-pass's); the rule of
// launch_dq_wgmma
int launch_dkv_wgmma(const void* qs, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* bias, void* dk, void* dv,
                     int bh, int sq, int sk, int d, int causal, int heads, float scale, Drop drop,
                     void* stream) {
  Geo g;
  int rc = make_geo<__nv_bfloat16>(&g, bh, sq, sk, d, causal, scale, true, bias, heads, drop);
  if (rc) return rc;
  if ((d != 64 && d != 128) || !aligned16(qs) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[6];
  if ((rc = wg::tensor_map(&m[0], qs, bh, sq, d, bw::kBQ2)) ||
      (rc = wg::tensor_map(&m[1], k, bh, sk, d, bw::kBKV)) ||
      (rc = wg::tensor_map(&m[2], v, bh, sk, d, bw::kBKV)) ||
      (rc = wg::tensor_map(&m[3], dout, bh, sq, d, bw::kBQ2)) ||
      (rc = wg::tensor_map(&m[4], dk, bh, sk, d, bw::kBKV)) ||
      (rc = wg::tensor_map(&m[5], dv, bh, sk, d, bw::kBKV)))
    return rc;
  const bw::Args a{static_cast<const float*>(bias), static_cast<const float*>(lse),
                   static_cast<const float*>(delta), bh, sq, sk, g.heads, g.causal, drop};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = (long long)((sk + bw::kBKV - 1) / bw::kBKV) * bh;
#define DKV_LAUNCH(D, DR)                                                                     \
  bw::launch(bw::flash_dkv_wgmma_kernel<D, DR>, sizeof(bw::DkvSmem<D>) + 1024, items, st, a, \
             m[0], m[1], m[2], m[3], m[4], m[5])
  if (d == 128) return drop.rows ? DKV_LAUNCH(128, true) : DKV_LAUNCH(128, false);
  return drop.rows ? DKV_LAUNCH(64, true) : DKV_LAUNCH(64, false);
#undef DKV_LAUNCH
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

// the forward of the wgmma kernel: bf16, d 64 or 128, 16-byte aligned
// pointers; the arguments of flash_fwd_bf16
int flash_fwd_wgmma_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                         void* lse, int bh, int sq, int sk, int d, int causal, int heads,
                         float scale, unsigned s0, unsigned s1, unsigned thresh, float inv,
                         int drop_rows, int drop_cols, void* stream) {
  return launch_fwd_wgmma(q, k, v, bias, o, lse, bh, sq, sk, d, causal, heads, scale, DROP_KEY,
                          stream);
}

// the backward's wgmma route (bf16, d 64 or 128, 16-byte aligned
// pointers): the pre-pass, then dQ from ks and dK/dV from qs with the
// arguments of flash_dq_bf16 / flash_dkv_bf16 (k, respectively q, the
// scaled copy)
int flash_bwd_prep_bf16(const void* q, const void* k, const void* o, const void* dout, void* qs,
                        void* ks, void* delta, int bh, int sq, int sk, int d, float scale,
                        void* stream) {
  return launch_bwd_prep(q, k, o, dout, qs, ks, delta, bh, sq, sk, d, scale, stream);
}
int flash_dq_wgmma_bf16(const void* q, const void* ks, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* bias, void* dq, int bh,
                        int sq, int sk, int d, int causal, int heads, float scale, unsigned s0,
                        unsigned s1, unsigned thresh, float inv, int drop_rows, int drop_cols,
                        void* stream) {
  return launch_dq_wgmma(q, ks, v, dout, lse, delta, bias, dq, bh, sq, sk, d, causal, heads,
                         scale, DROP_KEY, stream);
}
int flash_dkv_wgmma_bf16(const void* qs, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* bias, void* dk, void* dv,
                         int bh, int sq, int sk, int d, int causal, int heads, float scale,
                         unsigned s0, unsigned s1, unsigned thresh, float inv, int drop_rows,
                         int drop_cols, void* stream) {
  return launch_dkv_wgmma(qs, k, v, dout, lse, delta, bias, dk, dv, bh, sq, sk, d, causal, heads,
                          scale, DROP_KEY, stream);
}

}  // extern "C"
