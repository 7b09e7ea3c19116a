// Fused transformer MLPs, forward and backward, on one tiled GEMM core:
// the GeLU MLP y = gelu(x . W1 + b1) . W2 + b2 (GPT, BERT) and the SwiGLU
// MLP y = (silu(x . Wg) * (x . Wu)) . Wd (LLaMA, no biases).
//
// Replaces the TPU kernels of paddle_tpu/kernels/mlp_fusion.py:
//   _mlp_fwd_kernel    :228 (launched by _mlp_fwd :374) -> fused_mlp_fwd_*; in bf16
//                             with H and F multiples of 8, fused_mlp_fwd_wgmma_bf16
//   _mlp_dx_kernel     :260 (launched by _mlp_dx :394)  -> fused_mlp_bwd_* (dX part); in
//                             bf16 with H and F multiples of 8, fused_mlp_bwd_wgmma_bf16
//   _mlp_dw_kernel     :296 (launched by _mlp_dw :415)  -> the same calls (dW part)
// all entered through fused_mlp_2d :472 (the custom_vjp of :443-469), and
//   _swiglu_fwd_kernel :522 -> fused_swiglu_fwd_*; in bf16 with H and F
//                             multiples of 8, fused_swiglu_fwd_wgmma_bf16
//   _swiglu_dx_kernel  :543 -> fused_swiglu_bwd_* (dX part); in bf16 with H
//                             and F multiples of 8, fused_swiglu_bwd_wgmma_bf16
//   _swiglu_dw_kernel  :572 -> the same calls (dW part)
// entered through fused_swiglu_2d :674 (the custom_vjp of :611-671).
// x [R, H], W1/Wg/Wu [H, F], W2/Wd [F, H] and g [R, H] contiguous,
// float32 or bfloat16 (one dtype); b1 [F] and b2 [H] come in as f32.
//
// GeLU MLP:
//   forward: a = x . W1 (f32 accumulation) + b1 (f32); act = round(gelu(a));
//            y = round(act . W2 (f32) + b2)                          (:243-257)
//   dX:      dact = g . W2^T (f32); da = dact * gelu'(a) (f32);
//            dX = round(round(da) . W1^T (f32))                       (:275-293)
//   dW:      dW1 = x^T . da, db1 = sum_r da, dW2 = act^T . g, db2 = sum_r g,
//            all f32 in the reference (:318-353); dW1/dW2 rounded to the
//            weights' dtype at the end, db1/db2 kept f32 (the caller casts).
// gelu is the tanh form (approximate, GPT) or the erf form (BERT), with the
// reference's constants (:66-69).
// GeLU MLP with dropout (dropout_p > 0: the DROP instantiations, chosen at
// launch; the dropout-free instantiations read no key):
//   forward: y = round(drop(act . W2 + b2)), the mask applied to the f32 sum
//            before the rounding (:250-257);
//   dX, dW:  gm = drop(g) in f32 (:275-279, :318-323); dact = round(gm) .
//            W2^T, dW2 = act^T . gm, db2 = sum_r gm (:336-345).
// drop(x) = keep ? x * f32(1 / (1 - p)) : 0 (__fmul_rn), common.cuh's
// keep-mask keyed (row / block_r, 0, 0) at the index (row % block_r) * H +
// c, block_r being the reference's row tile (mlp_blocks :118, its tuning
// table's entries included), whatever tile a block here owns; the
// backward regenerates it from the seed pair, no mask is stored. The key
// is a kernel parameter of its own (held inside the argument struct it
// slowed a dropout-free kernel in proj_ln.cu).
// SwiGLU MLP (silu(a) = a * sigmoid(a), silu'(a) = s (1 + a (1 - s)),
// s = sigmoid(a); :90-96):
//   forward: ag = x . Wg, au = x . Wu (f32); act = round(silu(ag) * au);
//            y = round(act . Wd (f32))                               (:531-540)
//   dX:      dact = g . Wd^T (f32); dag = dact * au * silu'(ag);
//            dau = dact * silu(ag); dX = round(round(dag) . Wg^T +
//            round(dau) . Wu^T) (f32 accumulation)                   (:552-569)
//   dW:      dWg = x^T . dag, dWu = x^T . dau, dWd = (silu(ag) * au)^T . g,
//            all f32 in the reference (:584-607), rounded to the weights'
//            dtype at the end.
// Each backward computes dX and dW in one call (the flash backward groups
// its parts the same way). round() is the rounding to the input dtype.
//
// Bound: operations. At GPT-3 1.3B training shapes (R = B*S = 8192, H =
// 2048, F = 8192, bf16; RHF = 1.374e11) the GeLU forward needs 4 RHF =
// 0.550 TFLOP, 0.556 ms at 989 TFLOP/s, against 0.05 ms to move x, W1, W2
// and y once at 3.35 TB/s; dX needs 6 RHF (0.834 ms), dW 8 RHF (1.112 ms),
// one backward call that computes both 10 RHF (1.390 ms; 0.393 ms at
// BERT-base's R = 16384, H = 768, F = 3072).
// At LLaMA-7B training shapes (R = 2048, H = 4096, F = 11008, bf16; RHF =
// 9.23e10) the SwiGLU forward needs 6 RHF = 0.554 TFLOP (0.560 ms), the
// backward 16 RHF (1.494 ms), against 0.09 ms to move the operands once.
// Dropout adds the hash's ~12 integer operations per element of y (forward)
// and of g (backward): 0.2 GOP at GPT-3 1.3B shapes, 0.003 ms at 67 T/s,
// and the backward's pass over g writes gm once more (32 MB, ~0.01 ms).
//
// Design. The TPU keeps a [block_r, H] f32 accumulator (dX, forward) or
// [H, block_f] + [block_f, H] accumulators (dW) in VMEM across a sequential
// ffn (or row) axis: at H = 2048 that is 512 KB to 1 MB, two to four times
// an SM's shared memory. Here the ffn dim is walked in chunks of Fc columns
// (the caller's chunk, 2048 on the main paths; the last chunk may be
// ragged, as 11008 = 5 * 2048 + 768), and every product is one launch of
// one tiled GEMM kernel with a fused epilogue:
//   GeLU forward, per chunk:  (1) act_c = round(gelu(x . W1[:, c] + b1[c]))
//                             (2) acc (+)= act_c . W2[c, :]; last chunk writes
//                                 y = round(acc + b2)
//   GeLU backward, per chunk: (1) a_c = x . W1[:, c] + b1[c]               (f32)
//                        (2) dact = g . W2[c, :]^T; da_c = round(dact * gelu'(a_c)),
//                            act_c = round(gelu(a_c)), and each row block's
//                            column sums of da (f32) into the partials
//                        (3) dX: acc (+)= da_c . W1[:, c]^T; last writes round(acc)
//                        (4) dW1[:, c] = x^T . da_c   (5) dW2[c, :] = act_c^T . g
//                        once per call, before the chunks: each row block's
//                        column sums of g into the partials; after them: db1
//                        and db2 = the partials summed over the row blocks.
//                        With dropout that pass also writes gm = round(drop(g))
//                        into an [R, H] workspace in the dtype and sums the
//                        unrounded f32 drop(g) (db2's partials); (2) and (5)
//                        then read gm in place of g.
//   SwiGLU forward, per chunk: (1) ag_c = x . Wg[:, c]                    (f32)
//                        (2) act_c = round(silu(ag_c) * (x . Wu[:, c]))
//                        (3) acc (+)= act_c . Wd[c, :]; last writes round(acc)
//   SwiGLU backward, per chunk: (1) ag_c = x . Wg[:, c]  (2) au_c = x . Wu[:, c]
//                        (3) dact = g . Wd[c, :]^T; dag_c = round(dact * au_c *
//                            silu'(ag_c)), dau_c = round(dact * silu(ag_c)),
//                            act_c = round(silu(ag_c) * au_c)
//                        (4) dX: acc (+)= dag_c . Wg[:, c]^T
//                        (5) dX: acc += dau_c . Wu[:, c]^T; last writes round(acc)
//                        (6) dWg[:, c] = x^T . dag_c  (7) dWu[:, c] = x^T . dau_c
//                        (8) dWd[c, :] = act_c^T . g
// No atomics: every sum runs in a fixed order (db1 and db2 through
// common.cuh's sum_parts, one way: the row blocks in order), so each
// backward gives the same bits on every run.
// The [R, F] activation never exists whole: only one [R, Fc] chunk of it
// (and of a and da, or ag, au, dag and dau, in the backward) lives in
// device memory at a time.
// Workspace (allocated by the caller). GeLU: forward act_c [R, Fc] in the
// dtype plus the f32 accumulator [R, H] when F > Fc; backward a_c [R, Fc]
// f32, da_c and act_c [R, Fc] in the dtype, the f32 [R, H] dX accumulator
// when F > Fc, and the f32 column-sum partials [ceil(R / BM), F + H]. At R
// = 8192, H = 2048, Fc = 2048, bf16: 32 + 64 = 96 MB forward, 64 + 32 + 32
// + 64 + 2.6 = 194.6 MB backward; with dropout the backward adds gm [R, H]
// in the dtype (32 MB there; 25 MB at BERT-base's R = 16384, H = 768).
// The backward's wgmma route keeps a in registers: da_c and act_c [R, Fc]
// in the dtype, the f32 dX accumulator when F > Fc and the partials, 64 +
// 64 + 64 + 2.6 = 194.6 MB at its chunk Fc = 4096 there (and gm with
// dropout).
// SwiGLU: forward ag_c [R, Fc] f32, act_c
// [R, Fc] in the dtype and the f32 [R, H] accumulator when F > Fc;
// backward ag_c and au_c [R, Fc] f32, dag_c, dau_c and act_c [R, Fc] in
// the dtype and the f32 [R, H] dX accumulator (always: dX sums two products
// per chunk). At R = 2048, H = 4096, Fc = 2048, bf16: 16.8 + 8.4 + 33.6 =
// 58.7 MB forward, 33.6 + 25.2 + 33.6 = 92.3 MB backward; the backward's
// wgmma route keeps ag and au in registers: 25.2 + 33.6 = 58.7 MB.
// Recompute: each backward repeats its forward's first products once, as
// the TPU kernels do (their dX and dW kernels each recompute them): GeLU
// 10 RHF in all where the TPU's two kernels do 12, SwiGLU 16 RHF where
// they do 22.
//
// GEMM (the main loop of common.cuh, shared with proj_ln.cu): a 3-stage
// cp.async ring of operand tiles in shared memory (16-byte
// copies, zero-filled past the matrix edge: any R, H, F, no padding in
// device memory; a scalar path when a stride is not a multiple of 16
// bytes). Operands are read in their own layout (row- or column-major
// tiles), so no transpose is ever written. bf16: block tile 128 x 128 x
// 64, 8 warps of 64 x 32, fragments loaded with ldmatrix (.trans for the
// transposed layouts) into mma.sync m16n8k16 with f32 accumulators in
// registers (the chunk and this tile were chosen on an H100, PERF.md).
// Precision of the dW products: the bf16 kernels feed round(da) and
// round(act) (GeLU), round(dag), round(dau) and round(act) (SwiGLU) to the
// bf16 tensor cores, where the reference multiplies them in f32; x and g
// are bf16 already, so that is the only rounding they add; with dropout
// dW2 takes round(gm) where the reference takes the f32 gm (in float32 the
// two are one; in bf16 chip_smoke.py holds it to the dropout-free kernels'
// tolerance). float32: scalar
// FMA, 8 x 8 outputs per thread, every product in full f32 (for the
// parity runs; round() is then the identity, so dag, dau and act stay
// f32), block tile 128 x 128 x 32. The accumulator tile goes through
// shared memory as f32 for the epilogue.
//
// CUDA launches per call, nc = ceil(F / Fc) chunks: GeLU forward 2 nc on
// either route, backward 5 nc + 2 on this generic route and 4 nc + 2 on
// the wgmma route (below), with or without dropout; SwiGLU forward 3 nc on
// this generic route and 2 nc on the wgmma route, backward 8 nc and 4 nc.
// Each of the four in bf16 (H and F multiples of 8, 16-byte aligned
// tensors) takes a second route on the TMA + wgmma GEMM core of
// gemm_core.cuh: the backwards ge::launch and sw::launch, the forwards
// fw::gelu_launch and fw::swiglu_launch (their designs after the generic
// kernels); this mma.sync core keeps f32, the other widths and unaligned
// views.

#include <algorithm>

#include "common.cuh"
#include "gemm_core.cuh"  // the wgmma routes

namespace {

// the generic route's bf16 and f32 block tiles (the f32 FMA path takes 256
// threads of 8 x 8 outputs): every f32 call, and bf16 where H or F is not
// a multiple of 8 or a tensor is unaligned (the wgmma routes take the
// rest)
template <typename T> struct Cfg;
template <> struct Cfg<float> : TileCfg<128, 128, 32, 3, 32, 64> {};
template <> struct Cfg<__nv_bfloat16> : TileCfg<128, 128, 64, 3, 64, 32> {};
// the caller sizes the column-sum partials by one row-block height
constexpr int kRowBlock = 128;
static_assert(Cfg<float>::BM == kRowBlock && Cfg<__nv_bfloat16>::BM == kRowBlock,
              "one row-block height for both dtypes");

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluCoef = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

enum Epi { EPI_GELU, EPI_ACC, EPI_PRE, EPI_DGELU, EPI_STORE, EPI_SWIGLU, EPI_DSWIGLU };

__device__ __forceinline__ float gelu(float a, int approximate) {
  if (approximate) {
    const float u = kSqrt2OverPi * (a + kGeluCoef * a * a * a);
    return 0.5f * a * (1.f + tanhf(u));
  }
  return 0.5f * a * (1.f + erff(a * kInvSqrt2));
}

__device__ __forceinline__ float dgelu(float a, int approximate) {
  if (approximate) {
    const float u = kSqrt2OverPi * (a + kGeluCoef * a * a * a);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * kGeluCoef * a * a);
    return 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * du;
  }
  const float cdf = 0.5f * (1.f + erff(a * kInvSqrt2));
  const float pdf = expf(-0.5f * a * a) * kInvSqrt2Pi;
  return cdf + a * pdf;
}

// gelu(a) and gelu'(a) in one pass, the shared terms once (the formulas
// of gelu and dgelu above, operation for operation)
__device__ __forceinline__ void gelu_and_grad(float a, int approximate, float& g, float& dg) {
  if (approximate) {
    const float u = kSqrt2OverPi * (a + kGeluCoef * a * a * a);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * kGeluCoef * a * a);
    g = 0.5f * a * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * du;
  } else {
    const float e = erff(a * kInvSqrt2);
    const float pdf = expf(-0.5f * a * a) * kInvSqrt2Pi;
    g = 0.5f * a * (1.f + e);
    dg = 0.5f * (1.f + e) + a * pdf;
  }
}

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

// One GEMM: the operands (the fields of common.cuh's Operands, the main
// loop's P) and its epilogue. Epilogue operands:
//   EPI_GELU:  out = round(gelu(C + bias))
//   EPI_ACC:   buf = (first ? 0 : buf) + C; on the last call out =
//              round(buf + bias) (bias may be null; DROP: round(drop(buf +
//              bias)), the GeLU forward's last chunk) and buf is not written
//   EPI_PRE:   buf = C + bias (f32; bias may be null)
//   EPI_DGELU: da = C * gelu'(aux); out = round(da); out2 = round(gelu(aux));
//              colsum[by * ldcol + n] = sum of da over the block's rows, by
//              the block's row index
//   EPI_STORE: out = round(C)
//   EPI_SWIGLU:  out = round(silu(aux) * C)
//   EPI_DSWIGLU: with ag = aux, au = aux2: out = round(C * au * silu'(ag)),
//                out2 = round(C * silu(ag)), out3 = round(silu(ag) * au)
template <typename T> struct Gemm {
  const T* a;
  const T* b;
  size_t lda, ldb;
  int m, n, k;
  const float* bias;
  const float* aux;
  const float* aux2;
  float* buf;
  T* out;
  T* out2;
  T* out3;
  float* colsum;
  size_t ldaux, ldbuf, ldo, ldcol;
  int first, last, approximate, vec;
};

template <typename T, bool ACOL, bool BCOL> constexpr size_t smem_bytes() {
  const size_t ring = ring_bytes<T, Cfg<T>, ACOL, BCOL>();
  const size_t epi = (size_t)Cfg<T>::BM * Cfg<T>::LDS * sizeof(float);
  return ring > epi ? ring : epi;
}

// grid (ceil(n / BN), ceil(m / BM)); drop is read only by DROP (EPI_ACC)
template <typename T, bool ACOL, bool BCOL, int EPI, bool DROP>
__global__ void __launch_bounds__(Cfg<T>::THREADS) mlp_gemm_kernel(Gemm<T> p, Drop drop) {
  static_assert(!DROP || EPI == EPI_ACC, "dropout only in the forward's last chunk");
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN, LDS = Cfg<T>::LDS;
  extern __shared__ __align__(128) char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  mainloop<T, Cfg<T>, ACOL, BCOL>(p, smem, S, LDS, BN, m0, n0);

  for (int idx = threadIdx.x; idx < BM * BN; idx += Cfg<T>::THREADS) {
    const int r = idx / BN, c = idx - r * BN;
    const int gm = m0 + r, gn = n0 + c;
    const bool in = gm < p.m && gn < p.n;
    const float v = S[r * LDS + c];
    if (EPI == EPI_GELU) {
      if (in) p.out[(size_t)gm * p.ldo + gn] = from_f<T>(gelu(v + p.bias[gn], p.approximate));
    } else if (EPI == EPI_ACC) {
      if (in) {
        const size_t o = (size_t)gm * p.ldbuf + gn;
        const float s = p.first ? v : p.buf[o] + v;
        if (p.last) {
          float o = p.bias ? s + p.bias[gn] : s;
          if (DROP) o = dropped(row_keep(drop, row_key(drop, gm), gn), o, drop);
          p.out[(size_t)gm * p.ldo + gn] = from_f<T>(o);
        } else {
          p.buf[o] = s;
        }
      }
    } else if (EPI == EPI_PRE) {
      if (in) p.buf[(size_t)gm * p.ldbuf + gn] = p.bias ? v + p.bias[gn] : v;
    } else if (EPI == EPI_DGELU) {
      float da = 0.f;
      if (in) {
        const float a = p.aux[(size_t)gm * p.ldaux + gn];
        da = v * dgelu(a, p.approximate);
        p.out[(size_t)gm * p.ldo + gn] = from_f<T>(da);
        p.out2[(size_t)gm * p.ldo + gn] = from_f<T>(gelu(a, p.approximate));
      }
      S[r * LDS + c] = da;  // each thread rewrites only the elements it read
    } else if (EPI == EPI_SWIGLU) {
      if (in) {
        const float ag = p.aux[(size_t)gm * p.ldaux + gn];
        p.out[(size_t)gm * p.ldo + gn] = from_f<T>(ag * sigmoid(ag) * v);
      }
    } else if (EPI == EPI_DSWIGLU) {
      if (in) {
        const size_t o = (size_t)gm * p.ldaux + gn;
        const float ag = p.aux[o], au = p.aux2[o];
        const float s = sigmoid(ag), silu = ag * s;
        const size_t w = (size_t)gm * p.ldo + gn;
        p.out[w] = from_f<T>(v * au * (s * (1.f + ag * (1.f - s))));
        p.out2[w] = from_f<T>(v * silu);
        p.out3[w] = from_f<T>(silu * au);
      }
    } else {
      if (in) p.out[(size_t)gm * p.ldo + gn] = from_f<T>(v);
    }
  }
  if (EPI == EPI_DGELU) {
    __syncthreads();
    float* part = p.colsum + (size_t)blockIdx.y * p.ldcol;
    for (int c = threadIdx.x; c < BN && n0 + c < p.n; c += Cfg<T>::THREADS) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += S[r * LDS + c];
      part[n0 + c] = s;
    }
  }
}

// part[by * ld + c] = sum of g[r, c] over row block by (kRowBlock rows);
// DROP: of drop(g)[r, c] in f32, and gm[r, c] = round(drop(g)[r, c]).
// grid (ceil(cols / 256), ceil(rows / kRowBlock)), 256 threads.
template <typename T, bool DROP>
__global__ void colsum_kernel(const T* __restrict__ g, T* __restrict__ gm,
                              float* __restrict__ part, size_t ld, int rows, int cols, Drop drop) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kRowBlock;
  const int r1 = min(rows, r0 + kRowBlock);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * cols + c;
    float v = to_f(g[o]);
    if (DROP) {
      v = dropped(row_keep(drop, row_key(drop, r), c), v, drop);
      gm[o] = from_f<T>(v);
    }
    s += v;
  }
  part[(size_t)blockIdx.y * ld + c] = s;
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

template <typename T, bool ACOL, bool BCOL, int EPI, bool DROP = false>
int run_gemm(Gemm<T> p, cudaStream_t stream, const Drop& drop = Drop{}) {
  constexpr int V = 16 / sizeof(T);
  // 16-byte copies: aligned bases, strides and contiguous extents whole vectors
  p.vec = (aligned16(p.a) && aligned16(p.b) && p.lda % V == 0 && p.ldb % V == 0 &&
           (ACOL ? p.m : p.k) % V == 0 && (BCOL ? p.k : p.n) % V == 0)
              ? 1
              : 0;
  using C = Cfg<T>;
  const dim3 grid((p.n + C::BN - 1) / C::BN, (p.m + C::BM - 1) / C::BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<T, ACOL, BCOL>();
  auto kernel = mlp_gemm_kernel<T, ACOL, BCOL, EPI, DROP>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  if (rc) return rc;
  kernel<<<grid, C::THREADS, bytes, stream>>>(p, drop);
  return (int)cudaGetLastError();
}

bool bad_shape(int r, int h, int f, int fc) { return r < 1 || h < 1 || f < 1 || fc < 1; }

// the dropout key: rows 0 (no dropout), or the reference's row tile with H
// columns
bool bad_key(const Drop& d, int h) { return d.rows < 0 || (d.rows > 0 && d.cols != h); }

template <typename T>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* y, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
               int approximate, const Drop& drop, void* stream) {
  if (bad_shape(r, h, f, fc) || bad_key(drop, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* W1 = static_cast<const T*>(w1);
  const T* W2 = static_cast<const T*>(w2);
  T* act = static_cast<T*>(act_ws);
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    Gemm<T> p = {};
    p.a = X, p.lda = h, p.b = W1 + f0, p.ldb = f;
    p.m = r, p.n = nc, p.k = h;
    p.bias = static_cast<const float*>(b1) + f0;
    p.out = act, p.ldo = nc, p.approximate = approximate;
    int rc = run_gemm<T, false, false, EPI_GELU>(p, st);
    if (rc) return rc;
    Gemm<T> q = {};
    q.a = act, q.lda = nc, q.b = W2 + (size_t)f0 * h, q.ldb = h;
    q.m = r, q.n = h, q.k = nc;
    q.bias = static_cast<const float*>(b2);
    q.buf = static_cast<float*>(acc_ws), q.ldbuf = h;
    q.out = static_cast<T*>(y), q.ldo = h;
    q.first = c == 0, q.last = c == nch - 1;
    rc = q.last && drop.rows ? run_gemm<T, false, false, EPI_ACC, true>(q, st, drop)
                             : run_gemm<T, false, false, EPI_ACC>(q, st);
    if (rc) return rc;
  }
  return 0;
}

// db1 [F] and db2 [H] are f32; part_ws holds parts = ceil(R / kRowBlock)
// rows of F + H f32 column sums (da's, then g's), one row per row block;
// with dropout gm_ws [R, H] in the dtype holds round(drop(g)).
template <typename T>
int launch_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* g,
               void* dx, void* dw1, void* db1, void* dw2, void* db2, void* a_ws, void* da_ws,
               void* act_ws, void* acc_ws, void* part_ws, void* gm_ws, int parts, int r, int h,
               int f, int fc, int approximate, const Drop& drop, void* stream) {
  if (bad_shape(r, h, f, fc) || parts != (r + kRowBlock - 1) / kRowBlock || bad_key(drop, h) ||
      (drop.rows && !gm_ws))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* W1 = static_cast<const T*>(w1);
  const T* W2 = static_cast<const T*>(w2);
  const T* G = static_cast<const T*>(g);
  T* GM = static_cast<T*>(gm_ws);
  float* A = static_cast<float*>(a_ws);
  T* DA = static_cast<T*>(da_ws);
  T* ACT = static_cast<T*>(act_ws);
  float* PART = static_cast<float*>(part_ws);
  const size_t ldp = (size_t)f + h;
  int rc = 0;
  const dim3 grid((h + 255) / 256, parts);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  if (drop.rows) {  // gm and db2's partials
    colsum_kernel<T, true><<<grid, 256, 0, st>>>(G, GM, PART + f, ldp, r, h, drop);
    G = GM;  // the products below read gm in place of g
  } else {  // db2's partials
    colsum_kernel<T, false><<<grid, 256, 0, st>>>(G, nullptr, PART + f, ldp, r, h, drop);
  }
  if ((rc = (int)cudaGetLastError())) return rc;
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    Gemm<T> p = {};  // a_c = x . W1[:, c] + b1[c]
    p.a = X, p.lda = h, p.b = W1 + f0, p.ldb = f;
    p.m = r, p.n = nc, p.k = h;
    p.bias = static_cast<const float*>(b1) + f0;
    p.buf = A, p.ldbuf = nc;
    if ((rc = run_gemm<T, false, false, EPI_PRE>(p, st))) return rc;

    Gemm<T> q = {};  // da_c, act_c, db1[c] from dact = g . W2[c, :]^T
    q.a = G, q.lda = h, q.b = W2 + (size_t)f0 * h, q.ldb = h;
    q.m = r, q.n = nc, q.k = h;
    q.aux = A, q.ldaux = nc;
    q.out = DA, q.out2 = ACT, q.ldo = nc, q.approximate = approximate;
    q.colsum = PART + f0, q.ldcol = ldp;  // db1's partials
    if ((rc = run_gemm<T, false, true, EPI_DGELU>(q, st))) return rc;

    Gemm<T> d = {};  // acc (+)= da_c . W1[:, c]^T
    d.a = DA, d.lda = nc, d.b = W1 + f0, d.ldb = f;
    d.m = r, d.n = h, d.k = nc;
    d.buf = static_cast<float*>(acc_ws), d.ldbuf = h;
    d.out = static_cast<T*>(dx), d.ldo = h;
    d.first = c == 0, d.last = c == nch - 1;
    if ((rc = run_gemm<T, false, true, EPI_ACC>(d, st))) return rc;

    Gemm<T> w = {};  // dW1[:, c] = x^T . da_c
    w.a = X, w.lda = h, w.b = DA, w.ldb = nc;
    w.m = h, w.n = nc, w.k = r;
    w.out = static_cast<T*>(dw1) + f0, w.ldo = f;
    if ((rc = run_gemm<T, true, false, EPI_STORE>(w, st))) return rc;
    Gemm<T> v = {};  // dW2[c, :] = act_c^T . g
    v.a = ACT, v.lda = nc, v.b = G, v.ldb = h;
    v.m = nc, v.n = h, v.k = r;
    v.out = static_cast<T*>(dw2) + (size_t)f0 * h, v.ldo = h;
    if ((rc = run_gemm<T, true, false, EPI_STORE>(v, st))) return rc;
  }
  return sum_parts(PART, parts, (int)ldp, static_cast<float*>(db1), f, static_cast<float*>(db2),
                   1, st);
}

template <typename T>
int launch_swiglu_fwd(const void* x, const void* wg, const void* wu, const void* wd, void* y,
                      void* ag_ws, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                      void* stream) {
  if (bad_shape(r, h, f, fc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* WG = static_cast<const T*>(wg);
  const T* WU = static_cast<const T*>(wu);
  const T* WD = static_cast<const T*>(wd);
  float* AG = static_cast<float*>(ag_ws);
  T* ACT = static_cast<T*>(act_ws);
  const int nch = (f + fc - 1) / fc;
  int rc = 0;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    Gemm<T> p = {};  // ag_c = x . Wg[:, c]
    p.a = X, p.lda = h, p.b = WG + f0, p.ldb = f;
    p.m = r, p.n = nc, p.k = h;
    p.buf = AG, p.ldbuf = nc;
    if ((rc = run_gemm<T, false, false, EPI_PRE>(p, st))) return rc;
    Gemm<T> q = {};  // act_c = round(silu(ag_c) * (x . Wu[:, c]))
    q.a = X, q.lda = h, q.b = WU + f0, q.ldb = f;
    q.m = r, q.n = nc, q.k = h;
    q.aux = AG, q.ldaux = nc;
    q.out = ACT, q.ldo = nc;
    if ((rc = run_gemm<T, false, false, EPI_SWIGLU>(q, st))) return rc;
    Gemm<T> d = {};  // acc (+)= act_c . Wd[c, :]
    d.a = ACT, d.lda = nc, d.b = WD + (size_t)f0 * h, d.ldb = h;
    d.m = r, d.n = h, d.k = nc;
    d.buf = static_cast<float*>(acc_ws), d.ldbuf = h;
    d.out = static_cast<T*>(y), d.ldo = h;
    d.first = c == 0, d.last = c == nch - 1;
    if ((rc = run_gemm<T, false, false, EPI_ACC>(d, st))) return rc;
  }
  return 0;
}

// dWg, dWu and dWd in the weights' dtype; acc_ws is the f32 [R, H] dX
// accumulator, needed with one chunk too (dX sums two products per chunk).
template <typename T>
int launch_swiglu_bwd(const void* x, const void* wg, const void* wu, const void* wd,
                      const void* g, void* dx, void* dwg, void* dwu, void* dwd, void* ag_ws,
                      void* au_ws, void* dag_ws, void* dau_ws, void* act_ws, void* acc_ws,
                      int r, int h, int f, int fc, void* stream) {
  if (bad_shape(r, h, f, fc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* X = static_cast<const T*>(x);
  const T* WG = static_cast<const T*>(wg);
  const T* WU = static_cast<const T*>(wu);
  const T* WD = static_cast<const T*>(wd);
  const T* G = static_cast<const T*>(g);
  float* AG = static_cast<float*>(ag_ws);
  float* AU = static_cast<float*>(au_ws);
  T* DAG = static_cast<T*>(dag_ws);
  T* DAU = static_cast<T*>(dau_ws);
  T* ACT = static_cast<T*>(act_ws);
  float* ACC = static_cast<float*>(acc_ws);
  const int nch = (f + fc - 1) / fc;
  int rc = 0;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    Gemm<T> p = {};  // ag_c = x . Wg[:, c]
    p.a = X, p.lda = h, p.b = WG + f0, p.ldb = f;
    p.m = r, p.n = nc, p.k = h;
    p.buf = AG, p.ldbuf = nc;
    if ((rc = run_gemm<T, false, false, EPI_PRE>(p, st))) return rc;
    p.b = WU + f0, p.buf = AU;  // au_c = x . Wu[:, c]
    if ((rc = run_gemm<T, false, false, EPI_PRE>(p, st))) return rc;

    Gemm<T> q = {};  // dag_c, dau_c, act_c from dact = g . Wd[c, :]^T
    q.a = G, q.lda = h, q.b = WD + (size_t)f0 * h, q.ldb = h;
    q.m = r, q.n = nc, q.k = h;
    q.aux = AG, q.aux2 = AU, q.ldaux = nc;
    q.out = DAG, q.out2 = DAU, q.out3 = ACT, q.ldo = nc;
    if ((rc = run_gemm<T, false, true, EPI_DSWIGLU>(q, st))) return rc;

    Gemm<T> d = {};  // acc (+)= dag_c . Wg[:, c]^T
    d.a = DAG, d.lda = nc, d.b = WG + f0, d.ldb = f;
    d.m = r, d.n = h, d.k = nc;
    d.buf = ACC, d.ldbuf = h;
    d.out = static_cast<T*>(dx), d.ldo = h;
    d.first = c == 0, d.last = 0;
    if ((rc = run_gemm<T, false, true, EPI_ACC>(d, st))) return rc;
    d.a = DAU, d.b = WU + f0;  // acc += dau_c . Wu[:, c]^T
    d.first = 0, d.last = c == nch - 1;
    if ((rc = run_gemm<T, false, true, EPI_ACC>(d, st))) return rc;

    Gemm<T> w = {};  // dWg[:, c] = x^T . dag_c
    w.a = X, w.lda = h, w.b = DAG, w.ldb = nc;
    w.m = h, w.n = nc, w.k = r;
    w.out = static_cast<T*>(dwg) + f0, w.ldo = f;
    if ((rc = run_gemm<T, true, false, EPI_STORE>(w, st))) return rc;
    w.b = DAU, w.out = static_cast<T*>(dwu) + f0;  // dWu[:, c] = x^T . dau_c
    if ((rc = run_gemm<T, true, false, EPI_STORE>(w, st))) return rc;
    Gemm<T> v = {};  // dWd[c, :] = act_c^T . g
    v.a = ACT, v.lda = nc, v.b = G, v.ldb = h;
    v.m = nc, v.n = h, v.k = r;
    v.out = static_cast<T*>(dwd) + (size_t)f0 * h, v.ldo = h;
    if ((rc = run_gemm<T, true, false, EPI_STORE>(v, st))) return rc;
  }
  return 0;
}

// --------------------------------------------------------------------------
// SwiGLU backward, bf16: the wgmma route
// --------------------------------------------------------------------------
//
// Replaces _swiglu_dx_kernel :543 and _swiglu_dw_kernel :572 (TPU kernels
// 8 and 9) where the operands allow TMA: bf16, H and F multiples of 8,
// every tensor 16-byte aligned. Bound: operations, 16 RHF (1.494 ms at
// LLaMA-7B's R = 2048, H = 4096, F = 11008 at 989 TFLOP/s). The generic
// route above ran at ~220 TFLOP/s: eight mma.sync launches a chunk on a
// cp.async ring, each accumulator tile staged through shared memory as
// f32, ag and au written to f32 workspaces and read back, and dX's f32
// accumulator read and written twice a chunk. Here every product is wgmma
// from a TMA ring with its accumulators in registers, and a chunk of nc
// columns takes four launches:
//   P1 swiglu_dact_wgmma_kernel: ag = x . Wg_c, au = x . Wu_c, dact = g .
//      Wd_c^T, three accumulators on one [128, 64] output tile (96 f32
//      registers a consumer thread: at [128, 128] they would need 192, past
//      ptxas's cap of 168 at 288 threads); ag and au as one m64n128 product
//      of x by Wg_c's and Wu_c's boxes side by side (an m64n64 product reads
//      as many shared-memory bytes as it computes), the epilogue from the
//      registers:
//      dag = round(dact au silu'(ag)), dau = round(dact silu(ag)), act =
//      round(silu(ag) au) (EPI_DSWIGLU's formulas), stored from the
//      registers; ag and au never leave them. Four ring stages of 56 KB
//      (no staging tile: three stages ran slower), and clusters of two
//      blocks along N that share x's and g's tiles by TMA multicast (P1
//      reads 56 KB a k step, the most bytes a flop of the four products:
//      with its loads shared it ran faster).
//   P2-P4 run on the core (gemm_core.cuh) at [128, 256] tiles, three
//   stages.
//   P2 gc core, ksplit: dX (+)= [dag_c | dau_c] . [Wg_c | Wu_c]^T, K = 2 nc
//      (the producer switches maps halfway) into the f32 [R, H] sum: the
//      first chunk stores it and the middle ones add to it through the TMA
//      unit (reduce-add: no f32 loads into registers, one writer an
//      element a chunk, so the same bits every call); the last chunk loads
//      it into the accumulator before its k loop and writes round(sum) (a
//      single chunk: round(C)).
//   P3 gc core, nsplit: [dWg_c | dWu_c] = x^T . [dag_c | dau_c] (A and B
//      MN-major), rounded, stored by TMA into dwg, dwu.
//   P4 gc core: dWd_c = act_c^T . g (A and B MN-major), rounded, stored.
// Each chunk's maps end at the chunk's edge (Wg_c, Wu_c, Wd_c and the
// outputs as windows of the whole tensors), so a tile never reads or
// writes another chunk's columns. The rounding points are the generic
// route's: dag, dau, act rounded once; dX summed over the chunks in f32,
// rounded once; dWg, dWu, dWd products of bf16 operands with f32
// accumulation, rounded once. No atomics: the same bits on every call.
// Workspace: dag, dau and act [R, Fc] bf16 and, when F > Fc, the f32 [R,
// H] accumulator: 83.9 MB at LLaMA-7B's shape with this route's chunk, Fc
// = 4096 (the caller's; three chunks ran faster than six of 2048).
// The design's variants and their times: scripts/swiglu_bwd_variants.py,
// PERF.md.

// A consumer thread's release of a ring stage of a P1 kernel (the
// SwiGLU's and the GeLU's) on clusters of CL blocks: on its own block's
// empty barrier, and, from each warp's lane 0, on those of the cluster's
// other blocks (whose stage its block's multicast loads also fill)
template <int CL> __device__ __forceinline__ void release(uint64_t* empty, int rank) {
  mbar_arrive(empty);
  if (CL > 1) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      for (int q = 0; q < CL; ++q)
        if (q != rank) mbar_arrive_cluster(empty, q);
  }
}
// the arrivals that empty such a stage: every consumer thread of the block
// and every consumer warp of the cluster's other blocks
template <int CL> __host__ __device__ constexpr int empty_arrivals() {
  return gc::kConsumers + (CL - 1) * gc::kConsumers / 32;
}

namespace sw {

constexpr int kBN = 256, kStages = 3;  // the core's tile width and ring for P2-P4
constexpr int kDactBN = 64, kDactStages = 4;
constexpr int kDactCluster = 2;  // P1's blocks sharing x's and g's tiles

struct DactSmem {
  __nv_bfloat16 x[kDactStages][gc::kBM * gc::kBK];  // two boxes each
  __nv_bfloat16 g[kDactStages][gc::kBM * gc::kBK];
  __nv_bfloat16 wgu[kDactStages][2 * gc::kBox];  // Wg_c's box, then Wu_c's
  __nv_bfloat16 wd[kDactStages][gc::kBox];
  uint64_t full[kDactStages], empty[kDactStages];
};

// P1 over a chunk: R x nc output tiles of [128, 64], k over H, on
// clusters of kDactCluster blocks side by side along N: a cluster's blocks
// share their 128 rows, and block `rank` loads x's and g's row box
// (rank) once for all of them (TMA multicast), so each block reads its
// own Wg_c, Wu_c and Wd_c tiles and 1 / kDactCluster of x's and g's. A
// stage is refilled once the consumers of every block of the cluster have
// released it (release). Maps: x, g [R, H]; Wg_c, Wu_c [H, nc] and Wd_c
// [nc, H] windows; dag, dau, act: the [R, nc] workspace.
__global__ void __cluster_dims__(kDactCluster, 1, 1) __launch_bounds__(gc::kThreads, 1)
    swiglu_dact_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tg,
                             const __grid_constant__ CUtensorMap twg,
                             const __grid_constant__ CUtensorMap twu,
                             const __grid_constant__ CUtensorMap twd, __nv_bfloat16* dag,
                             __nv_bfloat16* dau, __nv_bfloat16* act, int r, int nc, int h) {
  using gc::kBox;
  constexpr int S = kDactStages, CL = kDactCluster;
  extern __shared__ __align__(1024) char smem_raw[];
  DactSmem& sm = *reinterpret_cast<DactSmem*>(smem_raw +
                                              ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // the cluster's tiles: (row tile, column pair); this block's columns
  // are the pair's rank-th 64
  const int nm = gc::cdiv(r, gc::kBM), np = gc::cdiv(gc::cdiv(nc, kDactBN), CL);
  const int nt = nm * np, nk = gc::cdiv(h, gc::kBK);
  const int rank = (int)cluster_rank(), first = blockIdx.x / CL, step = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 1);                          // the producer's expect_tx
      mbar_init(&sm.empty[st], empty_arrivals<CL>());
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers ready before any multicast or remote arrival

  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= gc::kConsumers) {
    if (threadIdx.x == gc::kConsumers) {
      for (int t = first; t < nt; t += step) {
        int mt, pt;
        gc::tile_of(t, nm, np, mt, pt);
        const int m0 = mt * gc::kBM, n0 = (pt * CL + rank) * kDactBN;
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * gc::kBK;
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_arrive_tx(&sm.full[stage], (2 * gc::kBM * gc::kBK + 3 * kBox) * 2);
          for (int hh = rank; hh < 2; hh += CL) {  // this block's share of x's and g's boxes
            if (CL == 1) {
              tma_load_2d(sm.x[stage] + hh * kBox, &tx, &sm.full[stage], k0, m0 + 64 * hh);
              tma_load_2d(sm.g[stage] + hh * kBox, &tg, &sm.full[stage], k0, m0 + 64 * hh);
            } else {
              constexpr uint16_t all = (1u << CL) - 1;
              tma_load_2d_multicast(sm.x[stage] + hh * kBox, &tx, &sm.full[stage], k0,
                                    m0 + 64 * hh, all);
              tma_load_2d_multicast(sm.g[stage] + hh * kBox, &tg, &sm.full[stage], k0,
                                    m0 + 64 * hh, all);
            }
          }
          tma_load_2d(sm.wgu[stage], &twg, &sm.full[stage], n0, k0);  // MN-major
          tma_load_2d(sm.wgu[stage] + kBox, &twu, &sm.full[stage], n0, k0);
          tma_load_2d(sm.wd[stage], &twd, &sm.full[stage], k0, n0);  // K-major
          gc::advance<S>(stage, phase);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while another may still arrive on its barriers
    return;
  }

  const int wgi = threadIdx.x >> 7;
  const gc::Frag f;
  for (int t = first; t < nt; t += step) {
    int mt, pt;
    gc::tile_of(t, nm, np, mt, pt);
    const int m0 = mt * gc::kBM, n0 = (pt * CL + rank) * kDactBN;
    // agu: [ag | au], one m64n128 product of x by Wg_c's and Wu_c's boxes
    // side by side (x read once for both); dact: m64n64
    float agu[kDactBN], dact[kDactBN / 2];
#pragma unroll
    for (int i = 0; i < kDactBN; ++i) agu[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDactBN / 2; ++i) dact[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&sm.full[stage], phase);
      fence_regs(agu);
      fence_regs(dact);
      wgmma_fence();
      const __nv_bfloat16* xs = sm.x[stage] + wgi * kBox;
      const __nv_bfloat16* gs = sm.g[stage] + wgi * kBox;
#pragma unroll
      for (int kk = 0; kk < gc::kBK / 16; ++kk) {
        const uint64_t xd = gc::operand_desc<false>(xs, kk);
        wgmma_smem<2 * kDactBN, 0, 1>(agu, xd, gc::operand_desc<true>(sm.wgu[stage], kk), 1);
        wgmma_smem<kDactBN, 0, 0>(dact, gc::operand_desc<false>(gs, kk),
                                  gc::operand_desc<false>(sm.wd[stage], kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(agu);
      fence_regs(dact);
      if (kt > 0) release<CL>(&sm.empty[prev], rank);
      prev = stage;
      gc::advance<S>(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(agu);
    fence_regs(dact);
    release<CL>(&sm.empty[prev], rank);

    // the epilogue from the registers, EPI_DSWIGLU's formulas, stored
    // straight to device memory (a staging tile's 48 KB hold the ring's
    // fourth stage instead); a block whose columns lie past nc (an odd
    // count of column tiles: the last pair's second) only shares its loads
#pragma unroll
    for (int n = 0; n < kDactBN / 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * wgi + f.row + 8 * hh, col = n0 + 8 * n + f.col;
        if (row >= r || col >= nc) continue;  // nc is even: col + 1 < nc too
        float o[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hh + e;
          const float a = agu[i], u = agu[kDactBN / 2 + i], v = dact[i];
          const float s = sigmoid(a), silu = a * s;
          o[0][e] = v * u * (s * (1.f + a * (1.f - s)));
          o[1][e] = v * silu;
          o[2][e] = silu * u;
        }
        const size_t at = (size_t)row * nc + col;
        *reinterpret_cast<uint32_t*>(dag + at) = pack_bf16(o[0][0], o[0][1]);
        *reinterpret_cast<uint32_t*>(dau + at) = pack_bf16(o[1][0], o[1][1]);
        *reinterpret_cast<uint32_t*>(act + at) = pack_bf16(o[2][0], o[2][1]);
      }
  }
  cluster_sync();
}

constexpr size_t kDactSmem = sizeof(DactSmem) + 1024;
static_assert(kDactSmem <= kMaxSmem, "shared memory of a block");

// The clusters of P1 that fit the card at once (its persistent grid), or
// 0 if the query fails.
int dact_clusters() {
  static const int n = [] {
    if (cudaFuncSetAttribute(swiglu_dact_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDactSmem))
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kDactCluster, 1, 1);
    cfg.blockDim = dim3(gc::kThreads, 1, 1);
    cfg.dynamicSmemBytes = kDactSmem;
    int count = 0;
    return cudaOccupancyMaxActiveClusters(&count, swiglu_dact_wgmma_kernel, &cfg) == cudaSuccess
               ? count
               : 0;
  }();
  return n;
}

int run_dact(const CUtensorMap (&m)[5], void* const (&out)[3], int r, int nc, int h,
             cudaStream_t st) {
  const int nt = gc::cdiv(r, gc::kBM) * gc::cdiv(gc::cdiv(nc, kDactBN), kDactCluster);
  const int clusters = dact_clusters();
  if (clusters <= 0) return (int)cudaErrorInvalidDevice;
  int rc = (int)cudaFuncSetAttribute(swiglu_dact_wgmma_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDactSmem);
  if (rc) return rc;
  swiglu_dact_wgmma_kernel<<<std::min(nt, clusters) * kDactCluster, gc::kThreads, kDactSmem,
                             st>>>(m[0], m[1], m[2], m[3], m[4],
                                   static_cast<__nv_bfloat16*>(out[0]),
                                   static_cast<__nv_bfloat16*>(out[1]),
                                   static_cast<__nv_bfloat16*>(out[2]), r, nc, h);
  return (int)cudaGetLastError();
}

// The route's launches, chunk by chunk; `parts` bit i runs product P(i + 1)
// (15 on the op's path: every product; the others time a part alone).
int launch(const void* x, const void* wg, const void* wu, const void* wd, const void* g, void* dx,
           void* dwg, void* dwu, void* dwd, void* dag_ws, void* dau_ws, void* act_ws,
           void* acc_ws, int r, int h, int f, int fc, int parts, void* stream) {
  if (bad_shape(r, h, f, fc) || h % 8 || f % 8 || fc % 8) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, wg, wu, wd, g, (const void*)dx, (const void*)dwg, (const void*)dwu,
                        (const void*)dwd, (const void*)dag_ws, (const void*)dau_ws,
                        (const void*)act_ws})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (f > fc && (!acc_ws || !aligned16(acc_ws))) return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t hb = (size_t)h * 2, fb = (size_t)f * 2;
  CUtensorMap tx, tg, tdx, tacc;
  int rc;
  if ((rc = gc::map_2d(&tx, x, h, r, hb)) || (rc = gc::map_2d(&tg, g, h, r, hb)) ||
      (rc = gc::map_2d(&tdx, dx, h, r, hb)))
    return rc;
  tacc = tdx;  // one chunk: no f32 sum
  if (f > fc && (rc = gc::map_2d_f32(&tacc, acc_ws, h, r, (size_t)h * 4))) return rc;
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    const size_t wrow = (size_t)f0 * h;  // Wd's and dWd's first row of the chunk
    // the chunk's windows: [H, nc] of Wg, Wu, dWg, dWu; [nc, H] of Wd,
    // dWd; the workspace [R, nc]
    CUtensorMap twg, twu, twd, tdwg, tdwu, tdwd, tdag, tdau, tact;
    if ((rc = gc::map_2d(&twg, static_cast<const B*>(wg) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&twu, static_cast<const B*>(wu) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&tdwg, static_cast<B*>(dwg) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&tdwu, static_cast<B*>(dwu) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&twd, static_cast<const B*>(wd) + wrow, h, nc, hb)) ||
        (rc = gc::map_2d(&tdwd, static_cast<B*>(dwd) + wrow, h, nc, hb)) ||
        (rc = gc::map_2d(&tdag, dag_ws, nc, r, (size_t)nc * 2)) ||
        (rc = gc::map_2d(&tdau, dau_ws, nc, r, (size_t)nc * 2)) ||
        (rc = gc::map_2d(&tact, act_ws, nc, r, (size_t)nc * 2)))
      return rc;
    if (parts & 1) {  // P1: dag, dau, act
      const CUtensorMap m[5] = {tx, tg, twg, twu, twd};
      void* const out[3] = {dag_ws, dau_ws, act_ws};
      if ((rc = run_dact(m, out, r, nc, h, st))) return rc;
    }
    if (parts & 2) {  // P2: dX (+)= [dag | dau] . [Wg_c | Wu_c]^T
      const CUtensorMap m[6] = {tdag, tdau, twg, twu, tdx, tacc};
      const gc::Shape sh{r, h, nc, 1, 0};
      if (nch == 1) {  // dX = round(C)
        rc = gc::run<false, false, kBN, kStages>(m, sh, gc::EpiStore{}, st);
      } else if (c < nch - 1) {  // the f32 sum: stored, then added to
        rc = gc::run<false, false, kBN, kStages>(m, sh, gc::EpiSum{c == 0}, st);
      } else {  // dX = round(sum + C)
        const gc::EpiSumLast epi{static_cast<const float*>(acc_ws), (size_t)h, r, h};
        rc = gc::run<false, false, kBN, kStages>(m, sh, epi, st);
      }
      if (rc) return rc;
    }
    if (parts & 4) {  // P3: [dWg_c | dWu_c] = x^T . [dag | dau]
      const CUtensorMap m[6] = {tx, tx, tdag, tdau, tdwg, tdwu};
      if ((rc = gc::run<true, true, kBN, kStages>(m, gc::Shape{h, nc, r, 0, 1},
                                                                gc::EpiStore{}, st)))
        return rc;
    }
    if (parts & 8) {  // P4: dWd_c = act^T . g
      const CUtensorMap m[6] = {tact, tact, tg, tg, tdwd, tdwd};
      if ((rc = gc::run<true, true, kBN, kStages>(m, gc::Shape{nc, h, r, 0, 0},
                                                                gc::EpiStore{}, st)))
        return rc;
    }
  }
  return 0;
}

}  // namespace sw

// --------------------------------------------------------------------------
// GeLU MLP backward, bf16: the wgmma route
// --------------------------------------------------------------------------
//
// Replaces _mlp_dx_kernel :260 and _mlp_dw_kernel :296 (TPU kernels 5 and
// 6) where the operands allow TMA: bf16, H and F multiples of 8, every
// tensor 16-byte aligned. Bound: operations, 10 RHF (1.390 ms at GPT-3
// 1.3B's R = 8192, H = 2048, F = 8192; 0.393 ms at BERT-base's R = 16384,
// H = 768, F = 3072; 989 TFLOP/s). The generic route (launch_bwd) ran at
// ~233 TFLOP/s: five mma.sync launches a chunk, a_c written to an f32
// workspace and read back, each accumulator tile staged through shared
// memory as f32. Here the SwiGLU route's plan carries over product for
// product: the column-sum pass as on the generic route (colsum_kernel:
// db2's partials; with dropout gm = round(drop(g)), which every product
// below reads in place of g), then per chunk of nc columns four launches:
//   P1 gelu_dact_wgmma_kernel: a = x . W1_c (W1_c's [H, nc]
//      window MN-major) and dact = gm . W2_c^T (W2_c's [nc, H] window
//      K-major), two accumulators on one [128, 128] output tile (128 f32
//      registers a consumer thread, 168 in all: ptxas's cap at 288
//      threads; with gelu and gelu' computed apart the erf form spilled
//      there); the epilogue from the registers: a += b1[col], da = dact
//      gelu'(a), act = gelu(a) (EPI_DGELU's formulas, gelu_and_grad),
//      round(da) and round(act) stored to the [R, nc] workspace, a never
//      leaving the registers; db1's partials of the unrounded da from the
//      same registers: each thread adds its two rows, a fixed shuffle over
//      the eight lanes of a column, then the eight consumer warps through
//      shared memory in order, into part[row block][f0 + col] (a tile's
//      128 rows are one row block of sum_parts; rows past R add nothing).
//      Three ring stages of 64 KB (a k step: x's and gm's 16 KB each, W1_c's
//      and W2_c's 16 KB each, for 4.2 MFLOP; [128, 64] tiles with four
//      stages of 48 KB ran ~15% slower), clusters of two blocks along N
//      multicasting x's and gm's tiles, as the SwiGLU's P1.
//   P2 gc core: dX (+)= da_c . W1_c^T, K = nc, into the f32 sum across
//      chunks as the SwiGLU's P2 (EpiStore for one chunk, EpiSum, then
//      EpiSumLast).
//   P3 gc core: dW1_c = x^T . da_c (A and B MN-major), rounded, stored.
//   P4 gc core: dW2_c = act_c^T . gm (A and B MN-major), rounded, stored.
//   P3 and P4 run at [128, 256] tiles or, where those leave the last wave
//   emptier, at [128, 192] (run_dw: BERT-base's 72 tiles of [128, 256]).
// Then sum_parts folds db1's and db2's partials over the row blocks in
// order. The rounding points are the generic route's: da and act rounded
// once, dX summed over the chunks in f32 and rounded once, the dW
// products of bf16 operands with f32 accumulation, db1 and db2 f32 sums
// of the unrounded da and gm. No atomics: the same bits on every call.
// CUDA launches a call: 2 + 4 nc. Workspace: da and act [R, Fc] bf16,
// the f32 [R, H] dX sum when F > Fc, the partials, and with dropout gm
// [R, H] bf16. The design's variants and their times:
// scripts/mlp_bwd_variants.py, PERF.md.

namespace ge {

constexpr int kTileN = 128, kRing = 3;  // P1's output tile width and ring stages
constexpr int kCluster = 2;            // P1's blocks sharing x's and gm's tiles
constexpr int kDwBN = 192, kDwStages = 4;  // P3's and P4's narrower tile (run_dw)
static_assert(gc::kBM == kRowBlock, "a P1 tile's rows are one row block of the partials");

struct DactSmem {
  __nv_bfloat16 x[kRing][gc::kBM * gc::kBK];  // two boxes each
  __nv_bfloat16 g[kRing][gc::kBM * gc::kBK];
  __nv_bfloat16 w1[kRing][kTileN * gc::kBK];  // W1_c's boxes (MN-major)
  __nv_bfloat16 w2[kRing][kTileN * gc::kBK];  // W2_c's (K-major)
  float sums[2][gc::kConsumers / 32][kTileN];  // db1: each warp's column sums, by tile parity
  uint64_t full[kRing], empty[kRing];
};

// P1's epilogue operands, the chunk's: b1 (f32, nc), the da and act
// workspaces [R, nc], db1's partials (row block i at part + i * ldp), the
// GeLU form (1 tanh, 0 erf: read at run time, one instantiation for both;
// a template parameter ran ~1% slower, scripts/mlp_bwd_variants.py)
struct DactOut {
  const float* b1;
  __nv_bfloat16* da;
  __nv_bfloat16* act;
  float* part;
  size_t ldp;
  int approximate;
};

// P1 over a chunk: R x nc output tiles of [128, kTileN], k over H, on
// clusters of kCluster blocks side by side along N: a cluster's blocks
// share their 128 rows, and block `rank` loads x's and gm's row box
// (rank) once for all of them (TMA multicast). Maps: x, gm [R, H]; W1_c
// [H, nc] and W2_c [nc, H] windows.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(gc::kThreads, 1)
    gelu_dact_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tw2, const DactOut o, int r,
                           int nc, int h) {
  using gc::kBox;
  constexpr int S = kRing, CL = kCluster, BN = kTileN;
  extern __shared__ __align__(1024) char smem_raw[];
  DactSmem& sm = *reinterpret_cast<DactSmem*>(smem_raw +
                                              ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int nm = gc::cdiv(r, gc::kBM), np = gc::cdiv(gc::cdiv(nc, BN), CL);
  const int nt = nm * np, nk = gc::cdiv(h, gc::kBK);
  const int rank = (int)cluster_rank(), first = blockIdx.x / CL, step = gridDim.x / CL;
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 1);  // the producer's expect_tx
      mbar_init(&sm.empty[st], empty_arrivals<CL>());
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers ready before any multicast or remote arrival

  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= gc::kConsumers) {
    if (threadIdx.x == gc::kConsumers) {
      for (int t = first; t < nt; t += step) {
        int mt, pt;
        gc::tile_of(t, nm, np, mt, pt);
        const int m0 = mt * gc::kBM, n0 = (pt * CL + rank) * BN;
        for (int kt = 0; kt < nk; ++kt) {
          const int k0 = kt * gc::kBK;
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_arrive_tx(&sm.full[stage], (2 * gc::kBM + 2 * BN) * gc::kBK * 2);
          for (int hh = rank; hh < 2; hh += CL) {  // this block's share of x's and gm's boxes
            if (CL == 1) {
              tma_load_2d(sm.x[stage] + hh * kBox, &tx, &sm.full[stage], k0, m0 + 64 * hh);
              tma_load_2d(sm.g[stage] + hh * kBox, &tg, &sm.full[stage], k0, m0 + 64 * hh);
            } else {
              constexpr uint16_t all = (1u << CL) - 1;
              tma_load_2d_multicast(sm.x[stage] + hh * kBox, &tx, &sm.full[stage], k0,
                                    m0 + 64 * hh, all);
              tma_load_2d_multicast(sm.g[stage] + hh * kBox, &tg, &sm.full[stage], k0,
                                    m0 + 64 * hh, all);
            }
          }
          gc::load_operand<true, BN>(sm.w1[stage], &tw1, &sm.full[stage], n0, k0);
          gc::load_operand<false, BN>(sm.w2[stage], &tw2, &sm.full[stage], n0, k0);
          gc::advance<S>(stage, phase);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while another may still arrive on its barriers
    return;
  }

  const int wgi = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const gc::Frag f;
  int parity = 0;
  for (int t = first; t < nt; t += step, parity ^= 1) {
    int mt, pt;
    gc::tile_of(t, nm, np, mt, pt);
    const int m0 = mt * gc::kBM, n0 = (pt * CL + rank) * BN;
    float a[BN / 2], dact[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) a[i] = dact[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&sm.full[stage], phase);
      fence_regs(a);
      fence_regs(dact);
      wgmma_fence();
      const __nv_bfloat16* xs = sm.x[stage] + wgi * kBox;
      const __nv_bfloat16* gs = sm.g[stage] + wgi * kBox;
#pragma unroll
      for (int kk = 0; kk < gc::kBK / 16; ++kk) {
        wgmma_smem<BN, 0, 1>(a, gc::operand_desc<false>(xs, kk),
                             gc::operand_desc<true>(sm.w1[stage], kk), 1);
        wgmma_smem<BN, 0, 0>(dact, gc::operand_desc<false>(gs, kk),
                             gc::operand_desc<false>(sm.w2[stage], kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(a);
      fence_regs(dact);
      if (kt > 0) release<CL>(&sm.empty[prev], rank);
      prev = stage;
      gc::advance<S>(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(a);
    fence_regs(dact);
    release<CL>(&sm.empty[prev], rank);

    // the epilogue from the registers, stored straight to device memory,
    // eight columns at a time; cs: this thread's two rows of da summed,
    // then the warp's 16 (the lanes of a column differ in bits 2-4)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + 8 * n + f.col;  // nc is even: col + 1 < nc too
      const float2 bias = col < nc ? *reinterpret_cast<const float2*>(o.b1 + col)
                                   : make_float2(0.f, 0.f);
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * wgi + f.row + 8 * hh;
        float d[2], act[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hh + e;
          float dg;
          gelu_and_grad(a[i] + (e ? bias.y : bias.x), o.approximate, act[e], dg);
          d[e] = dact[i] * dg;
        }
        if (row >= r || col >= nc) continue;
        cs[0] += d[0];
        cs[1] += d[1];
        const size_t at = (size_t)row * nc + col;
        *reinterpret_cast<uint32_t*>(o.da + at) = pack_bf16(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(o.act + at) = pack_bf16(act[0], act[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 4);
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 8);
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
        if (lane < 4) sm.sums[parity][warp][8 * n + f.col + e] = cs[e];
      }
    }
    // the warps' sums visible; a tile's sums are read before any thread
    // passes this barrier in the tile after next, which writes the same
    // parity
    bar_sync(1, gc::kConsumers);
    if (threadIdx.x < BN && n0 + (int)threadIdx.x < nc) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < gc::kConsumers / 32; ++w) s += sm.sums[parity][w][threadIdx.x];
      o.part[(size_t)mt * o.ldp + n0 + threadIdx.x] = s;
    }
  }
  cluster_sync();
}

constexpr size_t kDactSmem = sizeof(DactSmem) + 1024;
static_assert(kDactSmem <= kMaxSmem, "shared memory of a block");

// The clusters of P1 that fit the card at once (its persistent grid), or
// 0 if the query fails.
int dact_clusters() {
  static const int n = [] {
    if (cudaFuncSetAttribute(gelu_dact_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDactSmem))
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(gc::kThreads, 1, 1);
    cfg.dynamicSmemBytes = kDactSmem;
    int count = 0;
    return cudaOccupancyMaxActiveClusters(&count, gelu_dact_wgmma_kernel, &cfg) == cudaSuccess
               ? count
               : 0;
  }();
  return n;
}

int run_dact(const CUtensorMap (&m)[4], const DactOut& o, int r, int nc, int h,
             cudaStream_t st) {
  const int nt = gc::cdiv(r, gc::kBM) * gc::cdiv(gc::cdiv(nc, kTileN), kCluster);
  const int clusters = dact_clusters();
  if (clusters <= 0) return (int)cudaErrorInvalidDevice;
  const auto kernel = gelu_dact_wgmma_kernel;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)kDactSmem);
  if (rc) return rc;
  kernel<<<std::min(nt, clusters) * kCluster, gc::kThreads, kDactSmem, st>>>(
      m[0], m[1], m[2], m[3], o, r, nc, h);
  return (int)cudaGetLastError();
}

// P3 or P4 (A and B MN-major, K = R) on the core at [128, 256] tiles, or at
// [128, kDwBN] where those leave the last wave less empty (fewer waves
// times the tile's width): at BERT-base's H = 768, F = 3072 the [128, 256]
// tiles of each number 72 on 132 SMs and ran at ~500 TFLOP/s, 96 tiles of
// [128, 192] at ~640; at GPT-3 1.3B's widths 256 tiles of [128, 256] ran
// at ~780, 352 of [128, 192] at ~710 (scripts/mlp_bwd_variants.py).
int run_dw(const CUtensorMap (&m)[6], const gc::Shape& s, cudaStream_t st) {
  const int sms = gc::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto cost = [&](int bn) {
    return gc::cdiv(gc::cdiv(s.m, gc::kBM) * gc::cdiv(s.n, bn), sms) * bn;
  };
  const bool narrow = cost(kDwBN) < cost(sw::kBN);
  if (narrow) return gc::run<true, true, kDwBN, kDwStages>(m, s, gc::EpiStore{}, st);
  return gc::run<true, true, sw::kBN, sw::kStages>(m, s, gc::EpiStore{}, st);
}

// The route's launches; `products` bit i runs product P(i + 1), bit 4 the
// column-sum pass and sum_parts (31 on the op's path: everything; the
// others time a part alone).
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* g,
           void* dx, void* dw1, void* db1, void* dw2, void* db2, void* da_ws, void* act_ws,
           void* acc_ws, void* part_ws, void* gm_ws, int parts, int r, int h, int f, int fc,
           int approximate, const Drop& drop, int products, void* stream) {
  if (bad_shape(r, h, f, fc) || h % 8 || f % 8 || fc % 8 ||
      parts != (r + kRowBlock - 1) / kRowBlock || bad_key(drop, h) || (drop.rows && !gm_ws))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w1, w2, g, (const void*)dx, (const void*)dw1, (const void*)dw2,
                        (const void*)da_ws, (const void*)act_ws})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if ((f > fc && (!acc_ws || !aligned16(acc_ws))) || (drop.rows && !aligned16(gm_ws)))
    return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const B* G = static_cast<const B*>(g);
  float* PART = static_cast<float*>(part_ws);
  const size_t ldp = (size_t)f + h;
  int rc;
  if (products & 16) {
    const dim3 grid((h + 255) / 256, parts);
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    if (drop.rows) {  // gm and db2's partials
      colsum_kernel<B, true><<<grid, 256, 0, st>>>(G, static_cast<B*>(gm_ws), PART + f, ldp, r,
                                                   h, drop);
    } else {  // db2's partials
      colsum_kernel<B, false><<<grid, 256, 0, st>>>(G, nullptr, PART + f, ldp, r, h, drop);
    }
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  if (drop.rows) G = static_cast<const B*>(gm_ws);  // the products read gm in place of g
  const size_t hb = (size_t)h * 2, fb = (size_t)f * 2;
  CUtensorMap tx, tg, tdx, tacc;
  if ((rc = gc::map_2d(&tx, x, h, r, hb)) || (rc = gc::map_2d(&tg, G, h, r, hb)) ||
      (rc = gc::map_2d(&tdx, dx, h, r, hb)))
    return rc;
  tacc = tdx;  // one chunk: no f32 sum
  if (f > fc && (rc = gc::map_2d_f32(&tacc, acc_ws, h, r, (size_t)h * 4))) return rc;
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    const size_t wrow = (size_t)f0 * h;  // W2's and dW2's first row of the chunk
    // the chunk's windows: [H, nc] of W1, dW1; [nc, H] of W2, dW2; the
    // workspace [R, nc]
    CUtensorMap tw1, tw2, tdw1, tdw2, tda, tact;
    if ((rc = gc::map_2d(&tw1, static_cast<const B*>(w1) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&tdw1, static_cast<B*>(dw1) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&tw2, static_cast<const B*>(w2) + wrow, h, nc, hb)) ||
        (rc = gc::map_2d(&tdw2, static_cast<B*>(dw2) + wrow, h, nc, hb)) ||
        (rc = gc::map_2d(&tda, da_ws, nc, r, (size_t)nc * 2)) ||
        (rc = gc::map_2d(&tact, act_ws, nc, r, (size_t)nc * 2)))
      return rc;
    if (products & 1) {  // P1: da, act, db1's partials
      const CUtensorMap m[4] = {tx, tg, tw1, tw2};
      const DactOut o{static_cast<const float*>(b1) + f0, static_cast<B*>(da_ws),
                      static_cast<B*>(act_ws), PART + f0, ldp, approximate};
      if ((rc = run_dact(m, o, r, nc, h, st))) return rc;
    }
    if (products & 2) {  // P2: dX (+)= da . W1_c^T
      const CUtensorMap m[6] = {tda, tda, tw1, tw1, tdx, tacc};
      const gc::Shape sh{r, h, nc, 0, 0};
      if (nch == 1) {  // dX = round(C)
        rc = gc::run<false, false, sw::kBN, sw::kStages>(m, sh, gc::EpiStore{}, st);
      } else if (c < nch - 1) {  // the f32 sum: stored, then added to
        rc = gc::run<false, false, sw::kBN, sw::kStages>(m, sh, gc::EpiSum{c == 0}, st);
      } else {  // dX = round(sum + C)
        const gc::EpiSumLast epi{static_cast<const float*>(acc_ws), (size_t)h, r, h};
        rc = gc::run<false, false, sw::kBN, sw::kStages>(m, sh, epi, st);
      }
      if (rc) return rc;
    }
    if (products & 4) {  // P3: dW1_c = x^T . da
      const CUtensorMap m[6] = {tx, tx, tda, tda, tdw1, tdw1};
      if ((rc = run_dw(m, gc::Shape{h, nc, r, 0, 0}, st))) return rc;
    }
    if (products & 8) {  // P4: dW2_c = act^T . gm
      const CUtensorMap m[6] = {tact, tact, tg, tg, tdw2, tdw2};
      if ((rc = run_dw(m, gc::Shape{nc, h, r, 0, 0}, st))) return rc;
    }
  }
  if (!(products & 16)) return 0;
  return sum_parts(PART, parts, (int)ldp, static_cast<float*>(db1), f, static_cast<float*>(db2),
                   1, st);
}

}  // namespace ge

// --------------------------------------------------------------------------
// GeLU and SwiGLU forwards, bf16: the wgmma route
// --------------------------------------------------------------------------
//
// Replaces _mlp_fwd_kernel :228 (TPU kernel 4, its dropout variant
// included) and _swiglu_fwd_kernel :522 (kernel 7) where the operands allow
// TMA: bf16, H and F multiples of 8, every tensor 16-byte aligned. Bound:
// operations, GeLU 4 RHF (0.556 ms at GPT-3 1.3B's R = 8192, H = 2048, F =
// 8192; 0.159 ms at BERT-base's R = 16384, H = 768, F = 3072), SwiGLU 6
// RHF (0.560 ms at LLaMA-7B's R = 2048, H = 4096, F = 11008; 989
// TFLOP/s). The generic route (launch_fwd, launch_swiglu_fwd) ran at ~220
// TFLOP/s: mma.sync from a cp.async ring, each accumulator tile staged
// through shared memory as f32, the SwiGLU's gate product written to an
// f32 workspace and read back, the f32 sum across chunks read and written
// a chunk. Here both products of a chunk of nc columns run on the core of
// gemm_core.cuh, two launches a chunk:
//   P1 act_c = round(gelu(x . W1_c + b1_c)) (EpiGelu: x K-major, W1_c's
//      [H, nc] window MN-major, [128, 192] tiles, four stages; b1 added
//      and the GeLU form read at run time in the epilogue, gelu's
//      formulas, the result staged in bf16 and stored by TMA); SwiGLU:
//      act_c = round(silu(x . Wg_c) . (x . Wu_c)) on the core's paired B
//      at a [128, 256] accumulator, three stages (PAIR: a stage of B
//      holds 128 columns of Wg_c, then the same 128 of Wu_c, so one
//      m64n256 product gives ag and au of a [128, 128] output tile in the
//      same thread's registers; EpiSwiglu combines them with
//      EPI_SWIGLU's formulas, and ag and au never leave the registers).
//      The GeLU's epilogue costs the most: tanhf or erff for each of its
//      tile's elements, with no product in flight; at [128, 256] (three
//      stages) it ran ~20% slower, and reading b1 one pair at a time (each
//      load waited on before the next staging store) 7-13% slower.
//   P2 y (+)= act_c . W2_c (act_c K-major, W2_c's [nc, H] window
//      MN-major; [128, 256] tiles, three stages: at BERT-base's H = 768
//      the backward's wave rule, ge::run_dw, picks them too; the GeLU's
//      last of several chunks at [128, 192], four, kLastBN) into the f32
//      [R, H] sum across chunks, as the backwards'
//      dX: one chunk writes round(C + b2) (EpiBias<false>; the SwiGLU
//      EpiStore); the first and middle chunks the f32 sum (EpiSum: TMA
//      store, then reduce-adds); the last loads the sum into the
//      accumulator before its k loop and writes round(sum + C + b2)
//      (EpiBias<true>; the SwiGLU EpiSumLast). With dropout the one chunk
//      or the last writes round(drop(sum + C + b2)): the f32 value masked
//      before its one rounding, b2 added to the whole sum first, as the
//      reference does (:250-257); the keep-mask keyed (row / block_r, 0, 0)
//      at (row % block_r) H + col, block_r the reference's row tile, so
//      the mask is the interpret mode's whatever tile runs. Its key is in
//      the dropout epilogue's own type (EpiBias<., Drop>): the dropout-free
//      instantiations carry none.
// Each epilogue that can load the accumulator is its own type (a type
// that can load slows its kernel's k loop, scripts/swiglu_bwd_variants.py
// sum_can_load). Each chunk's maps end at the chunk's edge (W1_c, W2_c and
// act_c as windows), so a tile never reads another chunk's columns. The
// rounding points are the generic route's: act rounded once, y summed over
// the chunks in f32 and rounded once. No atomics: the same bits on every
// call. CUDA launches a call: 2 nc. Workspace: act_c [R, Fc] bf16 and,
// when F > Fc, the f32 [R, H] sum (at the route's chunk Fc = 8192: 134
// MB at GPT-3 1.3B's one chunk, 100.7 MB at BERT-base's, 33.6 + 33.6 MB
// at LLaMA-7B's two). The design's variants and their times:
// scripts/mlp_fwd_variants.py, PERF.md.

namespace fw {

// the accumulator widths and rings: the GeLU's P1 (its output tiles that
// wide), the SwiGLU's paired P1 (output tiles half as wide), P2
constexpr int kGeluBN = 192, kGeluStages = 4;
constexpr int kSwigluBN = 256, kSwigluStages = 3;
constexpr int kBN = 256, kStages = 3;
// P2's last chunk of the GeLU's several, whose init loads the f32 sum and
// whose epilogue reads the bias (EpiBias<true, .>): at [128, 256] the
// dropout-free type spilled 20 bytes at ptxas's cap of 168 registers (the
// SwiGLU's EpiSumLast, without the bias, did not;
// scripts/mlp_fwd_variants.py, last_bn256)
constexpr int kLastBN = 192, kLastStages = 4;
// the column groups of 8 whose bias pairs (and sum pairs) an epilogue
// reads ahead (stage_batched; one at a time left P1's tensor cores idle
// longer)
constexpr int kGeluBatch = 8, kBiasBatch = 4;

struct NoDrop {};  // the dropout-free epilogues' key: none

// v in bf16 pairs into a warpgroup's staging boxes: pair(n, h) packs
// columns 8n + col, + 1 of row row + 8h (gc::stage_bf16's layout)
template <int NG, typename Pair>
__device__ __forceinline__ void stage_pairs(char* ob, const gc::Frag& f, Pair pair) {
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(ob + gc::swizzled(f.row + 8 * h, n, f.col)) = pair(n, h);
}

// The same a batch of column groups at a time: pre(n) reads column group
// n's operands from device memory, BATCH groups' loads in flight
// together (issued one at a time, each was waited on before the staging
// store that follows it, which may alias it), then pair(n, h, operands)
// packs the pair
template <int NG, int BATCH, typename Pre, typename Pair>
__device__ __forceinline__ void stage_batched(char* ob, const gc::Frag& f, Pre pre, Pair pair) {
  static_assert(NG % BATCH == 0, "whole batches of column groups");
#pragma unroll
  for (int g = 0; g < NG; g += BATCH) {
    decltype(pre(0)) v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) v[j] = pre(g + j);
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(ob + gc::swizzled(f.row + 8 * h, g + j, f.col)) =
            pair(g + j, h, v[j]);
  }
}

// the f32 pair at columns col, col + 1 of a row (a bias, a row of the
// sum), or zeros past n (n even), through the read-only path
__device__ __forceinline__ float2 pair_at(const float* row, int col, int n) {
  return col < n ? __ldg(reinterpret_cast<const float2*>(row + col)) : make_float2(0.f, 0.f);
}

// P1 of the GeLU forward: round(gelu(C + b1)) to o0; b1 the chunk's f32
// [nc], the form read at run time (1 tanh, 0 erf)
struct EpiGelu {
  const float* b1;
  int n, approximate;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const gc::Tile<BN>&, int) const {
    gc::zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const gc::Tile<BN>& tl,
                                             int wgi, char* ob, const CUtensorMap& o0,
                                             const CUtensorMap&) const {
    const gc::Frag f;
    gc::out_acquire(wgi);
    stage_batched<BN / 8, kGeluBatch>(
        ob, f, [&](int nn) { return pair_at(b1, tl.n0 + 8 * nn + f.col, n); },
        [&](int nn, int h, float2 b) {
          const int i = 4 * nn + 2 * h;
          return pack_bf16(gelu(acc[i] + b.x, approximate),
                           gelu(acc[i + 1] + b.y, approximate));
        });
    if (gc::out_release(wgi)) gc::store_boxes(o0, ob, BN / 64, tl.n0, tl.m0 + 64 * wgi);
  }
};

// P1 of the SwiGLU forward, on the paired core: the accumulator holds ag
// (its first TN columns) and au (its last TN) of an output tile TN wide;
// round(silu(ag) au) to o0 (EPI_SWIGLU's formulas)
struct EpiSwiglu {
  template <int TN>
  __device__ __forceinline__ void init(float (&acc)[TN], const gc::Tile<TN>&, int) const {
    gc::zero(acc);
  }
  template <int TN>
  __device__ __forceinline__ void operator()(const float (&acc)[TN], const gc::Tile<TN>& tl,
                                             int wgi, char* ob, const CUtensorMap& o0,
                                             const CUtensorMap&) const {
    gc::out_acquire(wgi);
    stage_pairs<TN / 8>(ob, gc::Frag(), [&](int nn, int h) {
      const int i = 4 * nn + 2 * h, u = i + TN / 2;  // au: TN / 8 column groups on
      return pack_bf16(acc[i] * sigmoid(acc[i]) * acc[u],
                       acc[i + 1] * sigmoid(acc[i + 1]) * acc[u + 1]);
    });
    if (gc::out_release(wgi)) gc::store_boxes(o0, ob, TN / 64, tl.n0, tl.m0 + 64 * wgi);
  }
};

// P2 of the GeLU forward where it writes y: round([drop](C + b2)) (LOAD
// false: one chunk) or round([drop](sum + C + b2)) (LOAD: the last chunk,
// the f32 sum buf [m, n], row stride ld, loaded into the accumulator
// before the k loop as EpiSumLast does); K: Drop (the key) or NoDrop
template <bool LOAD, typename K> struct EpiBias {
  const float* b2;
  const float* buf;
  size_t ld;
  int m, n;
  K key;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const gc::Tile<BN>& tl,
                                       int wgi) const {
    if constexpr (LOAD) {
      gc::EpiSumLast{buf, ld, m, n}.init(acc, tl, wgi);
    } else {
      gc::zero(acc);
    }
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const gc::Tile<BN>& tl,
                                             int wgi, char* ob, const CUtensorMap& o0,
                                             const CUtensorMap&) const {
    const gc::Frag f;
    const auto bias = [&](int nn) { return pair_at(b2, tl.n0 + 8 * nn + f.col, n); };
    gc::out_acquire(wgi);
    if constexpr (std::is_same<K, Drop>::value) {
      const int row = tl.m0 + 64 * wgi + f.row;
      const RowKey rk[2] = {row_key(key, row), row_key(key, row + 8)};
      stage_batched<BN / 8, kBiasBatch>(ob, f, bias, [&](int nn, int h, float2 b) {
        const int col = tl.n0 + 8 * nn + f.col, i = 4 * nn + 2 * h;
        return pack_bf16(dropped(row_keep(key, rk[h], col), acc[i] + b.x, key),
                         dropped(row_keep(key, rk[h], col + 1), acc[i + 1] + b.y, key));
      });
    } else {
      stage_batched<BN / 8, kBiasBatch>(ob, f, bias, [&](int nn, int h, float2 b) {
        const int i = 4 * nn + 2 * h;
        return pack_bf16(acc[i] + b.x, acc[i + 1] + b.y);
      });
    }
    if (gc::out_release(wgi)) gc::store_boxes(o0, ob, BN / 64, tl.n0, tl.m0 + 64 * wgi);
  }
};

// the chunk's P2 on the core: y (+)= act_c . W2_c by the chunk's place
// (c of nch), maps {act_c, act_c, W2_c, W2_c, y, the f32 sum}; the last
// of several chunks at accumulator width LBN with LS stages
template <int LBN, int LS, typename One, typename Last>
int run_down(const CUtensorMap (&m)[6], const gc::Shape& sh, int c, int nch, const One& one,
             const Last& last, cudaStream_t st) {
  if (nch == 1) return gc::run<false, true, kBN, kStages>(m, sh, one, st);
  if (c < nch - 1) return gc::run<false, true, kBN, kStages>(m, sh, gc::EpiSum{c == 0}, st);
  return gc::run<false, true, LBN, LS>(m, sh, last, st);
}

// The check and the maps every launch shares: x, y [R, H] and the f32 sum
// (y's map where F <= Fc: one chunk keeps no sum)
int prepare(const void* const (&ptrs)[5], const void* acc_ws, int r, int h, int f, int fc,
            CUtensorMap& tx, CUtensorMap& ty, CUtensorMap& tacc) {
  if (bad_shape(r, h, f, fc) || h % 8 || f % 8 || fc % 8) return (int)cudaErrorInvalidValue;
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (f > fc && (!acc_ws || !aligned16(acc_ws))) return (int)cudaErrorInvalidValue;
  const size_t hb = (size_t)h * 2;
  int rc;
  if ((rc = gc::map_2d(&tx, ptrs[0], h, r, hb)) || (rc = gc::map_2d(&ty, ptrs[1], h, r, hb)))
    return rc;
  tacc = ty;
  if (f > fc && (rc = gc::map_2d_f32(&tacc, acc_ws, h, r, (size_t)h * 4))) return rc;
  return 0;
}

// The GeLU forward's launches, chunk by chunk; `parts` bit 0 runs P1, bit
// 1 P2 (3 on the op's path; the others time a product alone).
int gelu_launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* y, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                int approximate, const Drop& drop, int parts, void* stream) {
  using B = __nv_bfloat16;
  if (bad_key(drop, h) || !aligned16(b1) || !aligned16(b2)) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty, tacc;
  int rc = prepare({x, y, w1, w2, act_ws}, acc_ws, r, h, f, fc, tx, ty, tacc);
  if (rc) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* B1 = static_cast<const float*>(b1);
  const float* B2 = static_cast<const float*>(b2);
  const float* ACC = static_cast<const float*>(acc_ws);
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    CUtensorMap tw1, tw2, tact;  // W1_c [H, nc], W2_c [nc, H], act_c [R, nc]
    if ((rc = gc::map_2d(&tw1, static_cast<const B*>(w1) + f0, nc, h, (size_t)f * 2)) ||
        (rc = gc::map_2d(&tw2, static_cast<const B*>(w2) + (size_t)f0 * h, h, nc,
                         (size_t)h * 2)) ||
        (rc = gc::map_2d(&tact, act_ws, nc, r, (size_t)nc * 2)))
      return rc;
    if (parts & 1) {  // P1: act_c = round(gelu(x . W1_c + b1_c))
      const CUtensorMap m[6] = {tx, tx, tw1, tw1, tact, tact};
      if ((rc = gc::run<false, true, kGeluBN, kGeluStages>(m, gc::Shape{r, nc, h, 0, 0},
                                                           EpiGelu{B1 + f0, nc, approximate},
                                                           st)))
        return rc;
    }
    if (parts & 2) {  // P2: y (+)= act_c . W2_c, b2 and the mask where y is written
      const CUtensorMap m[6] = {tact, tact, tw2, tw2, ty, tacc};
      const gc::Shape sh{r, h, nc, 0, 0};
      if (drop.rows) {
        rc = run_down<kLastBN, kLastStages>(
            m, sh, c, nch, EpiBias<false, Drop>{B2, nullptr, 0, r, h, drop},
            EpiBias<true, Drop>{B2, ACC, (size_t)h, r, h, drop}, st);
      } else {
        rc = run_down<kLastBN, kLastStages>(
            m, sh, c, nch, EpiBias<false, NoDrop>{B2, nullptr, 0, r, h, {}},
            EpiBias<true, NoDrop>{B2, ACC, (size_t)h, r, h, {}}, st);
      }
      if (rc) return rc;
    }
  }
  return 0;
}

// The SwiGLU forward's launches, chunk by chunk; `parts` as gelu_launch's.
int swiglu_launch(const void* x, const void* wg, const void* wu, const void* wd, void* y,
                  void* act_ws, void* acc_ws, int r, int h, int f, int fc, int parts,
                  void* stream) {
  using B = __nv_bfloat16;
  if (!aligned16(wu)) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty, tacc;
  int rc = prepare({x, y, wg, wd, act_ws}, acc_ws, r, h, f, fc, tx, ty, tacc);
  if (rc) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t fb = (size_t)f * 2;
  const int nch = (f + fc - 1) / fc;
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * fc, nc = std::min(fc, f - f0);
    CUtensorMap twg, twu, twd, tact;  // Wg_c, Wu_c [H, nc], Wd_c [nc, H], act_c [R, nc]
    if ((rc = gc::map_2d(&twg, static_cast<const B*>(wg) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&twu, static_cast<const B*>(wu) + f0, nc, h, fb)) ||
        (rc = gc::map_2d(&twd, static_cast<const B*>(wd) + (size_t)f0 * h, h, nc,
                         (size_t)h * 2)) ||
        (rc = gc::map_2d(&tact, act_ws, nc, r, (size_t)nc * 2)))
      return rc;
    if (parts & 1) {  // P1: act_c = round(silu(x . Wg_c) (x . Wu_c)), paired B
      const CUtensorMap m[6] = {tx, tx, twg, twu, tact, tact};
      if ((rc = gc::run<false, true, kSwigluBN, kSwigluStages, EpiSwiglu, true>(
               m, gc::Shape{r, nc, h, 0, 0}, EpiSwiglu{}, st)))
        return rc;
    }
    if (parts & 2) {  // P2: y (+)= act_c . Wd_c
      const CUtensorMap m[6] = {tact, tact, twd, twd, ty, tacc};
      if ((rc = run_down<kBN, kStages>(
               m, gc::Shape{r, h, nc, 0, 0}, c, nch, gc::EpiStore{},
               gc::EpiSumLast{static_cast<const float*>(acc_ws), (size_t)h, r, h}, st)))
        return rc;
    }
  }
  return 0;
}

}  // namespace fw

}  // namespace

extern "C" {

// The dropout key of the GeLU MLP's entries: the seed pair, the keep
// threshold, f32(1 / (1 - p)) and the reference's row tile (drop_rows =
// block_r, drop_cols = H); drop_rows 0: no dropout (gm_ws may then be null).
int fused_mlp_fwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* y, void* act_ws, void* acc_ws, int r, int h, int f,
                      int fc, int approximate, unsigned s0, unsigned s1, unsigned thresh,
                      float inv, int drop_rows, int drop_cols, void* stream) {
  return launch_fwd<float>(x, w1, b1, w2, b2, y, act_ws, acc_ws, r, h, f, fc, approximate,
                           Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, stream);
}

int fused_mlp_fwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, void* act_ws, void* acc_ws, int r, int h, int f,
                       int fc, int approximate, unsigned s0, unsigned s1, unsigned thresh,
                       float inv, int drop_rows, int drop_cols, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, w1, b1, w2, b2, y, act_ws, acc_ws, r, h, f, fc,
                                   approximate, Drop{s0, s1, thresh, inv, drop_rows, drop_cols},
                                   stream);
}

// The GeLU forward's wgmma route, bf16 only: H, F and Fc multiples of 8,
// every tensor 16-byte aligned (anything else is refused); the generic
// entry's arguments. act_ws: [R, Fc] bf16; acc_ws: the f32 [R, H] sum when
// F > Fc (else may be null).
int fused_mlp_fwd_wgmma_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* act_ws, void* acc_ws, int r, int h,
                             int f, int fc, int approximate, unsigned s0, unsigned s1,
                             unsigned thresh, float inv, int drop_rows, int drop_cols,
                             void* stream) {
  return fw::gelu_launch(x, w1, b1, w2, b2, y, act_ws, acc_ws, r, h, f, fc, approximate,
                         Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, 3, stream);
}

// The same with only the launches of `parts` (bit 0: P1, bit 1: P2), for
// timing one product alone (scripts/mlp_fwd_variants.py).
int fused_mlp_fwd_wgmma_parts_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* y, void* act_ws, void* acc_ws, int r,
                                   int h, int f, int fc, int approximate, unsigned s0,
                                   unsigned s1, unsigned thresh, float inv, int drop_rows,
                                   int drop_cols, int parts, void* stream) {
  return fw::gelu_launch(x, w1, b1, w2, b2, y, act_ws, acc_ws, r, h, f, fc, approximate,
                         Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, parts, stream);
}

int fused_mlp_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* g, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                      void* a_ws, void* da_ws, void* act_ws, void* acc_ws, void* part_ws,
                      void* gm_ws, int parts, int r, int h, int f, int fc, int approximate,
                      unsigned s0, unsigned s1, unsigned thresh, float inv, int drop_rows,
                      int drop_cols, void* stream) {
  return launch_bwd<float>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, a_ws, da_ws, act_ws, acc_ws,
                           part_ws, gm_ws, parts, r, h, f, fc, approximate,
                           Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, stream);
}

int fused_mlp_bwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* g, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                       void* a_ws, void* da_ws, void* act_ws, void* acc_ws, void* part_ws,
                       void* gm_ws, int parts, int r, int h, int f, int fc, int approximate,
                       unsigned s0, unsigned s1, unsigned thresh, float inv, int drop_rows,
                       int drop_cols, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, a_ws, da_ws,
                                   act_ws, acc_ws, part_ws, gm_ws, parts, r, h, f, fc,
                                   approximate, Drop{s0, s1, thresh, inv, drop_rows, drop_cols},
                                   stream);
}

// The GeLU backward's wgmma route, bf16 only: H, F and Fc multiples of 8,
// every tensor 16-byte aligned (anything else is refused); the generic
// entry's arguments without a_ws (a stays in the registers). da_ws,
// act_ws: [R, Fc] bf16; acc_ws: the f32 [R, H] dX accumulator when F > Fc
// (else may be null).
int fused_mlp_bwd_wgmma_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* g, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                             void* da_ws, void* act_ws, void* acc_ws, void* part_ws, void* gm_ws,
                             int parts, int r, int h, int f, int fc, int approximate, unsigned s0,
                             unsigned s1, unsigned thresh, float inv, int drop_rows,
                             int drop_cols, void* stream) {
  return ge::launch(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, da_ws, act_ws, acc_ws, part_ws,
                    gm_ws, parts, r, h, f, fc, approximate,
                    Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, 31, stream);
}

// The same with only the launches of `products` (bit i: P(i + 1); bit 4:
// the column-sum pass and sum_parts), for timing one product alone
// (scripts/mlp_bwd_variants.py).
int fused_mlp_bwd_wgmma_parts_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* g, void* dx, void* dw1, void* db1, void* dw2,
                                   void* db2, void* da_ws, void* act_ws, void* acc_ws,
                                   void* part_ws, void* gm_ws, int parts, int r, int h, int f,
                                   int fc, int approximate, unsigned s0, unsigned s1,
                                   unsigned thresh, float inv, int drop_rows, int drop_cols,
                                   int products, void* stream) {
  return ge::launch(x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, da_ws, act_ws, acc_ws, part_ws,
                    gm_ws, parts, r, h, f, fc, approximate,
                    Drop{s0, s1, thresh, inv, drop_rows, drop_cols}, products, stream);
}

int fused_swiglu_fwd_f32(const void* x, const void* wg, const void* wu, const void* wd, void* y,
                         void* ag_ws, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                         void* stream) {
  return launch_swiglu_fwd<float>(x, wg, wu, wd, y, ag_ws, act_ws, acc_ws, r, h, f, fc, stream);
}

int fused_swiglu_fwd_bf16(const void* x, const void* wg, const void* wu, const void* wd, void* y,
                          void* ag_ws, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                          void* stream) {
  return launch_swiglu_fwd<__nv_bfloat16>(x, wg, wu, wd, y, ag_ws, act_ws, acc_ws, r, h, f, fc,
                                          stream);
}

// The SwiGLU forward's wgmma route, bf16 only: H, F and Fc multiples of 8,
// every tensor 16-byte aligned (anything else is refused); the generic
// entry's arguments without ag_ws (ag and au stay in the registers).
// act_ws: [R, Fc] bf16; acc_ws: the f32 [R, H] sum when F > Fc (else may
// be null).
int fused_swiglu_fwd_wgmma_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                                void* y, void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                                void* stream) {
  return fw::swiglu_launch(x, wg, wu, wd, y, act_ws, acc_ws, r, h, f, fc, 3, stream);
}

// The same with only the launches of `parts` (bit 0: P1, bit 1: P2), for
// timing one product alone (scripts/mlp_fwd_variants.py).
int fused_swiglu_fwd_wgmma_parts_bf16(const void* x, const void* wg, const void* wu,
                                      const void* wd, void* y, void* act_ws, void* acc_ws, int r,
                                      int h, int f, int fc, int parts, void* stream) {
  return fw::swiglu_launch(x, wg, wu, wd, y, act_ws, acc_ws, r, h, f, fc, parts, stream);
}

int fused_swiglu_bwd_f32(const void* x, const void* wg, const void* wu, const void* wd,
                         const void* g, void* dx, void* dwg, void* dwu, void* dwd, void* ag_ws,
                         void* au_ws, void* dag_ws, void* dau_ws, void* act_ws, void* acc_ws,
                         int r, int h, int f, int fc, void* stream) {
  return launch_swiglu_bwd<float>(x, wg, wu, wd, g, dx, dwg, dwu, dwd, ag_ws, au_ws, dag_ws,
                                  dau_ws, act_ws, acc_ws, r, h, f, fc, stream);
}

int fused_swiglu_bwd_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                          const void* g, void* dx, void* dwg, void* dwu, void* dwd, void* ag_ws,
                          void* au_ws, void* dag_ws, void* dau_ws, void* act_ws, void* acc_ws,
                          int r, int h, int f, int fc, void* stream) {
  return launch_swiglu_bwd<__nv_bfloat16>(x, wg, wu, wd, g, dx, dwg, dwu, dwd, ag_ws, au_ws,
                                          dag_ws, dau_ws, act_ws, acc_ws, r, h, f, fc, stream);
}

// The wgmma route, bf16 only: H, F and Fc multiples of 8, every tensor
// 16-byte aligned (anything else is refused). dag_ws, dau_ws, act_ws:
// [R, Fc] bf16; acc_ws: the f32 [R, H] dX accumulator when F > Fc (else
// may be null).
int fused_swiglu_bwd_wgmma_bf16(const void* x, const void* wg, const void* wu, const void* wd,
                                const void* g, void* dx, void* dwg, void* dwu, void* dwd,
                                void* dag_ws, void* dau_ws, void* act_ws, void* acc_ws, int r,
                                int h, int f, int fc, void* stream) {
  return sw::launch(x, wg, wu, wd, g, dx, dwg, dwu, dwd, dag_ws, dau_ws, act_ws, acc_ws, r, h, f,
                    fc, 15, stream);
}

// The same with only the products of `parts` (bit i: P(i + 1)), for
// timing one product alone (scripts/swiglu_bwd_variants.py).
int fused_swiglu_bwd_wgmma_parts_bf16(const void* x, const void* wg, const void* wu,
                                      const void* wd, const void* g, void* dx, void* dwg,
                                      void* dwu, void* dwd, void* dag_ws, void* dau_ws,
                                      void* act_ws, void* acc_ws, int r, int h, int f, int fc,
                                      int parts, void* stream) {
  return sw::launch(x, wg, wu, wd, g, dx, dwg, dwu, dwd, dag_ws, dau_ws, act_ws, acc_ws, r, h, f,
                    fc, parts, stream);
}

}  // extern "C"
