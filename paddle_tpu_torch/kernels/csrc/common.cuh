// What the port's CUDA sources share: element conversions, warp sums, the
// cp.async / ldmatrix / mma.sync wrappers, one tiled GEMM main loop (the
// fused MLP's, also the projection-LayerNorm's product), one fixed-order
// column sum of per-block partial rows, the dropout keep-mask (and its
// debug entry, dropout_bits), and the error string of the C interface.
// Each csrc/*.cu includes this header once and builds into its own shared
// library (kernels/_build.py), so the definitions below exist once per
// library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// --------------------------------------------------------------------------
// the dropout keep-mask
// --------------------------------------------------------------------------
//
// paddle_tpu/kernels/flash_attention.py's portable hash, _interpret_bits
// (:97), keyed as _keep_mask (:119) keys it: the masks of the reference's
// interpret-mode kernels, bit for bit (its compiled TPU kernels draw from
// the TPU's hardware generator, which cannot be reproduced). An element's
// bits hash the seed pair, the (b, i, j) triple of the reference's
// logical tile that holds it and its row-major index in that tile; it is
// kept iff its bits are below the threshold. Flash keys (bh, r / rows,
// c / cols), the row kernels (LayerNorm, projection-LN) (row / rows, 0, 0)
// with cols = the row's width: any CUDA tile computes the reference's
// mask, and a backward regenerates the forward's from the same key. The
// uint32 products wrap, as the reference's jnp.uint32 products do. Kept
// values are multiplied by f32(1 / (1 - p)) with __fmul_rn, so that no
// later add contracts the product into an fma the reference does not do.
struct Drop {
  uint32_t s0, s1;  // the seed pair: one generator split
  uint32_t thresh;  // kept iff bits < thresh (_keep_threshold :92)
  float inv;        // f32(1 / (1 - p))
  int rows, cols;   // the reference's logical tile; rows 0: no dropout
};

__host__ __device__ __forceinline__ uint32_t keep_base(const Drop& d, uint32_t b, uint32_t i,
                                                       uint32_t j) {
  return (d.s0 * 0x9E3779B1u) ^ (d.s1 * 0x85EBCA6Bu) ^ (b * 0xC2B2AE35u) ^ (i * 0x27D4EB2Fu) ^
         (j * 0x165667B1u);
}

__host__ __device__ __forceinline__ uint32_t keep_mix(uint32_t base, uint32_t idx) {
  uint32_t x = base ^ (idx * 0x9E3779B1u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The bits of element (r, c) of head bh's score matrix, reckoned once
// per head and row: the words of the seed pair and the head, then per row
// its tile row's word and the in-tile index of its column 0. When the
// logical tile's sides are powers of two (every model path's tiles) the
// divisions become shifts and masks (lr, lc their log2; lr = -1: the
// division path); bits<true> takes the shifts, bits<false> the divisions.
struct FlashKey {
  uint32_t head;
  int rows, cols, lr, lc;
  FlashKey() = default;
  __device__ FlashKey(const Drop& d, int bh)
      : head(keep_base(d, (uint32_t)bh, 0u, 0u)), rows(d.rows), cols(d.cols) {
    const bool pow2 = __popc(rows) == 1 && __popc(cols) == 1;
    lr = pow2 ? __ffs(rows) - 1 : -1;
    lc = pow2 ? __ffs(cols) - 1 : -1;
  }
  __device__ __forceinline__ void row(int r, uint32_t& word, uint32_t& idx0) const {
    int i;
    if (lr >= 0) {
      i = r >> lr;
      idx0 = (uint32_t)(r & (rows - 1)) << lc;
    } else {
      i = r / rows;
      idx0 = (uint32_t)(r - i * rows) * (uint32_t)cols;
    }
    word = head ^ ((uint32_t)i * 0x27D4EB2Fu);
  }
  template <bool POW2>
  __device__ __forceinline__ uint32_t bits(uint32_t word, uint32_t idx0, int c) const {
    const int j = POW2 ? c >> lc : c / cols;
    const uint32_t cm = POW2 ? (uint32_t)(c & (cols - 1)) : (uint32_t)(c - j * cols);
    return keep_mix(word ^ ((uint32_t)j * 0x165667B1u), idx0 + cm);
  }
};

// the generic flash kernels' element (r, c): the division path
__device__ __forceinline__ bool flash_keep(const Drop& d, int bh, int r, int c) {
  FlashKey key(d, bh);
  key.lr = key.lc = -1;
  uint32_t word, idx0;
  key.row(r, word, idx0);
  return key.bits<false>(word, idx0, c) < d.thresh;
}

// a row of a row kernel: its tile's word and the index of its column 0
struct RowKey {
  uint32_t base, idx0;
};

__device__ __forceinline__ RowKey row_key(const Drop& d, int row) {
  const int i = row / d.rows;
  return {keep_base(d, (uint32_t)i, 0u, 0u), (uint32_t)(row - i * d.rows) * (uint32_t)d.cols};
}

__device__ __forceinline__ bool row_keep(const Drop& d, RowKey k, int c) {
  return keep_mix(k.base, k.idx0 + (uint32_t)c) < d.thresh;
}

// x kept and scaled, or 0
__device__ __forceinline__ float dropped(bool keep, float x, const Drop& d) {
  return keep ? __fmul_rn(x, d.inv) : 0.f;
}

// the debug entry's kernel: the bits of every element of an [nb, nr, nc]
// score matrix (flash keys, through FlashKey) or of an [nr, nc] row matrix
// (row keys, nb 1)
__global__ void dropout_bits_kernel(uint32_t* __restrict__ out, int nb, int nr, int nc, Drop d,
                                    int row_layout) {
  const size_t n = (size_t)nb * nr * nc;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % nc);
    const size_t rest = e / nc;
    const int r = (int)(rest % nr), b = (int)(rest / nr);
    if (row_layout) {
      const RowKey k = row_key(d, r);
      out[e] = keep_mix(k.base, k.idx0 + (uint32_t)c);
    } else {  // FlashKey's path, the one the flash forward's wgmma kernel takes
      const FlashKey key(d, b);
      uint32_t word, idx0;
      key.row(r, word, idx0);
      out[e] = key.lr >= 0 ? key.bits<true>(word, idx0, c) : key.bits<false>(word, idx0, c);
    }
  }
}

// --------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// --------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory, one row address per lane;
// with TRANS each is transposed on the way into the registers.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --------------------------------------------------------------------------
// the GEMM main loop
// --------------------------------------------------------------------------

// Block tile BM x BN, k step BK, NSTAGE copies in flight, warp tile WTM x
// WTN (bf16; float32 takes the same threads, each BM / (THREADS / (BN /
// 8)) rows x 8 columns of scalar FMA).
template <int BM_, int BN_, int BK_, int NSTAGE_, int WTM_, int WTN_> struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, NSTAGE = NSTAGE_, WTM = WTM_, WTN = WTN_;
  static constexpr int THREADS = 32 * (BM / WTM) * (BN / WTN);
  static constexpr int LDS = BN + 4;  // row stride of a BM x BN f32 epilogue tile
};

// C[m, n] = sum_k A(m, k) B(k, n). A(m, k) is a[m * lda + k], or
// a[k * lda + m] when the caller's ACOL; B(k, n) is b[k * ldb + n], or
// b[n * ldb + k] when BCOL. vec: 16-byte copies (aligned bases, strides and
// contiguous extents whole vectors), else scalar copies. The main loop
// takes any struct P with these fields: the fused MLP passes its kernel
// parameter itself (reached through a base class instead, the parameter
// cost its row-major bf16 instantiations so many registers that they lost
// one of their two blocks per SM).
template <typename T> struct Operands {
  const T* a;
  const T* b;
  size_t lda, ldb;
  int m, n, k;
  int vec;
};

// Shared-memory tile shapes: a tile is `outer` rows of `inner` contiguous
// elements (the operand's own layout), rows padded by 16 bytes.
template <typename T> struct Pad { static constexpr int v = 16 / sizeof(T); };
template <typename T, typename C, bool ACOL> struct ATile {
  static constexpr int outer = ACOL ? C::BK : C::BM;
  static constexpr int inner = ACOL ? C::BM : C::BK;
  static constexpr int ld = inner + Pad<T>::v;
  static constexpr size_t bytes = (size_t)outer * ld * sizeof(T);
};
template <typename T, typename C, bool BCOL> struct BTile {
  static constexpr int outer = BCOL ? C::BN : C::BK;
  static constexpr int inner = BCOL ? C::BK : C::BN;
  static constexpr int ld = inner + Pad<T>::v;
  static constexpr size_t bytes = (size_t)outer * ld * sizeof(T);
};
template <typename T, typename C, bool ACOL, bool BCOL>
__host__ __device__ constexpr size_t ring_bytes() {
  return C::NSTAGE * (ATile<T, C, ACOL>::bytes + BTile<T, C, BCOL>::bytes);
}

// One tile: rows [0, OUTER) x columns [0, INNER) of the matrix at src with
// row stride lds; zero past outer_ext rows or inner_ext columns.
template <typename T, int THREADS, int OUTER, int INNER, int LDD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, size_t lds,
                                          int outer_ext, int inner_ext, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = INNER / V;
    for (int idx = threadIdx.x; idx < OUTER * CPR; idx += THREADS) {
      const int o = idx / CPR, i = (idx - o * CPR) * V;
      const bool ok = o < outer_ext && i < inner_ext;  // whole vector: ld % V == 0
      cp_async16(dst + o * LDD + i, ok ? src + (size_t)o * lds + i : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < OUTER * INNER; idx += THREADS) {
      const int o = idx / INNER, i = idx - o * INNER;
      dst[o * LDD + i] =
          (o < outer_ext && i < inner_ext) ? src[(size_t)o * lds + i] : from_f<T>(0.f);
    }
  }
}

template <typename T, typename C, bool ACOL, bool BCOL, typename P>
__device__ __forceinline__ void load_stage(const P& p, T* as, T* bs, int m0, int n0, int k0) {
  using A = ATile<T, C, ACOL>;
  using B = BTile<T, C, BCOL>;
  if (ACOL) {
    load_tile<T, C::THREADS, A::outer, A::inner, A::ld>(as, p.a + (size_t)k0 * p.lda + m0, p.lda,
                                                        p.k - k0, p.m - m0, p.vec);
  } else {
    load_tile<T, C::THREADS, A::outer, A::inner, A::ld>(as, p.a + (size_t)m0 * p.lda + k0, p.lda,
                                                        p.m - m0, p.k - k0, p.vec);
  }
  if (BCOL) {
    load_tile<T, C::THREADS, B::outer, B::inner, B::ld>(bs, p.b + (size_t)n0 * p.ldb + k0, p.ldb,
                                                        p.n - n0, p.k - k0, p.vec);
  } else {
    load_tile<T, C::THREADS, B::outer, B::inner, B::ld>(bs, p.b + (size_t)k0 * p.ldb + n0, p.ldb,
                                                        p.k - k0, p.n - n0, p.vec);
  }
}

// The k loop of the block at (m0, n0): a NSTAGE-deep cp.async ring of
// operand tiles at the start of smem; bf16 through ldmatrix into
// mma.sync m16n8k16 with f32 accumulators in registers, float32 through
// scalar FMA. The BM x BN product is left in S (f32, row stride lds),
// columns c < ncols only (ncols even); S may overlay the ring.
template <typename T, typename C, bool ACOL, bool BCOL, typename P>
__device__ void mainloop(const P& p, char* smem, float* S, int lds, int ncols, int m0, int n0) {
  using A = ATile<T, C, ACOL>;
  using B = BTile<T, C, BCOL>;
  constexpr int BK = C::BK, NSTAGE = C::NSTAGE;
  constexpr size_t kStage = A::bytes + B::bytes;
  auto as = [&](int s) { return reinterpret_cast<T*>(smem + s * kStage); };
  auto bs = [&](int s) { return reinterpret_cast<T*>(smem + s * kStage + A::bytes); };
  const int nk = (p.k + BK - 1) / BK;
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage<T, C, ACOL, BCOL>(p, as(s), bs(s), m0, n0, s * BK);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // mma.sync m16n8k16: this warp's WTM x WTN as FM x FN tiles of 16 x 8,
    // fragments loaded with ldmatrix (.trans where the tile's layout is
    // the transpose of the fragment's)
    constexpr int FM = C::WTM / 16, FN = C::WTN / 8, WARPS_N = C::BN / C::WTN;
    static_assert(FN % 2 == 0, "B fragments are loaded two n8 tiles at a time");
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int wm = (warp / WARPS_N) * C::WTM, wn = (warp % WARPS_N) * C::WTN;
    float acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // stage kt landed; everyone is done with stage kt - 1
      const int nxt = kt + NSTAGE - 1;
      if (nxt < nk)
        load_stage<T, C, ACOL, BCOL>(p, as(nxt % NSTAGE), bs(nxt % NSTAGE), m0, n0, nxt * BK);
      cp_async_commit();
      const T* at = as(kt % NSTAGE);
      const T* bt = bs(kt % NSTAGE);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t fa[FM][4], fb[FN][2];
        // lane l addresses row l % 8 of 8 x 8 matrix l / 8: for A the
        // matrices are (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
        // (m 8-15, k 8-15); for B (k 0-7, n 0-7), (k 8-15, n 0-7),
        // (k 0-7, n 8-15), (k 8-15, n 8-15): two n8 tiles
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int m = wm + 16 * i + (mi & 1) * 8, k = kk + (mi >> 1) * 8;
          ldmatrix_x4<ACOL>(fa[i], ACOL ? at + (k + r8) * A::ld + m : at + (m + r8) * A::ld + k);
        }
#pragma unroll
        for (int j = 0; j < FN; j += 2) {
          const int n = wn + 8 * j + (mi >> 1) * 8, k = kk + (mi & 1) * 8;
          uint32_t r[4];
          ldmatrix_x4<!BCOL>(r, BCOL ? bt + (n + r8) * B::ld + k : bt + (k + r8) * B::ld + n);
          fb[j][0] = r[0], fb[j][1] = r[1], fb[j + 1][0] = r[2], fb[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: S may overlay it
    // accumulator (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) with
    // r = lane / 4, c = 2 (lane % 4) in each 16 x 8 tile
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int col = wn + 8 * j + c2;
        if (col < ncols) {
          float* d = S + (wm + 16 * i + g) * lds + col;
          *reinterpret_cast<float2*>(d) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(d + 8 * lds) = make_float2(acc[i][j][2], acc[i][j][3]);
        }
      }
  } else {
    // thread (ty, tx): rows ty + TY i, columns tx + TX j
    constexpr int TX = C::BN / 8, TY = C::THREADS / TX, RI = C::BM / TY;
    static_assert(C::THREADS % TX == 0 && C::BM % TY == 0, "f32 FMA tiling");
    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    float c[RI][8];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      const int nxt = kt + NSTAGE - 1;
      if (nxt < nk)
        load_stage<T, C, ACOL, BCOL>(p, as(nxt % NSTAGE), bs(nxt % NSTAGE), m0, n0, nxt * BK);
      cp_async_commit();
      const T* at = as(kt % NSTAGE);
      const T* bt = bs(kt % NSTAGE);
      for (int k = 0; k < BK; ++k) {
        float av[RI], bv[8];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int r = ty + TY * i;
          av[i] = to_f(ACOL ? at[k * A::ld + r] : at[r * A::ld + k]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = tx + TX * j;
          bv[j] = to_f(BCOL ? bt[cc * B::ld + k] : bt[k * B::ld + cc]);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tx + TX * j < ncols) S[(ty + TY * i) * lds + tx + TX * j] = c[i][j];
  }
  __syncthreads();  // S is complete
}

// --------------------------------------------------------------------------
// column sums of per-block partial rows, in a fixed order
// --------------------------------------------------------------------------

// s[c] = sum over q < nparts of part[q * cols + c]; out1[c] = s[c] for
// c < n1, out2[c - n1] = s[c] past it. Thread (x, y) of a 32 x WAYS block
// sums rows y, y + WAYS, ... of column 32 blockIdx.x + x in order; thread
// (x, 0) then adds the WAYS sums in order y = 0, 1, ... No atomics: every
// call gives the same bits (WAYS = 1 sums the rows in order q = 0, 1, ...).
template <int WAYS>
__global__ void __launch_bounds__(32 * WAYS)
    sum_parts_kernel(const float* __restrict__ part, int nparts, int cols,
                     float* __restrict__ out1, int n1, float* __restrict__ out2) {
  __shared__ float red[WAYS][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols)
    for (int q = threadIdx.y; q < nparts; q += WAYS) s += part[(size_t)q * cols + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < WAYS; ++y) t += red[y][threadIdx.x];
    if (c < n1) {
      out1[c] = t;
    } else {
      out2[c - n1] = t;
    }
  }
}

// ways: 1 (the rows in order) or 8
inline int sum_parts(const float* part, int nparts, int cols, float* out1, int n1, float* out2,
                     int ways, cudaStream_t stream) {
  const unsigned blocks = (cols + 31) / 32;
  if (ways == 1) {
    sum_parts_kernel<1><<<blocks, dim3(32, 1), 0, stream>>>(part, nparts, cols, out1, n1, out2);
  } else if (ways == 8) {
    sum_parts_kernel<8><<<blocks, dim3(32, 8), 0, stream>>>(part, nparts, cols, out1, n1, out2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Debug entry: the device hash's bits (uint32) of an [nb, nr, nc] matrix
// under the reference's tile (rows, cols), flash keys, or of an [nr, nc]
// row matrix with row keys (row_layout 1, nb 1). No path calls it: it
// lets a test hold the device hash against the plain version bit for bit.
extern "C" int dropout_bits(void* out, int nb, int nr, int nc, unsigned s0, unsigned s1,
                            int rows, int cols, int row_layout, void* stream) {
  if (nb < 1 || nr < 1 || nc < 1 || rows < 1 || cols < 1 || (row_layout && nb != 1))
    return (int)cudaErrorInvalidValue;
  const Drop d{s0, s1, 0u, 0.f, rows, cols};
  const size_t n = (size_t)nb * nr * nc;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536);
  dropout_bits_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), nb, nr, nc, d, row_layout);
  return (int)cudaGetLastError();
}
