// Fused LayerNorm, forward and backward, with the bias + residual epilogue:
//   y = LayerNorm(res + (h + lin_b)) * w + b  over the last axis of [R, H],
// residual and lin_b each optional (plain LayerNorm has neither).
//
// Replaces the TPU kernels of paddle_tpu/kernels/norm_fusion.py:
//   _ln_fwd_kernel :82  (launched by _ln_fwd :239) -> ln_fwd_*
//   _ln_bwd_kernel :120 (launched by _ln_bwd :274) -> ln_bwd_* (+ sum_parts)
// both entered through fused_layer_norm_2d :364 (the custom_vjp of :315).
// h, res [R, H] contiguous, float32 or bfloat16 (one dtype); lin_b, w, b
// [H] come in as f32, as the reference broadcasts them in f32 (_rows :208).
//
//   forward:  z = drop(h (+ lin_b)) (+ res) in f32; mean = sum(z) / H; the
//             centred variance var = sum((z - mean)^2) / H in a second
//             pass over the row (:110-113, not Welford);
//             rstd = rsqrt(var + eps); y = round((z - mean) * rstd * w + b);
//             mean and rstd are written [R] f32 (the residuals the backward
//             reads, :323-327).
//   backward: z and x^ = (z - mean) * rstd recomputed from the primal inputs
//             and the saved stats; gw = g * w; c1 = mean(gw);
//             c2 = mean(gw * x^); dz = (gw - c1 - x^ * c2) * rstd (:182-184);
//             dh = round(drop(dz)), dres = round(dz); dw = sum_r g * x^,
//             db = sum_r g, dlin_b = sum_r drop(dz), in f32 (:190-195).
// round() is the rounding to the I/O dtype; drop(x) is x without dropout,
// and with it (dropout_p > 0, the DROP instantiations; the dropout-free
// ones are the code they were) keep ? x * f32(1 / (1 - p)) : 0 (:104-107,
// :162-175), common.cuh's keep-mask keyed (row / block_r, 0, 0) at the
// index (row % block_r) * H + c, block_r being the reference's row tile
// (_auto_block_r :343) whatever rows a block here owns; the backward
// regenerates it from the seed pair.
//
// Bound: bytes. At BERT-base training shapes (R = B*S = 16384, H = 768,
// bf16, with residual) the forward moves h, res and y once (75.5 MB, 22.5 us
// at 3.35 TB/s) and does ~10 flops per element (0.13 GFLOP); the backward
// moves h, res, g, dh and dres (126 MB, 37.6 us). The design keeps every
// row in registers so each input byte is read once, and sums in f32.
//
// Design (no TPU artifacts: no [R, 8] lane-broadcast stat rows, no row
// padding, no block_r tuning table):
//   - one warp per row; the row sits in registers, loaded with 16-byte
//     vectors (8 bf16 or 4 f32 a lane), NV vectors a lane (NV = 1, 2, 4 or
//     8: bf16 H <= 2048, f32 H <= 1024 in the forward; H <= 1024 in the
//     backward, whose lanes also hold g and the column sums). A row that
//     does not fit, or that is not 16-byte aligned or a whole number of
//     vectors, takes the generic kernels: one warp per row looping over
//     the row in global memory (the same arithmetic; slower);
//   - the TPU accumulates dw, db and dlin_b across its sequential row grid
//     in VMEM. Here a block of 8 warps owns 32 rows (4 a warp): each lane
//     sums its columns over its warp's rows in registers, the block sums its
//     8 warps in order through shared memory and writes one partial row per
//     block to an f32 workspace [ceil(R / 32), nacc, H]; common.cuh's
//     sum_parts then sums the partial rows in a fixed order. No
//     atomics: every call gives the same bits.
// CUDA launches per call: forward 1, backward 2.
//
// The backward has two routes (norm_fusion.ln_bwd_route): the persistent
// kernel ln_bwd_persist (rows that are whole aligned 16-byte vectors, at
// most 32 elements a lane: bf16 H <= 1024, f32 H <= 1024) and the kernels
// above, generic (ln_bwd_vec, ln_bwd_generic: every shape; also forced for
// an in-call comparison). The persistent kernel keeps one or two blocks an
// SM (ln_bwd_plan): each owns a contiguous run of rows, keeps its column
// sums in registers across all of them and writes one partial row, so
// sum_parts adds nparts (~264) rows instead of ceil(R / 32); the next
// row's h, res and g are in flight (cp.async into a per-warp ring) while a
// warp computes the current one. Its note is above its code.
//
// The second half of this file holds the fused BatchNorm-train kernels (TPU
// kernels 15-18), with their own note above their code.

#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kWarps = 8;                           // warps per block
constexpr int kRowsPerWarp = 4;                     // backward rows per warp
constexpr int kRowsPerPart = kWarps * kRowsPerWarp;  // rows per partial row (32)
constexpr int kFwdMaxNV = 8;
constexpr int kBwdMaxElems = 32;  // elements a lane holds in the backward

template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(float* dst, const T* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) dst[k] = to_f(e[k]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* src) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) e[k] = from_f<T>(src[k]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// n f32 values (n a multiple of 4, src 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_f32(float* dst, const float* src) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + k);
    dst[k] = v.x, dst[k + 1] = v.y, dst[k + 2] = v.z, dst[k + 3] = v.w;
  }
}

struct Fwd {
  const void* h;
  const void* res;    // null: no residual
  const float* lin_b; // null: no bias
  const float* w;
  const float* b;
  void* y;
  float* mean;
  float* rstd;
  int r, hd;
  float eps;
  Drop drop;  // drop.rows 0: no dropout
};

struct Bwd {
  const void* h;
  const void* res;
  const float* lin_b;
  const float* w;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dh;
  void* dres;   // null when there is no residual
  float* part;  // [ceil(R / 32), nacc, H]: dw, db (, dlin_b)
  int r, hd, nacc;
  Drop drop;
};

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

template <typename T, int NV, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd_vec(Fwd p) {
  constexpr int V = Vec<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.r) return;
  const int nvec = p.hd / V;
  const size_t base = (size_t)row * p.hd;
  const T* h = static_cast<const T*>(p.h) + base;
  const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
  const RowKey rk = DROP ? row_key(p.drop, row) : RowKey{0u, 0u};
  float z[NV][V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      load_vec<T>(z[i], h + j * V);
      if (p.lin_b) {
        float lb[V];
        load_f32<V>(lb, p.lin_b + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) z[i][k] += lb[k];
      }
      if (DROP) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          z[i][k] = dropped(row_keep(p.drop, rk, j * V + k), z[i][k], p.drop);
      }
      if (res) {
        float rv[V];
        load_vec<T>(rv, res + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) z[i][k] += rv[k];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) s += z[i][k];
    }
  }
  const float mean = warp_sum(s) / p.hd;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = z[i][k] - mean;
        v += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(v) / p.hd + p.eps);
  T* y = static_cast<T*>(p.y) + base;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      float w[V], b[V], o[V];
      load_f32<V>(w, p.w + j * V);
      load_f32<V>(b, p.b + j * V);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = (z[i][k] - mean) * rstd * w[k] + b[k];
      store_vec<T>(y + j * V, o);
    }
  }
  if (lane == 0) {
    p.mean[row] = mean;
    p.rstd[row] = rstd;
  }
}

// z at column c: drop(h (+ lin_b)) (+ res)
template <typename T, bool DROP, typename P>
__device__ __forceinline__ float z_at(const P& p, const T* h, const T* res, RowKey rk, int c) {
  float z = to_f(h[c]);
  if (p.lin_b) z += p.lin_b[c];
  if (DROP) z = dropped(row_keep(p.drop, rk, c), z, p.drop);
  if (res) z += to_f(res[c]);
  return z;
}

// any H, any alignment: one warp per row, three passes over the row
template <typename T, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd_generic(Fwd p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.r) return;
  const size_t base = (size_t)row * p.hd;
  const T* h = static_cast<const T*>(p.h) + base;
  const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
  const RowKey rk = DROP ? row_key(p.drop, row) : RowKey{0u, 0u};
  float s = 0.f;
  for (int c = lane; c < p.hd; c += 32) s += z_at<T, DROP>(p, h, res, rk, c);
  const float mean = warp_sum(s) / p.hd;
  float v = 0.f;
  for (int c = lane; c < p.hd; c += 32) {
    const float d = z_at<T, DROP>(p, h, res, rk, c) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / p.hd + p.eps);
  T* y = static_cast<T*>(p.y) + base;
  for (int c = lane; c < p.hd; c += 32)
    y[c] = from_f<T>((z_at<T, DROP>(p, h, res, rk, c) - mean) * rstd * p.w[c] + p.b[c]);
  if (lane == 0) {
    p.mean[row] = mean;
    p.rstd[row] = rstd;
  }
}

// --------------------------------------------------------------------------
// backward
// --------------------------------------------------------------------------

// grid ceil(R / 32); warp w takes rows r0 + w + 8 i, i < 4. Dynamic shared
// memory: kWarps * H f32 (the warps' column sums, one accumulator at a time).
template <typename T, int NV, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_bwd_vec(Bwd p) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) float red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRowsPerPart;
  const int nvec = p.hd / V;
  float acc_w[NV][V], acc_b[NV][V], acc_lb[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) acc_w[i][k] = acc_b[i][k] = acc_lb[i][k] = 0.f;

  for (int it = 0; it < kRowsPerWarp; ++it) {
    const int row = r0 + it * kWarps + warp;
    if (row >= p.r) break;
    const size_t base = (size_t)row * p.hd;
    const T* h = static_cast<const T*>(p.h) + base;
    const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
    const T* g = static_cast<const T*>(p.g) + base;
    const float mean = p.mean[row], rstd = p.rstd[row];
    const RowKey rk = DROP ? row_key(p.drop, row) : RowKey{0u, 0u};
    float xh[NV][V], gv[NV][V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        float z[V], w[V];
        load_vec<T>(z, h + j * V);
        if (p.lin_b) {
          float lb[V];
          load_f32<V>(lb, p.lin_b + j * V);
#pragma unroll
          for (int k = 0; k < V; ++k) z[k] += lb[k];
        }
        if (DROP) {
#pragma unroll
          for (int k = 0; k < V; ++k) z[k] = dropped(row_keep(p.drop, rk, j * V + k), z[k], p.drop);
        }
        if (res) {
          float rv[V];
          load_vec<T>(rv, res + j * V);
#pragma unroll
          for (int k = 0; k < V; ++k) z[k] += rv[k];
        }
        load_vec<T>(gv[i], g + j * V);
        load_f32<V>(w, p.w + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xh[i][k] = (z[k] - mean) * rstd;
          const float gw = gv[i][k] * w[k];
          s1 += gw;
          s2 += gw * xh[i][k];
        }
      }
    }
    const float c1 = warp_sum(s1) / p.hd, c2 = warp_sum(s2) / p.hd;
    T* dh = static_cast<T*>(p.dh) + base;
    T* dres = p.dres ? static_cast<T*>(p.dres) + base : nullptr;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        float w[V], dz[V], dhv[V];
        load_f32<V>(w, p.w + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          dz[k] = (gv[i][k] * w[k] - c1 - xh[i][k] * c2) * rstd;
          dhv[k] = DROP ? dropped(row_keep(p.drop, rk, j * V + k), dz[k], p.drop) : dz[k];
          acc_w[i][k] += gv[i][k] * xh[i][k];
          acc_b[i][k] += gv[i][k];
          acc_lb[i][k] += dhv[k];
        }
        store_vec<T>(dh + j * V, dhv);
        if (dres) store_vec<T>(dres + j * V, dz);
      }
    }
  }

  // the block's column sums: warps 0..7 in order, one accumulator at a time
  float* part = p.part + (size_t)blockIdx.x * p.nacc * p.hd;
  for (int a = 0; a < p.nacc; ++a) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          red[warp * p.hd + j * V + k] = a == 0 ? acc_w[i][k] : a == 1 ? acc_b[i][k] : acc_lb[i][k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.hd; c += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * p.hd + c];
      part[(size_t)a * p.hd + c] = s;
    }
    __syncthreads();
  }
}

// any H, any alignment: one warp per block owning 32 rows, two passes over
// each row in global memory; the column sums go straight to the block's
// partial row (its own, so no other block touches it), rows in order.
template <typename T, bool DROP>
__global__ void __launch_bounds__(32) ln_bwd_generic(Bwd p) {
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRowsPerPart;
  float* part = p.part + (size_t)blockIdx.x * p.nacc * p.hd;
  for (int it = 0; it < kRowsPerPart; ++it) {
    const int row = r0 + it;
    if (row >= p.r) break;
    const size_t base = (size_t)row * p.hd;
    const T* h = static_cast<const T*>(p.h) + base;
    const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
    const T* g = static_cast<const T*>(p.g) + base;
    const float mean = p.mean[row], rstd = p.rstd[row];
    const RowKey rk = DROP ? row_key(p.drop, row) : RowKey{0u, 0u};
    auto xhat = [&](int c) { return (z_at<T, DROP>(p, h, res, rk, c) - mean) * rstd; };
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < p.hd; c += 32) {
      const float gw = to_f(g[c]) * p.w[c];
      s1 += gw;
      s2 += gw * xhat(c);
    }
    const float c1 = warp_sum(s1) / p.hd, c2 = warp_sum(s2) / p.hd;
    T* dh = static_cast<T*>(p.dh) + base;
    T* dres = p.dres ? static_cast<T*>(p.dres) + base : nullptr;
    for (int c = lane; c < p.hd; c += 32) {
      const float gf = to_f(g[c]), xh = xhat(c);
      const float dz = (gf * p.w[c] - c1 - xh * c2) * rstd;
      const float dhv = DROP ? dropped(row_keep(p.drop, rk, c), dz, p.drop) : dz;
      dh[c] = from_f<T>(dhv);
      if (dres) dres[c] = from_f<T>(dz);
      const float v[3] = {gf * xh, gf, dhv};
      for (int a = 0; a < p.nacc; ++a) {
        float* q = part + (size_t)a * p.hd + c;
        *q = it == 0 ? v[a] : *q + v[a];
      }
    }
  }
}

// --------------------------------------------------------------------------
// backward, the persistent route
// --------------------------------------------------------------------------
//
// One block per partial row, gridDim.x of them (two an SM: the wrapper's
// ln_bwd_plan), block b owning the contiguous rows [b * rpb, min((b + 1) *
// rpb, R)), rpb = ceil(R / gridDim.x); warp w takes rows w, w + 8, ... of
// the run. Each lane copies its own 16-byte vectors of the warp's next row
// (h, res, g) into a two-stage ring in shared memory with cp.async while it
// computes the current row from the other stage (a vector is read only by
// the lane that copied it, so no barrier guards the ring); the next row's
// mean and rstd are read into registers a row ahead. The row is read twice
// from the ring (c1 and c2, then dz) instead of being held in registers. w
// and lin_b sit in shared memory for the block. The NACC column sums (dw,
// db (, dlin_b)) stay in registers across all of the block's rows, NV
// vectors a lane (NV = 3 at H 768 in bf16: no idle slots), and are added
// once, warps in order, into the block's partial row; sum_parts adds the
// partial rows in a fixed order. Dynamic shared memory: w, lin_b [H] f32,
// then the ring [8 warps][2][h, (res,) g][H], which the block's reduction
// reuses as [8][H] f32.
constexpr int kPersistBlocksPerSm = 2;

// two blocks an SM (at most 128 registers a thread) where the column sums
// take at most 72 registers a lane, else one
template <typename T, int NV, int NACC>
constexpr int persist_min_blocks() {
  return NV * Vec<T>::n * NACC <= 72 ? kPersistBlocksPerSm : 1;
}

template <typename T>
size_t persist_smem(int hd, bool res) {
  const size_t ring = (size_t)kWarps * 2 * (res ? 3 : 2) * hd * sizeof(T);
  const size_t red = (size_t)kWarps * hd * sizeof(float);
  return 2 * (size_t)hd * sizeof(float) + (ring > red ? ring : red);
}

// z = drop(h (+ lin_b)) (+ res) for one 16-byte vector j of a row; bit k
// of kbits keeps its element k
template <typename T, bool DROP>
__device__ __forceinline__ void z_vec(float* z, const Bwd& p, const T* sh, const T* sres,
                                      const float* lb_s, uint32_t kbits, int j) {
  constexpr int V = Vec<T>::n;
  load_vec<T>(z, sh + j * V);
  if (p.lin_b) {
    float lb[V];
    load_f32<V>(lb, lb_s + j * V);
#pragma unroll
    for (int k = 0; k < V; ++k) z[k] += lb[k];
  }
  if (DROP) {
#pragma unroll
    for (int k = 0; k < V; ++k) z[k] = dropped((kbits >> k) & 1u, z[k], p.drop);
  }
  if (sres) {
    float rv[V];
    load_vec<T>(rv, sres + j * V);
#pragma unroll
    for (int k = 0; k < V; ++k) z[k] += rv[k];
  }
}

template <typename T, int NV, int NACC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32, (persist_min_blocks<T, NV, NACC>())) ln_bwd_persist(Bwd p) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) float psm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd, nvec = hd / V;
  const int nin = p.res ? 3 : 2;  // h, (res,) g
  const size_t stage = (size_t)nin * hd;
  float* w_s = psm;
  float* lb_s = psm + hd;
  T* ring = reinterpret_cast<T*>(psm + 2 * hd) + (size_t)warp * 2 * stage;
  const int rpb = (p.r + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * rpb, r1 = min(r0 + rpb, p.r);
  const T* h = static_cast<const T*>(p.h);
  const T* res = static_cast<const T*>(p.res);
  const T* g = static_cast<const T*>(p.g);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    w_s[c] = p.w[c];
    if (p.lin_b) lb_s[c] = p.lin_b[c];
  }

  auto issue = [&](int row, int st) {
    if (row < r1) {
      T* dst = ring + st * stage;
      const size_t base = (size_t)row * hd;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = i * 32 + lane;
        if (j < nvec) {
          cp_async16(dst + j * V, h + base + j * V, true);
          if (res) cp_async16(dst + hd + j * V, res + base + j * V, true);
          cp_async16(dst + (nin - 1) * hd + j * V, g + base + j * V, true);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NACC][NV][V];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[a][i][k] = 0.f;

  int row = r0 + warp;
  issue(row, 0);
  float mean = row < r1 ? p.mean[row] : 0.f, rstd = row < r1 ? p.rstd[row] : 0.f;
  __syncthreads();  // w_s, lb_s
  for (int it = 0; row < r1; ++it, row += kWarps) {
    const int nrow = row + kWarps;
    issue(nrow, (it + 1) & 1);
    const float mean_n = nrow < r1 ? p.mean[nrow] : 0.f;
    const float rstd_n = nrow < r1 ? p.rstd[nrow] : 0.f;
    cp_async_wait<1>();  // this lane's vectors of `row`
    const T* sh = ring + (it & 1) * stage;
    const T* sres = p.res ? sh + hd : nullptr;
    const T* sg = sh + (nin - 1) * hd;
    float s1 = 0.f, s2 = 0.f;
    uint32_t keep = 0u;  // the row's keep bits, NV * V <= 32 of them: hashed once
    const RowKey rk = DROP ? row_key(p.drop, row) : RowKey{0u, 0u};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        uint32_t kbits = 0u;
        if (DROP) {
#pragma unroll
          for (int k = 0; k < V; ++k) kbits |= (uint32_t)row_keep(p.drop, rk, j * V + k) << k;
          keep |= kbits << (i * V);
        }
        float z[V], gv[V], w[V];
        z_vec<T, DROP>(z, p, sh, sres, lb_s, kbits, j);
        load_vec<T>(gv, sg + j * V);
        load_f32<V>(w, w_s + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (z[k] - mean) * rstd;
          const float gw = gv[k] * w[k];
          s1 += gw;
          s2 += gw * xh;
        }
      }
    }
    const float c1 = warp_sum(s1) / hd, c2 = warp_sum(s2) / hd;
    const size_t base = (size_t)row * hd;
    T* dh = static_cast<T*>(p.dh) + base;
    T* dres = p.dres ? static_cast<T*>(p.dres) + base : nullptr;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
        const uint32_t kbits = (keep >> (i * V)) & ((1u << V) - 1u);
        float z[V], gv[V], w[V], dz[V], dhv[V];
        z_vec<T, DROP>(z, p, sh, sres, lb_s, kbits, j);
        load_vec<T>(gv, sg + j * V);
        load_f32<V>(w, w_s + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (z[k] - mean) * rstd;
          dz[k] = (gv[k] * w[k] - c1 - xh * c2) * rstd;
          dhv[k] = DROP ? dropped((kbits >> k) & 1u, dz[k], p.drop) : dz[k];
          acc[0][i][k] += gv[k] * xh;
          acc[1][i][k] += gv[k];
          if (NACC == 3) acc[NACC - 1][i][k] += dhv[k];
        }
        store_vec<T>(dh + j * V, dhv);
        if (dres) store_vec<T>(dres + j * V, dz);
      }
    }
    mean = mean_n, rstd = rstd_n;
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the block's reduction reuses it

  // the block's column sums: warps 0..7 in order, one accumulator at a time
  float* red = psm + 2 * hd;
  float* part = p.part + (size_t)blockIdx.x * NACC * hd;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * 32 + lane;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k) red[warp * hd + j * V + k] = acc[a][i][k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < hd; c += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * hd + c];
      part[(size_t)a * hd + c] = s;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// vectors a lane needs (1, 2, 4 or 8), or 0 when the row is not a whole
// number of aligned 16-byte vectors or needs more than max_nv
template <typename T>
int pick_nv(int hd, int max_nv, bool aligned) {
  constexpr int V = Vec<T>::n;
  if (!aligned || hd % V) return 0;
  const int per_lane = (hd / V + 31) / 32;
  for (int nv = 1; nv <= max_nv; nv *= 2)
    if (per_lane <= nv) return nv;
  return 0;
}

// the dropout key: rows 0 (no dropout), or a row tile of positive rows
// over the whole row
inline bool drop_ok(const Drop& d, int hd) {
  return d.rows == 0 || (d.rows > 0 && d.cols == hd);
}

template <typename T, bool DROP>
void fwd_variant(const Fwd& p, int nv, cudaStream_t s) {
  const dim3 grid((p.r + kWarps - 1) / kWarps), block(kWarps * 32);
  switch (nv) {
    case 1: ln_fwd_vec<T, 1, DROP><<<grid, block, 0, s>>>(p); break;
    case 2: ln_fwd_vec<T, 2, DROP><<<grid, block, 0, s>>>(p); break;
    case 4: ln_fwd_vec<T, 4, DROP><<<grid, block, 0, s>>>(p); break;
    case 8: ln_fwd_vec<T, 8, DROP><<<grid, block, 0, s>>>(p); break;
    default: ln_fwd_generic<T, DROP><<<grid, block, 0, s>>>(p); break;
  }
}

template <typename T>
int launch_fwd(const Fwd& p, void* stream) {
  if (p.r < 1 || p.hd < 1 || !drop_ok(p.drop, p.hd)) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p.h) && (!p.res || aligned16(p.res)) && aligned16(p.y) &&
                       (!p.lin_b || aligned16(p.lin_b)) && aligned16(p.w) && aligned16(p.b);
  const int nv = pick_nv<T>(p.hd, kFwdMaxNV, aligned);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.drop.rows) {
    fwd_variant<T, true>(p, nv, s);
  } else {
    fwd_variant<T, false>(p, nv, s);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
void bwd_variant(const Bwd& p, int nv, int nparts, cudaStream_t s) {
  const size_t smem = (size_t)kWarps * p.hd * sizeof(float);
  const dim3 block(kWarps * 32);
  switch (nv) {
    case 1: ln_bwd_vec<T, 1, DROP><<<nparts, block, smem, s>>>(p); break;
    case 2: ln_bwd_vec<T, 2, DROP><<<nparts, block, smem, s>>>(p); break;
    case 4: ln_bwd_vec<T, 4, DROP><<<nparts, block, smem, s>>>(p); break;
    case 8: ln_bwd_vec<T, 8, DROP><<<nparts, block, smem, s>>>(p); break;
    default: ln_bwd_generic<T, DROP><<<nparts, 32, 0, s>>>(p); break;
  }
}

template <typename T>
int launch_bwd(const Bwd& p, float* sums, void* stream) {
  if (p.r < 1 || p.hd < 1 || p.nacc < 2 || p.nacc > 3 || !drop_ok(p.drop, p.hd))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p.h) && (!p.res || aligned16(p.res)) && aligned16(p.g) &&
                       aligned16(p.dh) && (!p.dres || aligned16(p.dres)) &&
                       (!p.lin_b || aligned16(p.lin_b)) && aligned16(p.w);
  const int nparts = (p.r + kRowsPerPart - 1) / kRowsPerPart;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = pick_nv<T>(p.hd, kBwdMaxElems / Vec<T>::n, aligned);
  if (p.drop.rows) {
    bwd_variant<T, true>(p, nv, nparts, s);
  } else {
    bwd_variant<T, false>(p, nv, nparts, s);
  }
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int cols = p.nacc * p.hd;
  return sum_parts(p.part, nparts, cols, sums, cols, nullptr, 8, s);
}

// the vectors a lane holds on the persistent route (1, 2, 3, 4, 6 or 8, at
// most 32 elements), or 0 when the row is not a whole number of aligned
// 16-byte vectors or does not fit
template <typename T>
int persist_nv(int hd, bool aligned) {
  constexpr int V = Vec<T>::n;
  if (!aligned || hd % V) return 0;
  const int per_lane = (hd / V + 31) / 32;
  for (int nv : {1, 2, 3, 4, 6, 8})
    if (per_lane <= nv) return nv * V <= kBwdMaxElems ? nv : 0;
  return 0;
}

template <typename T, int NV, int NACC, bool DROP>
int persist_run(const Bwd& p, int nparts, cudaStream_t s) {
  const size_t smem = persist_smem<T>(p.hd, p.res != nullptr);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ln_bwd_persist<T, NV, NACC, DROP>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  kernel<<<nparts, kWarps * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NACC, bool DROP>
int persist_nv_run(const Bwd& p, int nv, int nparts, cudaStream_t s) {
  switch (nv) {
    case 1: return persist_run<T, 1, NACC, DROP>(p, nparts, s);
    case 2: return persist_run<T, 2, NACC, DROP>(p, nparts, s);
    case 3: return persist_run<T, 3, NACC, DROP>(p, nparts, s);
    case 4: return persist_run<T, 4, NACC, DROP>(p, nparts, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {  // f32: 4 elements a vector
    if (nv == 6) return persist_run<T, 6, NACC, DROP>(p, nparts, s);
    if (nv == 8) return persist_run<T, 8, NACC, DROP>(p, nparts, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the persistent route: nparts blocks (and partial rows), then sum_parts
template <typename T>
int launch_bwd_persist(const Bwd& p, float* sums, int nparts, void* stream) {
  if (p.r < 1 || p.hd < 1 || p.nacc < 2 || p.nacc > 3 || !drop_ok(p.drop, p.hd) ||
      nparts < 1 || nparts > p.r)
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p.h) && (!p.res || aligned16(p.res)) && aligned16(p.g) &&
                       aligned16(p.dh) && (!p.dres || aligned16(p.dres));
  const int nv = persist_nv<T>(p.hd, aligned);
  if (nv == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (p.drop.rows) {
    rc = p.nacc == 3 ? persist_nv_run<T, 3, true>(p, nv, nparts, s)
                     : persist_nv_run<T, 2, true>(p, nv, nparts, s);
  } else {
    rc = p.nacc == 3 ? persist_nv_run<T, 3, false>(p, nv, nparts, s)
                     : persist_nv_run<T, 2, false>(p, nv, nparts, s);
  }
  if (rc) return rc;
  const int cols = p.nacc * p.hd;
  return sum_parts(p.part, nparts, cols, sums, cols, nullptr, 8, s);
}

// ==========================================================================
// Fused BatchNorm-train with the residual + ReLU epilogue (TPU kernels
// 15-18)
// ==========================================================================
//
// The generic route of both directions (the op takes bnf's cluster forward
// and bnb's persistent backward, below; these kernels serve in-call
// comparisons). Replaces the TPU kernels of paddle_tpu/kernels/norm_fusion.py:
//   _bn_stats_kernel :403      (launched by _bn_fwd :521)  -> bn_reduce<FWD>
//                                                             + sum_parts + bn_fold_fwd
//   _bn_apply_kernel :428      (_bn_fwd :542)              -> bn_apply<FWD>
//   _bn_bwd_reduce_kernel :455 (_make_fused_bn :567)       -> bn_reduce<BWD>
//                                                             + sum_parts + bn_fold_bwd
//   _bn_bwd_apply_kernel :487  (:594)                      -> bn_apply<BWD>
// all entered through fused_batch_norm_train :658 (the custom_vjp of :608).
// x, res, g [N, C, HW] contiguous (NCHW with the spatial dims flattened),
// float32 or bfloat16 (one dtype), C % 8 == 0 (bn_block_c's eligibility rule,
// :639-640); w, b [C] come in as f32, or as bf16 where AMP cast them
// (ChanVec: read as f32 where used, no conversion launch; dw and db leave
// as the f32 sums, which the op casts to w's and b's dtypes).
//
//   forward:  per channel s1 = sum x, s2 = sum x^2 in f32 over the M = N * HW
//             elements; mean = s1 * (1/M), the biased one-pass variance
//             var = max(s2 * (1/M) - mean^2, 0) as the reference computes it
//             (:419-424, clamped: the cancellation can dip below 0);
//             rstd = rsqrt(var + eps), a = w * rstd, b' = b - mean * a (:536-537);
//             y = round(relu?(x * a + b' (+ res))). mean and var [C] f32 are
//             outputs (the running statistics' update reads them).
//   backward: the ReLU gate recomputed from the same a, b' and the same f32
//             expression as the forward (bn_fold_ab, bn_pre: no contraction
//             into fma, so the gate agrees bit for bit with the forward's
//             max(pre, 0)); g' = g * [pre > 0]; x^ = (x - mean) * rstd;
//             per channel sg = sum g', sgx = sum g' x^ (dgamma = sgx,
//             dbeta = sg); with the cotangents of the mean and var outputs
//             (zero when absent) folded in as :576-581 does:
//             k1 = sg / M, k2 = sgx / M, p2 = 2 gvar / M - a k2 rstd,
//             p3 = gmean / M - a k1 - mean p2;
//             dx = round(a g' + x p2 + p3), dres = round(g').
//
// Bound: bytes. At resnet50's training shapes (B = 256, 224^2, bf16) the 53
// BatchNorms of a step move 14.2 GB forward (x, res read, y written) and
// 22.7 GB backward (x, g, res read, dx, dres written): 4.24 ms and 6.78 ms
// at 3.35 TB/s, against ~10 flops an element on the CUDA cores.
//
// Design (no TPU artifacts: no [C, 128] lane-broadcast vectors, no channel
// block picks against a VMEM target):
//   - the TPU splits each direction into two kernels because a Pallas output
//     block cannot be revisited; here each direction is a reduction pass,
//     common.cuh's fixed-order sum_parts, a one-thread-per-channel fold and
//     an elementwise apply pass: 4 launches a call;
//   - the reduction runs on a grid (parts, C): block (q, c) sums the planes
//     n in [q * P, (q + 1) * P) of channel c, P = ceil(16384 / HW) planes
//     (at least one), so the stem's BN (C = 64, HW = 12544) has 8192 blocks
//     and layer 4's (C = 2048, HW = 49) 2048. The block writes one f32
//     partial per channel and statistic; sum_parts adds the parts in a fixed
//     order. The split depends on the shape alone and nothing uses atomics:
//     every call gives the same bits;
//   - every byte is read as part of a 16-byte vector. When HW is a whole
//     number of vectors (HW % 8 == 0 in bf16, % 4 in f32: 12544, 3136, 784)
//     a vector lies in one plane. Otherwise (HW = 196 and 49 in bf16, 49 in
//     f32: 28 of resnet50's 53 BNs) a plane starts and ends inside vectors:
//     the reduction reads the aligned vectors that cover the plane and masks
//     the neighbouring planes' elements; the apply pass, which needs no
//     grouping by channel, walks the whole tensor as vectors and steps the
//     channel index where a vector crosses a plane boundary (C % 8 == 0
//     makes N * C * HW a whole number of vectors, so no vector runs past the
//     end of the tensor);
//   - the per-channel fold is a tiny kernel (a, b' forward; a, b', p2, p3
//     backward); the backward's reduction recomputes a and b' for its own
//     channel with the same bn_fold_ab, from the saved mean and var.

// A BatchNorm's per-channel weight or bias as the op hands it over: float32,
// or bfloat16 where AMP cast it (the white op at O2); read as f32 where it
// is used, one element a channel, so a bf16 vector costs no conversion
// launch.
struct ChanVec {
  const void* p;
  int bf16;
  __device__ __forceinline__ float operator[](int c) const {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
                : static_cast<const float*>(p)[c];
  }
};

namespace bn {

constexpr int kThreads = 256;
constexpr int kTarget = 16384;   // elements a reduction block sums, at least one plane
enum { FWD = 0, BWD = 1 };

struct Args {
  const void* x;
  const void* res;     // null: no residual
  const void* g;       // backward
  ChanVec w;           // [C] f32 or bf16
  ChanVec b;
  float* mean;         // forward: sum_parts writes s1 here, the fold the mean
  float* var;          // forward: s2, then the variance; backward: read
  const float* gmean;  // backward, null: zero cotangent
  const float* gvar;
  float* s1;           // the statistics' sums: forward mean/var, backward db (sum g'),
  float* s2;           //   dw (sum g' x^)
  void* y;             // forward
  void* dx;            // backward
  void* dres;          // backward, null without a residual
  float* part;         // [nparts, 2, C]
  float* coef;         // forward [2, C]: a, b'; backward [4, C]: a, b', p2, p3
  long long m;         // N * HW
  int n, c, hw, ppp;   // ppp: planes of one channel per reduction block
  int relu;
  float eps;
};

// rstd, a = w rstd and b' = b - mean a: the forward's fold, recomputed bit
// for bit by the backward (the ReLU gate depends on it)
__device__ __forceinline__ void fold_ab(float w, float b, float mean, float var, float eps,
                                        float& rstd, float& a, float& bb) {
  rstd = rsqrtf(__fadd_rn(var, eps));
  a = __fmul_rn(w, rstd);
  bb = __fsub_rn(b, __fmul_rn(mean, a));
}

// the pre-activation x a + b' (+ res), one expression for both directions
__device__ __forceinline__ float pre_act(float x, float a, float bb, bool has_res, float r) {
  const float p = __fadd_rn(__fmul_rn(x, a), bb);
  return has_res ? __fadd_rn(p, r) : p;
}

// a vector of the residual, or zeros without one (then unused)
template <typename T>
__device__ __forceinline__ void load_res(float* dst, const T* res, long long e0) {
  if (res) {
    load_vec<T>(dst, res + e0);
  } else {
#pragma unroll
    for (int k = 0; k < Vec<T>::n; ++k) dst[k] = 0.f;
  }
}

// grid (nparts, C); see the design note. ALIGNED: HW % V == 0.
template <typename T, bool ALIGNED, int MODE>
__global__ void __launch_bounds__(kThreads) bn_reduce(Args p) {
  constexpr int V = Vec<T>::n;
  const int c = blockIdx.y, q = blockIdx.x;
  const int n0 = q * p.ppp, n1 = min(p.n, n0 + p.ppp);
  const int per_plane = ALIGNED ? p.hw / V : (p.hw + V - 1) / V + 1;  // the widest cover
  const int count = (n1 - n0) * per_plane;
  const T* x = static_cast<const T*>(p.x);
  const T* res = static_cast<const T*>(p.res);
  const T* g = static_cast<const T*>(p.g);
  float a = 0.f, bb = 0.f, mean = 0.f, rstd = 0.f;
  if (MODE == BWD) {
    mean = p.mean[c];
    fold_ab(p.w[c], p.b[c], mean, p.var[c], p.eps, rstd, a, bb);
  }
  float s1 = 0.f, s2 = 0.f;
  for (int idx = threadIdx.x; idx < count; idx += kThreads) {
    const int pl = idx / per_plane, j = idx - pl * per_plane;
    const long long s = ((long long)(n0 + pl) * p.c + c) * p.hw;  // the plane's first element
    const long long e0 = (s / V + j) * V;                          // the vector's
    int lo = 0, hi = V;
    if (!ALIGNED) {
      if (e0 >= s + p.hw) continue;
      lo = (int)max(0LL, s - e0);
      hi = (int)min((long long)V, s + p.hw - e0);
    }
    float xv[V];
    load_vec<T>(xv, x + e0);
    if (MODE == FWD) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (ALIGNED || (k >= lo && k < hi)) {
          s1 += xv[k];
          s2 += xv[k] * xv[k];
        }
      }
    } else {
      float gv[V], rv[V];
      load_vec<T>(gv, g + e0);
      load_res<T>(rv, res, e0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (ALIGNED || (k >= lo && k < hi)) {
          float gk = gv[k];
          if (p.relu && !(pre_act(xv[k], a, bb, res != nullptr, rv[k]) > 0.f)) gk = 0.f;
          s1 += gk;
          s2 += gk * ((xv[k] - mean) * rstd);
        }
      }
    }
  }
  __shared__ float red[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) red[0][warp] = s1, red[1][warp] = s2;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t1 += red[0][w], t2 += red[1][w];
    float* out = p.part + (size_t)q * 2 * p.c;
    out[c] = t1;
    out[p.c + c] = t2;
  }
}

// one thread a channel: mean, var, a, b' from the sums (s1, s2 alias mean, var)
__global__ void bn_fold_fwd(Args p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.c) return;
  const float inv_m = (float)(1.0 / (double)p.m);
  const float mean = __fmul_rn(p.s1[c], inv_m);
  const float var = fmaxf(__fsub_rn(__fmul_rn(p.s2[c], inv_m), __fmul_rn(mean, mean)), 0.f);
  p.mean[c] = mean;
  p.var[c] = var;
  float rstd, a, bb;
  fold_ab(p.w[c], p.b[c], mean, var, p.eps, rstd, a, bb);
  p.coef[c] = a;
  p.coef[p.c + c] = bb;
}

// a, b', p2, p3 of one channel from sg = sum g', sgx = sum g' x^, the
// elements m = N * HW and the cotangents gm, gv of the mean and var outputs
// (:576-581); both backward routes fold with it
__device__ __forceinline__ void fold_bwd(float w, float b, float mean, float var, float eps,
                                         float mf, float sg, float sgx, float gm, float gv,
                                         float& a, float& bb, float& p2, float& p3) {
  float rstd;
  fold_ab(w, b, mean, var, eps, rstd, a, bb);
  const float k1 = __fdiv_rn(sg, mf), k2 = __fdiv_rn(sgx, mf);
  p2 = __fsub_rn(__fdiv_rn(__fmul_rn(2.f, gv), mf), __fmul_rn(__fmul_rn(a, k2), rstd));
  p3 = __fsub_rn(__fsub_rn(__fdiv_rn(gm, mf), __fmul_rn(a, k1)), __fmul_rn(mean, p2));
}

// one thread a channel: a, b', p2, p3 from sg (s1), sgx (s2) and the
// cotangents of the mean and var outputs
__global__ void bn_fold_bwd(Args p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.c) return;
  float a, bb, p2, p3;
  fold_bwd(p.w[c], p.b[c], p.mean[c], p.var[c], p.eps, (float)p.m, p.s1[c], p.s2[c],
           p.gmean ? p.gmean[c] : 0.f, p.gvar ? p.gvar[c] : 0.f, a, bb, p2, p3);
  p.coef[c] = a;
  p.coef[p.c + c] = bb;
  p.coef[2 * p.c + c] = p2;
  p.coef[3 * p.c + c] = p3;
}

// the whole tensor as 16-byte vectors, grid-stride; the channel of each
// element from the flat index (stepped inside a vector when !ALIGNED)
template <typename T, bool ALIGNED, int MODE>
__global__ void __launch_bounds__(kThreads) bn_apply(Args p, long long nvec) {
  constexpr int V = Vec<T>::n;
  const T* x = static_cast<const T*>(p.x);
  const T* res = static_cast<const T*>(p.res);
  const T* g = static_cast<const T*>(p.g);
  const float* coef = p.coef;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * kThreads) {
    const long long i0 = v * V;
    const long long plane = i0 / p.hw;
    int e = (int)(i0 - plane * p.hw);
    int c = (int)(plane % p.c);
    float xv[V], rv[V], gv[V], o[V], o2[V];
    load_vec<T>(xv, x + i0);
    load_res<T>(rv, res, i0);
    if (MODE == BWD) load_vec<T>(gv, g + i0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!ALIGNED && k > 0 && ++e == p.hw) {
        e = 0;
        if (++c == p.c) c = 0;
      }
      const float a = __ldg(coef + c), bb = __ldg(coef + p.c + c);
      const float pre = pre_act(xv[k], a, bb, res != nullptr, rv[k]);
      if (MODE == FWD) {
        o[k] = p.relu ? fmaxf(pre, 0.f) : pre;
      } else {
        const float gk = (p.relu && !(pre > 0.f)) ? 0.f : gv[k];
        const float p2 = __ldg(coef + 2 * p.c + c), p3 = __ldg(coef + 3 * p.c + c);
        o[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, gk), __fmul_rn(xv[k], p2)), p3);
        o2[k] = gk;
      }
    }
    if (MODE == FWD) {
      store_vec<T>(static_cast<T*>(p.y) + i0, o);
    } else {
      store_vec<T>(static_cast<T*>(p.dx) + i0, o);
      if (p.dres) store_vec<T>(static_cast<T*>(p.dres) + i0, o2);
    }
  }
}

inline int planes_per_part(int n, int hw) {
  const long long pp = (kTarget + (long long)hw - 1) / hw;
  return (int)(pp < n ? pp : n);
}

inline int nparts(int n, int hw) {
  const int pp = planes_per_part(n, hw);
  return (n + pp - 1) / pp;
}

inline int check(const Args& p, std::initializer_list<const void*> rows) {
  if (p.n < 1 || p.c < 8 || p.c % 8 || p.hw < 1 || p.c > 65535) return (int)cudaErrorInvalidValue;
  for (const void* r : rows)
    if (r && !aligned16(r)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <typename T, int MODE>
int run(Args p, cudaStream_t s) {
  constexpr int V = Vec<T>::n;
  p.ppp = planes_per_part(p.n, p.hw);
  p.m = (long long)p.n * p.hw;
  const int parts = nparts(p.n, p.hw);
  const bool aligned = p.hw % V == 0;
  const dim3 rgrid(parts, p.c);
  if (aligned) {
    bn_reduce<T, true, MODE><<<rgrid, kThreads, 0, s>>>(p);
  } else {
    bn_reduce<T, false, MODE><<<rgrid, kThreads, 0, s>>>(p);
  }
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = sum_parts(p.part, parts, 2 * p.c, p.s1, p.c, p.s2, 8, s);
  if (rc) return rc;
  const int fblocks = (p.c + kThreads - 1) / kThreads;
  if (MODE == FWD) {
    bn_fold_fwd<<<fblocks, kThreads, 0, s>>>(p);
  } else {
    bn_fold_bwd<<<fblocks, kThreads, 0, s>>>(p);
  }
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long nvec = (long long)p.n * p.c * p.hw / V;
  const long long want = (nvec + kThreads - 1) / kThreads;
  const unsigned agrid = (unsigned)(want < 8192 ? want : 8192);
  if (aligned) {
    bn_apply<T, true, MODE><<<agrid, kThreads, 0, s>>>(p, nvec);
  } else {
    bn_apply<T, false, MODE><<<agrid, kThreads, 0, s>>>(p, nvec);
  }
  return (int)cudaGetLastError();
}

}  // namespace bn

// ==========================================================================
// The BatchNorm backward's persistent route (TPU kernels 17, 18)
// ==========================================================================
//
// Replaces, as bn::run<.., BWD> above does (which stays as the generic
// route, reached only by an explicit route="generic" in
// norm_fusion._bn_bwd_cuda for in-call comparisons), the TPU kernels
//   _bn_bwd_reduce_kernel :455 and _bn_bwd_apply_kernel :487 of
//   paddle_tpu/kernels/norm_fusion.py, entered through _make_fused_bn
//   :553-606,
// with bn's arithmetic: fold_ab and pre_act (the ReLU gate agrees with the
// forward's bit for bit), fold_bwd, dx = round(a g' + x p2 + p3), dres =
// round(g').
//
// Bound: bytes. x, g (and the residual where the ReLU gate reads it) read
// once, dx (and dres) written once: 5 tensor passes at resnet50's
// layer1.bn3, 3 at the stems. bn::run reads every input twice (its
// reduction, then its apply: 8 passes against 5, and 5 against 3) in 4
// launches, so no tuning of it passes ~60% of the bound.
//
// Design: one cooperative launch of P = kBlocksPerSm x SMs blocks, all
// resident, in kTeams teams; team t takes groups t, t + kTeams, ...
// (norm_fusion.bn_bwd_plan reckons the same plan in Python). The
// constants after kBatch fix the design; scripts/bn_bwd_variants.py times
// copies of this file with them changed:
//   - groups: consecutive channels, cg a group (at most kMaxGroupC). A
//     block's share of a group is one shared-memory slot and kL2Bytes /
//     (the team's blocks) more that it reads past the slot, from device
//     memory in the reduction (L2 evict_last hint) and again in the apply;
//     cg is the largest whose every tile fits that share. A group starts
//     at a multiple of V / gcd(HW, V) channels (8 in bf16 at HW 49, 2 at
//     196, 1 where HW is whole vectors), so every (image, group) row is
//     contiguous and starts on a 16-byte boundary. In shared memory alone
//     (two blocks an SM, two slots of 54656 bytes a block: ~14.4 MB a
//     group) layer1.bn3 [256, 256, 3136] bf16 with residual and ReLU takes
//     2 channels a group, 128 groups; resnet50's stem [256, 64, 12544] 1,
//     64; ppyoloe-l's stem [8, 32, 102400] f32 2, 16; layer4.bn3 [256,
//     2048, 49] 184, 12. The route (kL2Bytes, 24 MB a group past the
//     slots, two teams) takes 6 (43 groups), 2 (32),
//     4 (8), 256 (8): a quarter of each tile goes through the slots and the
//     rest is read twice (the apply's time says the hint does not keep it
//     in L2); fewer, larger groups were faster all the same
//     (scripts/bn_bwd_variants.py, PERF.md §6).
//   - tiles: a group is N rows of Lv = cg HW / V vectors, cut into a grid of
//     th images by tw vectors (tiles(): the smallest tile whose rows span at
//     least kMinSpan vectors where the group's rows do, then the fewest
//     image slices); block b of a team takes tile b, blocks past the grid
//     sit the group out.
//   - reduce: warp 0's lanes bulk-copy the first `cap` vectors of the
//     tile's rows of x, g (and res) into the group's slot, completing on
//     the slot's mbarrier. Where HW is whole vectors and the tile holds at
//     most two channels (reduce2: the stems, layer 1, ppyoloe) the block
//     takes the tile's vectors in order with both channels' coefficients
//     in registers; otherwise the warps split the channels (teams of 8, 4,
//     2 or 1 warps a channel as the tile holds 1, 2-3, 4-7 or 8+). Each
//     thread keeps kBatch vectors' loads in flight, sums g' and g' x^ in
//     f32, the warps' sums are added in order, and the block writes its
//     partials [2, cg] for its channels; thread 0 then adds one to the
//     group's counter (acq_rel). No float atomics anywhere.
//   - fold: the block that brings the counter to the group's tile count
//     adds, for each statistic and channel, the partials of the tiles that
//     hold the channel in tile order, in `runs` contiguous runs that a
//     warp adds as a butterfly (a fixed order): the same bits on every
//     call. It writes a, b', p2, p3 (fold_bwd), dw and db, then sets the
//     group's flag (release).
//   - lag: a block has kLag + 1 slots. Its group i + kLag + 1's loads go
//     into group i's slot as soon as group i is applied, so while it
//     reduces and waits (acquire) for a fold the next kLag groups' loads are in
//     flight. It then applies the group from the slot (and past it from
//     device memory), storing dx and dres streaming (st.global.cs).
//   - a tile larger than its share (one channel unit over the budget: cg is
//     one unit) reads past it the same way: slower, never wrong. The
//     L2-only design (kL2Only) takes that path for every tile.
//   - the counters and flags ([2, G] at the end of the scratch) are zeroed
//     by a memset before the launch: 1 kernel launch and 1 memset a call. A
//     flag wait traps after kHangCycles instead of hanging the card.
// Measured (PERF.md §6, H100): the per-group synchronisation (~5 us), the
// apply's writes and the second read of the bytes past the slots keep it
// from its bound; at resnet50's shapes it is slower than bn::run.

namespace bnb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemPerSm = 233472;   // an SM's shared memory on sm_90
constexpr int kBlockReserve = 1024;  // the runtime's share of each resident block
constexpr int kScratch = 6400;       // a block's sums, coefficients, barriers
constexpr int kMaxGroupC = 256;      // channels a group holds at most
constexpr int kMinSpan = 64;         // vectors a tile's rows span at least
constexpr int kBatch = 2;            // vectors a thread loads before it computes
// the route's design (scripts/bn_bwd_variants.py times copies of this file
// with these changed)
constexpr int kBlocksPerSm = 2;      // the grid: blocks an SM, all resident
constexpr int kTeams = 2;            // teams of blocks taking every other group
constexpr int kLag = 1;              // groups loaded ahead of the one reduced: kLag + 1 slots
constexpr bool kL2Only = false;      // no slots: every vector from device memory
constexpr int kL2Bytes = 24000000;   // a group's bytes past the slots, read twice
// one slot: a block's share of the SM's shared memory, less the runtime's
// reserve and the scratch, over the slots, in whole 128 bytes
constexpr int kSlotBytes =
    kL2Only ? 0 : (kSmemPerSm / kBlocksPerSm - kBlockReserve - kScratch) / (kLag + 1) / 128 * 128;
static_assert(!kL2Only || kLag == 1, "the L2-only design holds no slots to lag");

struct Args {
  const void* x;
  const void* res;     // null: no residual
  const void* g;
  ChanVec w;           // [C] f32 or bf16
  ChanVec b;
  const float* mean;
  const float* var;
  const float* gmean;  // null: zero cotangent
  const float* gvar;
  void* dx;
  void* dres;          // null without a residual
  float* coef;         // [4, C]: a, b', p2, p3
  float* dw;           // [C] sum g' x^
  float* db;           // [C] sum g'
  void* dw16;          // [C] bf16: dw and db rounded once, for bf16 w and b
  void* db16;          //   (AMP's O2 casts); null: none
  float* part;         // the group at c0: [P, 2, cn] from c0 * 2P
  unsigned* cnt;       // [G] arrivals, then [G] flags
  long long m;         // N * HW
  int n, c, hw, relu;
  int gate_res;        // the ReLU gate reads the residual: x, g and res in the slot
  int groups, cg, th, tw, cg_last, th_last, tw_last;
  int cap;             // vectors of one tensor a slot holds
  int skip;            // a planted fault: every fold leaves out this tile (-1: none)
  float eps;
};

struct Group {
  int c0, cn, lv, th, tw, cols, tiles;
};

struct Tile {
  int rows;            // 0: the block sits the group out
  int id, n0, v0, w, fit, ch_lo, nch;
};

__device__ __forceinline__ Group group_of(const Args& p, int j, int V) {
  const bool last = j == p.groups - 1;
  Group gr;
  gr.c0 = j * p.cg;
  gr.cn = last ? p.cg_last : p.cg;
  gr.lv = (int)((long long)gr.cn * p.hw / V);
  gr.th = last ? p.th_last : p.th;
  gr.tw = last ? p.tw_last : p.tw;
  gr.cols = (gr.lv + gr.tw - 1) / gr.tw;
  gr.tiles = (p.n + gr.th - 1) / gr.th * gr.cols;
  return gr;
}

__device__ __forceinline__ Tile tile_of(const Args& p, const Group& gr, int b, int V) {
  Tile t{};
  if (b >= gr.tiles) return t;
  const int i = b / gr.cols, jc = b - i * gr.cols;
  t.id = b;
  t.n0 = i * gr.th;
  t.rows = min(gr.th, p.n - t.n0);
  t.v0 = jc * gr.tw;
  t.w = min(gr.tw, gr.lv - t.v0);
  t.fit = kL2Only ? 0 : min(t.rows * t.w, p.cap);
  t.ch_lo = (int)((long long)t.v0 * V / p.hw);
  t.nch = (int)(((long long)(t.v0 + t.w) * V - 1) / p.hw) - t.ch_lo + 1;
  return t;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint4 ld_hint(const void* p, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ void wait_flag(const unsigned* f) {
  if (ld_acquire(f)) return;
  const long long t0 = clock64();
  while (!ld_acquire(f))
    if (clock64() - t0 > kHangCycles) __trap();
}

template <typename T>
__device__ __forceinline__ void unpack(float* dst, uint4 raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) dst[k] = to_f(e[k]);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* src) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) e[k] = from_f<T>(src[k]);
  return raw;
}

// vector q of the tile from tensor i (0 x, 1 g, 2 res): the slot's copy, or
// device memory at element e past the slot
template <typename T>
__device__ __forceinline__ uint4 fetch(const uint4* slot, int cap, int i, int q, int fit,
                                       const void* base, long long e, uint64_t pol) {
  if (q < fit) return slot[(size_t)i * cap + q];
  return ld_hint(static_cast<const T*>(base) + e, pol);
}

// the tile row r's first element in the [N, C, HW] tensors
__device__ __forceinline__ long long row_elem(const Args& p, const Group& gr, const Tile& t,
                                              int r, int V) {
  return ((long long)(t.n0 + r) * p.c + gr.c0) * p.hw + (long long)t.v0 * V;
}

// warp 0: the tile's first `fit` vectors of x, g (and res) into the slot,
// a row a lane, completing on bar
template <typename T>
__device__ __forceinline__ void issue(const Args& p, const Group& gr, const Tile& t, uint4* slot,
                                      uint64_t* bar) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31, k = p.gate_res ? 3 : 2;
  if (lane == 0) {
    fence_proxy_async();
    mbar_arrive_tx(bar, (uint32_t)t.fit * 16u * (uint32_t)k);
  }
  __syncwarp();
  const void* src[3] = {p.x, p.g, p.res};
  for (int r = lane; r < t.rows; r += 32) {
    const int q0 = r * t.w;
    if (q0 >= t.fit) break;
    const uint32_t bytes = (uint32_t)min(t.w, t.fit - q0) * 16u;
    const long long e = row_elem(p, gr, t, r, V);
    for (int i = 0; i < k; ++i)
      bulk_load(slot + (size_t)i * p.cap + q0, static_cast<const T*>(src[i]) + e, bytes, bar);
  }
}

// the tile's partial sums of g' and g' x^ for each of its channels, into
// the group's part rows
template <typename T>
__device__ void reduce(const Args& p, const Group& gr, const Tile& t, const uint4* slot,
                       float* red, uint64_t keep) {
  constexpr int V = Vec<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int teams = t.nch >= 8 ? 8 : t.nch >= 4 ? 4 : t.nch >= 2 ? 2 : 1;
  const int W = kWarps / teams, team = warp / W, wi = warp - team * W;
  for (int tc = team; tc < t.nch; tc += teams) {
    const int cl = t.ch_lo + tc, c = gr.c0 + cl;
    const float mean = p.mean[c];
    float rstd, a, bb;
    bn::fold_ab(p.w[c], p.b[c], mean, p.var[c], p.eps, rstd, a, bb);
    // the channel's row elements [lo, hi) inside the tile, and their vectors
    const int lo = max(cl * p.hw, t.v0 * V), hi = min((cl + 1) * p.hw, (t.v0 + t.w) * V);
    const int vlo = lo / V, nv = (hi + V - 1) / V - vlo;
    // (r, cc): row and vector of the channel this lane reads, stepped by the
    // team's lanes without a division; kBatch vectors' loads in flight
    const int step = W * 32, dr = step / nv, dc = step - dr * nv;
    int r = (wi * 32 + lane) / nv, cc = wi * 32 + lane - r * nv;
    float s1 = 0.f, s2 = 0.f;
    while (r < t.rows) {
      int qs[kBatch], e0s[kBatch];
      long long es[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ok[u] = r < t.rows;
        const int vv = vlo + cc;
        qs[u] = r * t.w + (vv - t.v0);
        e0s[u] = vv * V;
        es[u] = ((long long)(t.n0 + r) * p.c + gr.c0) * p.hw + (long long)vv * V;
        r += dr;
        cc += dc;
        if (cc >= nv) {
          cc -= nv;
          ++r;
        }
      }
      uint4 xr[kBatch], gq[kBatch], rq[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;
        xr[u] = fetch<T>(slot, p.cap, 0, qs[u], t.fit, p.x, es[u], keep);
        gq[u] = fetch<T>(slot, p.cap, 1, qs[u], t.fit, p.g, es[u], keep);
        if (p.gate_res) rq[u] = fetch<T>(slot, p.cap, 2, qs[u], t.fit, p.res, es[u], keep);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;
        float xv[V], gv[V], rv[V];
        unpack<T>(xv, xr[u]);
        unpack<T>(gv, gq[u]);
        if (p.gate_res) {
          unpack<T>(rv, rq[u]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) rv[k] = 0.f;
        }
        const int e0 = e0s[u];
        const bool whole = e0 >= lo && e0 + V <= hi;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (whole || (e0 + k >= lo && e0 + k < hi)) {
            float gk = gv[k];
            if (p.relu && !(bn::pre_act(xv[k], a, bb, p.gate_res, rv[k]) > 0.f)) gk = 0.f;
            s1 += gk;
            s2 += gk * ((xv[k] - mean) * rstd);
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[tc * W + wi] = s1;
      red[kMaxGroupC + tc * W + wi] = s2;
    }
  }
  __syncthreads();
  float* out = p.part + (size_t)gr.c0 * 2 * gridDim.x + (size_t)t.id * 2 * gr.cn;
  for (int tc = threadIdx.x; tc < t.nch; tc += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < W; ++i) {
      t1 += red[tc * W + i];
      t2 += red[kMaxGroupC + tc * W + i];
    }
    out[t.ch_lo + tc] = t1;
    out[gr.cn + t.ch_lo + tc] = t2;
  }
}

// reduce's fast path, for HW a whole number of vectors and a tile of at
// most two channels (the stems' and layer 1's): every vector lies in one
// channel, the two channels' coefficients sit in registers, the block's
// threads take the tile's vectors in order; the sums per thread, then per
// warp, then the warps in order
template <typename T>
__device__ void reduce2(const Args& p, const Group& gr, const Tile& t, const uint4* slot,
                        float* red, uint64_t keep) {
  constexpr int V = Vec<T>::n;
  const int b1 = (t.ch_lo + 1) * (p.hw / V) - t.v0;  // the second channel's first column
  float mean[2], rstd[2], a[2], bb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = gr.c0 + t.ch_lo + min(i, t.nch - 1);
    mean[i] = p.mean[c];
    bn::fold_ab(p.w[c], p.b[c], mean[i], p.var[c], p.eps, rstd[i], a[i], bb[i]);
  }
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  const int dr = kThreads / t.w, dc = kThreads - dr * t.w;
  int r = threadIdx.x / t.w, col = threadIdx.x - r * t.w;
  while (r < t.rows) {
    int qs[kBatch], cols[kBatch];
    long long es[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ok[u] = r < t.rows;
      qs[u] = r * t.w + col;
      cols[u] = col;
      es[u] = ((long long)(t.n0 + r) * p.c + gr.c0) * p.hw + (long long)(t.v0 + col) * V;
      r += dr;
      col += dc;
      if (col >= t.w) {
        col -= t.w;
        ++r;
      }
    }
    uint4 xr[kBatch], gq[kBatch], rq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      xr[u] = fetch<T>(slot, p.cap, 0, qs[u], t.fit, p.x, es[u], keep);
      gq[u] = fetch<T>(slot, p.cap, 1, qs[u], t.fit, p.g, es[u], keep);
      if (p.gate_res) rq[u] = fetch<T>(slot, p.cap, 2, qs[u], t.fit, p.res, es[u], keep);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      float xv[V], gv[V], rv[V];
      unpack<T>(xv, xr[u]);
      unpack<T>(gv, gq[u]);
      if (p.gate_res) {
        unpack<T>(rv, rq[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) rv[k] = 0.f;
      }
      const bool second = cols[u] >= b1;
      const float m = second ? mean[1] : mean[0], rs = second ? rstd[1] : rstd[0];
      const float ai = second ? a[1] : a[0], bi = second ? bb[1] : bb[0];
      float v1 = 0.f, v2 = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float gk = gv[k];
        if (p.relu && !(bn::pre_act(xv[k], ai, bi, p.gate_res, rv[k]) > 0.f)) gk = 0.f;
        v1 += gk;
        v2 += gk * ((xv[k] - m) * rs);
      }
      if (second) {
        s1[1] += v1;
        s2[1] += v2;
      } else {
        s1[0] += v1;
        s2[0] += v2;
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s1[i] = warp_sum(s1[i]);
    s2[i] = warp_sum(s2[i]);
    if (lane == 0) {
      red[i * kWarps + warp] = s1[i];
      red[(2 + i) * kWarps + warp] = s2[i];
    }
  }
  __syncthreads();
  float* out = p.part + (size_t)gr.c0 * 2 * gridDim.x + (size_t)t.id * 2 * gr.cn;
  if (threadIdx.x < 2 * t.nch) {  // (statistic, channel)
    const int st = threadIdx.x / t.nch, i = threadIdx.x - st * t.nch;
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[(2 * st + i) * kWarps + w];
    out[st * gr.cn + t.ch_lo + i] = tot;
  }
}

// the runs a statistic of a channel is folded in: a power of two, at most
// a warp, that keeps 2 cn x runs within the block (1 at 2 cn >= kThreads)
__device__ __forceinline__ int fold_runs(int items) {
  if (items >= kThreads) return 1;
  const int r = min(32, kThreads / items);
  return 1 << (31 - __clz(r));
}

// the sum of item (statistic s, channel cl)'s partials in run sp of
// `runs`: the tiles holding the channel in tile order, 8 loads in flight
__device__ __forceinline__ float fold_run(const Args& p, const Group& gr, const float* part,
                                          int V, int s, int cl, int sp, int runs) {
  const int rows = (p.n + gr.th - 1) / gr.th;
  const int vhi = ((cl + 1) * p.hw + V - 1) / V - 1;  // the channel's last vector
  const int jlo = cl * p.hw / V / gr.tw, nj = vhi / gr.tw - jlo + 1, kn = rows * nj;
  const int k0 = (int)((long long)sp * kn / runs), k1 = (int)((long long)(sp + 1) * kn / runs);
  float acc = 0.f;
  for (int kk = k0; kk < k1; kk += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = kk + u, i = q / nj, tile = i * gr.cols + jlo + (q - i * nj);
      v[u] = (q < k1 && tile != p.skip) ? __ldcg(part + ((size_t)tile * 2 + s) * gr.cn + cl)
                                        : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  return acc;
}

// the last block of a group: each statistic and channel's partials in tile
// order, in `runs` contiguous runs whose sums a warp adds as a butterfly
// (a fixed order), then the coefficients, dw and db
__device__ void fold(const Args& p, const Group& gr, int V, float* red) {
  const float* part = p.part + (size_t)gr.c0 * 2 * gridDim.x;
  const int items = 2 * gr.cn, runs = fold_runs(items);
  if (runs == 1) {
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int s = it / gr.cn;
      red[it] = fold_run(p, gr, part, V, s, it - s * gr.cn, 0, 1);
    }
  } else {
    const int u = threadIdx.x, it = u / runs, sp = u - it * runs;
    float acc = 0.f;
    if (it < items) {
      const int s = it / gr.cn;
      acc = fold_run(p, gr, part, V, s, it - s * gr.cn, sp, runs);
    }
    for (int o = runs / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (it < items && sp == 0) red[it] = acc;
  }
  __syncthreads();
  for (int cl = threadIdx.x; cl < gr.cn; cl += kThreads) {
    const int c = gr.c0 + cl;
    const float sg = red[cl], sgx = red[gr.cn + cl];
    float a, bb, p2, p3;
    bn::fold_bwd(p.w[c], p.b[c], p.mean[c], p.var[c], p.eps, (float)p.m, sg, sgx,
                 p.gmean ? p.gmean[c] : 0.f, p.gvar ? p.gvar[c] : 0.f, a, bb, p2, p3);
    p.coef[c] = a;
    p.coef[p.c + c] = bb;
    p.coef[2 * p.c + c] = p2;
    p.coef[3 * p.c + c] = p3;
    p.dw[c] = sgx;
    p.db[c] = sg;
    if (p.dw16) {
      static_cast<__nv_bfloat16*>(p.dw16)[c] = __float2bfloat16_rn(sgx);
      static_cast<__nv_bfloat16*>(p.db16)[c] = __float2bfloat16_rn(sg);
    }
  }
}

// dx and dres of the tile, from the slot (and past it from device memory);
// cs: the tile's channels' a, b', p2, p3 [4, kMaxGroupC]
template <typename T>
__device__ void apply(const Args& p, const Group& gr, const Tile& t, const uint4* slot,
                      const float* cs, uint64_t pol) {
  constexpr int V = Vec<T>::n;
  T* dx = static_cast<T*>(p.dx);
  T* dres = static_cast<T*>(p.dres);
  // (r, col): this thread's vector, stepped by the block without a division;
  // kBatch vectors' loads in flight
  const int dr = kThreads / t.w, dc = kThreads - dr * t.w;
  int r = threadIdx.x / t.w, col = threadIdx.x - r * t.w;
  while (r < t.rows) {
    int qs[kBatch], vvs[kBatch];
    long long es[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ok[u] = r < t.rows;
      qs[u] = r * t.w + col;
      vvs[u] = t.v0 + col;
      es[u] = ((long long)(t.n0 + r) * p.c + gr.c0) * p.hw + (long long)vvs[u] * V;
      r += dr;
      col += dc;
      if (col >= t.w) {
        col -= t.w;
        ++r;
      }
    }
    uint4 xr[kBatch], gq[kBatch], rq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      xr[u] = fetch<T>(slot, p.cap, 0, qs[u], t.fit, p.x, es[u], pol);
      gq[u] = fetch<T>(slot, p.cap, 1, qs[u], t.fit, p.g, es[u], pol);
      if (p.gate_res) rq[u] = fetch<T>(slot, p.cap, 2, qs[u], t.fit, p.res, es[u], pol);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      float xv[V], gv[V], rv[V], o[V], o2[V];
      unpack<T>(xv, xr[u]);
      unpack<T>(gv, gq[u]);
      if (p.gate_res) {
        unpack<T>(rv, rq[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) rv[k] = 0.f;
      }
      const int e0 = vvs[u] * V, cl = e0 / p.hw;
      int within = e0 - cl * p.hw, tc = cl - t.ch_lo;
      if (within + V <= p.hw) {  // the vector lies in one channel
        const float a = cs[tc], bb = cs[kMaxGroupC + tc];
        const float p2 = cs[2 * kMaxGroupC + tc], p3 = cs[3 * kMaxGroupC + tc];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gk =
              (p.relu && !(bn::pre_act(xv[k], a, bb, p.gate_res, rv[k]) > 0.f)) ? 0.f : gv[k];
          o[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, gk), __fmul_rn(xv[k], p2)), p3);
          o2[k] = gk;
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (k > 0 && ++within == p.hw) {
            within = 0;
            ++tc;
          }
          const float a = cs[tc], bb = cs[kMaxGroupC + tc];
          const float p2 = cs[2 * kMaxGroupC + tc], p3 = cs[3 * kMaxGroupC + tc];
          const float gk =
              (p.relu && !(bn::pre_act(xv[k], a, bb, p.gate_res, rv[k]) > 0.f)) ? 0.f : gv[k];
          o[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, gk), __fmul_rn(xv[k], p2)), p3);
          o2[k] = gk;
        }
      }
      st_stream(dx + es[u], pack<T>(o));
      if (dres) st_stream(dres + es[u], pack<T>(o2));
    }
  }
}

// apply's fast path, for reduce2's tiles: the two channels' a, b', p2, p3
// in registers
template <typename T>
__device__ void apply2(const Args& p, const Group& gr, const Tile& t, const uint4* slot,
                       const float* cs, uint64_t pol) {
  constexpr int V = Vec<T>::n;
  T* dx = static_cast<T*>(p.dx);
  T* dres = static_cast<T*>(p.dres);
  const int b1 = (t.ch_lo + 1) * (p.hw / V) - t.v0, last = t.nch - 1;
  const float a0 = cs[0], a1 = cs[last], bb0 = cs[kMaxGroupC], bb1 = cs[kMaxGroupC + last];
  const float p20 = cs[2 * kMaxGroupC], p21 = cs[2 * kMaxGroupC + last];
  const float p30 = cs[3 * kMaxGroupC], p31 = cs[3 * kMaxGroupC + last];
  const int dr = kThreads / t.w, dc = kThreads - dr * t.w;
  int r = threadIdx.x / t.w, col = threadIdx.x - r * t.w;
  while (r < t.rows) {
    int qs[kBatch], cols[kBatch];
    long long es[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ok[u] = r < t.rows;
      qs[u] = r * t.w + col;
      cols[u] = col;
      es[u] = ((long long)(t.n0 + r) * p.c + gr.c0) * p.hw + (long long)(t.v0 + col) * V;
      r += dr;
      col += dc;
      if (col >= t.w) {
        col -= t.w;
        ++r;
      }
    }
    uint4 xr[kBatch], gq[kBatch], rq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      xr[u] = fetch<T>(slot, p.cap, 0, qs[u], t.fit, p.x, es[u], pol);
      gq[u] = fetch<T>(slot, p.cap, 1, qs[u], t.fit, p.g, es[u], pol);
      if (p.gate_res) rq[u] = fetch<T>(slot, p.cap, 2, qs[u], t.fit, p.res, es[u], pol);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!ok[u]) continue;
      float xv[V], gv[V], rv[V], o[V], o2[V];
      unpack<T>(xv, xr[u]);
      unpack<T>(gv, gq[u]);
      if (p.gate_res) {
        unpack<T>(rv, rq[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) rv[k] = 0.f;
      }
      const bool second = cols[u] >= b1;
      const float a = second ? a1 : a0, bb = second ? bb1 : bb0;
      const float p2 = second ? p21 : p20, p3 = second ? p31 : p30;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gk =
            (p.relu && !(bn::pre_act(xv[k], a, bb, p.gate_res, rv[k]) > 0.f)) ? 0.f : gv[k];
        o[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, gk), __fmul_rn(xv[k], p2)), p3);
        o2[k] = gk;
      }
      st_stream(dx + es[u], pack<T>(o));
      if (dres) st_stream(dres + es[u], pack<T>(o2));
    }
  }
}

// see the design note; kLag + 1 slots (none in the L2-only design)
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) bn_bwd_persist(Args p) {
  constexpr int V = Vec<T>::n, S = kLag + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* slots = reinterpret_cast<uint4*>(smem);
  const size_t slot_vecs = kL2Only ? 0 : (size_t)(p.gate_res ? 3 : 2) * p.cap;
  float* red = reinterpret_cast<float*>(slots + S * slot_vecs);  // [2, kMaxGroupC]
  float* cs = red + 2 * kMaxGroupC;                              // [4, kMaxGroupC]
  uint64_t* bar = reinterpret_cast<uint64_t*>(cs + 4 * kMaxGroupC);
  int* last_s = reinterpret_cast<int*>(bar + S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t keep = policy_evict_last(), once = policy_evict_first();
  // the block's team and its place in it: team tm takes groups tm, tm +
  // kTeams, ...; its i-th group sits in slot i % S
  const int per_team = gridDim.x / kTeams, tm = blockIdx.x / per_team;
  const int b = blockIdx.x - tm * per_team;
  const int mine = (p.groups - tm + kTeams - 1) / kTeams;  // the team's groups
  if (!kL2Only && threadIdx.x < 32) {
    for (int i = 0; i < S && i < mine; ++i) {
      const Group gr = group_of(p, tm + i * kTeams, V);
      const Tile t = tile_of(p, gr, b, V);
      if (t.rows && t.fit) issue<T>(p, gr, t, slots + i * slot_vecs, &bar[i]);
    }
  }
  uint32_t phase = 0;
  for (int i = 0; i < mine; ++i) {
    const int j = tm + i * kTeams, s = i % S;
    const Group gr = group_of(p, j, V);
    const Tile t = tile_of(p, gr, b, V);
    if (t.rows) {  // reduce the team's i-th group, fold it if this block is its last
      if (t.fit) {
        mbar_wait(&bar[s], (phase >> s) & 1u);
        phase ^= 1u << s;
      }
      if (p.hw % V == 0 && t.nch <= 2) {
        reduce2<T>(p, gr, t, slots + s * slot_vecs, red, keep);
      } else {
        reduce<T>(p, gr, t, slots + s * slot_vecs, red, keep);
      }
      __syncthreads();
      if (threadIdx.x == 0) *last_s = atom_add_acq_rel(p.cnt + j, 1u) + 1 == (unsigned)gr.tiles;
      __syncthreads();
      if (*last_s) {
        fold(p, gr, V, red);
        __syncthreads();
        if (threadIdx.x == 0) st_release(p.cnt + p.groups + j, 1u);
      }
      // apply it once its flag is set
      if (threadIdx.x == 0) wait_flag(p.cnt + p.groups + j);
      __syncthreads();
      for (int tc = threadIdx.x; tc < t.nch; tc += kThreads) {
        const int c = gr.c0 + t.ch_lo + tc;
#pragma unroll
        for (int k = 0; k < 4; ++k) cs[k * kMaxGroupC + tc] = __ldcg(p.coef + k * p.c + c);
      }
      __syncthreads();
      if (p.hw % V == 0 && t.nch <= 2) {
        apply2<T>(p, gr, t, slots + s * slot_vecs, cs, once);
      } else {
        apply<T>(p, gr, t, slots + s * slot_vecs, cs, once);
      }
      __syncthreads();
    }
    if (!kL2Only && threadIdx.x < 32 && i + S < mine) {  // the freed slot
      const Group g2 = group_of(p, j + S * kTeams, V);
      const Tile t2 = tile_of(p, g2, b, V);
      if (t2.rows && t2.fit) issue<T>(p, g2, t2, slots + s * slot_vecs, &bar[s]);
    }
  }
}

// ---- the plan, on the host (norm_fusion.bn_tiles / bn_bwd_plan mirror it)

inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the tile of a group's n rows of lv vectors on `parts` blocks: the
// smallest th x tw, rows at least kMinSpan vectors where lv allows, then
// the fewest image slices
inline void tiles(int n, long long lv, int parts, int& th, int& tw) {
  const long long cols_cap = std::max(1LL, lv / kMinSpan);
  long long best = -1;
  const int top = std::min(n, parts);
  for (int ns = 1; ns <= top; ++ns) {
    const long long cs = std::max(1LL, std::min((long long)(parts / ns), cols_cap));
    const long long w = (lv + cs - 1) / cs, h = ((long long)n + ns - 1) / ns;
    if (best < 0 || h * w < best) {
      best = h * w;
      th = (int)h;
      tw = (int)w;
    }
  }
}

struct Plan {
  int cg, groups, th, tw, cg_last, th_last, tw_last, cap;
};

// vec: elements a 16-byte vector; k: tensors a slot holds (x, g, res);
// parts: the blocks of one team (the grid / teams), each a tile of a
// group; a block's share of a group: slot_bytes in its shared-memory slot
// and l2_bytes / parts more read from device memory (kept in L2 between
// the reduction and the apply)
inline int plan(int n, int c, int hw, int vec, int k, int parts, int slot_bytes, int l2_bytes,
                Plan& pl) {
  const long long share = (long long)slot_bytes + (parts > 0 ? l2_bytes / parts : 0);
  if (n < 1 || c < 1 || hw < 1 || parts < 1 || (vec != 4 && vec != 8) || k < 2 || k > 3 ||
      slot_bytes < 0 || l2_bytes < 0 || share < 16 * k)
    return (int)cudaErrorInvalidValue;
  const int unit = vec / gcd_int(hw, vec);
  if (c % unit) return (int)cudaErrorInvalidValue;
  pl.cap = slot_bytes / (16 * k);
  const long long tile_cap = share / (16 * k);
  const long long per_channel = (long long)n * hw * (16 / vec) * k;
  long long cg = std::min(c, kMaxGroupC);
  cg = std::min(cg, (long long)parts * share / per_channel);
  cg = std::max((long long)unit, cg / unit * unit);
  int th = 1, tw = 1;
  for (;; cg -= unit) {
    tiles(n, cg * hw / vec, parts, th, tw);
    if (cg == unit || (long long)th * tw <= tile_cap) break;
  }
  pl.cg = (int)cg;
  pl.th = th;
  pl.tw = tw;
  pl.groups = (c + pl.cg - 1) / pl.cg;
  pl.cg_last = c - (pl.groups - 1) * pl.cg;
  tiles(n, (long long)pl.cg_last * hw / vec, parts, pl.th_last, pl.tw_last);
  return 0;
}

// the grid: kBlocksPerSm blocks on each of the device's SMs (-1 on an error)
inline int grid_parts() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  return kBlocksPerSm * sms;
}

template <typename T>
int launch(const Args& p, int parts, cudaStream_t s) {
  const int k = p.gate_res ? 3 : 2;
  const size_t smem = (kL2Only ? 0 : (size_t)(kLag + 1) * k * p.cap * 16) + kScratch;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = bn_bwd_persist<T>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  if (rc) return rc;
  int per_sm = 0;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)))
    return rc;
  if (per_sm < kBlocksPerSm) return (int)cudaErrorCooperativeLaunchTooLarge;
  rc = (int)cudaMemsetAsync(p.cnt, 0, 2 * (size_t)p.groups * sizeof(unsigned), s);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, p);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// scratch: f32 [6C + 2PC + 2G] (P = grid_parts()): coef [4, C], dw [C],
// db [C], part [P, 2, C], then the counters and flags [2, G] (u32)
template <typename T>
int run(Args p, float* scratch, cudaStream_t s) {
  constexpr int V = Vec<T>::n;
  const int parts = grid_parts();
  if (parts < kTeams || parts % kTeams) return (int)cudaErrorInvalidValue;
  if (p.n < 1 || p.c < 8 || p.c % 8 || p.hw < 1 || p.c > 65535 ||
      (long long)p.n * p.c * p.hw / V >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  if (int rc = plan(p.n, p.c, p.hw, V, p.gate_res ? 3 : 2, parts / kTeams, kSlotBytes, kL2Bytes,
                    pl))
    return rc;
  if ((long long)pl.cg * p.hw >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.groups = pl.groups, p.cg = pl.cg, p.th = pl.th, p.tw = pl.tw;
  p.cg_last = pl.cg_last, p.th_last = pl.th_last, p.tw_last = pl.tw_last, p.cap = pl.cap;
  p.m = (long long)p.n * p.hw;
  p.coef = scratch;
  p.dw = scratch + 4 * (size_t)p.c;
  p.db = scratch + 5 * (size_t)p.c;
  p.part = scratch + 6 * (size_t)p.c;
  p.cnt = reinterpret_cast<unsigned*>(scratch + 6 * (size_t)p.c + 2 * (size_t)parts * p.c);
  return launch<T>(p, parts, s);
}

}  // namespace bnb

// ==========================================================================
// The BatchNorm forward's cluster route (TPU kernels 15, 16)
// ==========================================================================
//
// Replaces, as bn::run<.., FWD> above does (which stays as the generic
// route, reached only by an explicit route="generic" in
// norm_fusion._bn_fwd_cuda for in-call comparisons), the TPU kernels
//   _bn_stats_kernel :403 and _bn_apply_kernel :428 of
//   paddle_tpu/kernels/norm_fusion.py, launched by _bn_fwd :521,
// with bn's arithmetic: s1 = sum x, s2 = sum x^2 in f32; mean = s1 (1/M);
// var = max(s2 (1/M) - mean^2, 0), the reference's one-pass clamped
// variance (:419-424), kept though x is resident (a two-pass variance is
// another function); fold_ab; y = round(relu?(pre_act(x, a, b', res))).
//
// Bound: bytes. x (and res) read once, y written once: 2 tensor passes
// without a residual, 3 with one. bn::run reads x twice (its reduction,
// then its apply): 3 passes against 2, 4 against 3, so no tuning of it
// passes 67% / 75% of the bound, and it takes 4 launches a call.
//
// Design: one launch a call (cudaLaunchKernelEx with the cluster-dimension
// attribute; no cooperative launch, no memset, no counter in device
// memory). The constants after kBatch fix the design;
// scripts/bn_fwd_variants.py times copies of this file with them changed
// (norm_fusion.bn_fwd_plan mirrors plan()).
//   - slabs: cg adjacent channels by all N images. cg is the least multiple
//     of V / gcd(HW, V) that divides C and makes a slab at least kMinSlab
//     bytes (at most kMaxC channels): each image's row of a slab (cg HW
//     elements, contiguous in NCHW) is a whole number of 16-byte vectors
//     on a 16-byte boundary, so the loads mask no neighbouring plane.
//   - clusters: a slab is cut over a cluster of K CTAs, K the least whose
//     shared memory holds the slab (at most kMaxCluster: 16, past the
//     portable 8, which holds ppyoloe-l's stem whole), raised while the
//     grid has fewer CTAs than the card has SMs (never below kMinCtaVecs
//     vectors a CTA); CTA `rank` takes a tile: images cut ns = min(N, K)
//     ways, each row's vectors K / ns ways. A CTA of at most half an SM's
//     shared memory runs kSmallThreads threads (two an SM), a larger one
//     kMaxThreads (one an SM, the warps to hide the shared-memory loads).
//   - loads: warp 0 issues the tile's first `cap` vectors of x as bulk
//     copies into shared memory (cp.async.bulk, one a row segment), all at
//     once, in chunks of kStageVecs vectors completing on an mbarrier
//     each: a CTA has its whole part in flight whatever the occupancy
//     (bn_reduce had one 16-byte load a thread in flight, ~1 MB over the
//     card at ppyoloe-l's stem). Where a tile does not fit (resnet50's
//     stem) `cap` is a whole number of chunks, and the rest of x streams
//     through a ring of kRing stages: read once for the sums, again for
//     the apply.
//   - sums: s1, s2 per channel in f32 from shared memory, kSteps vectors a
//     thread at a time, a chunk as soon as it lands where the tile holds
//     at most two channels (every vector's elements below the second
//     channel's first element are the first's: the stems, layers 1-3,
//     ppyoloe's large maps); otherwise once all has landed, the warps
//     splitting the channels and masking the neighbouring channels'
//     elements of a vector. The warps' sums are added in order into the
//     CTA's partials [2, cg] in shared memory.
//   - fold: a cluster barrier, then every CTA reads the K partials over
//     distributed shared memory in rank order (all in flight at once) and
//     folds every channel of the slab: each CTA adds the same values in
//     the same order, so all hold the same bits with no second exchange,
//     and a call repeats bitwise. Rank 0 writes mean and var. An arrival
//     on the cluster barrier then says the CTA is done with its peers'
//     partials; its wait comes before the CTA leaves.
//   - apply: y from the resident x (and the ring's x past it), a group of
//     kSteps vectors a thread at a time, the residual's next group loaded
//     into registers while this one is applied (kResRing: through the
//     ring instead, which then costs shared memory the slab needs), stored
//     by 16-byte streaming stores (kTmaStore: in place over x in shared
//     memory and out by bulk stores, a chunk each).
//   - kPersistent: a grid of the clusters the card holds at once, each
//     walking slabs; the next slab's chunks of x load into the chunks the
//     apply has freed.
// Measured (PERF.md section 6, H100; scripts/bn_step_shapes.py): x read
// once at every shape of both models' steps but resnet50's stem (1.76x);
// per call faster than bn::run at 19 of the 25 distinct shapes of a
// resnet50 and a ppyoloe-l step, slower at resnet50's stem and where a
// slab is one 200 KB CTA at HW 49 or 196.

namespace bnf {

constexpr int kSmemPerSm = 233472;   // an SM's shared memory on sm_90
constexpr int kBlockReserve = 1024;  // the runtime's share of each resident block
constexpr int kMaxC = 256;           // channels a slab holds at most
constexpr int kMinSlab = 65536;      // bytes of x a slab holds at least (cg raised)
constexpr int kMinCtaVecs = 1024;    // vectors a CTA holds at least where K is raised
constexpr int kBatch = 4;            // vectors a thread loads before it computes (global)
// the route's design (scripts/bn_fwd_variants.py times copies of this file
// with these changed)
constexpr int kMaxThreads = 512;     // threads a CTA of more than half an SM's shared memory
constexpr int kSmallThreads = 256;   // threads a CTA of at most half (two an SM)
constexpr int kSteps = 4;            // vectors a thread takes a group
constexpr int kCtasPerSm = 1;        // a CTA's share of an SM's shared memory
constexpr int kMaxCluster = 16;      // CTAs a cluster at most (over 8: non-portable)
constexpr int kParPerSm = 1;         // K is raised while the grid has fewer CTAs than this x SMs
constexpr int kStageVecs = 2048;     // vectors of a chunk of x and of a ring stage
constexpr int kRing = 3;             // ring stages
constexpr bool kResRing = false;     // the residual through the ring (else registers)
constexpr bool kTmaStore = false;    // y in place over x, out by bulk stores
constexpr bool kPersistent = false;  // clusters walking slabs
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChunks = (int)((kMaxSmem / 16 + kStageVecs - 1) / kStageVecs);
constexpr int kMaxK = 16;            // CTAs a cluster the hardware takes at most
// the partials, the warps' sums and the coefficients [2, kMaxC] f32 each,
// then the chunks' and the ring's mbarriers
constexpr int kScratch = (6 * kMaxC * 4 + 8 * (kMaxChunks + kRing) + 127) / 128 * 128;
static_assert(kStageVecs % (kMaxThreads * kSteps) == 0 &&
                  kStageVecs % (kSmallThreads * kSteps) == 0,
              "a chunk is whole groups of the block");

struct Args {
  const void* x;
  const void* res;     // null: no residual
  ChanVec w;           // [C] f32 or bf16
  ChanVec b;
  void* y;
  float* mean;
  float* var;
  long long m;         // N * HW
  int n, c, hw, relu;
  int skip;            // a planted fault: rank 0's fold leaves out the last rank's partial
  int cg, k, ns, cs, rowv, cap, ring_t, slabs;   // the plan
  float eps;
};

// CTA `rank`'s part of a slab: images [n0, n0 + rows) by row vectors [v0,
// v0 + w); its first `fit` vectors resident; channels ch_lo .. ch_lo + nch
// - 1 of the slab; chunks of kStageVecs vectors: nres resident of nall
struct Tile {
  int n0, rows, v0, w, tv, fit, ch_lo, nch, nres, nall;
};

__device__ __forceinline__ Tile tile_of(const Args& p, int rank, int V) {
  const int i = rank / p.cs, jc = rank - i * p.cs;
  Tile t;
  t.n0 = (int)((long long)i * p.n / p.ns);
  t.rows = (int)((long long)(i + 1) * p.n / p.ns) - t.n0;
  t.v0 = (int)((long long)jc * p.rowv / p.cs);
  t.w = (int)((long long)(jc + 1) * p.rowv / p.cs) - t.v0;
  t.tv = t.rows * t.w;
  t.fit = min(t.tv, p.cap);
  t.ch_lo = (int)((long long)t.v0 * V / p.hw);
  t.nch = (int)(((long long)(t.v0 + t.w) * V - 1) / p.hw) - t.ch_lo + 1;
  t.nres = (t.fit + kStageVecs - 1) / kStageVecs;
  t.nall = (t.tv + kStageVecs - 1) / kStageVecs;
  return t;
}

// the first element of the tile's vector (r, col) in the [N, C, HW] tensors
__device__ __forceinline__ long long elem(const Args& p, const Tile& t, int c0, int r, int col,
                                          int V) {
  return ((long long)(t.n0 + r) * p.c + c0) * p.hw + (long long)(t.v0 + col) * V;
}

// warp 0's lanes: the tile's vectors [f0, f1) of tensor src into dst[0,
// f1 - f0), a bulk copy a row segment, completing on bar
template <typename T>
__device__ __forceinline__ void copy_rows(const Args& p, const Tile& t, int c0, const void* src,
                                          uint4* dst, int f0, int f1, uint64_t* bar) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  for (int r = f0 / t.w + lane; r <= (f1 - 1) / t.w; r += 32) {
    const int a = max(f0, r * t.w), e = min(f1, (r + 1) * t.w);
    bulk_load(dst + (a - f0), static_cast<const T*>(src) + elem(p, t, c0, r, a - r * t.w, V),
              (uint32_t)(e - a) * 16u, bar);
  }
}

// warp 0's lanes: y's vectors [f0, f1) of the tile from src[0, f1 - f0)
// in shared memory, a bulk store a row segment, one bulk group a lane
template <typename T>
__device__ __forceinline__ void store_rows(const Args& p, const Tile& t, int c0, const uint4* src,
                                           int f0, int f1) {
  constexpr int V = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  for (int r = f0 / t.w + lane; r <= (f1 - 1) / t.w; r += 32) {
    const int a = max(f0, r * t.w), e = min(f1, (r + 1) * t.w);
    bulk_store(static_cast<T*>(p.y) + elem(p, t, c0, r, a - r * t.w, V), src + (a - f0),
               (uint32_t)(e - a) * 16u);
  }
  bulk_commit();
}

// the general reduction (more than two channels in the tile): teams of
// warps a channel, the channel's vectors of each
// row, the neighbouring channels' elements masked; x from shared memory
// below `fit`, past it from device memory. The channels' partials into
// part [2, kMaxC].
template <typename T>
__device__ void sums_general(const Args& p, const Tile& t, int c0, const uint4* xs, float* red,
                             float* part, uint64_t keep) {
  constexpr int V = Vec<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  // teams: the largest power of two at most the warps and the channels
  int teams = 1;
  while (teams * 2 <= min(nw, t.nch)) teams *= 2;
  const int W = nw / teams, team = warp / W, wi = warp - team * W;
  for (int tc = team; tc < t.nch; tc += teams) {
    const int cl = t.ch_lo + tc;
    // the channel's row elements [lo, hi) inside the tile, and their vectors
    const int lo = max(cl * p.hw, t.v0 * V), hi = min((cl + 1) * p.hw, (t.v0 + t.w) * V);
    const int vlo = lo / V, nv = (hi + V - 1) / V - vlo;
    const int step = W * 32, dr = step / nv, dc = step - dr * nv;
    int r = (wi * 32 + lane) / nv, cc = wi * 32 + lane - r * nv;
    float s1 = 0.f, s2 = 0.f;
    while (r < t.rows) {
      int qs[kBatch], e0s[kBatch];
      long long es[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ok[u] = r < t.rows;
        const int col = vlo + cc - t.v0;
        qs[u] = r * t.w + col;
        e0s[u] = (vlo + cc) * V;
        es[u] = elem(p, t, c0, r, col, V);
        r += dr;
        cc += dc;
        if (cc >= nv) {
          cc -= nv;
          ++r;
        }
      }
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;
        raw[u] = qs[u] < t.fit ? xs[qs[u]]
                               : bnb::ld_hint(static_cast<const T*>(p.x) + es[u], keep);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;
        float xv[V];
        bnb::unpack<T>(xv, raw[u]);
        const int e0 = e0s[u];
        const bool whole = e0 >= lo && e0 + V <= hi;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (whole || (e0 + k >= lo && e0 + k < hi)) {
            s1 += xv[k];
            s2 += xv[k] * xv[k];
          }
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[tc * W + wi] = s1;
      red[kMaxC + tc * W + wi] = s2;
    }
  }
  __syncthreads();
  for (int tc = threadIdx.x; tc < t.nch; tc += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < W; ++i) {
      t1 += red[tc * W + i];
      t2 += red[kMaxC + tc * W + i];
    }
    part[t.ch_lo + tc] = t1;
    part[kMaxC + t.ch_lo + tc] = t2;
  }
}

// see the design note; one instantiation a dtype, the plan (and the
// block's threads, kSmallThreads or kMaxThreads) in p
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) bn_fwd_cluster(Args p) {
  constexpr int V = Vec<T>::n, S = kStageVecs, R = kRing, U = kSteps;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);                          // [cap]
  uint4* ring = xs + p.cap;                                            // [R, ring_t, S]
  float* part = reinterpret_cast<float*>(ring + (size_t)R * p.ring_t * S);  // [2, kMaxC]
  float* red = part + 2 * kMaxC;                                       // [2, kMaxC]
  float* cs = red + 2 * kMaxC;                                         // [2, kMaxC]: a, b'
  uint64_t* xbar = reinterpret_cast<uint64_t*>(cs + 2 * kMaxC);        // [kMaxChunks]
  uint64_t* rbar = xbar + kMaxChunks;                                  // [R]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = blockDim.x, nw = nt >> 5, G = nt * U;  // a group: U vectors a thread
  const int rank = (int)cluster_rank();
  const Tile t = tile_of(p, rank, V);
  const bool has_res = p.res != nullptr, ring_res = kResRing && has_res;
  // at most two channels: every vector's elements below `bnd` (the second
  // channel's first element in the slab row) are the first channel's
  const bool fast = t.nch <= 2;
  const int bnd = (t.ch_lo + 1) * p.hw;
  // ring jobs a slab: the sums' chunks of x past `fit` (fast path), then
  // the apply's chunks that need the ring: every one with a residual in
  // the ring (res, and x past `fit`), else those past `fit` (x)
  const int jobs_sum = fast ? t.nall - t.nres : 0;
  const int jobs = jobs_sum + (ring_res ? t.nall : t.nall - t.nres);
  const int cluster = blockIdx.x / p.k, clusters = gridDim.x / p.k;
  const int mine = kPersistent ? (p.slabs - cluster + clusters - 1) / clusters : 1;
  const long long total_jobs = (long long)jobs * mine;
  if (tid == 0) {
    for (int i = 0; i < kMaxChunks; ++i) mbar_init(&xbar[i], 1);
    for (int i = 0; i < R; ++i) mbar_init(&rbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t keep = bnb::policy_evict_last(), once = bnb::policy_evict_first();

  // warp 0: chunk ch of the tile's resident x of the slab at channel c0
  auto issue_x = [&](int c0, int ch) {
    const int f0 = ch * S, f1 = min(f0 + S, t.fit);
    if (lane == 0) {
      fence_proxy_async();
      mbar_arrive_tx(&xbar[ch], (uint32_t)(f1 - f0) * 16u);
    }
    __syncwarp();
    copy_rows<T>(p, t, c0, p.x, xs + f0, f0, f1, &xbar[ch]);
  };
  // warp 0: ring job g (job g % jobs of the CTA's slab g / jobs) into
  // stage g % R: x half first, the residual's last
  auto issue_job = [&](long long g) {
    const int it = (int)(g / jobs), j = (int)(g - (long long)it * jobs);
    const int c0 = (cluster + it * clusters) * p.cg;
    int ch;
    bool bx, br;
    if (j < jobs_sum) {
      ch = t.nres + j, bx = true, br = false;
    } else {
      ch = ring_res ? j - jobs_sum : t.nres + j - jobs_sum;
      bx = ch >= t.nres, br = ring_res;
    }
    const int f0 = ch * S, f1 = min(f0 + S, t.tv), s = (int)(g % R);
    uint4* slot = ring + (size_t)s * p.ring_t * S;
    if (lane == 0) {
      fence_proxy_async();
      mbar_arrive_tx(&rbar[s], (uint32_t)(f1 - f0) * 16u * ((bx ? 1u : 0u) + (br ? 1u : 0u)));
    }
    __syncwarp();
    if (bx) copy_rows<T>(p, t, c0, p.x, slot, f0, f1, &rbar[s]);
    if (br) copy_rows<T>(p, t, c0, p.res, slot + (size_t)(p.ring_t - 1) * S, f0, f1, &rbar[s]);
  };
  // every thread: wait for ring job g's stage; returns it
  auto wait_job = [&](long long g) {
    const int s = (int)(g % R);
    mbar_wait(&rbar[s], (uint32_t)(g / R) & 1u);
    return ring + (size_t)s * p.ring_t * S;
  };

  if (warp == 0) {
    for (int ch = 0; ch < t.nres; ++ch) issue_x(cluster * p.cg, ch);
    for (long long g = 0; g < R && g < total_jobs; ++g) issue_job(g);
  }
  long long jg = 0;  // the next ring job to consume
  // (r, col): this thread's vector q = tid + k nt of the tile, stepped by
  // the block without a division
  const int dr = nt / t.w, dc = nt - dr * t.w;
  for (int it = 0; it < mine; ++it) {
    const int c0 = (cluster + it * clusters) * p.cg;
    const uint32_t xpar = (uint32_t)it & 1u;
    for (int i = tid; i < 2 * kMaxC; i += nt) part[i] = 0.f;

    // ---- the sums
    if (fast) {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      int col = tid % t.w;
      for (int ch = 0; ch < t.nall; ++ch) {
        const int f0 = ch * S, f1 = min(f0 + S, t.tv);
        const bool resident = ch < t.nres;
        const uint4* src;
        if (resident) {
          mbar_wait(&xbar[ch], xpar);
          src = xs + f0;
        } else {
          src = wait_job(jg);
        }
        for (int g0 = f0; g0 < f1; g0 += G) {
          uint4 raw[U];
          int e0s[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int q = g0 + tid + u * nt;
            e0s[u] = (t.v0 + col) * V;
            if (q < f1) raw[u] = src[q - f0];
            col += dc;
            if (col >= t.w) col -= t.w;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (g0 + tid + u * nt >= f1) continue;
            float xv[V];
            bnb::unpack<T>(xv, raw[u]);
            const int e0 = e0s[u];
            if (e0 + V <= bnd || e0 >= bnd) {  // the vector in one channel
              float v1 = 0.f, v2 = 0.f;
#pragma unroll
              for (int k = 0; k < V; ++k) {
                v1 += xv[k];
                v2 += xv[k] * xv[k];
              }
              if (e0 >= bnd) {
                s1[1] += v1;
                s2[1] += v2;
              } else {
                s1[0] += v1;
                s2[0] += v2;
              }
            } else {  // the two channels meet inside it
#pragma unroll
              for (int k = 0; k < V; ++k) {
                if (e0 + k < bnd) {
                  s1[0] += xv[k];
                  s2[0] += xv[k] * xv[k];
                } else {
                  s1[1] += xv[k];
                  s2[1] += xv[k] * xv[k];
                }
              }
            }
          }
        }
        if (!resident) {
          __syncthreads();
          if (warp == 0 && jg + R < total_jobs) issue_job(jg + R);
          ++jg;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s1[i] = warp_sum(s1[i]);
        s2[i] = warp_sum(s2[i]);
        if (lane == 0) {
          red[i * kMaxWarps + warp] = s1[i];
          red[(2 + i) * kMaxWarps + warp] = s2[i];
        }
      }
      __syncthreads();
      if (tid < 2 * t.nch) {  // (statistic, channel)
        const int st = tid / t.nch, i = tid - st * t.nch;
        float tot = 0.f;
        for (int w = 0; w < nw; ++w) tot += red[(2 * st + i) * kMaxWarps + w];
        part[st * kMaxC + t.ch_lo + i] = tot;
      }
    } else {
      for (int ch = 0; ch < t.nres; ++ch) mbar_wait(&xbar[ch], xpar);
      sums_general<T>(p, t, c0, xs, red, part, keep);
    }

    // ---- the fold: the K partials in rank order, every channel of the slab
    cluster_sync();
    {
      const float inv_m = (float)(1.0 / (double)p.m);
      const int ranks = (p.skip && rank == 0) ? p.k - 1 : p.k;
      for (int cl = tid; cl < p.cg; cl += nt) {
        // every peer's partials in flight at once, then the adds in rank order
        float v1[kMaxK], v2[kMaxK];
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < ranks) {
            v1[r] = ld_cluster(part + cl, (uint32_t)r);
            v2[r] = ld_cluster(part + kMaxC + cl, (uint32_t)r);
          }
        }
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxK; ++r) {
          if (r < ranks) {
            t1 += v1[r];
            t2 += v2[r];
          }
        }
        const float mean = __fmul_rn(t1, inv_m);
        const float var = fmaxf(__fsub_rn(__fmul_rn(t2, inv_m), __fmul_rn(mean, mean)), 0.f);
        const int c = c0 + cl;
        if (rank == 0) {
          p.mean[c] = mean;
          p.var[c] = var;
        }
        float rstd, a, bb;
        bn::fold_ab(p.w[c], p.b[c], mean, var, p.eps, rstd, a, bb);
        cs[cl] = a;
        cs[kMaxC + cl] = bb;
      }
    }
    cluster_arrive();  // done with the peers' partials
    __syncthreads();

    // ---- the apply, a group at a time
    {
      const int l0 = t.ch_lo, l1 = t.ch_lo + t.nch - 1;
      const float a0 = cs[l0], a1 = cs[l1], bb0 = cs[kMaxC + l0], bb1 = cs[kMaxC + l1];
      T* y = static_cast<T*>(p.y);
      int r = tid / t.w, col = tid - r * t.w;
      // !kResRing: the residual's vectors of a group into registers, a
      // group ahead of the one applied (pr, pc: the prefetch's own walk)
      int pr = r, pc = col;
      auto fetch_res = [&](int g, uint4(&dst)[U]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (g * G + tid + u * nt < t.tv)
            dst[u] = bnb::ld_hint(static_cast<const T*>(p.res) + elem(p, t, c0, pr, pc, V),
                                  once);
          pr += dr;
          pc += dc;
          if (pc >= t.w) {
            pc -= t.w;
            ++pr;
          }
        }
      };
      const uint4* slot = nullptr;  // the ring stage of the current chunk
      auto apply_group = [&](int g, uint4(&rcur)[U], uint4(&rnext)[U]) {
        const int g0 = g * G, ch = g0 / S, f0 = ch * S, f1 = min(f0 + S, t.tv);
        const bool resident = ch < t.nres, job = ring_res || !resident;
        if (!kResRing && has_res && g0 + G < t.tv) fetch_res(g + 1, rnext);
        if (job && g0 == f0) slot = wait_job(jg);
        const uint4* xsrc = resident ? xs + f0 : slot;
        const uint4* rsrc = ring_res ? slot + (size_t)(p.ring_t - 1) * S : nullptr;
        uint4 xr[U];
        int rows[U], cols[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = g0 + tid + u * nt;
          rows[u] = r, cols[u] = col;
          if (q < f1) {
            xr[u] = xsrc[q - f0];
            if (ring_res) rcur[u] = rsrc[q - f0];
          }
          r += dr;
          col += dc;
          if (col >= t.w) {
            col -= t.w;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = g0 + tid + u * nt;
          if (q >= f1) continue;
          float xv[V], rv[V], o[V];
          bnb::unpack<T>(xv, xr[u]);
          if (has_res) {
            bnb::unpack<T>(rv, rcur[u]);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) rv[k] = 0.f;
          }
          const int e0 = (t.v0 + cols[u]) * V;
          if (fast && (e0 + V <= bnd || e0 >= bnd)) {  // the vector in one channel
            const bool second = e0 >= bnd;
            const float a = second ? a1 : a0, bb = second ? bb1 : bb0;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float pre = bn::pre_act(xv[k], a, bb, has_res, rv[k]);
              o[k] = p.relu ? fmaxf(pre, 0.f) : pre;
            }
          } else if (fast) {  // the two channels meet inside it
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const bool second = e0 + k >= bnd;
              const float pre =
                  bn::pre_act(xv[k], second ? a1 : a0, second ? bb1 : bb0, has_res, rv[k]);
              o[k] = p.relu ? fmaxf(pre, 0.f) : pre;
            }
          } else {  // the element's channel, stepped inside the vector
            int cl = e0 / p.hw, within = e0 - cl * p.hw;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              if (k > 0 && ++within == p.hw) {
                within = 0;
                ++cl;
              }
              const float pre = bn::pre_act(xv[k], cs[cl], cs[kMaxC + cl], has_res, rv[k]);
              o[k] = p.relu ? fmaxf(pre, 0.f) : pre;
            }
          }
          if (kTmaStore && resident) {
            xs[q] = bnb::pack<T>(o);
          } else {
            bnb::st_stream(y + elem(p, t, c0, rows[u], cols[u], V), bnb::pack<T>(o));
          }
        }
        if (g0 + G < f1) return;  // the chunk's last group ends it
        bool synced = false;
        if (kTmaStore && resident) {
          fence_proxy_async();
          __syncthreads();
          synced = true;
          if (warp == 0) store_rows<T>(p, t, c0, xs + f0, f0, f1);
        }
        if (job) {
          if (!synced) __syncthreads();
          synced = true;
          if (warp == 0 && jg + R < total_jobs) issue_job(jg + R);
          ++jg;
        }
        if (kPersistent && resident && it + 1 < mine) {  // the next slab's chunk
          if (!synced) __syncthreads();
          if (warp == 0) {
            if (kTmaStore) {
              bulk_wait_read();
              __syncwarp();
            }
            issue_x(c0 + clusters * p.cg, ch);
          }
        }
      };
      // two register buffers for the residual, their roles swapped a group
      uint4 ra[U], rb[U];
      if (!kResRing && has_res) fetch_res(0, ra);
      const int groups = (t.tv + G - 1) / G;
      for (int g = 0; g < groups; g += 2) {
        apply_group(g, ra, rb);
        if (g + 1 < groups) apply_group(g + 1, rb, ra);
      }
    }
    cluster_wait();  // no peer reads this CTA's partials any more
  }
  if (kTmaStore && warp == 0) bulk_wait_read();
}

// ---- the plan, on the host (norm_fusion.bn_fwd_plan mirrors it)

struct Plan {
  int cg, k, ns, cs, rowv, cap, ring_t, smem, slabs, tv, threads;
};

// vec: elements a 16-byte vector; res: a residual streams through the
// ring; sms: the card's SMs (K is raised while the grid has fewer CTAs)
inline int plan(int n, int c, int hw, int vec, int res, int sms, Plan& pl) {
  if (n < 1 || c < 1 || hw < 1 || sms < 1 || (vec != 4 && vec != 8))
    return (int)cudaErrorInvalidValue;
  const int unit = vec / bnb::gcd_int(hw, vec);
  if (c % unit) return (int)cudaErrorInvalidValue;
  const long long esize = 16 / vec;
  int cg = 0;
  for (int m = unit; m <= std::min(c, kMaxC); m += unit) {
    if (c % m) continue;
    cg = m;
    if ((long long)n * m * hw * esize >= kMinSlab) break;
  }
  const long long rowv = (long long)cg * hw / vec, slabv = (long long)n * rowv;
  const long long budget =
      std::min((long long)kMaxSmem, (long long)kSmemPerSm / kCtasPerSm - kBlockReserve) -
      kScratch;
  const long long ring1 = (long long)kRing * kStageVecs * 16;
  res = res && kResRing;  // a residual in registers takes no shared memory
  const long long hold = (budget - (res ? ring1 : 0)) / 16;  // vectors a CTA holds
  if (hold < kStageVecs) return (int)cudaErrorInvalidValue;
  const int slabs = c / cg;
  long long k = std::min<long long>(kMaxCluster, (slabv + hold - 1) / hold);
  k = std::max(k, std::min<long long>({(long long)kMaxCluster,
                                       ((long long)kParPerSm * sms + slabs - 1) / slabs,
                                       slabv / kMinCtaVecs}));
  k = std::max(k, 1LL);
  // the cut of K CTAs: ns image slices, cs row-vector slices, the largest
  // tile's vectors
  const long long ns = std::min<long long>(n, k);
  const long long cs =
      std::max(1LL, std::min<long long>({(k + ns - 1) / ns, kMaxCluster / ns, rowv}));
  const long long tv = ((n + ns - 1) / ns) * ((rowv + cs - 1) / cs);
  long long cap;
  int ring_t;
  if (tv <= hold) {
    cap = tv;
    ring_t = res ? 1 : 0;
  } else {  // a whole number of chunks, the rest through the ring
    ring_t = res ? 2 : 1;
    cap = (budget - ring_t * ring1) / 16 / kStageVecs * kStageVecs;
    if (cap < kStageVecs) return (int)cudaErrorInvalidValue;
  }
  pl.cg = cg, pl.k = (int)(ns * cs), pl.ns = (int)ns, pl.cs = (int)cs, pl.rowv = (int)rowv;
  pl.cap = (int)cap, pl.ring_t = ring_t, pl.slabs = slabs, pl.tv = (int)tv;
  pl.smem = (int)(kScratch + cap * 16 + ring_t * ring1);
  // a CTA of at most half an SM's shared memory: two an SM at 256 threads
  pl.threads = pl.smem <= kSmemPerSm / 2 - kBlockReserve ? kSmallThreads : kMaxThreads;
  return 0;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  return sms;
}

// the launch of `clusters` clusters of the plan's K CTAs
inline cudaLaunchConfig_t config(const Plan& pl, int clusters, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pl.k * clusters));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int prepare(const Plan& pl) {
  auto kernel = bn_fwd_cluster<T>;
  if ((size_t)pl.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     pl.smem);
  if (!rc && pl.k > 8)
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return rc;
}

// the clusters of the plan the card holds at once
template <typename T>
int active_clusters(const Plan& pl, int* out) {
  if (int rc = prepare<T>(pl)) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(pl, 1, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, bn_fwd_cluster<T>, &cfg);
}

template <typename T>
int run(Args p, cudaStream_t s) {
  constexpr int V = Vec<T>::n;
  if (p.n < 1 || p.c < 8 || p.c % 8 || p.hw < 1 || p.c > 65535 ||
      (long long)p.n * p.c * p.hw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (int rc = plan(p.n, p.c, p.hw, V, p.res != nullptr, sms, pl)) return rc;
  p.cg = pl.cg, p.k = pl.k, p.ns = pl.ns, p.cs = pl.cs, p.rowv = pl.rowv;
  p.cap = pl.cap, p.ring_t = pl.ring_t, p.slabs = pl.slabs;
  p.m = (long long)p.n * p.hw;
  int clusters = pl.slabs;
  if (kPersistent) {
    int active = 0;
    if (int rc = active_clusters<T>(pl, &active)) return rc;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    clusters = std::min(clusters, active);
  } else if (int rc = prepare<T>(pl)) {
    return rc;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(pl, clusters, s, attr);
  int rc = (int)cudaLaunchKernelEx(&cfg, bn_fwd_cluster<T>, p);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace bnf

}  // namespace

extern "C" {

// The dropout key of both: the seed pair, the keep threshold,
// f32(1 / (1 - p)) and the reference's row tile (drop_rows = block_r,
// drop_cols = H); drop_rows 0: no dropout.
//
// y [R, H]; mean, rstd [R] f32. res / lin_b may be null.
#define LN_FWD(SUFFIX, T)                                                                    \
  int ln_fwd_##SUFFIX(const void* h, const void* res, const void* lin_b, const void* w,      \
                      const void* b, void* y, void* mean, void* rstd, int r, int hd,         \
                      float eps, unsigned s0, unsigned s1, unsigned thresh, float inv,       \
                      int drop_rows, int drop_cols, void* stream) {                          \
    Fwd p{h,                                                                                 \
          res,                                                                               \
          static_cast<const float*>(lin_b),                                                  \
          static_cast<const float*>(w),                                                      \
          static_cast<const float*>(b),                                                      \
          y,                                                                                 \
          static_cast<float*>(mean),                                                         \
          static_cast<float*>(rstd),                                                         \
          r,                                                                                 \
          hd,                                                                                \
          eps,                                                                               \
          Drop{s0, s1, thresh, inv, drop_rows, drop_cols}};                                  \
    return launch_fwd<T>(p, stream);                                                         \
  }
LN_FWD(f32, float)
LN_FWD(bf16, __nv_bfloat16)

// dh [R, H], dres [R, H] (null without a residual); part: f32 workspace
// [ceil(R / 32), nacc, H]; sums [nacc, H] f32: dw, db (, dlin_b when nacc 3).
#define LN_BWD(SUFFIX, T)                                                                    \
  int ln_bwd_##SUFFIX(const void* h, const void* res, const void* lin_b, const void* w,      \
                      const void* mean, const void* rstd, const void* g, void* dh,           \
                      void* dres, void* part, void* sums, int r, int hd, int nacc,           \
                      unsigned s0, unsigned s1, unsigned thresh, float inv,                  \
                      int drop_rows, int drop_cols, void* stream) {                          \
    Bwd p{h,                                                                                 \
          res,                                                                               \
          static_cast<const float*>(lin_b),                                                  \
          static_cast<const float*>(w),                                                      \
          static_cast<const float*>(mean),                                                   \
          static_cast<const float*>(rstd),                                                   \
          g,                                                                                 \
          dh,                                                                                \
          dres,                                                                              \
          static_cast<float*>(part),                                                         \
          r,                                                                                 \
          hd,                                                                                \
          nacc,                                                                              \
          Drop{s0, s1, thresh, inv, drop_rows, drop_cols}};                                  \
    return launch_bwd<T>(p, static_cast<float*>(sums), stream);                              \
  }
LN_BWD(f32, float)
LN_BWD(bf16, __nv_bfloat16)

int ln_rows_per_part() { return kRowsPerPart; }

// the persistent route: ln_bwd's arguments and the blocks (partial rows of
// part [nparts, nacc, H]) before the stream
#define LN_BWD_PERSIST(SUFFIX, T)                                                            \
  int ln_bwd_persist_##SUFFIX(const void* h, const void* res, const void* lin_b,             \
                              const void* w, const void* mean, const void* rstd,             \
                              const void* g, void* dh, void* dres, void* part, void* sums,   \
                              int r, int hd, int nacc, unsigned s0, unsigned s1,             \
                              unsigned thresh, float inv, int drop_rows, int drop_cols,      \
                              int nparts, void* stream) {                                    \
    Bwd p{h,                                                                                 \
          res,                                                                               \
          static_cast<const float*>(lin_b),                                                  \
          static_cast<const float*>(w),                                                      \
          static_cast<const float*>(mean),                                                   \
          static_cast<const float*>(rstd),                                                   \
          g,                                                                                 \
          dh,                                                                                \
          dres,                                                                              \
          static_cast<float*>(part),                                                         \
          r,                                                                                 \
          hd,                                                                                \
          nacc,                                                                              \
          Drop{s0, s1, thresh, inv, drop_rows, drop_cols}};                                  \
    return launch_bwd_persist<T>(p, static_cast<float*>(sums), nparts, stream);              \
  }
LN_BWD_PERSIST(f32, float)
LN_BWD_PERSIST(bf16, __nv_bfloat16)


// x, res, y [N, C, HW]; w, b [C] f32, or bf16 with vbf16 1; mean, var [C] f32
// (written); part: f32 workspace [fused_bn_parts(N, HW), 2, C]; coef: f32
// workspace [2, C].
#define FUSED_BN_FWD(SUFFIX, T)                                                              \
  int fused_bn_fwd_##SUFFIX(const void* x, const void* res, const void* w, const void* b,    \
                            void* y, void* mean, void* var, void* part, void* coef, int n,   \
                            int c, int hw, float eps, int relu, int vbf16, void* stream) {   \
    bn::Args p{};                                                                            \
    p.x = x, p.res = res, p.w = ChanVec{w, vbf16}, p.b = ChanVec{b, vbf16}, p.y = y;         \
    p.mean = p.s1 = static_cast<float*>(mean), p.var = p.s2 = static_cast<float*>(var);      \
    p.part = static_cast<float*>(part), p.coef = static_cast<float*>(coef);                  \
    p.n = n, p.c = c, p.hw = hw, p.eps = eps, p.relu = relu;                                 \
    if (int rc = bn::check(p, {x, res, y})) return rc;                                    \
    return bn::run<T, bn::FWD>(p, static_cast<cudaStream_t>(stream));                        \
  }
FUSED_BN_FWD(f32, float)
FUSED_BN_FWD(bf16, __nv_bfloat16)

// g, dx, dres [N, C, HW] (dres null without a residual); w, b as the
// forward's; mean, var [C] f32 (the forward's); gmean, gvar [C] f32 or null
// (zero cotangents); dw, db [C] f32 (written: sum g' x^, sum g'); part
// [fused_bn_parts(N, HW), 2, C] and coef [4, C] f32 workspaces.
#define FUSED_BN_BWD(SUFFIX, T)                                                              \
  int fused_bn_bwd_##SUFFIX(const void* x, const void* res, const void* w, const void* b,    \
                            const void* mean, const void* var, const void* g,                \
                            const void* gmean, const void* gvar, void* dx, void* dres,       \
                            void* dw, void* db, void* part, void* coef, int n, int c,        \
                            int hw, float eps, int relu, int vbf16, void* stream) {          \
    bn::Args p{};                                                                            \
    p.x = x, p.res = res, p.g = g, p.w = ChanVec{w, vbf16}, p.b = ChanVec{b, vbf16};         \
    p.mean = const_cast<float*>(static_cast<const float*>(mean));                            \
    p.var = const_cast<float*>(static_cast<const float*>(var));                              \
    p.gmean = static_cast<const float*>(gmean), p.gvar = static_cast<const float*>(gvar);    \
    p.s1 = static_cast<float*>(db), p.s2 = static_cast<float*>(dw);                          \
    p.dx = dx, p.dres = dres;                                                                \
    p.part = static_cast<float*>(part), p.coef = static_cast<float*>(coef);                  \
    p.n = n, p.c = c, p.hw = hw, p.eps = eps, p.relu = relu;                                 \
    if (int rc = bn::check(p, {x, res, g, dx, dres})) return rc;                          \
    return bn::run<T, bn::BWD>(p, static_cast<cudaStream_t>(stream));                        \
  }
FUSED_BN_BWD(f32, float)
FUSED_BN_BWD(bf16, __nv_bfloat16)

// The persistent route (bnb): fused_bn_bwd's tensors, with dw, db, the
// partials, the coefficients and the counters in one f32 scratch [6C + 2PC
// + 2G] (bnb::run's layout; P = 2 blocks an SM x SMs, G the plan's
// groups); dw16, db16 [C] bf16 (null with f32 w and b): dw and db rounded
// once for bf16 w and b; skip: a planted fault, every fold leaving out tile
// `skip`'s partial (-1: none). A memset of the counters, then one launch.
#define FUSED_BN_BWD_PERSIST(SUFFIX, T)                                                      \
  int fused_bn_bwd_persist_##SUFFIX(const void* x, const void* res, const void* w,           \
                                    const void* b, const void* mean, const void* var,        \
                                    const void* g, const void* gmean, const void* gvar,      \
                                    void* dx, void* dres, void* scratch, void* dw16,         \
                                    void* db16, int n, int c, int hw, float eps, int relu,   \
                                    int skip, int vbf16, void* stream) {                     \
    bnb::Args p{};                                                                           \
    p.x = x, p.res = res, p.g = g, p.w = ChanVec{w, vbf16}, p.b = ChanVec{b, vbf16};         \
    p.mean = static_cast<const float*>(mean);                                                \
    p.var = static_cast<const float*>(var), p.gmean = static_cast<const float*>(gmean);      \
    p.gvar = static_cast<const float*>(gvar), p.dx = dx, p.dres = dres;                      \
    p.dw16 = dw16, p.db16 = db16;                                                            \
    p.n = n, p.c = c, p.hw = hw, p.relu = relu, p.gate_res = relu && res, p.skip = skip;     \
    p.eps = eps;                                                                             \
    const std::initializer_list<const void*> rows = {x, res, g, dx, dres, scratch};          \
    for (const void* r : rows)                                                               \
      if (r && !aligned16(r)) return (int)cudaErrorMisalignedAddress;                        \
    return bnb::run<T>(p, static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));  \
  }
FUSED_BN_BWD_PERSIST(f32, float)
FUSED_BN_BWD_PERSIST(bf16, __nv_bfloat16)

// the persistent route's plan as bnb::run reckons it on `sms` SMs, for a
// check of its Python mirror (norm_fusion.bn_bwd_plan): out[8] = cg,
// groups, th, tw, cg_last, th_last, tw_last, cap; vec: elements a 16-byte
// vector; tensors: 2 (x, g) or 3 (and the residual)
int fused_bn_bwd_plan(int n, int c, int hw, int vec, int tensors, int sms, int* out) {
  bnb::Plan pl;
  if (int rc = bnb::plan(n, c, hw, vec, tensors, bnb::kBlocksPerSm * sms / bnb::kTeams,
                         bnb::kSlotBytes, bnb::kL2Bytes, pl))
    return rc;
  const int v[8] = {pl.cg, pl.groups, pl.th, pl.tw, pl.cg_last, pl.th_last, pl.tw_last, pl.cap};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// the reduction's parts (row count of the part workspace) for N planes of HW
int fused_bn_parts(int n, int hw) { return n < 1 || hw < 1 ? 0 : bn::nparts(n, hw); }

// The cluster route (bnf): x, res, y [N, C, HW] (res null without a
// residual); w, b [C] f32, or bf16 with vbf16 1; mean, var [C] f32
// (written); skip: a planted
// fault, rank 0's fold leaving out the last rank's partial (0: none). One
// launch; no workspace.
#define FUSED_BN_FWD_CLUSTER(SUFFIX, T)                                                      \
  int fused_bn_fwd_cluster_##SUFFIX(const void* x, const void* res, const void* w,           \
                                    const void* b, void* y, void* mean, void* var, int n,    \
                                    int c, int hw, float eps, int relu, int skip, int vbf16, \
                                    void* stream) {                                          \
    bnf::Args p{};                                                                           \
    p.x = x, p.res = res, p.w = ChanVec{w, vbf16}, p.b = ChanVec{b, vbf16}, p.y = y;         \
    p.mean = static_cast<float*>(mean), p.var = static_cast<float*>(var);                    \
    p.n = n, p.c = c, p.hw = hw, p.eps = eps, p.relu = relu, p.skip = skip;                  \
    const std::initializer_list<const void*> rows = {x, res, y};                             \
    for (const void* r : rows)                                                               \
      if (r && !aligned16(r)) return (int)cudaErrorMisalignedAddress;                        \
    return bnf::run<T>(p, static_cast<cudaStream_t>(stream));                                \
  }                                                                                          \
  /* the route's K at [n, c, hw] on this card and the clusters it holds at */                \
  /* once (cudaOccupancyMaxActiveClusters): out[2] */                                        \
  int fused_bn_fwd_clusters_##SUFFIX(int n, int c, int hw, int res, int* out) {              \
    const int sms = bnf::sm_count();                                                         \
    bnf::Plan pl;                                                                            \
    if (int rc = bnf::plan(n, c, hw, Vec<T>::n, res, sms, pl)) return rc;                   \
    out[0] = pl.k;                                                                           \
    return bnf::active_clusters<T>(pl, out + 1);                                             \
  }
FUSED_BN_FWD_CLUSTER(f32, float)
FUSED_BN_FWD_CLUSTER(bf16, __nv_bfloat16)

// the cluster route's plan as bnf::run reckons it on `sms` SMs, for a check
// of its Python mirror (norm_fusion.bn_fwd_plan): out[11] = cg, K, ns, cs,
// rowv, cap, ring_t, smem, slabs, tv, threads; vec: elements a 16-byte
// vector; res: 1 with a residual
int fused_bn_fwd_plan(int n, int c, int hw, int vec, int res, int sms, int* out) {
  bnf::Plan pl;
  if (int rc = bnf::plan(n, c, hw, vec, res, sms, pl)) return rc;
  const int v[11] = {pl.cg,   pl.k,    pl.ns,    pl.cs, pl.rowv,   pl.cap,
                     pl.ring_t, pl.smem, pl.slabs, pl.tv, pl.threads};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
