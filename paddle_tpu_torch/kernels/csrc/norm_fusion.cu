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
// No dropout (the seeded keep-mask is ROADMAP A6b).
//
//   forward:  z = h (+ lin_b) (+ res) in f32; mean = sum(z) / H; the
//             centred variance var = sum((z - mean)^2) / H in a second
//             pass over the row (:110-113, not Welford);
//             rstd = rsqrt(var + eps); y = round((z - mean) * rstd * w + b);
//             mean and rstd are written [R] f32 (the residuals the backward
//             reads, :323-327).
//   backward: z and x^ = (z - mean) * rstd recomputed from the primal inputs
//             and the saved stats; gw = g * w; c1 = mean(gw);
//             c2 = mean(gw * x^); dz = (gw - c1 - x^ * c2) * rstd (:182-184);
//             dh = round(dz), dres = round(dz); dw = sum_r g * x^,
//             db = sum_r g, dlin_b = sum_r dz, in f32 (:190-195).
// round() is the rounding to the I/O dtype.
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

#include "common.cuh"

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
};

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd_vec(Fwd p) {
  constexpr int V = Vec<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.r) return;
  const int nvec = p.hd / V;
  const size_t base = (size_t)row * p.hd;
  const T* h = static_cast<const T*>(p.h) + base;
  const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
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

template <typename T>
__device__ __forceinline__ float z_at(const Fwd& p, const T* h, const T* res, int c) {
  float z = to_f(h[c]);
  if (p.lin_b) z += p.lin_b[c];
  if (res) z += to_f(res[c]);
  return z;
}

// any H, any alignment: one warp per row, three passes over the row
template <typename T>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd_generic(Fwd p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.r) return;
  const size_t base = (size_t)row * p.hd;
  const T* h = static_cast<const T*>(p.h) + base;
  const T* res = p.res ? static_cast<const T*>(p.res) + base : nullptr;
  float s = 0.f;
  for (int c = lane; c < p.hd; c += 32) s += z_at(p, h, res, c);
  const float mean = warp_sum(s) / p.hd;
  float v = 0.f;
  for (int c = lane; c < p.hd; c += 32) {
    const float d = z_at(p, h, res, c) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / p.hd + p.eps);
  T* y = static_cast<T*>(p.y) + base;
  for (int c = lane; c < p.hd; c += 32)
    y[c] = from_f<T>((z_at(p, h, res, c) - mean) * rstd * p.w[c] + p.b[c]);
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
template <typename T, int NV>
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
        float w[V], dz[V];
        load_f32<V>(w, p.w + j * V);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          dz[k] = (gv[i][k] * w[k] - c1 - xh[i][k] * c2) * rstd;
          acc_w[i][k] += gv[i][k] * xh[i][k];
          acc_b[i][k] += gv[i][k];
          acc_lb[i][k] += dz[k];
        }
        store_vec<T>(dh + j * V, dz);
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
template <typename T>
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
    auto xhat = [&](int c) {
      float z = to_f(h[c]);
      if (p.lin_b) z += p.lin_b[c];
      if (res) z += to_f(res[c]);
      return (z - mean) * rstd;
    };
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
      dh[c] = from_f<T>(dz);
      if (dres) dres[c] = from_f<T>(dz);
      const float v[3] = {gf * xh, gf, dz};
      for (int a = 0; a < p.nacc; ++a) {
        float* q = part + (size_t)a * p.hd + c;
        *q = it == 0 ? v[a] : *q + v[a];
      }
    }
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

template <typename T>
int launch_fwd(const Fwd& p, void* stream) {
  if (p.r < 1 || p.hd < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p.h) && (!p.res || aligned16(p.res)) && aligned16(p.y) &&
                       (!p.lin_b || aligned16(p.lin_b)) && aligned16(p.w) && aligned16(p.b);
  const dim3 grid((p.r + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_nv<T>(p.hd, kFwdMaxNV, aligned)) {
    case 1: ln_fwd_vec<T, 1><<<grid, block, 0, s>>>(p); break;
    case 2: ln_fwd_vec<T, 2><<<grid, block, 0, s>>>(p); break;
    case 4: ln_fwd_vec<T, 4><<<grid, block, 0, s>>>(p); break;
    case 8: ln_fwd_vec<T, 8><<<grid, block, 0, s>>>(p); break;
    default: ln_fwd_generic<T><<<grid, block, 0, s>>>(p); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const Bwd& p, float* sums, void* stream) {
  if (p.r < 1 || p.hd < 1 || p.nacc < 2 || p.nacc > 3) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p.h) && (!p.res || aligned16(p.res)) && aligned16(p.g) &&
                       aligned16(p.dh) && (!p.dres || aligned16(p.dres)) &&
                       (!p.lin_b || aligned16(p.lin_b)) && aligned16(p.w);
  const int nparts = (p.r + kRowsPerPart - 1) / kRowsPerPart;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kWarps * p.hd * sizeof(float);
  const dim3 block(kWarps * 32);
  switch (pick_nv<T>(p.hd, kBwdMaxElems / Vec<T>::n, aligned)) {
    case 1: ln_bwd_vec<T, 1><<<nparts, block, smem, s>>>(p); break;
    case 2: ln_bwd_vec<T, 2><<<nparts, block, smem, s>>>(p); break;
    case 4: ln_bwd_vec<T, 4><<<nparts, block, smem, s>>>(p); break;
    case 8: ln_bwd_vec<T, 8><<<nparts, block, smem, s>>>(p); break;
    default: ln_bwd_generic<T><<<nparts, 32, 0, s>>>(p); break;
  }
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int cols = p.nacc * p.hd;
  return sum_parts(p.part, nparts, cols, sums, cols, nullptr, 8, s);
}

}  // namespace

extern "C" {

// y [R, H]; mean, rstd [R] f32. res / lin_b may be null.
#define LN_FWD(SUFFIX, T)                                                                    \
  int ln_fwd_##SUFFIX(const void* h, const void* res, const void* lin_b, const void* w,      \
                      const void* b, void* y, void* mean, void* rstd, int r, int hd,         \
                      float eps, void* stream) {                                             \
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
          eps};                                                                              \
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
                      void* stream) {                                                        \
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
          nacc};                                                                             \
    return launch_bwd<T>(p, static_cast<float*>(sums), stream);                              \
  }
LN_BWD(f32, float)
LN_BWD(bf16, __nv_bfloat16)

int ln_rows_per_part() { return kRowsPerPart; }

}  // extern "C"
