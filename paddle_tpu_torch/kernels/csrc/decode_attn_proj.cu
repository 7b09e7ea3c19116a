// B=1 serving decode: attention over the paged KV cache + output projection.
//
// Replaces the TPU kernel paddle_tpu/kernels/mlp_fusion.py:977
// (_decode_kernel, launched by _decode_call :1041, entered through
// decode_attn_proj :1067). Computes, for one token:
//
//   q'   = bf16/f32-round(q * scale)                      [NH, D]
//   s_j  = q'[h] . K[slot(j), h / G]   for j <= pos       (G = NH / KVH)
//   attn = softmax_j(s) . V[slot(j), h / G]               f32, [NH, D]
//   y    = proj_b + round(attn) @ proj_w                  f32 acc, out in q's type
//
// where slot(j) = clip(table[j / bs], 0, nblocks - 1) * bs + j % bs. Pages
// whose first position is past `pos` are never read; masked lanes inside a
// page are skipped (the reference's -1e30 mask gives them weight exactly 0).
//
// Bound: memory. One call must read (pos + 1) * KVH * D elements of K and
// as many of V, plus NH * D * HO elements of proj_w. At GPT-3 1.3B shapes in
// bf16 with pos = 511 that is 4 MiB + 8 MiB, ~3.8 us at 3.35 TB/s: the
// projection weight dominates at short context, so it must be streamed by
// many SMs at once rather than by the one program the TPU grid ran.
//
// Design (no TPU artifacts: no 8-row head padding, no lane-broadcast rows,
// no sequential grid). Three launches on the caller's stream, no sync:
//   1. attn_partial: grid (NH, splits). Each block walks its share of the
//      pages for one query head, one warp per context position at a time,
//      with an online softmax in f32 per warp; the warps merge in shared
//      memory and the block writes a partial (m, l, o[D]) to scratch.
//   2. proj_partial: grid (HO / 256, NH). Each block merges head h's
//      partials into attn[h] (rounded to the weight type, as the reference
//      casts before its matmul) and multiplies it into a 256-column tile of
//      the D rows of proj_w that belong to head h: NH * HO / 256 blocks
//      stream the weight in parallel. Partial sums go to scratch [NH, HO].
//   3. out: y = bias + sum over heads, in f32, cast to the output type —
//      the reference's order (bias first, then one dot per head).
// Scratch and output are allocated by the Python wrapper. wgmma, TMA and
// tuning of the split counts are left for later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;            // warps per attention block
constexpr int kPerLane = 8;          // D <= 32 * kPerLane
constexpr int kMaxD = 32 * kPerLane;
constexpr int kMaxSplits = 64;
constexpr int kColTile = 256;        // proj_w columns per block
constexpr float kNegInf = -1e30f;    // flash_attention.py:61, never -inf

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attn_partial(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ position,
             const int* __restrict__ table, int nh, int kvh, int d,
             int block_size, int nblocks, int mb, int pages_per_split,
             float scale, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_o) {
  const int h = blockIdx.x;
  const int split = blockIdx.y;
  const int kv_head = h / (nh / kvh);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = *position;

  float qv[kPerLane], o[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    // the reference scales in f32, then rounds to q's type (mlp_fusion.py:1101)
    qv[i] = e < d ? to_f(from_f<T>(to_f(q[h * d + e]) * scale)) : 0.f;
    o[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int tok0 = split * pages_per_split * block_size;
  const int tok_end = min(min((split + 1) * pages_per_split, mb) * block_size, pos + 1);
  for (int t = tok0 + warp; t < tok_end; t += kWarps) {
    int blk = table[t / block_size];
    blk = min(max(blk, 0), nblocks - 1);  // pad entries clip onto a real block
    const long long row = ((long long)blk * block_size + t % block_size) * kvh + kv_head;
    const T* kr = k_pool + row * d;
    const T* vr = v_pool + row * d;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < d) s += qv[i] * to_f(kr[e]);
    }
    s = warp_sum(s);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < d) o[i] = o[i] * alpha + p * to_f(vr[e]);
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_o[kWarps][kMaxD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < d) sm_o[warp][e] = o[i];
  }
  __syncthreads();
  float mg = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mg = fmaxf(mg, sm_m[w]);
  const long long pidx = (long long)h * gridDim.y + split;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sm_o[w][e] * expf(sm_m[w] - mg);
    part_o[pidx * d + e] = acc;
  }
  if (threadIdx.x == 0) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lt += sm_l[w] * expf(sm_m[w] - mg);
    part_m[pidx] = mg;
    part_l[pidx] = lt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kColTile)
proj_partial(const float* __restrict__ part_m, const float* __restrict__ part_l,
             const float* __restrict__ part_o, const T* __restrict__ w,
             int d, int ho, int nsplit, float* __restrict__ part_y) {
  const int h = blockIdx.y;
  __shared__ float att[kMaxD];
  __shared__ float wgt[kMaxSplits];
  __shared__ float lsum;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mg = kNegInf;
    for (int s = lane; s < nsplit; s += 32) mg = fmaxf(mg, part_m[h * nsplit + s]);
    mg = warp_max(mg);
    float lt = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float ws = expf(part_m[h * nsplit + s] - mg);
      wgt[s] = ws;
      lt += part_l[h * nsplit + s] * ws;
    }
    lt = warp_sum(lt);
    if (lane == 0) lsum = lt;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc += part_o[((long long)h * nsplit + s) * d + e] * wgt[s];
    att[e] = to_f(from_f<T>(acc / lsum));  // attn cast to the weight type (:1032)
  }
  __syncthreads();
  const int col = blockIdx.x * kColTile + threadIdx.x;
  if (col < ho) {
    const T* wr = w + (long long)h * d * ho + col;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < d; ++e) acc += att[e] * to_f(wr[(long long)e * ho]);
    part_y[(long long)h * ho + col] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kColTile)
proj_out(const float* __restrict__ part_y, const T* __restrict__ bias, int nh,
         int ho, T* __restrict__ y) {
  const int col = blockIdx.x * kColTile + threadIdx.x;
  if (col >= ho) return;
  float acc = to_f(bias[col]);  // bias first, in f32 (:1033)
  for (int h = 0; h < nh; ++h) acc += part_y[(long long)h * ho + col];
  y[col] = from_f<T>(acc);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* position, const void* table, const void* proj_w,
           const void* proj_b, void* y, void* scratch, int nh, int kvh, int d,
           int block_size, int nblocks, int mb, int ho, int pages_per_split,
           int nsplit, float scale, void* stream) {
  if (d > kMaxD || nsplit > kMaxSplits || nh % kvh != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part_m = static_cast<float*>(scratch);
  float* part_l = part_m + (long long)nh * nsplit;
  float* part_o = part_l + (long long)nh * nsplit;
  float* part_y = part_o + (long long)nh * nsplit * d;

  attn_partial<T><<<dim3(nh, nsplit), kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(position),
      static_cast<const int*>(table), nh, kvh, d, block_size, nblocks, mb,
      pages_per_split, scale, part_m, part_l, part_o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int col_tiles = (ho + kColTile - 1) / kColTile;
  proj_partial<T><<<dim3(col_tiles, nh), kColTile, 0, st>>>(
      part_m, part_l, part_o, static_cast<const T*>(proj_w), d, ho, nsplit,
      part_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  proj_out<T><<<col_tiles, kColTile, 0, st>>>(
      part_y, static_cast<const T*>(proj_b), nh, ho, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attn_proj_f32(const void* q, const void* k_pool, const void* v_pool,
                         const void* position, const void* table,
                         const void* proj_w, const void* proj_b, void* y,
                         void* scratch, int nh, int kvh, int d, int block_size,
                         int nblocks, int mb, int ho, int pages_per_split,
                         int nsplit, float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, position, table, proj_w, proj_b, y,
                       scratch, nh, kvh, d, block_size, nblocks, mb, ho,
                       pages_per_split, nsplit, scale, stream);
}

int decode_attn_proj_bf16(const void* q, const void* k_pool, const void* v_pool,
                          const void* position, const void* table,
                          const void* proj_w, const void* proj_b, void* y,
                          void* scratch, int nh, int kvh, int d, int block_size,
                          int nblocks, int mb, int ho, int pages_per_split,
                          int nsplit, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, position, table, proj_w,
                               proj_b, y, scratch, nh, kvh, d, block_size,
                               nblocks, mb, ho, pages_per_split, nsplit, scale,
                               stream);
}

}  // extern "C"
