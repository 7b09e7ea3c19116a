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
// many SMs at once rather than by the one program the TPU grid ran, and
// both streams need enough bytes in flight (~25-30 KB an SM) to cover the
// memory's latency.
//
// Two routes, picked by the wrapper (mlp_fusion.decode_route):
//
// The split route (namespace sp; bf16 and f32, D 64 or 128, NH * D 1024 or
// 2048, G 1, 2, 4 or 8, HO a whole number of 16-byte vectors, 16-byte
// aligned pools and weight): two launches on the caller's stream, no sync,
// no atomics.
//   1. decode_attn_split_kernel, grid (KVH, nsplit): flash-decoding. A
//      block takes one kv head's context split and all G query heads of
//      its group, so K and V are read once per group. The splits follow
//      pos on the device (decode_split_plan mirrors them): the live pages
//      min(pos / bs + 1, MB) are cut into at most nsplit runs of whole
//      pages; blocks past the last run exit. The block table (at most
//      1024 pages) is read into shared memory beside pos. A block copies its positions into a ring
//      of kStages 32-position tiles with 16-byte cp.async (all of its
//      tiles at once at the model's shapes), scores a tile with 16 lanes a
//      row, applies one online-softmax rescale a tile (a warp a head, a
//      lane a position), accumulates P.V with a thread a column, and
//      writes its partial (m, l, o). It triggers its dependents as it
//      starts.
//   2. decode_proj_kernel, launched as a programmatic dependent: a
//      cluster of 8 blocks a column tile of 16 vectors, block `rank` the
//      row band [rank * NH * D / 8, +NH * D / 8) of proj_w (whole heads),
//      one band row a thread. Each block loads its 64 KB of the weight
//      into registers while attention runs, then waits on the attention
//      grid (griddepcontrol.wait), merges its heads' split partials into
//      attn in split order (every cluster merges the heads it needs: 2 MB
//      of L2 reads at gpt3-1.3b's shape, against a ticket, a fence and
//      an L2 round trip more on the path), rounds attn to the weight type
//      (:1032), multiplies it into the band and adds the band's rows head
//      by head. Rank 0 adds y = bias + the heads in order (:1033-1037)
//      from the cluster's shared memory.
//   Every sum has one order: two calls give the same bits.
//
// The generic route (every other shape): three launches.
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
// Scratch and output are allocated by the Python wrapper.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;            // warps per attention block
constexpr int kPerLane = 8;          // D <= 32 * kPerLane
constexpr int kMaxD = 32 * kPerLane;
constexpr int kMaxSplits = 64;     // splits a kv head times its group, at most
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

// ==========================================================================
// the split route
// ==========================================================================

namespace sp {

constexpr int kAttnThreads = 128;  // 4 warps
constexpr int kTile = 32;          // context positions a tile: a lane each in the softmax
constexpr int kStages = 3;         // tiles a block keeps in flight
constexpr int kMaxSplits = 32;     // splits a kv head: the partials a projection thread merges
constexpr int kMaxPages = 1024;    // table entries (the block table sits in shared memory)
constexpr int kCluster = 8;        // projection blocks a column tile, one row band each
constexpr int kVecs = 16;          // 16-byte vectors of a projection row band's row

template <typename T>
struct Args {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* position;
  const int* table;
  const T* w;
  const T* bias;
  T* y;
  float* part;  // [KVH * nsplit * G] m, the same of l, then [.. * D] o
  int nh, kvh, block_size, nblocks, mb, ho, nsplit;
  float scale;
  int probe;  // the probe's cuts (0 on the route): 1 no merge (attn = 1), 2 the weight
              // loads only, 4 (with 2) launched without the cluster
};

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// 16 bytes of the weight stream: read once, kept out of L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T>
__device__ __forceinline__ void unpack(float* dst, const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 16 / (int)sizeof(T); ++k) dst[k] = to_f(e[k]);
}

// the live splits of a kv head's context at pos, as decode_split_plan
// reckons them: the live pages cut into runs of pps whole pages
struct Splits {
  int live, pps, nsl;
  __device__ Splits(int pos, int block_size, int mb, int nsplit) {
    live = min(pos / block_size + 1, mb);
    pps = (live + nsplit - 1) / nsplit;
    nsl = (live + pps - 1) / pps;
  }
};

template <typename T, int D>
constexpr size_t attn_smem() {
  return (size_t)kStages * 2 * kTile * D * sizeof(T);
}

// One block: kv head blockIdx.x, context split blockIdx.y, all G query heads
// of the group; writes the split's partial (m, l, o). Dynamic shared
// memory: the K/V ring [kStages][2][kTile][D].
template <typename T, int D, int G>
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_split_kernel(Args<T> a) {
  pdl_trigger();  // the projection may start streaming its weight now
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = D / V;                      // 16-byte vectors a row
  constexpr int LPR = NV < 16 ? NV : 16;         // lanes a row when scoring
  constexpr int VPL = NV / LPR;                  // vectors a lane
  constexpr int RPW = 32 / LPR;                  // rows a warp scores at once
  constexpr int RP = kAttnThreads / D;           // threads a column in P.V (1 or 2)
  constexpr int HPW = (G + 3) / 4;               // heads a warp runs the softmax for
  static_assert(NV % LPR == 0 && kAttnThreads % D == 0, "D must be 64 or 128");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ float sc[G][kTile];   // scores, then weights
  __shared__ float al[G];          // the tile's rescale
  __shared__ float ored[RP > 1 ? G * D : 1];
  __shared__ int tab[kMaxPages];

  const int kvi = blockIdx.x, split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the table (clipped onto real blocks: pad entries read a real block,
  // which the position mask leaves out) read beside pos, not after it
  for (int i = threadIdx.x; i < a.mb; i += kAttnThreads)
    tab[i] = min(max(a.table[i], 0), a.nblocks - 1);
  const int pos = *a.position;
  const Splits plan(pos, a.block_size, a.mb, a.nsplit);
  if (split >= plan.nsl) return;
  const int t0 = split * plan.pps * a.block_size;
  const int t1 = min(min((split + 1) * plan.pps, plan.live) * a.block_size, pos + 1);
  const int ntile = (t1 - t0 + kTile - 1) / kTile;
  __syncthreads();  // tab

  // a tile's K and V rows, 2 * kTile * NV 16-byte copies, kLoads a thread
  constexpr int kLoads = 2 * kTile * NV / kAttnThreads;
  static_assert(kLoads * kAttnThreads == 2 * kTile * NV, "whole copies a thread");
  auto load_tile = [&](int i) {
    T* dst = ring + (size_t)(i % kStages) * 2 * kTile * D;
    const int base = t0 + i * kTile;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kAttnThreads;
      const int which = idx / (kTile * NV), rem = idx % (kTile * NV);
      const int r = rem / NV, v = rem % NV;
      const int t = base + r;
      if (t < t1) {
        const long long row =
            ((long long)tab[t / a.block_size] * a.block_size + t % a.block_size) * a.kvh + kvi;
        cp_async16(dst + (which * kTile + r) * D + v * V,
                   (which ? a.v_pool : a.k_pool) + row * D + v * V, true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntile) {
      load_tile(i);
    } else {
      cp_async_commit();
    }
  }

  // q scaled in f32 and rounded to q's type (:1101), the lane's columns
  float qr[G][VPL * V];
  const int lr = lane % LPR;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = a.q + (size_t)(kvi * G + g) * D;
#pragma unroll
    for (int u = 0; u < VPL; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k)
        qr[g][u * V + k] = to_f(from_f<T>(to_f(qh[(lr + u * LPR) * V + k]) * a.scale));
  }
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) m_run[j] = kNegInf, l_run[j] = 0.f;
  float o[G];
#pragma unroll
  for (int g = 0; g < G; ++g) o[g] = 0.f;
  const int col = threadIdx.x % D, rp = threadIdx.x / D;

  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for every thread; tile i - 1 is done with
    if (i + kStages - 1 < ntile) {
      load_tile(i + kStages - 1);
    } else {
      cp_async_commit();
    }
    const T* kt = ring + (size_t)(i % kStages) * 2 * kTile * D;
    const T* vt = kt + kTile * D;
    const int nval = min(kTile, t1 - (t0 + i * kTile));
    // scores: LPR lanes a row
    for (int r0 = warp * RPW; r0 < kTile; r0 += 4 * RPW) {
      const int r = r0 + lane / LPR;
      float kv[VPL * V];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        unpack<T>(kv + u * V, *reinterpret_cast<const uint4*>(kt + r * D + (lr + u * LPR) * V));
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < VPL * V; ++k) s += qr[g][k] * kv[k];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lr == 0) sc[g][r] = r < nval ? s : kNegInf;
      }
    }
    __syncthreads();
    // the online softmax, one rescale a tile: warp w takes heads w, w + 4
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + 4 * j;
      if (g < G) {
        const float s = sc[g][lane];
        const float m_new = fmaxf(m_run[j], warp_max(s));
        const float alpha = expf(m_run[j] - m_new);
        const float p = expf(s - m_new);  // masked rows: exactly 0
        l_run[j] = l_run[j] * alpha + warp_sum(p);
        m_run[j] = m_new;
        sc[g][lane] = p;
        if (lane == 0) al[g] = alpha;
      }
    }
    __syncthreads();
    // P.V: a thread a column (two threads a column at D 64, rows split by parity)
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] *= al[g];
#pragma unroll 4
    for (int r = rp; r < nval; r += RP) {
      const float v = to_f(vt[r * D + col]);
#pragma unroll
      for (int g = 0; g < G; ++g) o[g] += sc[g][r] * v;
    }
  }
  cp_async_wait<0>();

  // the block's partial (m, l, o) for each head of the group
  const int n = a.kvh * a.nsplit * G;
  const int pidx = (kvi * a.nsplit + split) * G;
  if (RP > 1) {
    if (rp == 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) ored[g * D + col] = o[g];
    }
    __syncthreads();
  }
  if (rp == 0) {
    float* po = a.part + 2 * (size_t)n;
#pragma unroll
    for (int g = 0; g < G; ++g)
      po[(size_t)(pidx + g) * D + col] = RP > 1 ? o[g] + ored[g * D + col] : o[g];
  }
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int g = warp + 4 * j;
    if (g < G && lane == 0) {
      a.part[pidx + g] = m_run[j];
      a.part[n + pidx + g] = l_run[j];
    }
  }
}

// The projection: a cluster of kCluster blocks a column tile of CT = 16 V
// columns, block `rank` holding the row band [rank * RB, +RB) of proj_w (RB
// = NH * D / kCluster: whole heads), one row of the band a thread. It loads
// its 16 vectors of the band into registers while attention runs
// (programmatic dependent launch), then waits on the attention grid, merges
// the splits' partials of its rows into attn (split order; rounded to the
// weight type, :1032), multiplies attn into the band (each thread 16 rows:
// rs + RB / 16 * k), adds the band's rows head by head (lane pairs, then
// the warps in order) and leaves each head's partial row in shared memory;
// rank 0 adds y = bias + the heads in order (:1033-1037) from the cluster's
// shared memory.
template <typename T, int D, int RB>
__global__ void __launch_bounds__(RB) decode_proj_kernel(Args<T> a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CT = kVecs * V;     // columns a block
  constexpr int RS = RB / kVecs;    // row steps: a thread's rows rs + RS * k, k < 16
  constexpr int NH_B = RB / D;      // heads a band
  constexpr int NW = RB / 32;       // warps
  static_assert(RB % D == 0 && D % RS == 0 && NH_B <= NW, "bands of whole heads");
  __shared__ float mw[NH_B][kMaxSplits];  // the splits' m, then weights
  __shared__ float ml[NH_B][kMaxSplits];
  __shared__ float lt[NH_B];
  __shared__ float att[RB];
  __shared__ float red[NW][NH_B][CT];
  __shared__ float heads[NH_B][CT];
  const int rank = blockIdx.x % kCluster;  // the cluster's rank: clusters of kCluster along x
  const int ct = blockIdx.x / kCluster;
  const int r0 = rank * RB;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int v = t % kVecs, rs = t / kVecs;
  const int c0 = ct * CT + v * V;
  const bool in = c0 < a.ho;  // HO is a whole number of vectors
  uint4 wv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    wv[k] = in ? ld_stream(a.w + (size_t)(r0 + rs + RS * k) * a.ho + c0) : make_uint4(0u, 0u, 0u, 0u);
  const int pos = *a.position;  // an input: read before the wait
  const Splits plan(pos, a.block_size, a.mb, a.nsplit);
  const int grp = a.nh / a.kvh;
  const int n = a.kvh * a.nsplit * grp;
  pdl_wait();  // the attention grid has finished: its partials are written
  if (a.probe & 2) {  // the probe: the weight stream alone
    uint32_t x = 0u;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) x ^= wv[k].x ^ wv[k].y ^ wv[k].z ^ wv[k].w;
    if (x == 0x9E3779B9u) a.y[0] = from_f<T>(0.f);  // keeps the loads
    return;
  }

  // the merge: this thread's row of attn, its head's splits in order
  if (a.probe & 1) {
    att[t] = 1.f;
  } else {
    const int hb = t / D, h = r0 / D + hb, e = t % D;
    const int base = ((h / grp) * a.nsplit) * grp + h % grp;  // split s: base + s * grp
    float ov[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      ov[s] = s < plan.nsl ? __ldcg(a.part + 2 * (size_t)n + (size_t)(base + s * grp) * D + e) : 0.f;
    for (int i = t; i < NH_B * kMaxSplits; i += RB) {
      const int j = i / kMaxSplits, s = i % kMaxSplits;
      const int k = ((r0 / D + j) / grp * a.nsplit + s) * grp + (r0 / D + j) % grp;
      mw[j][s] = s < plan.nsl ? __ldcg(a.part + k) : kNegInf;
      ml[j][s] = s < plan.nsl ? __ldcg(a.part + n + k) : 0.f;
    }
    __syncthreads();
    if (warp < NH_B) {  // warp j: head j of the band, a lane a split
      const float m = mw[warp][lane];
      const float mg = warp_max(m);
      const float ws = lane < plan.nsl ? expf(m - mg) : 0.f;
      const float l = warp_sum(ml[warp][lane] * ws);
      mw[warp][lane] = ws;
      if (lane == 0) lt[warp] = l;
    }
    __syncthreads();
    float ot = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) ot += ov[s] * mw[hb][s];
    att[t] = to_f(from_f<T>(ot / lt[hb]));  // cast to the weight type (:1032)
  }
  __syncthreads();

  // the band's product: thread rows rs + RS * k, head (rs + RS * k) / D
  float acc[NH_B][V];
#pragma unroll
  for (int j = 0; j < NH_B; ++j)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int j = k * RS / D;  // rs < RS <= D: the head does not depend on rs
    const float at = att[rs + RS * k];
    float wf[V];
    unpack<T>(wf, wv[k]);
#pragma unroll
    for (int c = 0; c < V; ++c) acc[j][c] += at * wf[c];
  }
  // lanes l and l + 16 (rows rs, rs + 1 of one vector), then the warps in order
#pragma unroll
  for (int j = 0; j < NH_B; ++j)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], 16);
      if (lane < 16) red[warp][j][v * V + c] = acc[j][c];
    }
  __syncthreads();
  for (int i = t; i < NH_B * CT; i += RB) {
    const int j = i / CT, c = i % CT;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w][j][c];
    heads[j][c] = s;
  }
  cluster_sync();  // every band's head rows are written
  if (rank == 0 && t < CT && ct * CT + t < a.ho) {
    float y = to_f(a.bias[ct * CT + t]);  // bias first, in f32 (:1033)
#pragma unroll
    for (int b = 0; b < kCluster; ++b)
#pragma unroll
      for (int j = 0; j < NH_B; ++j) y += ld_cluster(&heads[j][t], b);
    a.y[ct * CT + t] = from_f<T>(y);
  }
  cluster_sync();  // no block leaves while rank 0 reads its shared memory
}

// parts: the probe's bitmask (decode_attn_proj_split_parts_bf16); the
// route runs all three: 1 attention, 2 projection, 4 the projection as a
// programmatic dependent of attention
constexpr int kAllParts = 7;

template <typename T, int D, int G>
int run(const Args<T>& a, int parts, cudaStream_t st) {
  cudaError_t err;
  if (parts & 1) {
    auto attn = decode_attn_split_kernel<T, D, G>;
    constexpr size_t smem = attn_smem<T, D>();
    err = cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn<<<dim3(a.kvh, a.nsplit), kAttnThreads, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    constexpr int CT = kVecs * (16 / (int)sizeof(T));
    const int rb = a.nh * D / kCluster;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.ho + CT - 1) / CT * kCluster);
    cfg.blockDim = dim3(rb);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    int nattr = 0;
    if (!(a.probe & 4)) {  // the probe's weight loads alone may run without the cluster
      attr[nattr].id = cudaLaunchAttributeClusterDimension;
      attr[nattr].val.clusterDim.x = kCluster;
      attr[nattr].val.clusterDim.y = 1;
      attr[nattr].val.clusterDim.z = 1;
      ++nattr;
    }
    if (parts & 4) {
      attr[nattr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[nattr].val.programmaticStreamSerializationAllowed = 1;
      ++nattr;
    }
    cfg.attrs = attr;
    cfg.numAttrs = nattr;
    if (rb == 128) {
      err = cudaLaunchKernelEx(&cfg, decode_proj_kernel<T, D, 128>, a);
    } else if (rb == 256) {
      err = cudaLaunchKernelEx(&cfg, decode_proj_kernel<T, D, 256>, a);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run_d(const Args<T>& a, int g, int parts, cudaStream_t st) {
  switch (g) {
    case 1: return run<T, D, 1>(a, parts, st);
    case 2: return run<T, D, 2>(a, parts, st);
    case 4: return run<T, D, 4>(a, parts, st);
    case 8: return run<T, D, 8>(a, parts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* position,
           const void* table, const void* proj_w, const void* proj_b, void* y, void* part, int nh,
           int kvh, int d, int block_size, int nblocks, int mb, int ho, int nsplit, float scale,
           int parts, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int rb = kvh > 0 ? nh * d / kCluster : 0;
  const int probe = parts >> 3;
  parts &= kAllParts;
  if ((probe & 4) && !(probe & 2)) return (int)cudaErrorInvalidValue;
  if (kvh < 1 || nh % kvh != 0 || nsplit < 1 || nsplit > kMaxSplits || mb < 1 || mb > kMaxPages ||
      block_size < 1 || nblocks < 1 || ho < 1 || ho % V != 0 || (rb != 128 && rb != 256) ||
      nh * d != rb * kCluster || !aligned16(k_pool) || !aligned16(v_pool) || !aligned16(proj_w))
    return (int)cudaErrorInvalidValue;
  Args<T> a{static_cast<const T*>(q),      static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), static_cast<const int*>(position),
            static_cast<const int*>(table), static_cast<const T*>(proj_w),
            static_cast<const T*>(proj_b), static_cast<T*>(y),
            static_cast<float*>(part),     nh, kvh, block_size, nblocks, mb, ho, nsplit, scale,
            probe};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = nh / kvh;
  if (d == 128) return run_d<T, 128>(a, g, parts, st);
  if (d == 64) return run_d<T, 64>(a, g, parts, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace sp

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

// the split route: the generic entry's arguments with its scratch as part
// (f32 [NH * nsplit * (2 + D)]: the splits' m, l, o) and nsplit the
// attention grid's splits a kv head (at most kMaxSplits)
#define DECODE_SPLIT(SUFFIX, T)                                                               \
  int decode_attn_proj_split_##SUFFIX(                                                        \
      const void* q, const void* k_pool, const void* v_pool, const void* position,           \
      const void* table, const void* proj_w, const void* proj_b, void* y, void* part, int nh, \
      int kvh, int d, int block_size, int nblocks, int mb, int ho, int nsplit, float scale,  \
      void* stream) {                                                                         \
    return sp::launch<T>(q, k_pool, v_pool, position, table, proj_w, proj_b, y, part, nh,    \
                         kvh, d, block_size, nblocks, mb, ho, nsplit, scale, sp::kAllParts,  \
                         stream);                                                             \
  }
DECODE_SPLIT(f32, float)
DECODE_SPLIT(bf16, __nv_bfloat16)

// the probe's entry (scripts/decode_variants.py): the route's arguments and
// the parts to launch (1 attention, 2 projection, 4 as a programmatic
// dependent; 8 the projection without the merge, 16 its weight loads
// alone, 32 those launched without the cluster) before the stream; no path
// calls it
int decode_attn_proj_split_parts_bf16(const void* q, const void* k_pool, const void* v_pool,
                                      const void* position, const void* table,
                                      const void* proj_w, const void* proj_b, void* y,
                                      void* part, int nh, int kvh, int d, int block_size,
                                      int nblocks, int mb, int ho, int nsplit, float scale,
                                      int parts, void* stream) {
  return sp::launch<__nv_bfloat16>(q, k_pool, v_pool, position, table, proj_w, proj_b, y, part,
                                   nh, kvh, d, block_size, nblocks, mb, ho, nsplit, scale,
                                   parts, stream);
}

}  // extern "C"
