// Hopper (sm_90a) primitives of the port's TMA + wgmma kernels (the flash
// kernels' in flash_attention.cu, the projection-LayerNorm's cluster
// route in proj_ln.cu, the GEMM core of gemm_core.cuh): shared-memory
// addresses, mbarriers with a hang trap, named and cluster barriers, reads
// of a cluster peer's shared memory and arrivals on its barriers, TMA
// loads (multicast to a cluster too), plain bulk copies both ways (the
// BatchNorm kernels' in norm_fusion.cu), stores and reduce-adds, the wgmma
// descriptor of a 128-byte swizzled tile, wgmma's fences and its products
// from shared memory (wgmma_smem), and the host-side encoding of a
// tensor map through the runtime (no libcuda at link time). Included
// after common.cuh; like it, everything here lives in an anonymous
// namespace, once per library.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda at link time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// every mbarrier wait traps after this many cycles (~18 s at 1.9 GHz): a
// broken ring ends in a launch error instead of a hung card
constexpr long long kHangCycles = 1LL << 35;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}
// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// thread block clusters
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster (whole warps: .aligned);
// arrive releases this thread's shared-memory writes, wait acquires the
// others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// arrive on the barrier at bar's offset in block `rank` of the cluster
// (the default .release.cta semantics: it only orders this thread's
// reads of the stage, which wgmma_wait has completed, before the arrival)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(a) : "memory");
}
// the f32 at p (a shared-memory address of this block) in block `rank` of
// the cluster
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// --------------------------------------------------------------------------
// TMA
// --------------------------------------------------------------------------

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// a plain bulk copy of `bytes` contiguous bytes (dst, src and bytes
// multiples of 16), completing on bar's transaction count: no tensor map
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// its converse: `bytes` contiguous bytes of this block's shared memory to
// device memory, in this thread's bulk group (bulk_commit, bulk_wait_read)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// the same load into the same offset of the shared memory of every block
// of the cluster in `mask`, completing on each one's barrier at bar's
// offset
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// global += the box in shared memory, element by element in the map's
// type, by the TMA unit
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's committed stores have read their shared memory (the
// block may leave: the writes complete on their own)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// wgmma
// --------------------------------------------------------------------------

// A wgmma operand in shared memory, 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO); lbo: for an MN-major operand, the distance between
// its 64-element column blocks (unused for K-major ones).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are in flight
template <int N = 0> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers in place around the asynchronous products: the compiler
// may neither read an accumulator before wgmma_wait nor move a write to
// it past the next product's issue
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, f32) (+)= a (64 x 16) . b (16 x N), both bf16 in shared
// memory. TA / TB: the operand is MN-major and read through wgmma's
// transpose (0: K-major). acc 0 overwrites d, else adds to it. One set
// of wrappers for every kernel of the port that takes both operands from
// shared memory (proj_ln.cu's cluster route: TA 0, TB 1; the GEMM core
// of gemm_core.cuh: all four).
template <int N, int TA, int TB> struct Wgmma;
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_smem(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int acc) {
  Wgmma<N, TA, TB>::run(d, da, db, acc);
}

// the "+f" operands d[i] .. d[i + 7] of an accumulator; the register lists
// of 32 accumulator operands each
#define HW_ACC8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HW_R0                                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HW_R1                                                                                 \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HW_R2                                                                                 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HW_R3                                                                                  \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "   \
  "%126, %127"
// N, its register list, then the operand numbers of the two descriptors,
// of scale-d (a predicate, set from acc) and of the two transpose bits
// (immediates)
#define HW_WGMMA(N, REGS, DA, DB, SC, TA_, TB_, ...)                                       \
  template <int TA, int TB> struct Wgmma<N, TA, TB> {                                      \
    static __device__ __forceinline__ void run(float (&d)[N / 2], uint64_t da, uint64_t db, \
                                               int acc) {                                  \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\n"                                                             \
          "setp.ne.b32 p, %" #SC ", 0;\n"                                                   \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS                \
          "}, %" #DA ", %" #DB ", p, 1, 1, %" #TA_ ", %" #TB_ ";\n}\n"                      \
          : __VA_ARGS__                                                                    \
          : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));                                 \
    }                                                                                      \
  };
HW_WGMMA(64, HW_R0, 32, 33, 34, 35, 36, HW_ACC8(0), HW_ACC8(8), HW_ACC8(16), HW_ACC8(24))
HW_WGMMA(128, HW_R0 HW_R1, 64, 65, 66, 67, 68, HW_ACC8(0), HW_ACC8(8), HW_ACC8(16),
         HW_ACC8(24), HW_ACC8(32), HW_ACC8(40), HW_ACC8(48), HW_ACC8(56))
HW_WGMMA(192, HW_R0 HW_R1 HW_R2, 96, 97, 98, 99, 100, HW_ACC8(0), HW_ACC8(8), HW_ACC8(16),
         HW_ACC8(24), HW_ACC8(32), HW_ACC8(40), HW_ACC8(48), HW_ACC8(56), HW_ACC8(64),
         HW_ACC8(72), HW_ACC8(80), HW_ACC8(88))
HW_WGMMA(256, HW_R0 HW_R1 HW_R2 HW_R3, 128, 129, 130, 131, 132, HW_ACC8(0), HW_ACC8(8),
         HW_ACC8(16), HW_ACC8(24), HW_ACC8(32), HW_ACC8(40), HW_ACC8(48), HW_ACC8(56),
         HW_ACC8(64), HW_ACC8(72), HW_ACC8(80), HW_ACC8(88), HW_ACC8(96), HW_ACC8(104),
         HW_ACC8(112), HW_ACC8(120))
#undef HW_WGMMA
#undef HW_R0
#undef HW_R1
#undef HW_R2
#undef HW_R3
#undef HW_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// --------------------------------------------------------------------------
// tensor maps (host)
// --------------------------------------------------------------------------

// cuTensorMapEncodeTiled through the runtime (no libcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a tensor of `type` and `rank` (<= 3) dimensions, the
// innermost first: dims[0] elements contiguous, strides[i] the bytes
// between consecutive indices of dims[i + 1]; boxes of box[] elements,
// the inner extent 128 bytes (64 bf16, 32 f32) in the 128-byte swizzle.
// Elements outside the tensor arrive as zeros.
int tensor_map_typed(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult rc = fn(map, type, (cuuint32_t)rank,
                         const_cast<void*>(base), dims, strides, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
int tensor_map_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  return tensor_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box);
}

}  // namespace
