#!/usr/bin/env python3
"""The wgmma SwiGLU backward's design choices, measured on one CUDA card.

    python3 scripts/swiglu_bwd_variants.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/fused_mlp.cu`` (and of
the headers an edit touches), each with one choice of the wgmma route's
design changed, into ``build/swiglu_bwd_variants/``, one nvcc each, all
started together, and
prints ptxas' registers and spills of each copy's wgmma kernels (P1's
``swiglu_dact_wgmma_kernel`` and the core's ``wgmma_gemm_kernel``
instantiations). Then, for each copy that builds, holds its backward at
llama-7b's MLP shape (R = 2048, H = 4096, F = 11008, bf16) against the
plain versions (chip_smoke.py's flash_reading, within MLP_TOL) and times,
in turns with the other copies (each copy once in order, once in
reverse; the better pass):

- the whole backward with the ffn chunk Fc = 2048 and 4096 (the op's on
  this route), and the even splits of F into six and three chunks (FCS);
- each product of one 2048-column chunk alone (P1 dag, dau, act; P2 dX;
  P3 dWg, dWu; P4 dWd; the entry ``fused_swiglu_bwd_wgmma_parts_bf16``),
  beside its flops at 989 TFLOP/s.

The copies:

- ``base``: the source as it is (the core's tile 128 x 256 with three
  ring stages, P2's f32 sum through TMA stores and reduce-adds; P1's tile
  128 x 64, ag and au as one m64n128 product, four stages, clusters of two
  blocks multicasting x's and g's tiles);
- ``core_bn128``: the core's tile 128 x 128, five stages;
- ``dact_two``: P1's ag and au as two m64n64 products (x read twice);
- ``dact_s3``: three P1 ring stages;
- ``dact_cluster1``: P1 without clusters (each block loads its own x and
  g tiles);
- ``dact_split``: P1 as two launches of the core at 128 x 128 (ag | au
  written in f32 to scratch memory, then dact with the SwiGLU epilogue
  reading them back): the design where P1 would not fit;
- ``sum_can_load``: P2's first and middle chunks' epilogue type with a
  path that loads the sum into the accumulator, never taken (why the last
  chunk has a type of its own);
- ``acc_rmw``: the middle chunks' P2 reads and writes the f32 sum from
  the registers in its epilogue (no TMA stores or reduce-adds).

Prints the card's name and power limit, then one JSON object: each copy's
ptxas lines, readings and device times in ms (chip_smoke.py's
``cuda_ms``). Needs nvcc and a card; run from the repository's root.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import mlp_fusion as mf  # noqa: E402

CORE = "constexpr int kBN = 256, kStages = 3;"
DACT = "constexpr int kDactBN = 64, kDactStages = 4;"
CLUSTER = "constexpr int kDactCluster = 2;"
MERGED = """        wgmma_smem<2 * kDactBN, 0, 1>(agu, xd, gc::operand_desc<true>(sm.wgu[stage], kk), 1);"""
TWO = """        wgmma_smem<kDactBN, 0, 1>(*reinterpret_cast<float(*)[kDactBN / 2]>(agu), xd,
                                  gc::operand_desc<true>(sm.wgu[stage], kk), 1);
        wgmma_smem<kDactBN, 0, 1>(*reinterpret_cast<float(*)[kDactBN / 2]>(agu + kDactBN / 2),
                                  xd, gc::operand_desc<true>(sm.wgu[stage] + gc::kBox, kk), 1);"""
P1_LAUNCH = """    if (parts & 1) {  // P1: dag, dau, act
      const CUtensorMap m[5] = {tx, tg, twg, twu, twd};
      void* const out[3] = {dag_ws, dau_ws, act_ws};
      if ((rc = run_dact(m, out, r, nc, h, st))) return rc;
    }"""
# P1 as two launches of the core (128 x 128 tiles): ag | au = x . [Wg_c |
# Wu_c] stored in f32 (scratch allocated on the stream: this copy only),
# then dact = g . Wd_c^T with EPI_DSWIGLU's epilogue reading them back
SPLIT_EPI = """
struct EpiF32 {
  float* b0;
  float* b1;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const gc::Tile<BN>&, int) const {
    gc::zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const gc::Tile<BN>& tl,
                                             int wgi, char*, const CUtensorMap&,
                                             const CUtensorMap&) const {
    const gc::Frag f;
    float* b = tl.half ? b1 : b0;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = tl.m0 + 64 * wgi + f.row + 8 * hh, col = tl.n0 + 8 * nn + f.col;
        if (row < m && col < n)
          *reinterpret_cast<float2*>(b + (size_t)row * n + col) =
              make_float2(acc[4 * nn + 2 * hh], acc[4 * nn + 2 * hh + 1]);
      }
  }
};
struct EpiDswiglu {
  const float* ag;
  const float* au;
  __nv_bfloat16* dag;
  __nv_bfloat16* dau;
  __nv_bfloat16* act;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const gc::Tile<BN>&, int) const {
    gc::zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const gc::Tile<BN>& tl,
                                             int wgi, char*, const CUtensorMap&,
                                             const CUtensorMap&) const {
    const gc::Frag f;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = tl.m0 + 64 * wgi + f.row + 8 * hh, col = tl.n0 + 8 * nn + f.col;
        if (row >= m || col >= n) continue;
        const size_t at = (size_t)row * n + col;
        const float2 a2 = *reinterpret_cast<const float2*>(ag + at);
        const float2 u2 = *reinterpret_cast<const float2*>(au + at);
        float o[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = e ? a2.y : a2.x, u = e ? u2.y : u2.x, v = acc[4 * nn + 2 * hh + e];
          const float s = sigmoid(a), silu = a * s;
          o[0][e] = v * u * (s * (1.f + a * (1.f - s)));
          o[1][e] = v * silu;
          o[2][e] = silu * u;
        }
        *reinterpret_cast<uint32_t*>(dag + at) = pack_bf16(o[0][0], o[0][1]);
        *reinterpret_cast<uint32_t*>(dau + at) = pack_bf16(o[1][0], o[1][1]);
        *reinterpret_cast<uint32_t*>(act + at) = pack_bf16(o[2][0], o[2][1]);
      }
  }
};

// The route's launches"""
SPLIT_LAUNCH = """    if (parts & 1) {  // P1 split: ag, au in f32, then dact and the epilogue
      float* ag = nullptr;
      float* au = nullptr;
      if ((rc = (int)cudaMallocAsync(reinterpret_cast<void**>(&ag), (size_t)r * nc * 4, st)) ||
          (rc = (int)cudaMallocAsync(reinterpret_cast<void**>(&au), (size_t)r * nc * 4, st)))
        return rc;
      const CUtensorMap ma[6] = {tx, tx, twg, twu, tdx, tdx};
      if ((rc = gc::run<false, true, 128, 5>(ma, gc::Shape{r, nc, h, 0, 1},
                                             EpiF32{ag, au, r, nc}, st)))
        return rc;
      const CUtensorMap mb[6] = {tg, tg, twd, twd, tdx, tdx};
      const EpiDswiglu epi{ag, au, static_cast<__nv_bfloat16*>(dag_ws),
                           static_cast<__nv_bfloat16*>(dau_ws),
                           static_cast<__nv_bfloat16*>(act_ws), r, nc};
      if ((rc = gc::run<false, false, 128, 5>(mb, gc::Shape{r, nc, h, 0, 0}, epi, st)))
        return rc;
      if ((rc = (int)cudaFreeAsync(ag, st)) || (rc = (int)cudaFreeAsync(au, st))) return rc;
    }"""

def _struct(name):
    """A struct of gemm_core.cuh as it stands, from its first line to its
    closing brace."""
    src = (_build.CSRC / "gemm_core.cuh").read_text()
    i = src.index(f"struct {name} {{")
    return src[i:src.index("\n};\n", i) + 4]


# P2's sum read and written from the registers in the epilogue of the
# middle chunks (the loads beside the accumulator) in place of TMA stores
# and reduce-adds
ACC_RMW = """struct EpiSum {
  int first;
  const float* buf;
  size_t ld;
  int m, n;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>&, int) const {
    zero(acc);
  }
  template <int BN>
  __device__ __forceinline__ void operator()(const float (&acc)[BN / 2], const Tile<BN>& tl,
                                             int wgi, char*, const CUtensorMap&,
                                             const CUtensorMap&) const {
    const Frag f;
    float* sum = const_cast<float*>(buf);
    const int row0 = tl.m0 + 64 * wgi + f.row, col0 = tl.n0 + f.col;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * nn;
        if (row >= m || col >= n) continue;
        float2* p = reinterpret_cast<float2*>(sum + (size_t)row * ld + col);
        float2 v = make_float2(acc[4 * nn + 2 * h], acc[4 * nn + 2 * h + 1]);
        if (!first) {
          const float2 o = *p;
          v.x = o.x + v.x, v.y = o.y + v.y;
        }
        *p = v;
      }
  }
};
"""
# EpiSum (P2's first and middle chunks) with a load of the sum into the
# accumulator in its init, never taken (buf stays null): what a load path
# in the epilogue's type costs the k loop
SUM_INIT = """struct EpiSum {
  int first;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>&, int) const {
    zero(acc);
  }"""
SUM_CAN_LOAD = """struct EpiSum {
  int first;
  const float* buf = nullptr;
  template <int BN>
  __device__ __forceinline__ void init(float (&acc)[BN / 2], const Tile<BN>& tl, int wgi) const {
    if (!buf) {
      zero(acc);
      return;
    }
    const Frag f;
    const int row0 = tl.m0 + 64 * wgi + f.row, col0 = tl.n0 + f.col;
#pragma unroll
    for (int nn = 0; nn < BN / 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            buf + (size_t)(row0 + 8 * h) * (BN * 16) + col0 + 8 * nn);
        acc[4 * nn + 2 * h] = v.x, acc[4 * nn + 2 * h + 1] = v.y;
      }
  }"""
VARIANTS = {
    "base": [],
    "core_bn128": [(CORE, "constexpr int kBN = 128, kStages = 5;")],
    "dact_two": [(MERGED, TWO)],
    "dact_s3": [(DACT, "constexpr int kDactBN = 64, kDactStages = 3;")],
    "dact_cluster1": [(CLUSTER, "constexpr int kDactCluster = 1;")],
    "dact_split": [("\n// The route's launches", SPLIT_EPI), (P1_LAUNCH, SPLIT_LAUNCH)],
    "sum_can_load": [(SUM_INIT, SUM_CAN_LOAD)],
    "acc_rmw": [(_struct("EpiSum"), ACC_RMW),
                ("gc::EpiSum{c == 0}", "gc::EpiSum{c == 0, static_cast<const float*>(acc_ws), "
                                       "(size_t)h, r, h}")],
}
R, H, F = cs.SW_R, cs.SW_H, cs.SW_F
# the ffn chunks timed: 2048 and the op's 4096, and the even splits of F
# into 6 and 3 chunks (multiples of 64: 5 x 1856 + 1728, 2 x 3712 + 3584)
FCS = (2048, 4096, 1856, 3712)
PARTS = {"P1": (1, 6), "P2": (2, 4), "P3": (4, 4), "P4": (8, 2)}  # bit, flops / (R H nc)
ENTRY = "fused_swiglu_bwd_wgmma_parts_bf16"


def build(out):
    """Each copy in its own directory: the sources an edit touches
    (fused_mlp.cu, or a header it includes), edited; the rest found in
    csrc/ through -I."""
    names = ("fused_mlp.cu", "gemm_core.cuh", "hopper.cuh")
    texts = {n: (_build.CSRC / n).read_text() for n in names}
    procs = {}
    for name, edits in VARIANTS.items():
        copy = dict(texts)
        for old, new in edits:
            hits = [n for n in names if old in copy[n]]
            if len(hits) != 1:
                raise RuntimeError(f"{name}: {len(hits)} sources hold {old!r}")
            copy[hits[0]] = copy[hits[0]].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for n in names:
            if n == "fused_mlp.cu" or copy[n] != texts[n]:
                (d / n).write_text(copy[n])
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(d / "fused_mlp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        lines = cs.mlp_ptxas_lines(log)
        ptxas[name] = lines if proc.returncode == 0 else (
            f"nvcc exit {proc.returncode}: " + log[-2000:])
        if proc.returncode == 0:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            fn = getattr(lib, ENTRY)
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[name] = fn
    return libs, ptxas


def caller(fn, x, wg, wu, wd, g, fc, parts):
    """The route's launches through one copy's entry: outputs and the
    workspace at chunk fc, the products of ``parts``."""
    r, h = x.shape
    f = wg.shape[1]
    bf, dev = torch.bfloat16, x.device
    outs = [torch.empty(r, h, dtype=bf, device=dev),
            torch.empty(h, f, dtype=bf, device=dev),
            torch.empty(h, f, dtype=bf, device=dev),
            torch.empty(f, h, dtype=bf, device=dev)]
    ws = [torch.empty(r, fc, dtype=bf, device=dev) for _ in range(3)]
    acc = torch.empty(r, h, dtype=torch.float32, device=dev) if f > fc else None
    ptrs = [t.data_ptr() for t in (x, wg, wu, wd, g, *outs, *ws)]
    ptrs.append(None if acc is None else acc.data_ptr())
    held = (outs, ws, acc)  # the buffers live as long as the call

    def call(_):
        rc = fn(*ptrs, r, h, f, fc, parts, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{ENTRY}: CUDA error {rc}")
        return held[0]

    return call


def timed(calls, iters=10):
    """Each copy's cuda_ms, in order then in reverse; the better pass."""
    t = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            t[name].append(cs.cuda_ms(calls[name], [None], iters=iters))
    return {name: min(v) for name, v in t.items()}, t


def main():
    if not torch.cuda.is_available():
        print("swiglu_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.gpu_line()
    print(card, flush=True)
    out = ROOT / "build" / "swiglu_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    libs, ptxas = build(out)
    x, wg, wu, wd, g = cs.swiglu_inputs(torch, R, H, F, torch.bfloat16, seed=13)
    ref = (mf.fused_swiglu_dx_ref(x, wg, wu, wd, g),
           *mf.fused_swiglu_dw_ref(x, wg, wu, wd, g))
    readings = {}
    for name, fn in libs.items():
        got = caller(fn, x, wg, wu, wd, g, mf._SWIGLU_BWD_CHUNK_F, 15)(None)
        torch.cuda.synchronize()
        readings[name] = {k: cs.flash_reading(a, b) for k, a, b in
                          zip(("dx", "dwg", "dwu", "dwd"), got, ref)}
    del ref
    good = {n: fn for n, fn in libs.items()
            if max(readings[n].values()) <= cs.MLP_TOL["bfloat16"]}
    res = {"card": card, "shape": dict(r=R, h=H, f=F, dtype="bfloat16"),
           "ptxas": ptxas, "readings": readings,
           "bound_ms": cs.swiglu_bounds(R, H, F, 2)["backward"][0]}
    for fc in FCS:
        res[f"whole_fc{fc}_ms"], res[f"whole_fc{fc}_passes"] = timed(
            {n: caller(fn, x, wg, wu, wd, g, fc, 15) for n, fn in good.items()})
    # one 2048-column chunk: its own [H, 2048] and [2048, H] weights
    nc = 2048
    wg1, wu1, wd1 = (t.contiguous() for t in (wg[:, :nc], wu[:, :nc], wd[:nc]))
    for part, (bit, flops) in PARTS.items():
        ms, _ = timed({n: caller(fn, x, wg1, wu1, wd1, g, nc, bit)
                       for n, fn in libs.items()})
        bound = flops * R * H * nc / cs.H100_FLOPS["bfloat16"] * 1e3
        res[f"{part}_chunk_ms"] = ms
        res[f"{part}_chunk_tflops"] = {n: flops * R * H * nc / t / 1e9
                                       for n, t in ms.items()}
        res[f"{part}_chunk_bound_ms"] = bound
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
