#!/usr/bin/env python3
"""The wgmma GeLU MLP backward's design choices, measured on one CUDA card.

    python3 scripts/mlp_bwd_variants.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/fused_mlp.cu``, each with
one choice of the GeLU backward's wgmma route changed, into
``build/mlp_bwd_variants/``, one nvcc each, all started together, and
prints ptxas' registers and spills of each copy's P1 kernels
(``gelu_dact_wgmma_kernel``). Then, at gpt3-1.3b's MLP
shape (R = 8192, H = 2048, F = 8192, tanh) and bert-base's (R = 16384,
H = 768, F = 3072, erf), bf16, holds each copy's backward against the
plain versions (chip_smoke.py's flash_reading, within MLP_TOL) and times,
in turns with the other copies (each copy once in order, once in
reverse; the better pass):

- the whole backward at the ffn chunk Fc = 2048, 4096 and F;
- each product of one chunk of the op's Fc alone (P1 da, act and db1's
  partials; P2 dX; P3 dW1; P4 dW2; the entry
  ``fused_mlp_bwd_wgmma_parts_bf16``), beside its flops at 989 TFLOP/s.

The copies:

- ``base``: the source as it is (P1's tile 128 x 128, three ring
  stages, clusters of two blocks multicasting x's and gm's tiles, the
  GeLU form read at run time; P2-P4 on the core's 128 x 256 tiles,
  three stages, P3 and P4 at 128 x 192 where those leave the last wave
  less empty);
- ``dact_bn64``: P1's tile 128 x 64 with four ring stages (64
  accumulator registers a thread);
- ``dact_bn64_cluster1``: the same without clusters;
- ``dact_cluster1``: P1 without clusters (each block loads its own x and
  gm tiles);
- ``form_template``: the GeLU form a template parameter (two P1
  instantiations) in place of an argument read at run time;
- ``dw_bn256``: P3 and P4 always on the core's 128 x 256 tiles (the
  source picks 128 x 192 where those leave the last wave less empty: at
  bert-base's width the 128 x 256 tiles of each number 72, for 132 SMs);
- ``dw_bn128``: P3 and P4 always on 128 x 128 tiles, five stages.

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

P1 = "constexpr int kTileN = 128, kRing = 3;"
CLUSTER = "constexpr int kCluster = 2;            // P1's blocks"
KERNEL = ("__global__ void __cluster_dims__(kCluster, 1, 1) "
          "__launch_bounds__(gc::kThreads, 1)\n    gelu_dact_wgmma_kernel(")
DW = "const bool narrow = cost(kDwBN) < cost(sw::kBN);"
DW_TILE = "constexpr int kDwBN = 192, kDwStages = 4;"
VARIANTS = {
    "base": [],
    "dact_bn64": [(P1, "constexpr int kTileN = 64, kRing = 4;")],
    "dact_bn64_cluster1": [(P1, "constexpr int kTileN = 64, kRing = 4;"),
                           (CLUSTER, "constexpr int kCluster = 1;            // P1's blocks")],
    "dact_cluster1": [(CLUSTER, "constexpr int kCluster = 1;            // P1's blocks")],
    "form_template": [
        (KERNEL, "template <int APPROX>\n" + KERNEL),
        ("o.approximate, act[e], dg);", "APPROX, act[e], dg);"),
        ("(gelu_dact_wgmma_kernel,", "(gelu_dact_wgmma_kernel<1>,"),
        ("(&count, gelu_dact_wgmma_kernel, &cfg)", "(&count, gelu_dact_wgmma_kernel<1>, &cfg)"),
        ("const auto kernel = gelu_dact_wgmma_kernel;",
         "const auto kernel = o.approximate ? gelu_dact_wgmma_kernel<1> "
         ": gelu_dact_wgmma_kernel<0>;")],
    "dw_bn256": [(DW, "const bool narrow = false;")],
    "dw_bn128": [(DW, "const bool narrow = true;"),
                 (DW_TILE, "constexpr int kDwBN = 128, kDwStages = 5;")],
}
SHAPES = {"gpt3-1.3b": (cs.MLP_R, cs.MLP_H, cs.MLP_F, True),
          "bert-base": (*cs.MLP_BERT, False)}
# bit in the entry's `products`, flops / (R H nc)
PARTS = {"P1": (1, 4), "P2": (2, 2), "P3": (4, 2), "P4": (8, 2)}
WHOLE = 31   # every product, the column-sum pass and sum_parts
ENTRY = "fused_mlp_bwd_wgmma_parts_bf16"
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P] * 15 + [_I] * 6 + mf._DROP + [_I, _P]


def build(out):
    """Each copy in its own directory, fused_mlp.cu edited; the headers
    found in csrc/ through -I."""
    text = (_build.CSRC / "fused_mlp.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        copy = text
        for old, new in edits:
            if old not in copy:
                raise RuntimeError(f"{name}: fused_mlp.cu holds no {old!r}")
            copy = copy.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_mlp.cu").write_text(copy)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(d / "fused_mlp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas[name] = cs.mlp_ptxas_lines(log) if proc.returncode == 0 else (
            f"nvcc exit {proc.returncode}: " + log[-2000:])
        if proc.returncode == 0:
            fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), ENTRY)
            fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
            libs[name] = fn
    return libs, ptxas


def caller(fn, x, w1, b1, w2, g, approx, fc, products):
    """The route's launches through one copy's entry: outputs and the
    workspace at chunk fc, the launches of ``products``."""
    r, h = x.shape
    f = w1.shape[1]
    dev, f32 = x.device, torch.float32
    parts = -(-r // mf._ROW_BLOCK)
    outs = [torch.empty(r, h, dtype=x.dtype, device=dev),
            torch.empty(h, f, dtype=x.dtype, device=dev),
            torch.empty(f, dtype=f32, device=dev),
            torch.empty(f, h, dtype=x.dtype, device=dev),
            torch.empty(h, dtype=f32, device=dev)]
    ws = [torch.empty(r, fc, dtype=x.dtype, device=dev),
          torch.empty(r, fc, dtype=x.dtype, device=dev),
          torch.empty(r, h, dtype=f32, device=dev) if f > fc else None,
          torch.empty(parts, f + h, dtype=f32, device=dev)]
    b1f = b1.float().contiguous()
    ptrs = [t.data_ptr() for t in (x, w1, b1f, w2, g, *outs)]
    ptrs += [None if t is None else t.data_ptr() for t in ws] + [None]
    held = (outs, ws, b1f)  # the buffers live as long as the call

    def call(_):
        rc = fn(*ptrs, parts, r, h, f, fc, int(approx), 0, 0, 0, 0.0, 0, 0,
                products, torch.cuda.current_stream().cuda_stream)
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


def measure(libs, label, r, h, f, approx):
    """One shape: each copy's readings at the op's chunk, the whole
    backward at each chunk, each product of one chunk alone."""
    x, w1, b1, w2, _, g = cs.mlp_inputs(torch, r, h, f, torch.bfloat16,
                                        seed=11)
    fc = min(f, mf._MLP_BWD_CHUNK_F)
    ref = (mf.fused_mlp_dx_ref(x, w1, b1, w2, g, approx),
           *mf.fused_mlp_dw_ref(x, w1, b1, w2, g, approx))
    readings = {}
    for name, fn in libs.items():
        got = caller(fn, x, w1, b1, w2, g, approx, fc, WHOLE)(None)
        torch.cuda.synchronize()
        readings[name] = {k: cs.flash_reading(a, b) for k, a, b in
                          zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref)}
    del ref
    good = {n: fn for n, fn in libs.items()
            if max(readings[n].values()) <= cs.MLP_TOL["bfloat16"]}
    res = {"shape": dict(r=r, h=h, f=f, dtype="bfloat16", approximate=approx,
                         op_chunk_f=fc),
           "readings": readings,
           "bound_ms": cs.mlp_bounds(r, h, f, 2)["backward"][0]}
    for chunk in sorted({2048, 4096, f}):
        if chunk > f:
            continue
        res[f"whole_fc{chunk}_ms"], res[f"whole_fc{chunk}_passes"] = timed(
            {n: caller(fn, x, w1, b1, w2, g, approx, chunk, WHOLE)
             for n, fn in good.items()})
    # one chunk of the op's width: its own [H, fc] and [fc, H] weights
    w1c, b1c, w2c = (t.contiguous() for t in (w1[:, :fc], b1[:fc], w2[:fc]))
    for part, (bit, flops) in PARTS.items():
        ms, _ = timed({n: caller(fn, x, w1c, b1c, w2c, g, approx, fc, bit)
                       for n, fn in good.items()})
        res[f"{part}_chunk_ms"] = ms
        res[f"{part}_chunk_tflops"] = {n: flops * r * h * fc / t / 1e9
                                       for n, t in ms.items()}
        res[f"{part}_chunk_bound_ms"] = (flops * r * h * fc
                                         / cs.H100_FLOPS["bfloat16"] * 1e3)
    del x, w1, b1, w2, g, w1c, b1c, w2c
    torch.cuda.empty_cache()
    return res


def main():
    if not torch.cuda.is_available():
        print("mlp_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.gpu_line()
    print(card, flush=True)
    out = ROOT / "build" / "mlp_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    libs, ptxas = build(out)
    res = {"card": card, "ptxas": ptxas}
    for label, shape in SHAPES.items():
        res[label] = measure(libs, label, *shape)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
