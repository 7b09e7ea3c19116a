#!/usr/bin/env python3
"""The wgmma GeLU and SwiGLU forwards' design choices, measured on one
CUDA card.

    python3 scripts/mlp_fwd_variants.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/fused_mlp.cu``, each with
one choice of the forwards' wgmma route changed, into
``build/mlp_fwd_variants/``, one nvcc each, all started together, and
prints ptxas' registers and spills of each copy's wgmma kernels. Then, at
gpt3-1.3b's MLP shape (R = 8192, H = 2048, F = 8192, tanh), bert-base's
(R = 16384, H = 768, F = 3072, erf) and llama-7b's SwiGLU (R = 2048, H =
4096, F = 11008), bf16, holds each copy's forward against the plain
version (chip_smoke.py's flash_reading, within MLP_TOL) and times, in
turns with the other copies (each copy once in order, once in reverse;
the better pass):

- the whole forward at the ffn chunk Fc = 2048, 4096, 8192 (those not
  above F) and F (one chunk);
- each product of one chunk of the op's Fc alone (P1 act_c; P2 y's down
  product; the entries ``fused_mlp_fwd_wgmma_parts_bf16`` and
  ``fused_swiglu_fwd_wgmma_parts_bf16``), beside its flops at 989
  TFLOP/s.

The copies:

- ``base``: the source as it is (the GeLU's P1 on the core at [128,
  192], four stages; the SwiGLU's paired P1 at a [128, 256] accumulator,
  three stages, its output tiles 128 wide; P2 at [128, 256], three
  stages; the epilogues' bias pairs read 8 (P1) and 4 (P2) column groups
  at a time);
- ``gelu_bn256``, ``gelu_bn128``: the GeLU's P1 at [128, 256], three
  stages, and at [128, 128], five;
- ``swiglu_bn128``: the SwiGLU's P1 at a [128, 128] accumulator, five
  stages (output tiles 64 wide);
- ``bias_batch1``: every bias pair read one column group at a time;
- ``p2_batch2``: P2's bias pairs two column groups at a time;
- ``last_bn256``: the GeLU's last of several chunks' P2 (whose init
  loads the f32 sum) at [128, 256], three stages.

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

GELU = "constexpr int kGeluBN = 192, kGeluStages = 4;"
SWIGLU = "constexpr int kSwigluBN = 256, kSwigluStages = 3;"
BATCH = "constexpr int kGeluBatch = 8, kBiasBatch = 4;"
VARIANTS = {
    "base": [],
    "gelu_bn256": [(GELU, "constexpr int kGeluBN = 256, kGeluStages = 3;")],
    "gelu_bn128": [(GELU, "constexpr int kGeluBN = 128, kGeluStages = 5;")],
    "swiglu_bn128": [(SWIGLU, "constexpr int kSwigluBN = 128, kSwigluStages = 5;")],
    "bias_batch1": [(BATCH, "constexpr int kGeluBatch = 1, kBiasBatch = 1;")],
    "p2_batch2": [(BATCH, "constexpr int kGeluBatch = 8, kBiasBatch = 2;")],
    "last_bn256": [("constexpr int kLastBN = 192, kLastStages = 4;",
                    "constexpr int kLastBN = 256, kLastStages = 3;")],
}
# label: (kind, r, h, f, approximate)
SHAPES = {"gpt3-1.3b": ("gelu", cs.MLP_R, cs.MLP_H, cs.MLP_F, True),
          "bert-base": ("gelu", *cs.MLP_BERT, False),
          "llama-7b": ("swiglu", cs.SW_R, cs.SW_H, cs.SW_F, None)}
WHOLE = 3    # P1 and P2
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"gelu": ("fused_mlp_fwd_wgmma_parts_bf16",
                    [_P] * 8 + [_I] * 5 + mf._DROP + [_I, _P]),
           "swiglu": ("fused_swiglu_fwd_wgmma_parts_bf16",
                      [_P] * 7 + [_I] * 4 + [_I, _P])}


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
        ptxas[name] = ({k: v for k, v in cs.mlp_ptxas_lines(log).items()
                        if "<0, 1," in k} if proc.returncode == 0 else
                       f"nvcc exit {proc.returncode}: " + log[-2000:])
        if proc.returncode == 0:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            libs[name] = {}
            for kind, (entry, argtypes) in ENTRIES.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                libs[name][kind] = fn
    return libs, ptxas


def caller(fn, kind, inputs, approx, fc, parts):
    """The route's launches through one copy's entry: y and the workspace
    at chunk fc, the launches of ``parts``."""
    x, w1 = inputs[0], inputs[1]
    r, h = x.shape
    f = w1.shape[1]
    dev = x.device
    y = torch.empty_like(x)
    ws = [torch.empty(r, fc, dtype=x.dtype, device=dev),
          torch.empty(r, h, dtype=torch.float32, device=dev) if f > fc
          else None]
    if kind == "gelu":
        x, w1, b1, w2, b2 = inputs
        vecs = [b1.float().contiguous(), b2.float().contiguous()]
        ptrs = [t.data_ptr() for t in (x, w1, vecs[0], w2, vecs[1], y)]
        tail = (r, h, f, fc, int(approx), 0, 0, 0, 0.0, 0, 0, parts)
    else:
        vecs = []
        ptrs = [t.data_ptr() for t in (*inputs, y)]
        tail = (r, h, f, fc, parts)
    ptrs += [None if t is None else t.data_ptr() for t in ws]
    held = (y, ws, vecs)  # the buffers live as long as the call

    def call(_):
        rc = fn(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{kind} forward parts: CUDA error {rc}")
        return held[0]

    return call


def timed(calls, iters=10):
    """Each copy's cuda_ms, in order then in reverse; the better pass."""
    t = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            t[name].append(cs.cuda_ms(calls[name], [None], iters=iters))
    return {name: min(v) for name, v in t.items()}, t


def measure(libs, kind, r, h, f, approx):
    """One shape: each copy's reading at the op's chunk, the whole forward
    at each chunk, each product of one chunk alone."""
    if kind == "gelu":
        inputs = cs.mlp_inputs(torch, r, h, f, torch.bfloat16, seed=11)[:5]
        ref = mf.fused_mlp_fwd_ref(*inputs, approx)
        bound = cs.mlp_bounds(r, h, f, 2)["forward"][0]
        p1_flops = 2
    else:
        inputs = cs.swiglu_inputs(torch, r, h, f, torch.bfloat16, seed=13)[:4]
        ref = mf.fused_swiglu_fwd_ref(*inputs)
        bound = cs.swiglu_bounds(r, h, f, 2)["forward"][0]
        p1_flops = 4
    fc = min(f, mf._MLP_FWD_CHUNK_F)
    readings = {}
    for name, fns in libs.items():
        got = caller(fns[kind], kind, inputs, approx, fc, WHOLE)(None)
        torch.cuda.synchronize()
        readings[name] = cs.flash_reading(got, ref)
    del ref
    good = {n: fns[kind] for n, fns in libs.items()
            if readings[n] <= cs.MLP_TOL["bfloat16"]}
    res = {"shape": dict(kind=kind, r=r, h=h, f=f, dtype="bfloat16",
                         approximate=approx, op_chunk_f=fc),
           "readings": readings, "bound_ms": bound}
    for chunk in sorted({c for c in (2048, 4096, 8192) if c <= f} | {fc, f}):
        res[f"whole_fc{chunk}_ms"], res[f"whole_fc{chunk}_passes"] = timed(
            {n: caller(fn, kind, inputs, approx, chunk, WHOLE)
             for n, fn in good.items()})
    # one chunk of the op's width: its own [H, fc] and [fc, H] weights (its
    # P2 the one-chunk epilogue)
    if kind == "gelu":
        x, w1, b1, w2, b2 = inputs
        chunk = (x, w1[:, :fc], b1[:fc], w2[:fc], b2)
    else:
        x, wg, wu, wd = inputs
        chunk = (x, wg[:, :fc], wu[:, :fc], wd[:fc])
    chunk = [t.contiguous() for t in chunk]
    for part, bit, flops in (("P1", 1, p1_flops), ("P2", 2, 2)):
        ms, _ = timed({n: caller(fn, kind, chunk, approx, fc, bit)
                       for n, fn in good.items()})
        res[f"{part}_chunk_ms"] = ms
        res[f"{part}_chunk_tflops"] = {n: flops * r * h * fc / t / 1e9
                                       for n, t in ms.items()}
        res[f"{part}_chunk_bound_ms"] = (flops * r * h * fc
                                         / cs.H100_FLOPS["bfloat16"] * 1e3)
    del inputs, chunk
    torch.cuda.empty_cache()
    return res


def main():
    if not torch.cuda.is_available():
        print("mlp_fwd_variants: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.gpu_line()
    print(card, flush=True)
    out = ROOT / "build" / "mlp_fwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    libs, ptxas = build(out)
    res = {"card": card, "ptxas": ptxas}
    for label, shape in SHAPES.items():
        res[label] = measure(libs, *shape)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
