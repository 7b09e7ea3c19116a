#!/usr/bin/env python3
"""Every distinct BatchNorm call of a resnet50 and a ppyoloe-l training
step, each direction's kernels timed alone on both routes, measured on one
CUDA card.

    python3 scripts/bn_step_shapes.py

Builds the two trainers of chip_smoke.py (resnet50 bf16 at B=256, 224^2;
ppyoloe-l f32 at B=8, 640^2; random weights from a seed), runs one step
of each with the forward wrapper recorded, and for every distinct (shape,
dtype, residual, ReLU) it saw, on inputs of that shape: the cluster
forward in turns with the generic forward, the persistent backward in
turns with the generic backward (chip_smoke.py's ``in_turns``: device time,
the better of two passes), the forward's plan (K, channels a slab,
threads) and bound. Prints a JSON line a shape and each step's sums (the
calls' kernel times weighted by their count), and writes the record to
``chiprun_out/bn_step_shapes.json``. Needs nvcc and a card; run from the
repository's root (~1 min after the build).
"""
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import norm_fusion as nf  # noqa: E402

def capture(step):
    seen = collections.Counter()
    real = nf._bn_fwd_cuda

    def rec(x, res, w, b, eps, relu, route=None, **kw):
        seen[(tuple(x.shape), str(x.dtype).split(".")[-1], res is not None,
              bool(relu))] += 1
        return real(x, res, w, b, eps, relu, route=route, **kw)

    nf._bn_fwd_cuda = rec
    try:
        step()
    finally:
        nf._bn_fwd_cuda = real
    return seen


def main():
    if not torch.cuda.is_available():
        print("bn_step_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    out = {}
    for model in ("resnet50", "ppyoloe-l"):
        if model == "resnet50":
            _, step, _ = cs.resnet_trainer(torch, torch.bfloat16, cs.RESNET_B,
                                           cs.RESNET_HW)
        else:
            _, step = cs.ppyoloe_trainer(torch, model, cs.PPYOLOE_B,
                                         cs.PPYOLOE_HW)
        step()
        seen = capture(step)
        del step
        cs.free_card(torch)
        rows = []
        tot = dict.fromkeys(("cluster", "generic", "bwd_persistent",
                             "bwd_generic"), 0.0)
        for (shape, dt, res, relu), count in sorted(seen.items()):
            n, c, hw = shape
            x = cs.bn_inputs(torch, n, c, hw, getattr(torch, dt), 3, res)
            xx, r, w, b = (x[k] for k in ("x", "res", "w", "b"))
            f = {rt: (lambda _, rt=rt: nf._bn_fwd_cuda(xx, r, w, b, cs.BN_EPS,
                                                        relu, route=rt))
                 for rt in ("cluster", "generic")}
            gen, clu, _ = cs.in_turns(f["generic"], f["cluster"])
            g = x["g"]
            _, mean, var = nf._bn_fwd_cuda(xx, r, w, b, cs.BN_EPS, relu)
            bw = {rt: (lambda _, rt=rt: nf._bn_bwd_cuda(
                xx, r, w, b, mean, var, g, None, None, cs.BN_EPS, relu,
                route=rt)) for rt in ("persistent", "generic")}
            bgen, bper, _ = cs.in_turns(bw["generic"], bw["persistent"])
            plan = nf.bn_fwd_plan(n, c, hw, xx.dtype, res,
                                  nf._sm_count(xx.device))
            bound = cs.bn_bounds(n, c, hw, xx.element_size(), res)
            rows.append(dict(shape=shape, dtype=dt, res=res, relu=relu,
                             calls=count, cluster_ms=clu, generic_ms=gen,
                             bound_ms=bound["fused_bn_fwd"][0],
                             bwd_bound_ms=bound["fused_bn_bwd"][0],
                             k=plan.k, cg=plan.cg,
                             bwd_persistent_ms=bper, bwd_generic_ms=bgen,
                             threads=plan.threads, slabs=plan.slabs,
                             channel_bytes=n * hw * xx.element_size()))
            tot["cluster"] += count * clu
            tot["generic"] += count * gen
            tot["bwd_persistent"] += count * bper
            tot["bwd_generic"] += count * bgen
            del x, xx, r, w, b, g, mean, var
            torch.cuda.empty_cache()
        out[model] = dict(rows=rows, per_step=tot)
        for row in rows:
            print(json.dumps(row), flush=True)
        print(model, json.dumps(tot), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "bn_step_shapes.json").write_text(json.dumps(out))
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
