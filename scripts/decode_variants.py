#!/usr/bin/env python3
"""Time the split decode route's parts and design choices on one card.

    python3 scripts/decode_variants.py

Needs one CUDA card and nvcc (the kernels are built from the checkout's
``paddle_tpu_torch/kernels/csrc/decode_attn_proj.cu``). At the serving
path's shape (gpt3-1.3b: NH 16, D 128, HO 2048, block_size 16, 64-entry
tables, bf16, the weights cold in L2: chip_smoke.py's six input sets) it
times, through the probe entry ``decode_attn_proj_split_parts_bf16``:

- the whole call (attention, then the projection as a programmatic
  dependent), the same with the projection launched plainly (no PDL),
  the attention kernel alone, the projection kernel alone, without its
  merge, and its weight loads alone (and after attention, with and
  without PDL: what the dependent launch overlaps);
- the whole call at other split counts than ``decode_splits`` picks;

at pos 511 and 1023 (KVH 16) and at pos 511 with KVH 4, each variant
timed twice (the list, then the list backwards; the better pass), with
the generic route and the library yardstick (SDPA over the gathered
context + addmm) beside them. Prints one JSON object with the card's
name and power limit.
"""
import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import mlp_fusion as mf  # noqa: E402

PARTS = {"whole": 7, "no_pdl": 3, "attention": 1, "projection": 2,
         "projection_no_merge": 2 | 8, "weight_loads_only": 2 | 16,
         "attention_then_loads_pdl": 7 | 16, "attention_then_loads": 3 | 16,
         "weight_loads_no_cluster": 2 | 16 | 32,
         "attention_then_loads_pdl_no_cluster": 7 | 16 | 32}


def probe(lib, x, nsplit, parts, scale):
    """One probe call on input set x: the route's partials for nsplit
    splits, the parts of the bitmask launched on the current stream."""
    q = x["q"]
    nh, d = q.shape
    kvh = x["k_pool"].shape[1]
    ho = x["proj_w"].shape[1]
    mb = x["table"].shape[0]
    key = ("bufs", nsplit)
    if key not in x:
        x[key] = (torch.empty(nh * nsplit * (2 + d), device="cuda"),
                  torch.empty(ho, dtype=q.dtype, device="cuda"))
    part, y = x[key]
    rc = lib.decode_attn_proj_split_parts_bf16(
        *(t.data_ptr() for t in (q, x["k_pool"], x["v_pool"], x["p"],
                                 x["table"], x["proj_w"], x["proj_b"], y,
                                 part)),
        nh, kvh, d, cs.BS, cs.NBLOCKS, mb, ho, nsplit, float(scale), parts,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"probe launch failed: {rc}")


def measure(lib, pos, kvh):
    scale = 1.0 / np.sqrt(cs.D)
    sets = cs.decode_sets(torch, pos, kvh)
    picked = mf.decode_splits(kvh, cs.MB)
    runs = {name: (lambda x, p=parts: probe(lib, x, picked, p, scale))
            for name, parts in PARTS.items()}
    for n in sorted({4, 8, 16, 32} - {picked}):
        if n <= mf.DECODE_MAX_SPLITS and n <= cs.MB:
            runs[f"whole_splits_{n}"] = (
                lambda x, n=n: probe(lib, x, n, 7, scale))

    def args(x):
        return (x["q"], x["k_pool"], x["v_pool"], x["p"], x["table"],
                x["proj_w"], x["proj_b"])

    runs["generic"] = lambda x: mf._launch(*args(x), cs.BS, scale,
                                           route="generic")

    def library(x):
        attn = torch.nn.functional.scaled_dot_product_attention(
            x["q"][None, :, None, :], x["kc"], x["vc"],
            enable_gqa=kvh != cs.NH)
        torch.addmm(x["proj_b"], attn.reshape(1, cs.NH * cs.D), x["proj_w"])

    runs["library"] = library
    # the probe's whole call against the route's own on one set
    x = sets[0]
    probe(lib, x, picked, 7, scale)
    want = mf._launch(*args(x), cs.BS, scale)
    torch.cuda.synchronize()
    cs.check(torch.equal(x[("bufs", picked)][1], want),
             "the probe's whole call differs from the route's")
    t = {}
    names = list(runs)
    for name in names + names[::-1]:
        ms = cs.cuda_ms(runs[name], sets)
        t[name] = min(t.get(name, float("inf")), ms)
    bms, by = cs.bound_ms(pos, kvh, "bfloat16")
    return dict(pos=pos, kvh=kvh, splits=picked, bound_ms=bms, bound_by=by,
                ms=t)


def main():
    if not torch.cuda.is_available():
        print("decode_variants: needs one CUDA card", file=sys.stderr)
        return 2
    lib = mf._lib()
    fn = lib.decode_attn_proj_split_parts_bf16
    fn.argtypes = mf._SPLIT_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = dict(card=cs.gpu_line(), shapes=[
        measure(lib, 511, 16), measure(lib, 1023, 16), measure(lib, 511, 4)])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
