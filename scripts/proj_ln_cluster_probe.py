#!/usr/bin/env python3
"""Where the projection-LN cluster kernels' time goes, on one CUDA card.

    python3 scripts/proj_ln_cluster_probe.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/proj_ln.cu`` with parts
of the cluster kernels' epilogue cut (their results are wrong by design)
into ``build/probe/``, one nvcc each, all started together, and times the
forward and the backward kernel of each copy at R=16384, Hout=768, bf16,
at Hin = 768 (BERT-base) and Hin = 64 (the product nearly free), with and
without dropout (p = 0.1, the reference's 256-row tile). The copies:

- ``base``: the source as it is;
- ``no_store``: the staged output boxes never stored (no TMA stores);
- ``no_stage``: nor staged in shared memory;
- ``no_col``: the backward's column sums without their warp shuffles;
- ``no_exch``: each row's sums from the block's own slice times four,
  block barriers in place of the cluster's (no distributed shared
  memory, no waiting on the other three blocks);
- ``all_cut``: no_stage, no_col and no_exch together.

Prints the card's name and power limit, then one JSON object of device
times in ms (chip_smoke.py's ``cuda_ms``). Needs nvcc and a card; run
from the repository's root.
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import mlp_fusion as mf  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "probe"


def no_store(s):
    return re.sub(r"store_box<NW>\([^;]*;", "", s)


def no_stage(s):
    return re.sub(r"stage<NW>\([^;]*;", "", no_store(s))


def no_col(s):
    for o in (4, 8, 16):
        s = s.replace(f"v += __shfl_xor_sync(0xffffffffu, v, {o});", "")
    return s


def no_exch(s):
    s = s.replace("cluster_total(&", "(4.f * *&")
    s = re.sub(r"ld_cluster\((&[^,]*), q\)", r"(*\1)", s)
    s = s.replace("  cluster_arrive();  // done with the peers' shared memory",
                  "  __syncthreads();")
    s = s.replace("  cluster_wait();  // no block leaves while a peer may still "
                  "read its partials", "")
    return re.sub(r"\bcluster_sync\(\);", "__syncthreads();", s)


VARIANTS = {"base": lambda s: s, "no_store": no_store, "no_stage": no_stage,
            "no_col": no_col, "no_exch": no_exch,
            "all_cut": lambda s: no_exch(no_col(no_stage(s)))}


def build():
    """Each copy's library, its cluster entries' signatures set."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    src = (CSRC / "proj_ln.cu").read_text()
    procs = {}
    for name, cut in VARIANTS.items():
        path = OUT / f"proj_ln_{name}.cu"
        path.write_text(cut(src))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"probe copy {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib_{name}.so"))
        for entry, types in mf._PL_CLUSTER_ARGTYPES.items():
            fn = getattr(lib, f"{entry}_bf16")
            fn.argtypes, fn.restype = types, ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("proj_ln_cluster_probe: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    libs = build()
    bf = torch.bfloat16
    key = cs.drop_key(fa, 256, cs.BERT_H)
    out = {}
    real_lib = mf._pl_lib
    try:
        for hin in (cs.BERT_H, 64):
            x = cs.pl_inputs(torch, cs.BERT_R, hin, cs.BERT_H, bf, 5)
            args = (x["x"], x["w"], x["b"], x["res"], x["lnw"])
            _, mean, rstd = mf.fused_proj_ln_fwd_ref(*args, x["lnb"], 1e-12)
            for name, lib in libs.items():
                mf._pl_lib = lambda lib=lib: lib
                row = {}
                for label, k in (("", None), ("_dropout", key)):
                    row["fwd" + label] = cs.cuda_ms(
                        lambda _: mf._proj_ln_fwd_cuda(
                            *args, x["lnb"], 1e-12, k, route="cluster"),
                        [None], iters=20)
                    row["bwd" + label] = cs.cuda_ms(
                        lambda _: mf._pl_pair_kernel(*args, mean, rstd,
                                                     x["g"], k),
                        [None], iters=20)
                out.setdefault(f"hin_{hin}", {})[name] = row
            del x, args, mean, rstd
    finally:
        mf._pl_lib = real_lib
    print(cs.gpu_line(), flush=True)
    print(json.dumps(dict(r=cs.BERT_R, hout=cs.BERT_H, dtype="bfloat16",
                          ms=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
