#!/usr/bin/env python3
"""The wgmma flash backward's design choices, measured on one CUDA card.

    python3 scripts/flash_bwd_variants.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/flash_attention.cu``,
each with one choice of the backward's design undone, into
``build/flash_bwd_variants/``, one nvcc each, all started together, and
prints ptxas' registers and spills of each copy's wgmma dQ and dK/dV
kernels. Then, for each copy that builds, holds its backward against the
plain versions (flash_reading) and times its dQ, dK/dV and whole
backward in turns with the others (each copy once in order, once in
reverse; the better pass) at gpt3-1.3b's attention (B=4, NH=16, S=2048,
D=128, causal) and bert-base's key-padding attention (B=32, NH=12,
S=512, D=64), without and with dropout (p = 0.1). The copies:

- ``base``: the source as it is (three ring stages in dQ and dK/dV, the
  producer reading lse and delta before it waits for a free stage, dQ's
  64-key tile in two 32-key steps at D 128 under dropout);
- ``stages2``: two ring stages in both kernels;
- ``lse_after_wait``: dK/dV's producer reads lse and delta after the wait;
- ``dq_one_step``: dQ's 64-key tile in one step at D 128 under dropout
  (ptxas' spills only: no shape below runs it).

Prints the card's name and power limit, then one JSON object: each copy's
ptxas lines, readings and device times in ms (chip_smoke.py's
``cuda_ms``). Needs nvcc and a card; run from the repository's root.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

STAGES = "constexpr int kStagesQ = 3, kStagesKV = 3;"
PREFETCH = """        float lt[kBQ2 / 32], dt[kBQ2 / 32];  // read before the wait: their latency hides
#pragma unroll
        for (int t = 0; t < kBQ2 / 32; ++t) {
          const int row = i * kBQ2 + lane + 32 * t;
          const bool ok = row < a.sq;
          lt[t] = ok ? a.lse[(size_t)bh * a.sq + row] : 0.f;
          dt[t] = ok ? a.delta[(size_t)bh * a.sq + row] : 0.f;
        }
        mbar_wait(&sm.empty[stage], phase ^ 1);
#pragma unroll
        for (int t = 0; t < kBQ2 / 32; ++t) {
          sm.lse[stage][lane + 32 * t] = lt[t];
          sm.delta[stage][lane + 32 * t] = dt[t];
        }"""
AFTER_WAIT = """        mbar_wait(&sm.empty[stage], phase ^ 1);
#pragma unroll
        for (int t = 0; t < kBQ2 / 32; ++t) {
          const int row = i * kBQ2 + lane + 32 * t;
          const bool ok = row < a.sq;
          sm.lse[stage][lane + 32 * t] = ok ? a.lse[(size_t)bh * a.sq + row] : 0.f;
          sm.delta[stage][lane + 32 * t] = ok ? a.delta[(size_t)bh * a.sq + row] : 0.f;
        }"""
STEP = "constexpr int W = (D == 128 && DROP) ? 32 : 64;"
VARIANTS = {
    "base": [],
    "stages2": [(STAGES, "constexpr int kStagesQ = 2, kStagesKV = 2;")],
    "lse_after_wait": [(PREFETCH, AFTER_WAIT)],
    "dq_one_step": [(STEP, "constexpr int W = 64;")],
}
TIMED = ("base", "stages2", "lse_after_wait")


def build(out):
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    ptxas, libs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        kern = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '\S*(flash_(?:dq|dkv)_"
                          r"wgmma_kernel)ILi(\d+)ELb(\d)E", ln)
            if m:
                kern = f"{m.group(1)}<{m.group(2)}, {m.group(3) == '1'}>"
            elif "Compiling entry function" in ln:
                kern = None
            elif kern and ("spill" in ln or "registers" in ln):
                ptxas.setdefault(name, {}).setdefault(kern, []).append(
                    ln.strip())
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fname, types in fa._ARGTYPES.items():
            for suffix in ("f32", "bf16"):
                fn = getattr(lib, f"{fname}_{suffix}")
                fn.argtypes, fn.restype = list(types), ctypes.c_int
        for fname, types in fa._WGMMA_ARGTYPES.items():
            fn = getattr(lib, f"{fname}_bf16")
            fn.argtypes, fn.restype = list(types), ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return ptxas, libs


def inputs(kind):
    """q, k, v, dO and the backward's arguments after them."""
    if kind == "gpt":
        q, k, v, do = cs.flash_inputs(torch, cs.TRAIN_B * cs.TRAIN_NH,
                                      cs.TRAIN_S, torch.bfloat16, seed=7)
        return q, k, v, do, (True, cs.FLASH_D ** -0.5, None, 1, None)
    lengths = cs.bert_lengths(cs.BERT_B, cs.BERT_S, seed=cs.BERT_B)
    bias = cs.kv_bias_for(torch, lengths, cs.BERT_S)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(cs.BERT_B * cs.BERT_NH, cs.BERT_S, cs.BERT_D,
                               generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    key = None
    if kind == "bert_dropout":
        key = cs.drop_key(fa, *fa.flash_drop_tile(cs.BERT_S, cs.BERT_S,
                                                  False, torch.bfloat16))
    return q, k, v, do, (False, cs.BERT_D ** -0.5, bias, cs.BERT_NH, key)


def main():
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    out = ROOT / "build" / "flash_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    ptxas, libs = build(out)
    res = {name: {"ptxas": ptxas.get(name, {})} for name in VARIANTS}
    for kind in ("gpt", "bert", "bert_dropout"):
        q, k, v, do, a = inputs(kind)
        o, lse = fa.flash_fwd_ref(q, k, v, *a)
        lse = lse.contiguous()
        ref = fa.flash_bwd_ref(q, k, v, o, lse, do, *a)
        for name in TIMED:
            fa._lib = lambda name=name: libs[name]
            got = fa._bwd_cuda(q, k, v, o, lse, do, *a)
            torch.cuda.synchronize()
            res[name][f"{kind} readings"] = [
                cs.flash_reading(x, y) for x, y in zip(got, ref)]
        qs, ks, delta = fa._bwd_prep_cuda(q, k, o, do, a[1])
        calls = {"dq": lambda: fa._dq_cuda(q, k, v, do, lse, delta, *a,
                                           ks=ks),
                 "dkv": lambda: fa._dkv_cuda(q, k, v, do, lse, delta, *a,
                                             qs=qs),
                 "backward": lambda: fa._bwd_cuda(q, k, v, o, lse, do, *a)}
        for what, call in calls.items():
            times = {name: [] for name in TIMED}
            for order in (TIMED, TIMED[::-1]):
                for name in order:
                    fa._lib = lambda name=name: libs[name]
                    times[name].append(cs.cuda_ms(lambda _: call(), [None],
                                                  iters=20))
            for name in TIMED:
                res[name][f"{kind} {what} ms"] = min(times[name])
        del q, k, v, do, o, lse, ref, qs, ks, delta
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
