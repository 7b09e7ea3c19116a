#!/usr/bin/env python3
"""The cluster BatchNorm forward's design choices, measured on one CUDA
card.

    python3 scripts/bn_fwd_variants.py [copy ...]

Builds copies of ``paddle_tpu_torch/kernels/csrc/norm_fusion.cu`` into
``build/bn_fwd_variants/``, one nvcc each, all started together, and
prints ptxas' registers, shared memory and spills of each copy's
``bn_fwd_cluster`` instantiations. The route's design is fixed by the
constants of namespace ``bnf`` (clusters of up to 16 CTAs, K raised while
the grid has fewer CTAs than SMs, 256 threads a CTA of at most half an
SM's shared memory and 512 a larger one, 4 vectors a thread a group,
chunks and ring stages of 2048 vectors, a ring of 3 stages for x past
the resident part, the residual into registers a group ahead, y by
16-byte stores, one slab a cluster); the copies change one of them:

- ``base``: the source as it is (the route);
- ``k8``: clusters of up to 8 CTAs (the portable limit);
- ``threads512``: 512 threads for every CTA (one an SM however small);
- ``steps2``: 2 vectors a thread a group;
- ``ring2``, ``ring4``: other ring depths; ``s4096_ring2``: chunks and
  stages of 4096 vectors, two stages;
- ``res_ring``: the residual through the ring (its stages then hold x's
  and the residual's vectors), not registers;
- ``par2``: K raised while the grid has fewer CTAs than twice the SMs;
- ``tma_store``: y written in place over x in shared memory and out by
  bulk stores, a chunk each;
- ``persistent``: a grid of the clusters the card holds at once, each
  walking slabs (the next slab's x loading into the chunks the apply has
  freed).

A design whose plan holds no chunk at a shape (the residual's ring beside
a tile that does not fit) is refused there and left out.
Naming copies on the command line builds and times only those (and the
base). At every distinct BN forward call of a resnet50 step ([256, C, HW] bf16,
16 shapes and epilogues, 53 calls) and of a ppyoloe-l step ([8, C, HW]
f32, 9 shapes, 35 calls), and at a BatchNorm1D ([256, 512] bf16), it
checks each
copy's plan (its ``fused_bn_fwd_plan`` against ``norm_fusion._bnf_plan``
under the copy's constants), holds each copy's y, mean and var against the
plain version (chip_smoke.py's ``BN_TOL`` and ``BN_STAT_TOL``), and times
the generic route and every copy, each beside the bytes-once bound, in two
passes (in order, then reversed; the better pass).

Prints the card's name and power limit, ptxas' lines, each step's BN
forward ms (the calls' kernel times summed) by copy, then a JSON line a
shape: ms, the bound, each copy's cluster size, clusters the card holds
at once (cudaOccupancyMaxActiveClusters), shared memory a CTA, x's bytes
read over x's size, and the copies whose readings failed; the whole record
goes to ``chiprun_out/bn_fwd_variants.json``. Needs nvcc and a card; run
from the repository's root.
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
from paddle_tpu_torch.kernels import norm_fusion as nf  # noqa: E402

# the route's design constants (norm_fusion.cu namespace bnf)
ROUTE = {"kSmallThreads": nf.BNF_SMALL_THREADS, "kSteps": 4,
         "kCtasPerSm": nf.BNF_CTAS_PER_SM, "kMaxCluster": nf.BNF_MAX_CLUSTER,
         "kParPerSm": nf.BNF_PAR_PER_SM,
         "kStageVecs": nf.BNF_STAGE_VECS, "kRing": nf.BNF_RING,
         "kResRing": nf.BNF_RES_RING, "kTmaStore": False,
         "kPersistent": False}
DESIGNS = {
    "base": {},
    "k8": dict(kMaxCluster=8),
    "threads512": dict(kSmallThreads=512),
    "steps2": dict(kSteps=2),
    "ring2": dict(kRing=2),
    "ring4": dict(kRing=4),
    "s4096_ring2": dict(kStageVecs=4096, kRing=2),
    "res_ring": dict(kResRing=True),
    "par2": dict(kParPerSm=2),
    "tma_store": dict(kTmaStore=True),
    "persistent": dict(kPersistent=True),
}
# every distinct BN forward call of a resnet50 step (bf16, B=256, 224^2)
# and of a ppyoloe-l step (f32, B=8, 640^2): (C, HW, relu, residual,
# calls a step); chip_smoke's BN_CASES are among them but its BatchNorm1D
STEPS = {
    "resnet50": (cs.BN_N, torch.bfloat16, [
        (64, 12544, True, False, 1), (64, 3136, True, False, 6),
        (128, 3136, True, False, 1), (256, 3136, False, False, 1),
        (256, 3136, True, True, 3), (128, 784, True, False, 7),
        (256, 784, True, False, 1), (512, 784, False, False, 1),
        (512, 784, True, True, 4), (256, 196, True, False, 11),
        (512, 196, True, False, 1), (1024, 196, False, False, 1),
        (1024, 196, True, True, 6), (512, 49, True, False, 5),
        (2048, 49, False, False, 1), (2048, 49, True, True, 3)]),
    "ppyoloe-l": (cs.PPYOLOE_B, torch.float32, [
        (32, 102400, False, False, 1), (64, 25600, False, False, 1),
        (64, 6400, False, False, 5), (128, 6400, False, False, 6),
        (128, 1600, False, False, 9), (256, 1600, False, False, 2),
        (128, 400, False, False, 4), (256, 400, False, False, 5),
        (512, 400, False, False, 2)]),
}
# (label, N, C, HW, dtype, relu, residual), the steps' calls by label
SHAPES, CALLS = [], {}
for _model, (_n, _dt, _rows) in STEPS.items():
    for _c, _hw, _relu, _res, _calls in _rows:
        _label = (f"{_model} {_c}x{_hw}" + ("+res" if _res else "")
                  + ("+relu" if _relu else ""))
        SHAPES.append((_label, _n, _c, _hw, _dt, _relu, _res))
        CALLS.setdefault(_model, {})[_label] = _calls
SHAPES.append(("bn1d", cs.BN_N, 512, 1, torch.bfloat16, True, True))


def _literal(v):
    return ("true" if v else "false") if isinstance(v, bool) else str(v)


def design_subs(changes):
    """The source's lines of the changed design constants, replaced."""
    out = []
    for name, value in changes.items():
        kind = "bool" if isinstance(value, bool) else "int"
        out.append((f"constexpr {kind} {name} = {_literal(ROUTE[name])};",
                    f"constexpr {kind} {name} = {_literal(value)};"))
    return out


def build(out, names):
    src = (_build.CSRC / "norm_fusion.cu").read_text()
    body = src.index("namespace bnf {")
    procs = {}
    for name in names:
        text = src
        for old, new in design_subs(DESIGNS[name]):
            if old not in text[body:]:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text[:body] + text[body:].replace(old, new, 1)
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
            m = re.search(r"Compiling entry function "
                          r"'\S*bn_fwd_clusterI(\w+?)E", ln)
            if m:
                kern = f"bn_fwd_cluster<{m.group(1)}>"
            elif "Compiling entry function" in ln:
                kern = None
            elif kern and re.search(r"spill|registers|smem", ln):
                ptxas.setdefault(name, {}).setdefault(kern, []).append(
                    ln.strip())
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fname, types in nf._ARGTYPES.items():
            for suffix in ("f32", "bf16"):
                fn = getattr(lib, f"{fname}_{suffix}")
                fn.argtypes, fn.restype = list(types), ctypes.c_int
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"fused_bn_fwd_clusters_{suffix}")
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.fused_bn_parts.argtypes = [ctypes.c_int] * 2
        lib.fused_bn_parts.restype = ctypes.c_int
        lib.fused_bn_fwd_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.fused_bn_fwd_plan.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return ptxas, libs


def copy_plan(name, lib, n, c, hw, dtype, res, sms):
    """A copy's plan from its C side, checked against the Python mirror
    under the copy's constants; with the clusters the card holds at once."""
    d = {**ROUTE, **DESIGNS[name]}
    try:
        want = nf._bnf_plan(n, c, hw, dtype, bool(res), sms, d["kCtasPerSm"],
                            d["kMaxCluster"], d["kStageVecs"], d["kRing"],
                            d["kResRing"], d["kSmallThreads"], d["kParPerSm"])
    except ValueError:      # the design holds no chunk at this shape
        want = None
    got = (ctypes.c_int * 11)()
    if want is None:
        rc = lib.fused_bn_fwd_plan(n, c, hw, 128 // torch.finfo(dtype).bits,
                                   int(res), sms, got)
        if rc == 0:
            raise RuntimeError(f"{name} plan at [{n}, {c}, {hw}]: the "
                               f"kernel's {list(got)}, the mirror refuses")
        return None, None
    rc = lib.fused_bn_fwd_plan(n, c, hw, want.vec, int(res), sms, got)
    fields = [want.cg, want.k, want.ns, want.cs, want.rowv, want.cap,
              want.ring_t, want.smem, want.slabs, want.tv, want.threads]
    if rc or list(got) != fields or want is None:
        raise RuntimeError(f"{name} plan at [{n}, {c}, {hw}]: the kernel's "
                           f"{list(got)} (rc {rc}), the mirror's {fields}")
    act = (ctypes.c_int * 2)()
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    rc = getattr(lib, f"fused_bn_fwd_clusters_{suffix}")(n, c, hw, int(res),
                                                         act)
    if rc:
        raise RuntimeError(f"{name}: fused_bn_fwd_clusters rc {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")
    b = nf.bn_fwd_bytes(want)
    return want, dict(k=want.k, active_clusters=act[1], smem=want.smem,
                      threads=want.threads,
                      cg=want.cg, cap=want.cap, tile_vectors=want.tv,
                      x_read_over_x=b["x_read"] / b["y_written"])


def main():
    if not torch.cuda.is_available():
        print("bn_fwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    names = ["base"] + [a for a in sys.argv[1:] if a != "base"]
    if len(names) == 1:
        names = list(DESIGNS)
    unknown = set(names) - set(DESIGNS)
    if unknown:
        print(f"bn_fwd_variants: no copy {sorted(unknown)}", file=sys.stderr)
        return 2
    out = ROOT / "build" / "bn_fwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    ptxas, libs = build(out, names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = {"ptxas": ptxas, "sms": sms}
    nf._lib = lambda: libs["base"]      # the generic route
    for label, n, c, hw, dtype, relu, has_res in SHAPES:
        x = cs.bn_inputs(torch, n, c, hw, dtype, 41, has_res)
        xx, r, w, b = (x[k] for k in ("x", "res", "w", "b"))
        ry, rmean, rvar = nf.fused_bn_fwd_ref(xx, r, w, b, cs.BN_EPS, relu)
        bound = cs.bn_bounds(n, c, hw, xx.element_size(), has_res)
        plans = {name: copy_plan(name, libs[name], n, c, hw, dtype, has_res,
                                 sms) for name in names}
        live = [name for name in names if plans[name][0] is not None]
        w32, b32 = nf._vec32(w), nf._vec32(b)

        def call(name):
            if name == "generic":
                return nf._bn_fwd_cuda(xx, r, w, b, cs.BN_EPS, relu,
                                       route="generic")
            y = torch.empty_like(xx)
            mean = torch.empty(c, dtype=torch.float32, device=xx.device)
            var = torch.empty_like(mean)
            _build.call(libs[name], "fused_bn_fwd_cluster", dtype, xx.device,
                        xx.data_ptr(), nf._ptr(r), w32.data_ptr(),
                        b32.data_ptr(), y.data_ptr(), mean.data_ptr(),
                        var.data_ptr(), n, c, hw, float(cs.BN_EPS),
                        int(relu), 0, 0)
            return y, mean, var

        row = {"bound_ms": bound["fused_bn_fwd"][0], "readings": {},
               "plans": {k: v[1] for k, v in plans.items() if k in live},
               "refused": [k for k in names if k not in live]}
        tol = cs.BN_TOL[str(dtype).split(".")[-1]]
        for name in ("generic", *live):
            try:
                got = call(name)
                again = call(name)
                torch.cuda.synchronize()
            except RuntimeError as err:   # a launch the card refuses
                row["readings"][name] = dict(ok=False, error=str(err))
                continue
            rd = {"y": cs.rel_err(got[0], ry)[1],
                  "mean": cs.rel_err(got[1], rmean)[1],
                  "var": cs.rel_err(got[2], rvar)[1],
                  "repeat_bits": all(cs.same_bits(a, o)
                                     for a, o in zip(got, again))}
            rd["ok"] = (rd["y"] <= tol and max(rd["mean"], rd["var"])
                        <= cs.BN_STAT_TOL and rd["repeat_bits"])
            row["readings"][name] = rd
            del got, again
        timed = [k for k in ("generic", *live)
                 if "error" not in row["readings"][k]]
        times = {name: [] for name in timed}
        for order in (timed, timed[::-1]):
            for name in order:
                times[name].append(cs.cuda_ms(lambda _, name=name: call(name),
                                              [None], iters=20))
        row["ms"] = {name: min(t) for name, t in times.items()}
        row["share_of_bound"] = {name: row["bound_ms"] / t
                                 for name, t in row["ms"].items()}
        record[label] = row
        del x, xx, r, w, b, ry, rmean, rvar
        torch.cuda.empty_cache()
    dump = ROOT / "chiprun_out" / "bn_fwd_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps(record))
    for copy, kernels in ptxas.items():
        for kern, lines in kernels.items():
            print(f"ptxas {copy} {kern}: {' | '.join(lines)}", flush=True)
    for model, calls in CALLS.items():
        per_step = {}
        for name in record[SHAPES[0][0]]["ms"]:
            if all(name in record[lb]["ms"] for lb in calls):
                per_step[name] = sum(n * record[lb]["ms"][name]
                                     for lb, n in calls.items())
        record[f"{model} ms a step"] = per_step
        print(json.dumps({f"{model} BN forward ms a step": per_step}),
              flush=True)
    for label, *_ in SHAPES:
        row = record[label]
        print(json.dumps({label: dict(
            bound_ms=row["bound_ms"], ms=row["ms"],
            k={k: v["k"] for k, v in row["plans"].items()},
            active_clusters={k: v["active_clusters"]
                             for k, v in row["plans"].items()},
            smem={k: v["smem"] for k, v in row["plans"].items()},
            x_read_over_x={k: round(v["x_read_over_x"], 4)
                           for k, v in row["plans"].items()},
            failed=[k for k, v in row["readings"].items() if not v["ok"]],
            refused=row["refused"])}),
            flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
