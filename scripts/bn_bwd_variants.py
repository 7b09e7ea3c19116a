#!/usr/bin/env python3
"""The persistent BatchNorm backward's design choices, measured on one CUDA
card.

    python3 scripts/bn_bwd_variants.py

Builds copies of ``paddle_tpu_torch/kernels/csrc/norm_fusion.cu`` into
``build/bn_bwd_variants/``, one nvcc each, all started together, and
prints ptxas' registers, shared memory and spills of each copy's
``bn_bwd_persist`` instantiations. The route's design is fixed by the
constants of namespace ``bnb`` (two blocks an SM, two teams, lag 1,
slots in shared memory, 24 MB a group read past them); the design copies
change one or two of them:

- ``base``: the source as it is (the route);
- ``smem_only``: groups of the slots alone, one team (nothing read past
  the slots); ``smem_only_teams2`` the same in two teams;
- ``l2_8MB``, ``l2_16MB``, ``l2_32MB``: other budgets read past the
  slots;
- ``l2_only_12MB``, ``l2_only_24MB``: the L2-only design (no slots; every
  vector read from device memory with an evict_last hint, and again by
  the apply) at two group budgets;
- ``lag2``: three slots a block (two groups' loads ahead);
- ``bps1``: one block an SM (larger slots);
- ``teams1``: the grid as one team.

The diagnostic copies keep the route's design and undo one step:

- ``no_wait``: blocks apply a group without waiting for its fold (the
  cost of the per-group synchronisation; wrong results);
- ``no_reduce``: no reduction (wrong results): the loads, the counters,
  the folds and the apply;
- ``no_apply``: no apply: the loads, the reduction and the folds;
- ``no_sync``: no counters, folds or waits (wrong results);
- ``loads_only``: only the loads into the slots and the loop around them;
  ``loads_only_no_slot``: the loop alone;
- ``producer_last_warp``: the last warp, not the first, issues the bulk
  copies (the first warp's thread 0 keeps the counters and flags);
- ``plain_stores``: dx and dres stored without the streaming hint;
- ``relaxed_arrival``: the counter's add without release semantics (the
  partials may not be visible to the fold: wrong results possible), the
  cost of a release that waits for the apply's stores;
- ``batch4``: four vectors' loads in flight a thread, not two;
- ``no_fast_path``: every tile on the general reduce and apply (the
  fast path takes tiles of at most two channels where HW is a whole
  number of vectors).

Then, at resnet50's layer1.bn3 ([256, 256, 3136] bf16, residual + ReLU),
its stem ([256, 64, 12544] bf16, ReLU) and ppyoloe-l's stem ([8, 32,
102400] f32), it holds each design copy's backward against the plain
version (chip_smoke.py's ``BN_TOL`` and ``BN_STAT_TOL``), and times the
generic route and every copy, each beside the bytes-once bound, in two
passes (in order, then reversed; the better pass).

Prints the card's name and power limit, ptxas' registers and spills of
each copy's instantiations, then a JSON line a shape: the device times
in ms (chip_smoke.py's ``cuda_ms``) beside the bound, each copy's groups
and dynamic shared memory a block, and the copies whose readings failed;
the whole record (ptxas lines, readings) goes to
``chiprun_out/bn_bwd_variants.json``.
Needs nvcc and a card; run from the repository's root.
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

WAIT = "      if (threadIdx.x == 0) wait_flag(p.cnt + p.groups + j);\n"
REDUCE = """      if (p.hw % V == 0 && t.nch <= 2) {
        reduce2<T>(p, gr, t, slots + s * slot_vecs, red, keep);
      } else {
        reduce<T>(p, gr, t, slots + s * slot_vecs, red, keep);
      }
"""
APPLY = """      if (p.hw % V == 0 && t.nch <= 2) {
        apply2<T>(p, gr, t, slots + s * slot_vecs, cs, once);
      } else {
        apply<T>(p, gr, t, slots + s * slot_vecs, cs, once);
      }
"""
ARRIVE = ("      if (threadIdx.x == 0) *last_s = atom_add_acq_rel(p.cnt + j, 1u) "
          "+ 1 == (unsigned)gr.tiles;\n")
NO_ARRIVE = "      if (threadIdx.x == 0) *last_s = 0;\n"
PRODUCER = "!kL2Only && threadIdx.x < 32"
# the route's design constants (norm_fusion.cu namespace bnb)
ROUTE = {"kBlocksPerSm": nf.BN_BLOCKS_PER_SM, "kTeams": nf.BN_TEAMS,
         "kLag": nf.BN_LAG, "kL2Only": False, "kL2Bytes": nf.BN_L2_BYTES}
DESIGNS = {
    "base": {},
    "smem_only": dict(kL2Bytes=0, kTeams=1),
    "smem_only_teams2": dict(kL2Bytes=0),
    "l2_8MB": dict(kL2Bytes=8 * 10 ** 6),
    "l2_16MB": dict(kL2Bytes=16 * 10 ** 6),
    "l2_32MB": dict(kL2Bytes=32 * 10 ** 6),
    "l2_only_12MB": dict(kL2Only=True, kL2Bytes=12 * 10 ** 6),
    "l2_only_24MB": dict(kL2Only=True),
    "lag2": dict(kLag=2),
    "bps1": dict(kBlocksPerSm=1),
    "teams1": dict(kTeams=1),
}
DIAGNOSTICS = {
    "no_wait": [(WAIT, "")],
    "no_reduce": [(REDUCE, "")],
    "no_apply": [(APPLY, "")],
    "no_sync": [(ARRIVE, NO_ARRIVE), (WAIT, "")],
    "loads_only": [(REDUCE, ""), (APPLY, ""), (ARRIVE, NO_ARRIVE), (WAIT, "")],
    "producer_last_warp": [(PRODUCER,
                            "!kL2Only && threadIdx.x >= kThreads - 32")],
    "plain_stores": [("st.global.cs.v4.u32", "st.global.v4.u32")],
    "relaxed_arrival": [("atom.acq_rel.gpu.global.add.u32",
                         "atom.relaxed.gpu.global.add.u32")],
    "batch4": [("constexpr int kBatch = 2;", "constexpr int kBatch = 4;")],
    "no_fast_path": [("p.hw % V == 0 && t.nch <= 2", "false")],
}
# (label, N, C, HW, dtype, relu, residual)
SHAPES = [("layer1.bn3", 256, 256, 3136, torch.bfloat16, True, True),
          ("stem", 256, 64, 12544, torch.bfloat16, True, False),
          ("ppyoloe_stem", 8, 32, 102400, torch.float32, False, False)]


def _literal(v):
    return ("true" if v else "false") if isinstance(v, bool) else str(v)


def _design_subs(changes):
    """The source's lines of the changed design constants, replaced."""
    out = []
    for name, value in changes.items():
        kind = "bool" if name == "kL2Only" else "int"
        out.append((f"constexpr {kind} {name} = {_literal(ROUTE[name])};",
                    f"constexpr {kind} {name} = {_literal(value)};"))
    return out


def copies():
    """{name: (the design's constants, the source's substitutions)}."""
    out = {name: ({**ROUTE, **ch}, _design_subs(ch))
           for name, ch in DESIGNS.items()}
    for name, subs in DIAGNOSTICS.items():
        out[name] = (dict(ROUTE), subs)
    out["loads_only_no_slot"] = ({**ROUTE, "kL2Only": True},
                                 DIAGNOSTICS["loads_only"]
                                 + _design_subs({"kL2Only": True}))
    return out


def build(out, table):
    src = (_build.CSRC / "norm_fusion.cu").read_text()
    procs = {}
    for name, (_, subs) in table.items():
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
            m = re.search(r"Compiling entry function '\S*bn_bwd_persistI(\w+?)E",
                          ln)
            if m:
                kern = f"bn_bwd_persist<{m.group(1)}>"
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
        lib.fused_bn_parts.argtypes = [ctypes.c_int] * 2
        lib.fused_bn_parts.restype = ctypes.c_int
        lib.fused_bn_bwd_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.fused_bn_bwd_plan.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return ptxas, libs


def copy_plan(lib, n, c, hw, dtype, tensors, sms):
    """A copy's plan as its C side reckons it: cg, groups, th, tw, cg_last,
    th_last, tw_last, cap."""
    got = (ctypes.c_int * 8)()
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    rc = lib.fused_bn_bwd_plan(n, c, hw, vec, tensors, sms, got)
    if rc:
        raise RuntimeError(f"fused_bn_bwd_plan [{n}, {c}, {hw}]: rc {rc}")
    return list(got)


def persist(lib, design, plan, sms, x, res, w, b, mean, var, g, gm, gv,
            relu):
    """One call of a copy's persistent backward, its scratch sized by its
    own grid and plan: (dx, dres, dw, db)."""
    n, c, hw = x.shape
    parts = design["kBlocksPerSm"] * sms
    scratch = torch.empty(6 * c + 2 * parts * c + 2 * plan[1],
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dres = None if res is None else torch.empty_like(x)
    ptr = nf._ptr
    _build.call(lib, "fused_bn_bwd_persist", x.dtype, x.device, x.data_ptr(),
                ptr(res), w.data_ptr(), b.data_ptr(), mean.data_ptr(),
                var.data_ptr(), g.data_ptr(), ptr(gm), ptr(gv), dx.data_ptr(),
                ptr(dres), scratch.data_ptr(), None, None, n, c, hw,
                float(cs.BN_EPS), int(relu), -1, 0)
    return dx, dres, scratch[4 * c:5 * c], scratch[5 * c:6 * c]


def main():
    if not torch.cuda.is_available():
        print("bn_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    out = ROOT / "build" / "bn_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    table = copies()
    ptxas, libs = build(out, table)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"ptxas": ptxas}
    nf._lib = lambda: libs["base"]      # the forward and the generic route
    for label, n, c, hw, dtype, relu, has_res in SHAPES:
        x = cs.bn_inputs(torch, n, c, hw, dtype, 41, has_res)
        xx, r, w, b, g = (x[k] for k in ("x", "res", "w", "b", "g"))
        y, mean, var = nf.fused_bn_fwd(xx, r, w, b, cs.BN_EPS, relu)
        rdx, rgate, rdw, rdb = nf.fused_bn_bwd_ref(
            xx, r, w, b, mean, var, g, x["gmean"], x["gvar"], cs.BN_EPS, relu)
        # phase 27's rule: elements whose ReLU gate the plain version's
        # pre-activation flips are left out of dx
        keep = None
        if relu:
            keep = (y > 0) == (cs.bn_plain_pre(torch, nf, xx, r, w, b, mean,
                                               var) > 0)
        bound = cs.bn_bounds(n, c, hw, xx.element_size(), has_res)
        tensors = 3 if relu and has_res else 2
        plans = {name: copy_plan(libs[name], n, c, hw, dtype, tensors, sms)
                 for name in table}
        w32, b32 = nf._vec32(w), nf._vec32(b)

        def call(name, gm=None, gv=None):
            if name == "generic":
                return nf._bn_bwd_cuda(xx, r, w, b, mean, var, g, gm, gv,
                                       cs.BN_EPS, relu, route="generic")
            return persist(libs[name], table[name][0], plans[name], sms, xx,
                           r, w32, b32, mean, var, g, gm, gv, relu)

        row = {"bound_ms": bound["fused_bn_bwd"][0], "readings": {}}
        tol = cs.BN_TOL[str(dtype).split(".")[-1]]
        for name in ("generic", *DESIGNS):
            got = call(name, nf._vec32(x["gmean"]), nf._vec32(x["gvar"]))
            torch.cuda.synchronize()
            dx, ref = got[0], rdx.to(dtype)
            if keep is not None:
                dx, ref = dx[keep], ref[keep]
            rd = {"dx": cs.rel_err(dx, ref)[1],
                  "dw": cs.rel_err(got[2], rdw)[1],
                  "db": cs.rel_err(got[3], rdb)[1]}
            ok = rd["dx"] <= tol and max(rd["dw"], rd["db"]) <= \
                cs.BN_STAT_TOL
            row["readings"][name] = dict(ok=ok, **rd)
        timed = ["generic", *table]
        times = {name: [] for name in timed}
        for order in (timed, timed[::-1]):
            for name in order:
                times[name].append(cs.cuda_ms(lambda _, name=name: call(name),
                                              [None], iters=20))
        row["ms"] = {name: min(t) for name, t in times.items()}
        row["groups"] = {name: pl[1] for name, pl in plans.items()}
        # a block's dynamic shared memory: kLag + 1 slots and the scratch
        # (ptxas -v counts static shared memory only)
        row["smem_bytes"] = {
            name: (design["kLag"] + 1) * plans[name][7] * 16 * tensors
            + nf.BN_SCRATCH for name, (design, _) in table.items()}
        row["share_of_bound"] = {name: row["bound_ms"] / t
                                 for name, t in row["ms"].items()}
        res[label] = row
        del x, xx, r, w, b, g, y, mean, var, rdx, rgate, rdw, rdb, keep
        torch.cuda.empty_cache()
    # the whole record to chiprun_out/, the times here
    dump = ROOT / "chiprun_out" / "bn_bwd_variants.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps(res))
    for copy, kernels in ptxas.items():
        for kern, lines in kernels.items():
            print(f"ptxas {copy} {kern}: {' | '.join(lines)}", flush=True)
    for label, _, _, _, _, _, _ in SHAPES:
        row = res[label]
        print(json.dumps({label: dict(bound_ms=row["bound_ms"], ms=row["ms"],
                                      groups=row["groups"],
                                      smem_bytes=row["smem_bytes"],
                                      failed=[k for k, v in row["readings"]
                                              .items() if not v["ok"]])}),
              flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
