"""The BatchNorm backward's persistent route (TPU kernels 17 and 18 on
Hopper), reckoned on the CPU.

``bn_bwd_route`` sends every call the op takes (float32 or bfloat16, C %
8 == 0, C <= 65535) to the persistent kernel and refuses the rest, as
the wrapper refuses tensors that are not contiguous and 16-byte aligned:
nothing falls back to the generic kernels. ``bn_bwd_plan`` is the
kernel's plan: groups of whole consecutive channels whose every tile fits
its share (one shared-memory slot and its part of the bytes read past
the slots), each group's grid of image-by-vector tiles, one tile a
block; ``_bn_plan`` reckons it under the other designs that
scripts/bn_bwd_variants.py compiles, and under budgets small enough to
make several groups of a small tensor. A simulated schedule of that plan (the prologue's loads,
the reduction, the counter, the fold of the last block, the flag wait,
the apply, the next loads into the freed slot) runs to its end in any
order of the blocks. An emulation of the kernel's arithmetic in its
order -- each tile's partial per channel, the fold adding the partials of
the tiles that hold a channel in tile order in the kernel's runs, the
coefficients from the fold's f32 expressions, the apply -- is held
against the reference's Pallas backward in interpret mode (``jax.vjp``
through ``fused_batch_norm_train(..., interpret=True)``) in all four
epilogues, f32 and bf16, with and without the cotangents of the mean and
var outputs, at HW a whole number of vectors, HW 49, HW 20 (a bf16 plane
that starts mid-vector like HW 196) and HW 1, with budgets small enough
that tiles read past their slots.

Tolerances, phase 27's (``BN_TOL``, ``BN_STAT_TOL`` in chip_smoke.py), of
each output's largest magnitude: the rows (dx, dres) 1e-5 in f32 (the same
f32 arithmetic in other summation orders) and 2^-7 in bf16 (both round
the same f32 values to bf16; one near a rounding boundary may round the
other way); dw and db 1e-5 (f32 sums). Each is shown to reject the
emulation with one block's partial left out of every fold.
"""
import ctypes
import functools
import importlib.util
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import norm_fusion as jnf
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import norm_fusion as pnf

ROOT = Path(__file__).resolve().parents[1]
SRC = Path(pnf.__file__).parent / "csrc" / "norm_fusion.cu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# phase 27's tolerances, read from chip_smoke.py
_CS = _chip_smoke()
BN_TOL = {torch.float32: _CS.BN_TOL["float32"],
          torch.bfloat16: _CS.BN_TOL["bfloat16"]}
BN_STAT_TOL = _CS.BN_STAT_TOL
EPS = _CS.BN_EPS


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 256), (torch.float32, 32),
                                     (torch.bfloat16, 8),
                                     (torch.float32, 65528)])
def test_route_takes_every_call_the_op_takes(dtype, c):
    assert pnf.bn_bwd_route(dtype, c) == "persistent"


@pytest.mark.parametrize("dtype,c,error", [
    (torch.float16, 64, TypeError),
    (torch.bfloat16, 12, ValueError),
    (torch.float32, 65536, ValueError)])
def test_route_refuses_what_the_op_refuses(dtype, c, error):
    """No "generic" answer: the old kernels are never a route's fallback."""
    with pytest.raises(error):
        pnf.bn_bwd_route(dtype, c)


@pytest.mark.parametrize("which", ["x", "g", "res"])
@pytest.mark.parametrize("layout", ["misaligned", "strided"])
def test_wrapper_refuses_misaligned_or_strided_rows(monkeypatch, which,
                                                    layout):
    """The kernel's 16-byte spans need contiguous rows on 16-byte
    boundaries: the wrapper refuses anything else before any launch."""
    monkeypatch.setattr(pnf, "_lib", lambda: pytest.fail("launched"))
    n, c, hw = 2, 8, 16
    rows = {k: torch.zeros(n, c, hw, dtype=torch.bfloat16)
            for k in ("x", "g", "res")}
    if layout == "misaligned":
        rows[which] = torch.zeros(n * c * hw + 1,
                                  dtype=torch.bfloat16)[1:].view(n, c, hw)
    else:
        rows[which] = torch.zeros(n, hw, c,
                                  dtype=torch.bfloat16).transpose(1, 2)
    v = torch.ones(c)
    with pytest.raises(ValueError, match="16-byte"):
        pnf._bn_bwd_cuda(rows["x"], rows["res"], v, v, v, v, rows["g"], None,
                         None, EPS, True)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (N, C, HW, dtype, tensors, SMs): resnet50's stem, layer1.bn3, layer1's
# downsample, layer3.bn2 (HW 196), layer4.bn3 (HW 49), a BatchNorm1D, and
# ppyoloe-l's stem, on an H100; then small and ragged shapes
PLAN_CASES = [
    (256, 64, 12544, torch.bfloat16, 2, 132),
    (256, 256, 3136, torch.bfloat16, 3, 132),
    (256, 256, 3136, torch.bfloat16, 2, 132),
    (256, 256, 196, torch.bfloat16, 2, 132),
    (256, 2048, 49, torch.bfloat16, 3, 132),
    (256, 512, 1, torch.bfloat16, 3, 132),
    (8, 32, 102400, torch.float32, 2, 132),
    (8, 256, 25, torch.float32, 2, 132),
    (5, 24, 49, torch.float32, 3, 3),
    (3, 16, 20, torch.bfloat16, 2, 1),
    (7, 8, 1, torch.bfloat16, 3, 2),
]


SMEM_ONLY = dict(l2_bytes=0, teams=1)


def _slot_bytes(blocks_per_sm, lag):
    """kSlotBytes under kBlocksPerSm = blocks_per_sm and kLag = lag."""
    return ((pnf.BN_SMEM_PER_SM // blocks_per_sm - pnf.BN_BLOCK_RESERVE
             - pnf.BN_SCRATCH) // (lag + 1) // 128 * 128)


def _plan(n, c, hw, dtype, sms, tensors=2, *,
          blocks_per_sm=pnf.BN_BLOCKS_PER_SM, lag=pnf.BN_LAG,
          slot_bytes=None, l2_bytes=pnf.BN_L2_BYTES, teams=pnf.BN_TEAMS):
    """The plan of a copy of the kernel with its design constants changed
    (``slot_bytes`` 0: the L2-only design), or of a budget small enough to
    cut a small tensor into several groups; the route's at the
    defaults."""
    if slot_bytes is None:
        slot_bytes = _slot_bytes(blocks_per_sm, lag)
    return pnf._bn_plan(n, c, hw, dtype, tensors, blocks_per_sm * sms, teams,
                        slot_bytes, l2_bytes)


def _check_plan(plan):
    n, c, hw, vec = plan.n, plan.c, plan.hw, plan.vec
    assert plan.groups[0].c0 == 0
    assert sum(g.cn for g in plan.groups) == c
    for a, b in zip(plan.groups, plan.groups[1:]):
        assert b.c0 == a.c0 + a.cn
    for gr in plan.groups:
        # every (image, group) row contiguous and on a 16-byte boundary
        assert gr.c0 % plan.unit == 0 and gr.c0 * hw % vec == 0
        assert gr.cn <= pnf.BN_MAX_GROUP_C and gr.cn * hw % vec == 0
        assert gr.lv * vec == gr.cn * hw
        tiles = pnf.bn_bwd_tiles(plan, gr)
        assert len(tiles) == gr.tiles <= plan.team_parts
        assert plan.team_parts * plan.teams == plan.parts
        assert [t.block for t in tiles] == list(range(gr.tiles))
        # within budget: every tile fits its share (its slot and its part
        # of the group's L2 bytes) unless the group is one unit (then it
        # reads past it); its first `cap` vectors go through the slot
        assert plan.tile_cap == (plan.slot_bytes + plan.l2_bytes
                                 // plan.team_parts) // (16 * plan.tensors)
        if gr.cn > plan.unit:
            assert all(t.rows * t.w <= plan.tile_cap for t in tiles)
        assert all(t.fit == min(t.rows * t.w, plan.cap) for t in tiles)
        # each (image, row vector) of the group exactly once: per image
        # slice, the column intervals partition [0, lv)
        by_rows = {}
        for t in tiles:
            assert t.rows >= 1 and t.w >= 1
            by_rows.setdefault((t.n0, t.rows), []).append((t.v0, t.w))
        assert sorted(by_rows) == [(i * gr.th, min(gr.th, n - i * gr.th))
                                   for i in range(-(-n // gr.th))]
        for cols in by_rows.values():
            edge = 0
            for v0, w in sorted(cols):
                assert v0 == edge
                edge = v0 + w
            assert edge == gr.lv
        for t in tiles:
            lo, hi = t.v0 * vec, (t.v0 + t.w) * vec
            assert t.ch_lo == lo // hw and t.ch_lo + t.nch - 1 == (hi - 1) // hw
            assert (gr.c0 * hw + lo) % vec == 0     # spans start on vectors
    return plan


@pytest.mark.parametrize("n,c,hw,dtype,tensors,sms", PLAN_CASES)
def test_plan_covers_each_element_once_within_budget(n, c, hw, dtype, tensors,
                                                     sms):
    assert pnf.bn_bwd_plan(n, c, hw, dtype, sms, tensors) == _plan(
        n, c, hw, dtype, sms, tensors)
    for kw in ({}, SMEM_ONLY):
        plan = _check_plan(_plan(n, c, hw, dtype, sms, tensors, **kw))
        assert plan.parts == pnf.BN_BLOCKS_PER_SM * sms
        assert plan.slot_bytes == pnf.BN_SLOT_BYTES == 54656
        # the groups are the largest that fit: one unit more would not
        if plan.cg < min(c, pnf.BN_MAX_GROUP_C) and len(plan.groups) > 1:
            bigger = plan.cg + plan.unit
            th, tw = pnf.bn_tiles(n, bigger * hw // plan.vec,
                                  plan.team_parts)
            share = plan.slot_bytes + plan.l2_bytes // plan.team_parts
            assert th * tw > plan.tile_cap or bigger * n * hw \
                * (16 // plan.vec) * tensors > plan.team_parts * share


def test_plan_worked_examples():
    """The design note's groups, shared memory alone (one team, no bytes
    past the slots): layer1.bn3 2 channels (128 groups), the stem 1 (64),
    ppyoloe-l's stem 2 (16), layer4.bn3 184 (12); the route's default
    (two teams, 24 MB a group past the slots): 6 (43), 2 (32), 4 (8), 256
    (8)."""
    def cg(*a, **k):
        p = _plan(*a, **k) if k else pnf.bn_bwd_plan(*a)
        return p.cg, len(p.groups)
    for kw, want in ((SMEM_ONLY, ((2, 128), (1, 64), (2, 16), (184, 12))),
                     ({}, ((6, 43), (2, 32), (4, 8), (256, 8)))):
        assert (cg(256, 256, 3136, torch.bfloat16, 132, 3, **kw),
                cg(256, 64, 12544, torch.bfloat16, 132, 2, **kw),
                cg(8, 32, 102400, torch.float32, 132, 2, **kw),
                cg(256, 2048, 49, torch.bfloat16, 132, 3, **kw)
                ) == want


@pytest.mark.parametrize("kw", [dict(lag=2), dict(blocks_per_sm=1),
                                dict(slot_bytes=512), dict(slot_bytes=96),
                                dict(slot_bytes=0, l2_bytes=65536),
                                dict(slot_bytes=256, l2_bytes=32768),
                                dict(teams=2), dict(teams=2, l2_bytes=32768)])
def test_plan_variants_and_tiles_past_the_slot(kw):
    """Other lags, grids, slots and L2 shares (the variants script's
    copies, and budgets smaller than any copy's) keep the plan's rules; a
    slot smaller than one unit's tile makes one-unit groups whose tiles
    read past it; an L2 share makes tiles read past their slot; the
    L2-only design (no slot) puts nothing in one."""
    past = False
    for n, c, hw, dtype, tensors, sms in PLAN_CASES[-4:]:
        plan = _check_plan(_plan(n, c, hw, dtype, sms, tensors,
                                 **{**SMEM_ONLY, **kw}))
        if kw.get("slot_bytes") == 0:
            assert plan.cap == 0 and all(
                t.fit == 0 for g in plan.groups
                for t in pnf.bn_bwd_tiles(plan, g))
        past |= any(t.rows * t.w > t.fit for g in plan.groups
                    for t in pnf.bn_bwd_tiles(plan, g))
        if kw.get("slot_bytes") == 96:
            assert plan.cg == plan.unit
    if kw.get("slot_bytes") == 96 or kw.get("slot_bytes") == 256:
        assert past
    assert _slot_bytes(2, 2) == 36352
    assert _slot_bytes(1, 1) == 113024


def test_slots_fill_the_shared_memory():
    """Two slots and the scratch fill a block's share of an SM at two
    blocks an SM (the route), and at lag 2; one block an SM takes the
    largest block (kMaxSmem)."""
    assert pnf.BN_SLOT_BYTES == _slot_bytes(pnf.BN_BLOCKS_PER_SM, pnf.BN_LAG)
    for bps, lag in ((2, 1), (2, 2), (1, 1)):
        smem = (lag + 1) * _slot_bytes(bps, lag) + pnf.BN_SCRATCH
        share = pnf.BN_SMEM_PER_SM // bps - pnf.BN_BLOCK_RESERVE
        assert share - 128 * (lag + 1) < smem <= min(share, 232448)


def test_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        pnf.bn_bwd_plan(0, 8, 4, torch.float32, 132)
    with pytest.raises(ValueError):
        pnf.bn_bwd_plan(2, 12, 49, torch.bfloat16, 132)   # C not whole units
    with pytest.raises(ValueError):
        pnf.bn_bwd_plan(2, 8, 4, torch.float32, 0)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _simulate(plan, lag, seed):
    """Runs every block's program (the kernel's loop: the prologue's
    loads, then for each of its team's groups the reduction (the counter,
    the fold of its last block), the apply after the group's flag, then
    the next loads into the freed slot) with the blocks stepped in a
    random order. Returns the events. Asserts that no
    apply of a group runs before the group's flag is set, that a block
    reduces and waits for a group only after it claimed that group's
    loads, that a slot is loaded only once its last group is applied, and
    that every block ends (no deadlock)."""
    slots, teams, per = lag + 1, plan.teams, plan.team_parts
    groups = len(plan.groups)
    # block b of the grid: team b // per, place b % per; its team's groups
    active = [[j % teams == b // per and b % per < g.tiles
               for j, g in enumerate(plan.groups)] for b in range(plan.parts)]
    count = [0] * groups
    flag = [False] * groups
    claimed = [set() for _ in range(plan.parts)]
    holds = [dict() for _ in range(plan.parts)]   # slot -> group in it

    def program(b):
        mine = list(range(b // per, groups, teams))

        def claim(i):
            s = i % slots
            assert s not in holds[b], (b, mine[i], holds[b])
            if active[b][mine[i]]:
                holds[b][s] = mine[i]
            claimed[b].add(mine[i])
        for i in range(min(slots, len(mine))):
            claim(i)
            yield ("issue", mine[i])
        for i, j in enumerate(mine):
            if active[b][j]:
                assert j in claimed[b] and holds[b][i % slots] == j
                yield ("reduce", j)
                count[j] += 1
                if count[j] == plan.groups[j].tiles:
                    flag[j] = True
                    yield ("fold", j)
                while not flag[j]:
                    yield ("wait", j)
                yield ("apply", j)
                del holds[b][i % slots]
            if i + slots < len(mine):
                claim(i + slots)
                yield ("issue", mine[i + slots])

    rng = random.Random(seed)
    live = {b: program(b) for b in range(plan.parts)}
    events, spins = [], 0
    while live:
        b = rng.choice(sorted(live))
        try:
            ev = next(live[b])
        except StopIteration:
            del live[b]
            continue
        if ev[0] == "wait":
            spins += 1
            assert spins < 10 ** 6, "the blocks deadlocked"
        else:
            events.append((b, *ev))
        if ev[0] == "apply":
            assert flag[ev[1]]
    assert all(flag)
    return events


@pytest.mark.parametrize("lag,teams", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("case", [(5, 24, 49, torch.float32, 3, 3, 96),
                                  (3, 16, 20, torch.bfloat16, 2, 2, 64),
                                  (8, 64, 36, torch.float32, 2, 4, 2048)])
def test_schedule_runs_to_its_end_in_any_order(case, lag, teams):
    n, c, hw, dtype, tensors, sms, slot = case
    plan = _plan(n, c, hw, dtype, sms, tensors, slot_bytes=slot, lag=lag,
                 teams=teams, l2_bytes=0)
    assert len(plan.groups) >= teams * (lag + 1)
    for seed in range(4):
        events = _simulate(plan, lag, seed)
        folds = [e for e in events if e[1] == "fold"]
        assert sorted(e[2] for e in folds) == list(range(len(plan.groups)))
        applies = {(e[0], e[2]) for e in events if e[1] == "apply"}
        assert applies == {((j % teams) * plan.team_parts + t.block, j)
                           for j, g in enumerate(plan.groups)
                           for t in pnf.bn_bwd_tiles(plan, g)}


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _fold_order(plan, gr):
    """For each group-local channel: the tiles holding it in tile order,
    and the kernel's runs (``fold_runs``): a power of two at most 32 with 2
    cn x runs within the block's threads, 1 from 2 cn = 256 threads on."""
    rows = -(-plan.n // gr.th)
    items = 2 * gr.cn
    splits = 1
    if items < pnf.BN_THREADS:
        splits = 1 << (min(32, pnf.BN_THREADS // items).bit_length() - 1)
    order = []
    for cl in range(gr.cn):
        jlo = cl * plan.hw // plan.vec // gr.tw
        jhi = (-(-(cl + 1) * plan.hw // plan.vec) - 1) // gr.tw
        order.append([i * gr.cols + j for i in range(rows)
                      for j in range(jlo, jhi + 1)])
    return order, splits


def _emulate(x, res, w, b, mean, var, g, gmean, gvar, relu, sms, *,
             skip=None, **plan_kw):
    """The persistent kernel's (dx, dres, dw, db) under the plan of
    ``plan_kw``: dx, dres in x's dtype, dw, db f32, in the kernel's
    order."""
    n, c, hw = x.shape
    tensors = 3 if relu and res is not None else 2
    plan = _plan(n, c, hw, x.dtype, sms, tensors, **plan_kw)
    xf, gf = x.float(), g.float()
    rstd, a, bb = pnf._bn_fold(w, b, mean, var, EPS)
    if relu:
        pre = pnf._bn_pre(xf, res if tensors == 3 else None, a, bb)
        gf = torch.where(pre > 0.0, gf, 0.0)
    gx = gf * ((xf - mean[None, :, None]) * rstd[None, :, None])
    sg, sgx = torch.zeros(c), torch.zeros(c)
    for gr in plan.groups:
        rows_g = gf[:, gr.c0:gr.c0 + gr.cn].reshape(n, -1)
        rows_gx = gx[:, gr.c0:gr.c0 + gr.cn].reshape(n, -1)
        part = torch.zeros(gr.tiles, 2, gr.cn)
        for t in pnf.bn_bwd_tiles(plan, gr):
            e_lo, e_hi = t.v0 * plan.vec, (t.v0 + t.w) * plan.vec
            for cl in range(t.ch_lo, t.ch_lo + t.nch):
                lo, hi = max(cl * hw, e_lo), min((cl + 1) * hw, e_hi)
                sl = (slice(t.n0, t.n0 + t.rows), slice(lo, hi))
                part[t.block, 0, cl] = rows_g[sl].sum()
                part[t.block, 1, cl] = rows_gx[sl].sum()
        order, splits = _fold_order(plan, gr)
        for s, out in ((0, sg), (1, sgx)):
            for cl, tiles in enumerate(order):
                kn = len(tiles)
                runs = []
                for sp in range(splits):
                    run = torch.zeros((), dtype=torch.float32)
                    for tile in tiles[sp * kn // splits:(sp + 1) * kn // splits]:
                        if tile != skip:
                            run = run + part[tile, s, cl]
                    runs.append(run)
                # a warp's butterfly over the runs: lane i adds lane i ^ o
                o = splits // 2
                while o:
                    runs = [runs[i] + runs[i ^ o] for i in range(splits)]
                    o //= 2
                out[gr.c0 + cl] = runs[0]
    m = float(n * hw)
    gm = torch.zeros(c) if gmean is None else gmean.float()
    gv = torch.zeros(c) if gvar is None else gvar.float()
    k1, k2 = sg / m, sgx / m
    p2 = (2.0 * gv) / m - (a * k2) * rstd
    p3 = (gm / m - a * k1) - mean * p2
    dx = (gf * a[None, :, None] + xf * p2[None, :, None]) + p3[None, :, None]
    dres = None if res is None else gf.to(x.dtype)
    return dx.to(x.dtype), dres, sgx, sg


def _arrays(seed, n, c, hw, g_mean=0.1):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    # x with per-channel offsets, the residual, w, b, g with a mean (so
    # that a partial left out shows), the mean and var cotangents
    return dict(x=r(n, c, hw) + r(1, c, 1, s=0.5), res=r(n, c, hw),
                w=r(c, s=0.2, m=1.0), b=r(c, s=0.2),
                g=r(n, c, hw, m=g_mean), gmean=r(c), gvar=r(c))


@functools.lru_cache(maxsize=None)
def _forward(n, c, hw, dtype, relu, has_res, seed):
    """The reference's forward statistics and the pullback of its Pallas
    kernels in interpret mode."""
    a = _arrays(seed, n, c, hw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = jnp.asarray(a["x"]).astype(jdt)
    res = jnp.asarray(a["res"]).astype(jdt) if has_res else None

    def fn(x, res, w, b):
        return jnf.fused_batch_norm_train(x, w, b, residual=res, eps=EPS,
                                          fuse_relu=relu, block_c=8,
                                          interpret=True)

    (_, mean, var), vjp = jax.vjp(fn, x, res, jnp.asarray(a["w"]),
                                  jnp.asarray(a["b"]))
    return a, np.array(mean), np.array(var), vjp, jdt


@functools.lru_cache(maxsize=None)
def _reference(case, with_stats):
    """(dx, dres, dw, db) of the reference's Pallas backward, f32 numpy,
    with the mean and var cotangents or with zeros for them."""
    n, c, hw, dtype, relu, has_res, _, _, seed = CASES[case]
    a, _, _, vjp, jdt = _forward(n, c, hw, dtype, relu, has_res, seed)
    cot = ((jnp.asarray(a["gmean"]), jnp.asarray(a["gvar"])) if with_stats
           else (jnp.zeros(c), jnp.zeros(c)))
    dx, dres, dw, db = vjp((jnp.asarray(a["g"]).astype(jdt), *cot))
    return tuple(None if t is None else np.array(jnp.asarray(t, jnp.float32))
                 for t in (dx, dres, dw, db))


def _inputs(case, with_stats):
    n, c, hw, dtype, relu, has_res, sms, _, seed = CASES[case]
    a, mean, var, _, _ = _forward(n, c, hw, dtype, relu, has_res, seed)
    t = torch.from_numpy
    args = (t(a["x"]).to(dtype), t(a["res"]).to(dtype) if has_res else None,
            t(a["w"]), t(a["b"]), t(mean), t(var), t(a["g"]).to(dtype),
            t(a["gmean"]) if with_stats else None,
            t(a["gvar"]) if with_stats else None, relu, sms)
    return args, _reference(case, with_stats)


def _reading(got, ref):
    got = got.float().numpy()
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


# (N, C, HW, dtype, relu, residual, SMs, the plan's keywords, seed): the
# four epilogues, each dtype, HW a whole number of vectors, 49, 20 (bf16
# planes starting mid-vector, as at 196) and 1; one team and two; slots
# that make several groups, tiles that read past their slot, groups with
# bytes past the slots, the route's default plan
SMEM = dict(l2_bytes=0, teams=1)
CASES = [
    (4, 16, 64, torch.float32, False, False, 2, dict(SMEM, slot_bytes=512), 1),
    (3, 16, 49, torch.bfloat16, True, False, 3, {}, 2),
    (6, 16, 1, torch.float32, True, False, 1,
     dict(slot_bytes=64, l2_bytes=0, teams=2), 3),
    (3, 16, 20, torch.bfloat16, False, True, 2,
     dict(slot_bytes=96, l2_bytes=0, teams=2), 4),
    (4, 24, 49, torch.float32, True, True, 3,
     dict(slot_bytes=256, l2_bytes=1536, teams=1), 5),
    (3, 16, 64, torch.bfloat16, True, True, 2, dict(SMEM, slot_bytes=144), 6),
]
CASE_IDS = ["none-f32-hw64", "relu-bf16-hw49", "relu-f32-hw1",
            "res-bf16-hw20", "res_relu-f32-hw49", "res_relu-bf16-hw64"]
# every case with the mean and var cotangents; one per epilogue without
RUNS = [(i, True) for i in range(len(CASES))] + [
    (i, False) for i in (0, 1, 3, 4)]


@pytest.mark.parametrize(
    "case,with_stats", RUNS,
    ids=[f"{CASE_IDS[i]}-{'stats' if s else 'nostats'}" for i, s in RUNS])
def test_emulation_matches_pallas_backward(case, with_stats):
    args, (jdx, jdres, jdw, jdb) = _inputs(case, with_stats)
    dtype, plan_kw = CASES[case][3], CASES[case][7]
    dx, dres, dw, db = _emulate(*args, **plan_kw)
    assert (dres is None) == (jdres is None)
    for got, ref, tol in ((dx, jdx, BN_TOL[dtype]), (dres, jdres, BN_TOL[dtype]),
                          (dw, jdw, BN_STAT_TOL), (db, jdb, BN_STAT_TOL)):
        if got is not None:
            assert _reading(got, ref) <= tol


@pytest.mark.parametrize("case", [0, 5], ids=["f32", "bf16"])
def test_tolerance_rejects_a_dropped_partial(case):
    """Every fold leaving out one tile's partial: dw and db fail
    BN_STAT_TOL, and dx fails the rows' tolerance, for each tile."""
    args, (jdx, _, jdw, jdb) = _inputs(case, True)
    n, c, hw, dtype = CASES[case][:4]
    plan = _plan(n, c, hw, dtype, args[-1], 3 if CASES[case][4] and
                 CASES[case][5] else 2, **CASES[case][7])
    tiles = max(g.tiles for g in plan.groups)
    assert tiles > 1
    for skip in range(tiles):
        dx, _, dw, db = _emulate(*args, skip=skip, **CASES[case][7])
        assert _reading(dw, jdw) > BN_STAT_TOL, skip
        assert _reading(db, jdb) > BN_STAT_TOL, skip
        assert _reading(dx, jdx) > BN_TOL[dtype], skip


def test_cpu_op_counts_no_route():
    a = _arrays(9, 2, 8, 16)
    x, res, w, b, g = (torch.from_numpy(a[k]) for k in ("x", "res", "w", "b",
                                                        "g"))
    before = dict(pnf.bn_bwd_routes), dict(pnf.launches)
    _, mean, var = pnf.fused_bn_fwd(x, res, w, b, EPS, True)
    pnf.fused_bn_bwd(x, res, w, b, mean, var, g, None, None, EPS, True)
    assert (dict(pnf.bn_bwd_routes), dict(pnf.launches)) == before


class _FakeLib:
    def fused_bn_parts(self, n, hw):
        return 3


@pytest.mark.parametrize("route", ["persistent", "generic"])
@pytest.mark.parametrize("relu,has_res,sms", [(True, True, 132),
                                              (True, False, 132),
                                              (False, True, 5)])
def test_wrapper_sizes_one_scratch_from_the_plan(monkeypatch, route, relu,
                                                 has_res, sms):
    """One f32 scratch on the persistent route, sized from the plan the
    kernel reckons (coefficients, dw, db, partials, counters), dw and db
    its rows 4C and 5C; the generic route's three workspaces; each call
    counted once under its route; bf16 weight and bias passed as they
    come (vbf16 1), the persistent kernel then writing dw and db to bf16
    tensors of their own."""
    n, c, hw = 4, 16, 49
    calls, made = [], []
    monkeypatch.setattr(pnf, "launches", dict(pnf.launches))
    monkeypatch.setattr(pnf, "bn_bwd_routes", dict(pnf.bn_bwd_routes))
    monkeypatch.setattr(pnf, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(pnf, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(pnf._build, "call",
                        lambda lib, name, dtype, dev, *args:
                        calls.append((name, args)))
    real_empty = torch.empty
    monkeypatch.setattr(pnf.torch, "empty",
                        lambda *a, **k: made.append(real_empty(*a, **k))
                        or made[-1])
    x = torch.zeros(n, c, hw, dtype=torch.bfloat16)
    vec = torch.ones(c)
    _, _, dw, db = pnf._bn_bwd_cuda(x, x.clone() if has_res else None, vec,
                                    vec, vec, vec, x, None, None, EPS, relu,
                                    route=route)
    (name, args), = calls
    if route == "persistent":
        plan = pnf.bn_bwd_plan(n, c, hw, x.dtype, sms,
                               3 if relu and has_res else 2)
        scratch, = made
        assert name == "fused_bn_bwd_persist"
        assert scratch.numel() == pnf.bn_bwd_scratch_floats(plan) \
            == 6 * c + 2 * plan.parts * c + 2 * len(plan.groups)
        assert args[11] == scratch.data_ptr()
        assert args[12:14] == (None, None)      # f32 w and b: no bf16 dw, db
        assert args[14:] == (n, c, hw, EPS, int(relu), -1, 0)
        assert dw.data_ptr() == scratch[4 * c:].data_ptr()
        assert db.data_ptr() == scratch[5 * c:].data_ptr()
    else:
        assert name == "fused_bn_bwd" and len(made) == 3
        assert made[1].shape == (3, 2, c)
        assert args[-1] == 0
    assert pnf.bn_bwd_routes[route] == 1 and pnf.launches["fused_bn_bwd"] == 1
    v16 = vec.bfloat16()
    pnf._bn_bwd_cuda(x, x.clone() if has_res else None, v16, v16, vec, vec,
                     x, None, None, EPS, relu, route=route)
    assert calls[-1][1][2:4] == (v16.data_ptr(), v16.data_ptr())
    assert calls[-1][1][-1] == 1
    if route == "persistent":
        # the kernel rounds dw and db into bf16 tensors of their own
        _, _, dw16, db16 = pnf._bn_bwd_cuda(
            x, None, v16, v16, vec, vec, x, None, None, EPS, relu,
            route=route)
        assert dw16.dtype == db16.dtype == torch.bfloat16
        assert calls[-1][1][12:14] == (dw16.data_ptr(), db16.data_ptr())


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_ctypes_signature_matches_the_cuda_source():
    src = SRC.read_text()
    m = re.search(r"int fused_bn_bwd_persist_##SUFFIX\(([^)]*)\)", src)
    assert m is not None
    assert _kinds(m.group(1).replace("\\", "")) == pnf._ARGTYPES[
        "fused_bn_bwd_persist"]
    assert "FUSED_BN_BWD_PERSIST(f32, float)" in src
    assert "FUSED_BN_BWD_PERSIST(bf16, __nv_bfloat16)" in src
    m = re.search(r"int fused_bn_bwd_plan\(([^)]*)\)", src)
    assert _kinds(m.group(1).replace("\n", " ")) == [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    body = src[src.index("namespace bnb {"):]
    for name, value in (("kThreads", pnf.BN_THREADS),
                        ("kSmemPerSm", pnf.BN_SMEM_PER_SM),
                        ("kBlockReserve", pnf.BN_BLOCK_RESERVE),
                        ("kScratch", pnf.BN_SCRATCH),
                        ("kMaxGroupC", pnf.BN_MAX_GROUP_C),
                        ("kMinSpan", pnf.BN_MIN_SPAN),
                        ("kBlocksPerSm", pnf.BN_BLOCKS_PER_SM),
                        ("kTeams", pnf.BN_TEAMS),
                        ("kLag", pnf.BN_LAG),
                        ("kL2Bytes", pnf.BN_L2_BYTES)):
        assert re.search(rf"constexpr int {name} = {value};", body), name
    # the route holds slots (the L2-only design is a copy's)
    assert "constexpr bool kL2Only = false;" in body
    # one instantiation a dtype: the kernel takes no design parameter
    assert re.search(r"template <typename T>\n__global__ void "
                     r"__launch_bounds__\(kThreads, kBlocksPerSm\) "
                     r"bn_bwd_persist\(Args p\)", body)
    # the kernel's shared-memory scratch fits kScratch: red [2, 256] and
    # the coefficients [4, 256] f32, three mbarriers, a flag
    assert 4 * (2 * 256 + 4 * 256) + 8 * 3 + 4 <= pnf.BN_SCRATCH


def test_persistent_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library both routes raise, and a route
    that is not one is refused."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pnf._lib.cache_clear()
    before = dict(pnf.bn_bwd_routes), dict(pnf.launches)
    try:
        x = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
        v = torch.ones(8)
        for route in (None, "generic"):
            with pytest.raises(RuntimeError, match="nvcc"):
                pnf._bn_bwd_cuda(x, x, v, v, v, v, x, None, None, EPS, True,
                                 route=route)
        with pytest.raises(ValueError, match="route"):
            pnf._bn_bwd_cuda(x, x, v, v, v, v, x, None, None, EPS, True,
                             route="fast")
    finally:
        pnf._lib.cache_clear()
    assert (dict(pnf.bn_bwd_routes), dict(pnf.launches)) == before
