"""The BatchNorm forward's cluster route (TPU kernels 15 and 16 on
Hopper), reckoned on the CPU.

``bn_fwd_route`` sends every call the op takes (float32 or bfloat16, C %
8 == 0, C <= 65535) to the cluster kernel and refuses the rest, as the
wrapper refuses tensors that are not contiguous and 16-byte aligned:
nothing falls back to the generic kernels. ``bn_fwd_plan`` is the
kernel's plan: slabs of cg whole channels whose rows are whole 16-byte
vectors, cut over a cluster of K CTAs by image and by row vector, each
tile's first ``cap`` vectors resident in shared memory and the rest read
twice; ``_bnf_plan`` reckons it under the designs that
scripts/bn_fwd_variants.py compiles. An emulation of the kernel's order
-- each CTA's partial sums per channel, the K partials added in rank
order, the fold's f32 expressions, the apply from each tile's
coefficients -- is held against the reference's Pallas forward in
interpret mode (``paddle_tpu.kernels.norm_fusion.fused_batch_norm_train``)
in all four epilogues, f32 and bf16 I/O, at HW a whole number of
vectors, HW 49, HW 20 (a bf16 plane that starts mid-vector like HW 196)
and HW 1, with clusters of one to eight CTAs cut by image and by row.

Tolerances, phase 27's (``BN_TOL``, ``BN_STAT_TOL`` in chip_smoke.py), of
each output's largest magnitude: y 1e-5 in f32 (the same f32 arithmetic
in another summation order) and 2^-7 in bf16 (both round the same f32
values to bf16; one near a rounding boundary may round the other way);
mean and var 1e-5 (f32 sums). Each is shown to reject the emulation with
rank 0's fold leaving out the last rank's partial.
"""
import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

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
# the route's design: (CTAs an SM's shared memory is cut for, K at most,
# vectors a chunk and a ring stage, ring stages, the residual in the ring)
ROUTE = (pnf.BNF_CTAS_PER_SM, pnf.BNF_MAX_CLUSTER, pnf.BNF_STAGE_VECS,
         pnf.BNF_RING, pnf.BNF_RES_RING)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 256), (torch.float32, 32),
                                     (torch.bfloat16, 8),
                                     (torch.float32, 65528)])
def test_route_takes_every_call_the_op_takes(dtype, c):
    assert pnf.bn_fwd_route(dtype, c) == "cluster"


@pytest.mark.parametrize("dtype,c,error", [
    (torch.float16, 64, TypeError),
    (torch.bfloat16, 12, ValueError),
    (torch.float32, 65536, ValueError)])
def test_route_refuses_what_the_op_refuses(dtype, c, error):
    """No "generic" answer: the old kernels are never a route's fallback."""
    with pytest.raises(error):
        pnf.bn_fwd_route(dtype, c)


@pytest.mark.parametrize("which", ["x", "res"])
@pytest.mark.parametrize("layout", ["misaligned", "strided"])
def test_wrapper_refuses_misaligned_or_strided_rows(monkeypatch, which,
                                                    layout):
    """The bulk copies need contiguous rows on 16-byte boundaries: the
    wrapper refuses anything else before any launch."""
    monkeypatch.setattr(pnf, "_lib", lambda: pytest.fail("launched"))
    n, c, hw = 2, 8, 16
    rows = {k: torch.zeros(n, c, hw, dtype=torch.bfloat16)
            for k in ("x", "res")}
    if layout == "misaligned":
        rows[which] = torch.zeros(n * c * hw + 1,
                                  dtype=torch.bfloat16)[1:].view(n, c, hw)
    else:
        rows[which] = torch.zeros(n, hw, c,
                                  dtype=torch.bfloat16).transpose(1, 2)
    v = torch.ones(c)
    with pytest.raises(ValueError, match="16-byte"):
        pnf._bn_fwd_cuda(rows["x"], rows["res"], v, v, EPS, True)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (N, C, HW, dtype, residual, SMs): resnet50's stem, layer1.bn3, layer2's
# HW 784, layer3.bn2 (HW 196), layer4.bn3 (HW 49), a downsample BN, a
# BatchNorm1D, ppyoloe-l's stem and two of its smaller maps, on an H100;
# then small and ragged shapes
PLAN_CASES = [
    (256, 64, 12544, torch.bfloat16, False, 132),
    (256, 256, 3136, torch.bfloat16, True, 132),
    (256, 512, 784, torch.bfloat16, True, 132),
    (256, 256, 196, torch.bfloat16, False, 132),
    (256, 2048, 49, torch.bfloat16, True, 132),
    (256, 256, 3136, torch.bfloat16, False, 132),
    (256, 512, 1, torch.bfloat16, True, 132),
    (8, 32, 102400, torch.float32, False, 132),
    (8, 128, 6400, torch.float32, False, 132),
    (8, 512, 400, torch.float32, False, 132),
    (5, 24, 49, torch.float32, True, 3),
    (3, 16, 20, torch.bfloat16, False, 1),
    (7, 8, 1, torch.bfloat16, True, 2),
]
# other designs the variants script compiles, and the first design timed
# (chunks of 512 vectors, the residual through the ring, clusters of 8)
DESIGNS = [ROUTE, (1, 8, 2048, 3, False), (1, 16, 2048, 2, False),
           (1, 16, 2048, 4, False), (1, 16, 4096, 2, False),
           (1, 8, 512, 3, True), (2, 16, 512, 3, True)]


def _plan(n, c, hw, dtype, res, sms, design=ROUTE, **kw):
    return pnf._bnf_plan(n, c, hw, dtype, bool(res), sms, *design, **kw)


def _check_plan(plan, max_cluster=pnf.BNF_MAX_CLUSTER):
    n, c, hw, vec = plan.n, plan.c, plan.hw, plan.vec
    # slabs of whole channels; every image's slab row whole vectors on a
    # 16-byte boundary (c0 a multiple of cg, C HW whole vectors)
    assert plan.cg % plan.unit == 0 and c % plan.cg == 0
    assert plan.cg <= pnf.BNF_MAX_C and plan.slabs * plan.cg == c
    assert plan.cg * hw % vec == 0 and c * hw % vec == 0
    assert plan.rowv * vec == plan.cg * hw
    # a cluster the card takes; shared memory within a block's
    assert 1 <= plan.k <= max_cluster and plan.k == plan.ns * plan.cs
    assert plan.smem <= pnf.MAX_SMEM
    tiles = pnf.bn_fwd_tiles(plan)
    assert [t.rank for t in tiles] == list(range(plan.k))
    # each element of each channel of a slab exactly once
    seen = np.zeros((n, plan.cg * hw), np.int32)
    for t in tiles:
        assert t.rows >= 1 and t.w >= 1 and t.rows * t.w <= plan.tv
        e_lo, e_hi = t.v0 * vec, (t.v0 + t.w) * vec
        for cl in range(plan.cg):
            lo, hi = max(cl * hw, e_lo), min((cl + 1) * hw, e_hi)
            held = t.ch_lo <= cl < t.ch_lo + t.nch
            assert held == (lo < hi), (t, cl)
            if held:
                seen[t.n0:t.n0 + t.rows, lo:hi] += 1
    assert (seen == 1).all()
    # resident and re-read vectors make up the whole slab; a tile that
    # does not fit keeps whole chunks and streams the rest
    assert sum(t.fit + (t.rows * t.w - t.fit) for t in tiles) \
        == n * plan.rowv
    for t in tiles:
        if t.fit < t.rows * t.w:
            assert t.fit == plan.cap and plan.cap % plan.stage == 0
            assert plan.ring_t == (2 if plan.res else 1)
    assert plan.ring_t == 0 or plan.res or plan.cap < plan.tv
    return plan


@pytest.mark.parametrize("design", DESIGNS,
                         ids=lambda d: "-".join(map(str, d)))
@pytest.mark.parametrize("n,c,hw,dtype,res,sms", PLAN_CASES)
def test_plan_covers_each_element_once_within_budget(n, c, hw, dtype, res,
                                                     sms, design):
    plan = _check_plan(_plan(n, c, hw, dtype, res, sms, design),
                       max_cluster=design[1])
    if design == ROUTE:
        assert pnf.bn_fwd_plan(n, c, hw, dtype, res, sms) == plan
    nbytes = pnf.bn_fwd_bytes(plan)
    assert nbytes["y_written"] == n * c * hw * (16 // plan.vec)
    assert nbytes["x_once"] <= nbytes["y_written"] <= nbytes["x_read"] \
        == 2 * nbytes["y_written"] - nbytes["x_once"]


def test_plan_worked_examples():
    """The design note's plans at resnet50's five HWs and ppyoloe-l's stem
    on an H100's 132 SMs: (cg, K, ns, cs, resident vectors, largest tile,
    ring tensors, shared memory, threads); every slab held but the resnet50
    stem's, which re-reads through the ring what does not fit."""
    def key(*a, design=ROUTE):
        p = _plan(*a, 132, design)
        return p.cg, p.k, p.ns, p.cs, p.cap, p.tv, p.ring_t, p.smem, p.threads
    bf, f32 = torch.bfloat16, torch.float32
    assert key(256, 64, 12544, bf, False) == (1, 16, 16, 1, 6144, 25088, 1,
                                              202880, 512)
    assert key(256, 256, 3136, bf, True) == (1, 8, 8, 1, 12544, 12544, 0,
                                             206976, 512)
    assert key(256, 256, 784, bf, False) == (1, 2, 2, 1, 12544, 12544, 0,
                                             206976, 512)
    assert key(256, 256, 196, bf, False) == (2, 2, 2, 1, 6272, 6272, 0,
                                             106624, 256)
    assert key(256, 2048, 49, bf, True) == (8, 1, 1, 1, 12544, 12544, 0,
                                            206976, 512)
    # clusters of 16 hold ppyoloe-l's stem whole (two CTAs an image); 8
    # hold a quarter of it
    assert key(8, 32, 102400, f32, False) == (1, 16, 8, 2, 12800, 12800, 0,
                                              211072, 512)
    k8 = (1, 8, 2048, 3, False)
    assert key(8, 32, 102400, f32, False, design=k8) == (
        1, 8, 8, 1, 6144, 25600, 1, 202880, 512)
    # x read once at every shape but the resnet50 stem: 1.76x its size (at
    # clusters of 8: 1.88x, and ppyoloe-l's stem 1.76x)
    for a, design, want in (((256, 64, 12544, bf, False), ROUTE, 1.755),
                            ((256, 64, 12544, bf, False), k8, 1.878),
                            ((8, 32, 102400, f32, False), k8, 1.76),
                            ((8, 32, 102400, f32, False), ROUTE, 1.0),
                            ((256, 256, 3136, bf, True), ROUTE, 1.0),
                            ((256, 2048, 49, bf, True), ROUTE, 1.0)):
        b = pnf.bn_fwd_bytes(_plan(*a, 132, design))
        assert b["x_read"] / b["y_written"] == pytest.approx(want, abs=5e-3)


def test_residual_ring_refuses_a_tile_that_does_not_fit():
    """With the residual through the ring, clusters of 8 cannot hold
    layer1.bn3's slab, and the ring beside x past the resident part leaves
    no whole chunk of 2048 vectors: that design holds no plan there;
    clusters of 16 hold it in 13 CTAs. The route takes the residual into
    registers: 8 CTAs, no ring."""
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="resident"):
        _plan(256, 256, 3136, bf, True, 132, (1, 8, 2048, 3, True))
    held = _plan(256, 256, 3136, bf, True, 132, (1, 16, 2048, 3, True))
    assert (held.k, held.cap == held.tv, held.ring_t) == (13, True, 1)
    route = _plan(256, 256, 3136, bf, True, 132)
    assert (route.k, route.ring_t) == (8, 0)


def test_plan_raises_k_for_a_card_with_idle_sms():
    """Fewer slabs than SMs: K rises (never below kMinCtaVecs vectors a
    CTA); layer3.bn2's 128 slabs take two CTAs each on 132 SMs, one on 64."""
    bf = torch.bfloat16
    assert _plan(256, 256, 196, bf, False, 132).k == 2
    assert _plan(256, 256, 196, bf, False, 64).k == 1
    small = _plan(4, 8, 64, torch.float32, False, 132)
    assert small.k == 1                              # 64 vectors: too few
    cut = _plan(4, 8, 64, torch.float32, False, 132, min_cta_vecs=1,
                min_slab=1)                          # 8 slabs, 132 SMs
    assert (cut.k, cut.ns, cut.cs) == (16, 4, 4)    # a quarter image each


def test_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        pnf.bn_fwd_plan(0, 8, 4, torch.float32, False, 132)
    with pytest.raises(ValueError):
        pnf.bn_fwd_plan(2, 12, 49, torch.bfloat16, False, 132)
    with pytest.raises(ValueError):
        pnf.bn_fwd_plan(2, 8, 4, torch.float32, False, 0)


def test_scratch_fits_the_partials_and_barriers():
    """kScratch: the partials, the warps' sums and the coefficients [2,
    256] f32 each, an mbarrier a chunk of the largest resident part and a
    ring stage."""
    assert pnf.BNF_SCRATCH == 6272
    assert pnf.BNF_MAX_CHUNKS * pnf.BNF_STAGE_VECS * 16 >= pnf.MAX_SMEM
    assert 6 * 256 * 4 + 8 * (pnf.BNF_MAX_CHUNKS + pnf.BNF_RING) \
        <= pnf.BNF_SCRATCH


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _emulate(x, res, w, b, relu, plan, *, skip=False):
    """The cluster kernel's (y, mean, var) in its order: each CTA's sums
    of x and x^2 per channel over its tile (f32), the K partials added in
    rank order by every CTA (rank 0 leaving out the last rank's with
    ``skip``), mean and var from rank 0's fold, y of each tile from its
    own CTA's coefficients."""
    n, c, hw = x.shape
    vec, cg = plan.vec, plan.cg
    xf = x.float()
    inv_m = torch.tensor(np.float32(1.0 / (n * hw)))
    mean, var = torch.empty(c), torch.empty(c)
    y = torch.empty(n, c, hw)
    tiles = pnf.bn_fwd_tiles(plan)
    for s in range(plan.slabs):
        c0 = s * cg
        rows = xf[:, c0:c0 + cg].reshape(n, cg * hw)
        pre_rows = torch.empty(n, cg * hw)
        part = torch.zeros(plan.k, 2, cg)
        for t in tiles:
            e_lo, e_hi = t.v0 * vec, (t.v0 + t.w) * vec
            for cl in range(t.ch_lo, t.ch_lo + t.nch):
                lo, hi = max(cl * hw, e_lo), min((cl + 1) * hw, e_hi)
                seg = rows[t.n0:t.n0 + t.rows, lo:hi]
                part[t.rank, 0, cl] = seg.sum()
                part[t.rank, 1, cl] = (seg * seg).sum()

        def fold(ranks):
            s1, s2 = torch.zeros(cg), torch.zeros(cg)
            for r in range(ranks):
                s1, s2 = s1 + part[r, 0], s2 + part[r, 1]
            m = s1 * inv_m
            return m, (s2 * inv_m - m * m).clamp_min(0.0)

        good = fold(plan.k)
        bad = fold(plan.k - 1) if skip else good
        mean[c0:c0 + cg], var[c0:c0 + cg] = bad
        for t in tiles:
            m, v = bad if t.rank == 0 else good
            _, a, bb = pnf._bn_fold(w[c0:c0 + cg], b[c0:c0 + cg], m, v, EPS)
            e_lo, e_hi = t.v0 * vec, (t.v0 + t.w) * vec
            for cl in range(t.ch_lo, t.ch_lo + t.nch):
                lo, hi = max(cl * hw, e_lo), min((cl + 1) * hw, e_hi)
                sl = (slice(t.n0, t.n0 + t.rows), slice(lo, hi))
                pre_rows[sl] = rows[sl] * a[cl] + bb[cl]
        pre = pre_rows.reshape(n, cg, hw)
        if res is not None:
            pre = pre + res[:, c0:c0 + cg].float()
        y[:, c0:c0 + cg] = pre.clamp_min(0.0) if relu else pre
    return y.to(x.dtype), mean, var


def _arrays(seed, n, c, hw):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    # x with per-channel and per-(image, channel) offsets (so that a
    # partial left out shows), the residual, w, b
    return dict(x=r(n, c, hw) + r(1, c, 1, s=0.5) + r(n, c, 1, s=0.5),
                res=r(n, c, hw), w=r(c, s=0.2, m=1.0), b=r(c, s=0.2))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's Pallas forward in interpret mode: (y f32, mean,
    var) as numpy."""
    n, c, hw, dtype, relu, has_res, _, _, seed = CASES[case]
    a = _arrays(seed, n, c, hw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    y, mean, var = jnf.fused_batch_norm_train(
        jnp.asarray(a["x"]).astype(jdt), jnp.asarray(a["w"]),
        jnp.asarray(a["b"]),
        residual=jnp.asarray(a["res"]).astype(jdt) if has_res else None,
        eps=EPS, fuse_relu=relu, block_c=8, interpret=True)
    return tuple(np.array(jnp.asarray(t, jnp.float32))
                 for t in (y, mean, var))


def _case(case):
    n, c, hw, dtype, relu, has_res, sms, kw, seed = CASES[case]
    a = _arrays(seed, n, c, hw)
    t = torch.from_numpy
    plan = _plan(n, c, hw, dtype, has_res, sms, **kw)
    args = (t(a["x"]).to(dtype), t(a["res"]).to(dtype) if has_res else None,
            t(a["w"]), t(a["b"]), relu, plan)
    return args, _reference(case)


def _reading(got, ref):
    got = got.float().numpy()
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


# (N, C, HW, dtype, relu, residual, SMs, the plan's keywords, seed): the
# four epilogues, each dtype, HW a whole number of vectors, 49, 20 (bf16
# planes starting mid-vector, as at 196) and 1; clusters cut by image
# only, by image and by row (N < K), one CTA; slabs of one channel and of
# several
SMALL = dict(min_slab=1, min_cta_vecs=1)
CASES = [
    (4, 16, 64, torch.float32, False, False, 128, SMALL, 1),
    (3, 16, 49, torch.bfloat16, True, False, 64, SMALL, 2),
    (6, 16, 1, torch.float32, True, False, 64, SMALL, 3),
    (3, 16, 20, torch.bfloat16, False, True, 64, SMALL, 4),
    (5, 24, 49, torch.float32, True, True, 64, SMALL, 5),
    (3, 16, 64, torch.bfloat16, True, True, 64, SMALL, 6),
    (9, 8, 36, torch.float32, True, True, 1, {}, 7),
]
CASE_IDS = ["none-f32-hw64", "relu-bf16-hw49", "relu-f32-hw1",
            "res-bf16-hw20", "res_relu-f32-hw49", "res_relu-bf16-hw64",
            "res_relu-f32-one_cta"]


def test_emulated_cases_cut_clusters_every_way():
    ks = [_plan(*CASES[i][:4], CASES[i][5], CASES[i][6], **CASES[i][7])
          for i in range(len(CASES))]
    assert any(p.cs > 1 for p in ks) and any(p.ns > 1 and p.cs == 1
                                             for p in ks)
    assert any(p.k == 1 for p in ks) and any(p.cg > p.unit for p in ks)
    assert max(p.k for p in ks) >= 8


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_emulation_matches_pallas_forward(case):
    args, (jy, jmean, jvar) = _case(case)
    dtype = CASES[case][3]
    y, mean, var = _emulate(*args)
    assert y.dtype == dtype
    assert _reading(y, jy) <= BN_TOL[dtype]
    assert _reading(mean, jmean) <= BN_STAT_TOL
    assert _reading(var, jvar) <= BN_STAT_TOL


@pytest.mark.parametrize("case", [0, 5], ids=["f32", "bf16"])
def test_tolerance_rejects_a_dropped_partial(case):
    """Rank 0 leaving out the last rank's partial: mean and var (which
    rank 0 writes) fail BN_STAT_TOL, y (rank 0's tile) the rows'."""
    args, (jy, jmean, jvar) = _case(case)
    assert args[-1].k > 1
    y, mean, var = _emulate(*args, skip=True)
    assert _reading(mean, jmean) > BN_STAT_TOL
    assert _reading(var, jvar) > BN_STAT_TOL
    assert _reading(y, jy) > BN_TOL[CASES[case][3]]


def test_cpu_op_counts_no_route():
    a = _arrays(9, 2, 8, 16)
    x, res, w, b = (torch.from_numpy(a[k]) for k in ("x", "res", "w", "b"))
    before = dict(pnf.bn_fwd_routes), dict(pnf.launches)
    pnf.fused_bn_fwd(x, res, w, b, EPS, True)
    assert (dict(pnf.bn_fwd_routes), dict(pnf.launches)) == before


class _FakeLib:
    def fused_bn_parts(self, n, hw):
        return 3


@pytest.mark.parametrize("route", ["cluster", "generic"])
@pytest.mark.parametrize("relu,has_res", [(True, True), (False, False)])
def test_wrapper_passes_the_kernels_their_arguments(monkeypatch, route, relu,
                                                    has_res):
    """The cluster route: one call, no workspace, the planted fault off;
    the generic route: its two workspaces; each call counted once under
    its route; the weight and bias passed as they come, f32 (vbf16 0) or
    bf16 (vbf16 1: no conversion launch)."""
    n, c, hw = 4, 16, 49
    calls, made = [], []
    monkeypatch.setattr(pnf, "launches", dict(pnf.launches))
    monkeypatch.setattr(pnf, "bn_fwd_routes", dict(pnf.bn_fwd_routes))
    monkeypatch.setattr(pnf, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(pnf._build, "call",
                        lambda lib, name, dtype, dev, *args:
                        calls.append((name, args)))
    real_empty = torch.empty
    monkeypatch.setattr(pnf.torch, "empty",
                        lambda *a, **k: made.append(real_empty(*a, **k))
                        or made[-1])
    x = torch.zeros(n, c, hw, dtype=torch.bfloat16)
    res = x.clone() if has_res else None
    vec = torch.ones(c)
    y, mean, var = pnf._bn_fwd_cuda(x, res, vec, vec, EPS, relu, route=route)
    (name, args), = calls
    head = (x.data_ptr(), None if res is None else res.data_ptr())
    assert args[:2] == head and args[4:7] == (y.data_ptr(), mean.data_ptr(),
                                              var.data_ptr())
    if route == "cluster":
        assert name == "fused_bn_fwd_cluster" and len(made) == 1   # mean
        assert args[7:] == (n, c, hw, EPS, int(relu), 0, 0)
    else:
        assert name == "fused_bn_fwd" and len(made) == 3
        assert made[1].shape == (3, 2, c) and made[2].shape == (2, c)
        assert args[7:9] == (made[1].data_ptr(), made[2].data_ptr())
        assert args[9:] == (n, c, hw, EPS, int(relu), 0)
    assert pnf.bn_fwd_routes[route] == 1 and pnf.launches["fused_bn_fwd"] == 1
    v16 = vec.bfloat16()
    pnf._bn_fwd_cuda(x, res, v16, v16, EPS, relu, route=route)
    assert calls[-1][1][2:4] == (v16.data_ptr(), v16.data_ptr())
    assert calls[-1][1][-1] == 1
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        pnf._bn_fwd_cuda(x, res, vec, v16, EPS, relu, route=route)
    with pytest.raises(ValueError, match="route"):
        pnf._bn_fwd_cuda(x, res, vec, vec, EPS, relu, route="fast")


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_ctypes_signature_matches_the_cuda_source():
    src = SRC.read_text()
    m = re.search(r"int fused_bn_fwd_cluster_##SUFFIX\(([^)]*)\)", src)
    assert m is not None
    assert _kinds(m.group(1).replace("\\", "")) == pnf._ARGTYPES[
        "fused_bn_fwd_cluster"]
    assert "FUSED_BN_FWD_CLUSTER(f32, float)" in src
    assert "FUSED_BN_FWD_CLUSTER(bf16, __nv_bfloat16)" in src
    m = re.search(r"int fused_bn_fwd_clusters_##SUFFIX\(([^)]*)\)", src)
    assert _kinds(m.group(1)) == [ctypes.c_int] * 4 + [ctypes.c_void_p]
    m = re.search(r"int fused_bn_fwd_plan\(([^)]*)\)", src)
    assert _kinds(m.group(1).replace("\n", " ")) == [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    body = src[src.index("namespace bnf {"):]
    for name, value in (("kMaxThreads", pnf.BNF_MAX_THREADS),
                        ("kSmallThreads", pnf.BNF_SMALL_THREADS),
                        ("kParPerSm", pnf.BNF_PAR_PER_SM),
                        ("kSteps", 4),
                        ("kMaxC", pnf.BNF_MAX_C),
                        ("kMinSlab", pnf.BNF_MIN_SLAB),
                        ("kMinCtaVecs", pnf.BNF_MIN_CTA_VECS),
                        ("kCtasPerSm", pnf.BNF_CTAS_PER_SM),
                        ("kMaxCluster", pnf.BNF_MAX_CLUSTER),
                        ("kStageVecs", pnf.BNF_STAGE_VECS),
                        ("kRing", pnf.BNF_RING),
                        ("kSmemPerSm", 233472),
                        ("kBlockReserve", 1024)):
        assert re.search(rf"constexpr int {name} = {value};", body), name
    # the route: register stores, one slab a cluster
    assert "constexpr bool kTmaStore = false;" in body
    assert "constexpr bool kPersistent = false;" in body
    assert f"constexpr bool kResRing = {str(pnf.BNF_RES_RING).lower()};" \
        in body
    # one instantiation a dtype: the kernel takes no design parameter
    assert re.search(r"template <typename T>\n__global__ void "
                     r"__launch_bounds__\(kMaxThreads, 1\) "
                     r"bn_fwd_cluster\(Args p\)", body)
    assert "kScratch = (6 * kMaxC * 4 + 8 * (kMaxChunks + kRing) + 127) " \
           "/ 128 * 128;" in body
    assert "kMaxSmem = 232448;" in (SRC.parent / "common.cuh").read_text()


def test_cluster_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library both routes raise."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pnf._lib.cache_clear()
    before = dict(pnf.bn_fwd_routes), dict(pnf.launches)
    try:
        x = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
        v = torch.ones(8)
        for route in (None, "generic"):
            with pytest.raises(RuntimeError, match="nvcc"):
                pnf._bn_fwd_cuda(x, x, v, v, EPS, True, route=route)
    finally:
        pnf._lib.cache_clear()
    assert (dict(pnf.bn_fwd_routes), dict(pnf.launches)) == before
