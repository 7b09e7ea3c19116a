"""The LayerNorm backward's persistent route (TPU kernel 14 on Hopper),
reckoned on the CPU.

``ln_bwd_route`` sends float32 and bfloat16 rows of whole aligned 16-byte
vectors that fit a lane (bf16 and f32 H up to 1024) to the persistent
kernel and everything else to the generic ones. ``ln_bwd_plan`` is the
rows each persistent block owns (two blocks an SM, contiguous runs,
warp w taking rows w, w + 8, ... of its run). An emulation of the
kernel's arithmetic in its order -- each row's dz from the recomputed
x^ and the row's c1, c2; the column sums per warp over its rows, the
warps added in order into the block's partial row, the partial rows
added in block order -- is held against the reference's Pallas backward
in interpret mode (``jax.vjp`` through ``fused_layer_norm_2d(...,
interpret=True)``), all four (residual, lin_b) variants and dropout 0.1
keyed by the reference's row tile (``ln_block_r``).

Tolerances, of each output's largest magnitude: f32 1e-5 (the same f32
arithmetic in other summation orders); bf16 I/O 2^-7 for the rows (both
round the same f32 values to bf16; one near a rounding boundary may
round the other way) and 1e-5 for the f32 column sums. The tolerance is
shown to reject the emulation with one block's partial row left out.
"""
import ctypes
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
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import norm_fusion as pnf

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
DROP_SEED = np.array([0xC0FFEE11, 0x13579BDF], np.uint32)
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["plain", "res", "bias", "res_bias"]


@pytest.mark.parametrize("dtype,hd,aligned,route", [
    (torch.bfloat16, 768, True, "persistent"),
    (torch.bfloat16, 1024, True, "persistent"),
    (torch.bfloat16, 256, True, "persistent"),
    (torch.bfloat16, 8, True, "persistent"),
    (torch.bfloat16, 520, True, "persistent"),
    (torch.float32, 768, True, "persistent"),
    (torch.float32, 1024, True, "persistent"),
    (torch.float32, 96, True, "persistent"),
    (torch.bfloat16, 2048, True, "generic"),
    (torch.bfloat16, 1032, True, "generic"),
    (torch.float32, 1028, True, "generic"),
    (torch.bfloat16, 100, True, "generic"),
    (torch.float32, 98, True, "generic"),
    (torch.bfloat16, 768, False, "generic"),
    (torch.float16, 768, True, "generic"),
])
def test_route_rule(dtype, hd, aligned, route):
    assert pnf.ln_bwd_route(dtype, hd, aligned) == route


# (R, SMs): bert-base's rows on an H100; ragged; one row; fewer rows than
# blocks; rows a multiple of the blocks and one past it; one SM
PLAN_CASES = [(16384, 132), (16383, 132), (1, 132), (7, 132), (100, 132),
              (264, 132), (265, 132), (4096, 114), (50, 1), (3, 1)]


@pytest.mark.parametrize("r,sms", PLAN_CASES)
def test_persistent_plan_covers_each_row_once(r, sms):
    plan = pnf.ln_bwd_plan(r, sms)
    nparts = pnf.ln_bwd_parts(r, sms)
    assert len(plan) == nparts <= pnf.LN_BLOCKS_PER_SM * sms
    assert plan[0][0] == 0 and plan[-1][1] == r
    assert all(a < b for a, b in plan)                  # no empty block
    assert all(p[1] == q[0] for p, q in zip(plan, plan[1:]))
    seen = np.zeros(r, np.int64)
    for a, b in plan:
        for w in range(pnf.LN_WARPS):                   # warp w: a + w + 8 k
            seen[np.arange(a + w, b, pnf.LN_WARPS)] += 1
    assert (seen == 1).all()


def test_plan_refuses_no_rows():
    with pytest.raises(ValueError):
        pnf.ln_bwd_parts(0, 132)


class _FakeLib:
    def ln_rows_per_part(self):
        return 32


@pytest.mark.parametrize("route", ["persistent", "generic"])
@pytest.mark.parametrize("r,sms", [(16384, 132), (16383, 132), (7, 132),
                                   (300, 2)])
def test_wrapper_sizes_part_from_the_kernel_grid(monkeypatch, route, r, sms):
    """The wrapper's partial rows are the grid it launches: the persistent
    kernel's blocks (passed to it as its grid), the generic kernels' one
    row a 32-row block."""
    hd, nacc = 96, 3
    calls = []
    # the fake launch counts: on copies, so no other test sees them
    monkeypatch.setattr(pnf, "launches", dict(pnf.launches))
    monkeypatch.setattr(pnf, "ln_bwd_routes", dict(pnf.ln_bwd_routes))
    monkeypatch.setattr(pnf, "_lib", lambda: _FakeLib())
    monkeypatch.setattr(pnf, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(pnf._build, "call",
                        lambda lib, name, dtype, dev, *args:
                        calls.append((name, args)))
    made = []
    real = pnf._bwd_part
    monkeypatch.setattr(pnf, "_bwd_part",
                        lambda *a: made.append(real(*a)) or made[-1])
    h = torch.zeros(r, hd, dtype=torch.bfloat16)
    stats = torch.zeros(r)
    pnf._bwd_cuda(h, h, torch.zeros(hd), torch.ones(hd), stats, stats, h,
                  route=route)
    (name, args), = calls
    part = made[0]
    assert part.shape == (len(pnf.ln_bwd_plan(r, sms)) if route ==
                          "persistent" else -(-r // 32), nacc, hd)
    assert args[9] == part.data_ptr()
    if route == "persistent":
        assert name == "ln_bwd_persist" and args[-1] == part.shape[0]
    else:
        assert name == "ln_bwd"
    assert pnf.ln_bwd_routes[route] == 1
    assert pnf.launches["fused_ln_bwd"] == 1


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _arrays(seed, r, hd):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    # h, residual, lin_bias, weight, bias, g
    return (n(r, hd, s=2.0, m=0.5), n(r, hd), n(hd, s=0.3),
            n(hd, s=0.2, m=1.0), n(hd, s=0.2), n(r, hd))


def _emulate(h, res, lb, w, mean, rstd, g, drop, sms, skip_block=None):
    """The persistent kernel's outputs: (dh, dres, dw, db, dlin_b), the
    rows in h's dtype, the column sums f32 in the kernel's order."""
    z = h.float()
    if lb is not None:
        z = z + lb.float()
    z = pnf._dropped(z, drop)
    if res is not None:
        z = z + res.float()
    xh = (z - mean[:, None]) * rstd[:, None]
    gf = g.float()
    gw = gf * w.float()
    hd = h.shape[1]
    c1 = gw.sum(1, keepdim=True) / hd
    c2 = (gw * xh).sum(1, keepdim=True) / hd
    dz = (gw - c1 - xh * c2) * rstd[:, None]
    dhv = pnf._dropped(dz, drop)
    cols = [gf * xh, gf] + ([dhv] if lb is not None else [])
    sums = [torch.zeros(hd) for _ in cols]
    for b, (a, stop) in enumerate(pnf.ln_bwd_plan(h.shape[0], sms)):
        part = [torch.zeros(hd) for _ in cols]
        for wi in range(pnf.LN_WARPS):
            acc = [torch.zeros(hd) for _ in cols]
            for row in range(a + wi, stop, pnf.LN_WARPS):
                acc = [x + c[row] for x, c in zip(acc, cols)]
            part = [p + x for p, x in zip(part, acc)]
        if b != skip_block:
            sums = [s + p for s, p in zip(sums, part)]
    dres = None if res is None else dz.to(h.dtype)
    return (dhv.to(h.dtype), dres, *sums[:2],
            sums[2] if lb is not None else None)


def _reference(h, w, b, res, lb, g, dtype, **drop):
    """(dh, dres, dlin_b, dw, db) through the reference's Pallas kernels in
    interpret mode (``drop``: dropout_p, dropout_seed)."""
    args = [jnp.asarray(h).astype(dtype), jnp.asarray(w), jnp.asarray(b),
            None if res is None else jnp.asarray(res).astype(dtype),
            None if lb is None else jnp.asarray(lb)]

    def fn(h, w, b, res, lb):
        return jnf.fused_layer_norm_2d(h, w, b, residual=res, lin_bias=lb,
                                       eps=1e-12, interpret=True, **drop)

    _, vjp = jax.vjp(fn, *args)
    dh, dw, db, dres, dlb = vjp(jnp.asarray(g).astype(dtype))
    return dh, dres, dlb, dw, db


def _reading(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _case(variant, r, hd, dtype, p, seed):
    has_res, has_lb = variant
    h, res, lb, w, b, g = _arrays(seed, r, hd)
    res = res if has_res else None
    lb = lb if has_lb else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    drop, key = {}, None
    if p:
        drop = dict(dropout_p=p, dropout_seed=jnp.asarray(DROP_SEED))
        key = pfa.DropKey(p, *map(int, DROP_SEED),
                          pnf.ln_block_r(r, hd, dtype), hd)
    ref = _reference(h, w, b, res, lb, g, jdt, **drop)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    th, tres, tg = (None if a is None else t(a).to(dtype) for a in (h, res, g))
    _, mean, rstd = pnf.fused_ln_fwd_ref(th, tres, t(lb), t(w), t(b), 1e-12,
                                         key)
    args = (th, tres, t(lb), t(w), mean, rstd, tg, key)
    return args, ref


# (R, H, SMs): several blocks, the last ragged, warps with unequal rows;
# fewer rows than blocks; bf16's three vectors a lane at H 768's lane share
EMU_SHAPES = [(200, 96, 3), (37, 128, 132), (70, 24, 2)]


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape,dtype", [
    (EMU_SHAPES[0], torch.float32), (EMU_SHAPES[0], torch.bfloat16),
    (EMU_SHAPES[1], torch.float32), (EMU_SHAPES[2], torch.bfloat16)],
    ids=["r200-f32", "r200-bf16", "r37-f32", "r70-bf16"])
def test_emulation_matches_pallas_backward(shape, dtype, variant, p):
    r, hd, sms = shape
    args, (jdh, jdres, jdlb, jdw, jdb) = _case(variant, r, hd, dtype, p,
                                               seed=r + hd)
    dh, dres, dw, db, dlb = _emulate(*args, sms)
    row_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for got, ref, tol in ((dh, jdh, row_tol), (dres, jdres, row_tol),
                          (dw, jdw, F32_TOL), (db, jdb, F32_TOL),
                          (dlb, jdlb, F32_TOL)):
        assert (got is None) == (ref is None)
        if got is not None:
            assert _reading(got, ref) <= tol
    if p:
        key = args[-1]
        keep = pnf.row_keep_ref(key, args[0]).numpy()
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(jdh).astype(jnp.float32)) == 0, ~keep)
        # the mask keyed by the reference's row tile, not by a CUDA block's
        assert key.rows == pnf.ln_block_r(r, hd, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tolerance_rejects_a_dropped_partial_row(dtype):
    r, hd, sms = EMU_SHAPES[0]
    args, (_, _, jdlb, jdw, jdb) = _case((True, True), r, hd, dtype, 0.1,
                                         seed=3)
    nparts = pnf.ln_bwd_parts(r, sms)
    assert nparts > 1
    for b in range(nparts):
        _, _, dw, db, dlb = _emulate(*args, sms, skip_block=b)
        for got, ref in ((dw, jdw), (db, jdb), (dlb, jdlb)):
            assert _reading(got, ref) > F32_TOL, b


def test_cpu_op_counts_no_route():
    h, res, lb, w, b, g = (torch.from_numpy(a) for a in _arrays(1, 40, 64))
    before = dict(pnf.ln_bwd_routes)
    y, mean, rstd = pnf.fused_ln_fwd(h, res, lb, w, b, 1e-5)
    pnf.fused_ln_bwd(h, res, lb, w, b, mean, rstd, g)
    assert dict(pnf.ln_bwd_routes) == before


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------

def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_ctypes_signature_matches_the_cuda_source():
    src = (Path(pnf.__file__).parent / "csrc" / "norm_fusion.cu").read_text()
    m = re.search(r"int ln_bwd_persist_##SUFFIX\(([^)]*)\)", src)
    assert m is not None
    assert _kinds(m.group(1).replace("\\", "")) == pnf._ARGTYPES[
        "ln_bwd_persist"]
    # ln_bwd's arguments, then the grid's blocks
    assert pnf._ARGTYPES["ln_bwd_persist"] == (
        pnf._ARGTYPES["ln_bwd"][:-1] + [ctypes.c_int, ctypes.c_void_p])
    assert "LN_BWD_PERSIST(f32, float)" in src
    assert "LN_BWD_PERSIST(bf16, __nv_bfloat16)" in src
    assert re.search(rf"constexpr int kPersistBlocksPerSm = "
                     rf"{pnf.LN_BLOCKS_PER_SM};", src)
    assert re.search(rf"constexpr int kBwdMaxElems = {pnf.LN_LANE_ELEMS};",
                     src)
    assert re.search(rf"constexpr int kWarps = {pnf.LN_WARPS};", src)
    nvs = ", ".join(str(v) for v in pnf.LN_LANE_VECTORS)
    assert f"for (int nv : {{{nvs}}})" in src


def test_persistent_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library both routes raise, and a named
    route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pnf._lib.cache_clear()
    before = dict(pnf.ln_bwd_routes), dict(pnf.launches)
    try:
        h = torch.zeros(8, 64, dtype=torch.bfloat16)
        w, stats = torch.ones(64), torch.zeros(8)
        with pytest.raises(RuntimeError, match="nvcc"):
            pnf._bwd_cuda(h, h, None, w, stats, stats, h)
        with pytest.raises(RuntimeError, match="nvcc"):
            pnf._bwd_cuda(h, h, None, w, stats, stats, h, route="generic")
        odd = torch.zeros(8, 100, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="persistent route"):
            pnf._bwd_cuda(odd, odd, None, torch.ones(100), stats, stats, odd,
                          route="persistent")
        with pytest.raises(ValueError, match="route"):
            pnf._bwd_cuda(h, h, None, w, stats, stats, h, route="fast")
    finally:
        pnf._lib.cache_clear()
    assert (dict(pnf.ln_bwd_routes), dict(pnf.launches)) == before
