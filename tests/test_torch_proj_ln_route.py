"""The projection-LN's cluster route (TPU kernels 10, 11 on Hopper),
reckoned on the CPU.

``pl_route`` sends bfloat16 with Hout a multiple of 256 up to 768, Hin a
multiple of 8 and aligned tensors to the cluster kernels and everything
else to the generic ones. ``pl_cluster_plan`` is the cluster's column
slices. An emulation of the cluster kernels' arithmetic over that plan —
each block's partial row sums over its slice, combined in rank order (the
forward's mean and variance by Chan et al.'s pairwise update of each
slice's sum and centred sum of squares; the backward's sums of g·γ and
g·γ·x̂), dp written as the pair hi = bf16(dp), lo = bf16(dp − hi), the
column sums per 128-row tile — is held against the reference's Pallas
forward and backward in interpret mode (``fused_proj_ln_2d(...,
interpret=True)`` and ``jax.vjp``), ragged R and dropout included.

Tolerances:
- the emulation's y, mean, rstd, dres, dgamma, dbeta and db: 1e-5 of each
  output's largest magnitude. The inputs are bf16-representable f32 (the
  route takes bf16), so both sides do the same f32 arithmetic in other
  summation orders.
- hi + lo against the plain f32 dp: 2^-16 of |dp|, element by element
  (lo keeps the 8 bits past hi's 8: ~2^-17); against the reference
  kernel's f32 dp, 2^-16 of its largest magnitude.
- dx = [hi | lo]·[Wᵀ; Wᵀ] and dW = xᵀ·[hi | lo], emulated in f32 with the
  bf16-exact halves, against the reference's f32 products of dp: 2^-16 of
  the largest magnitude (the pair's error, summed over the contraction).
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

from paddle_tpu.kernels import mlp_fusion as jmf
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.kernels import norm_fusion as pnf

TOL = 1e-5
PAIR_TOL = 2.0 ** -16
ROWS = pmf.PL_CLUSTER_ROWS
DROP_SEED = np.array([0x9E3779B9, 0x80000001], np.uint32)
# (r, hin, hout): two row tiles, the last ragged; one ragged tile; the
# widest Hout (BERT-base's) at a Hin not a multiple of the 64-wide k step
SHAPES = [(200, 64, 256), (37, 96, 512), (130, 40, 768)]


@pytest.mark.parametrize("dtype,hin,hout,aligned,route", [
    (torch.bfloat16, 768, 768, True, "cluster"),
    (torch.bfloat16, 768, 512, True, "cluster"),
    (torch.bfloat16, 64, 256, True, "cluster"),
    (torch.bfloat16, 8, 768, True, "cluster"),
    (torch.bfloat16, 768, 1024, True, "generic"),
    (torch.bfloat16, 1024, 2048, True, "generic"),
    (torch.bfloat16, 768, 384, True, "generic"),
    (torch.bfloat16, 768, 128, True, "generic"),
    (torch.bfloat16, 100, 768, True, "generic"),
    (torch.bfloat16, 768, 768, False, "generic"),
    (torch.float32, 768, 768, True, "generic"),
    (torch.float16, 768, 768, True, "generic"),
])
def test_route_rule(dtype, hin, hout, aligned, route):
    assert pmf.pl_route(dtype, hin, hout, aligned) == route


@pytest.mark.parametrize("hout", [256, 512, 768])
def test_cluster_plan_tiles_the_row_in_rank_order(hout):
    plan = pmf.pl_cluster_plan(hout)
    assert len(plan) == pmf.PL_CLUSTER_CTAS
    assert plan[0][0] == 0 and plan[-1][1] == hout
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert {c1 - c0 for c0, c1 in plan} == {hout // pmf.PL_CLUSTER_CTAS}


@pytest.mark.parametrize("hout", [1024, 300, 0])
def test_cluster_plan_refuses_what_the_route_does_not_take(hout):
    with pytest.raises(ValueError, match="cluster route"):
        pmf.pl_cluster_plan(hout)


def _bf16_exact(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _arrays(seed, r, hin, hout):
    """x, w, b, res, ln_w, ln_b, g; the row tensors and W bf16-exact."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    return (_bf16_exact(n(r, hin)), _bf16_exact(n(hin, hout, s=hin ** -0.5)),
            n(hout, s=0.2), _bf16_exact(n(r, hout)), n(hout, s=0.2, m=1.0),
            n(hout, s=0.2), _bf16_exact(n(r, hout)))


def _key(r, hin, hout):
    """The reference's dropout key at these widths: its row tile
    (mlp_blocks) by the row's width."""
    block_r = jmf.mlp_blocks(r, hout, hin, dtype=jnp.float32)[0]
    return pfa.DropKey(0.1, int(DROP_SEED[0]), int(DROP_SEED[1]), block_r,
                       hout)


def _slices(t, hout):
    return [t[:, c0:c1] for c0, c1 in pmf.pl_cluster_plan(hout)]


def _rank_sum(parts):
    """Each row's four partials added in rank order, as every block of
    the cluster adds them."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _emulate_fwd(x, w, b, res, lnw, lnb, eps, key):
    """The cluster forward's arithmetic: z in f32, each slice's sum and
    sum of squares about its own mean, Chan's combination over the four."""
    hout = w.shape[1]
    nw = hout // pmf.PL_CLUSTER_CTAS
    z = pnf._dropped(x @ w + b, key) + res
    sums = [s.sum(1) for s in _slices(z, hout)]
    m2 = [((s - (sq / nw)[:, None]) ** 2).sum(1)
          for s, sq in zip(_slices(z, hout), sums)]
    mean = _rank_sum(sums) / hout
    var = _rank_sum([q + nw * (sq / nw - mean) ** 2
                     for q, sq in zip(m2, sums)]) / hout
    rstd = torch.rsqrt(var + eps)
    return z, (z - mean[:, None]) * rstd[:, None] * lnw + lnb, mean, rstd


def _emulate_bwd(x, w, b, res, lnw, mean, rstd, g, key):
    """The cluster backward's arithmetic: x^ from the saved stats, the
    slices' sums of gw and gw x^ in rank order, dz, dp as the pair, the
    column sums per 128-row tile, then over the tiles."""
    hout = w.shape[1]
    z = pnf._dropped(x @ w + b, key) + res
    xh = (z - mean[:, None]) * rstd[:, None]
    gw = g * lnw
    c1 = _rank_sum([s.sum(1) for s in _slices(gw, hout)]) / hout
    c2 = _rank_sum([s.sum(1) for s in _slices(gw * xh, hout)]) / hout
    dz = (gw - c1[:, None] - xh * c2[:, None]) * rstd[:, None]
    dp = pnf._dropped(dz, key)
    hi = dp.bfloat16()
    lo = (dp - hi.float()).bfloat16()
    tiles = range(0, x.shape[0], ROWS)
    cols = [sum(t[i:i + ROWS].sum(0) for i in tiles)
            for t in (g * xh, g, dp)]
    return dz, dp, hi, lo, cols


def _reference(arrays, eps, drop):
    x, w, b, res, lnw, lnb, g = map(jnp.asarray, arrays)
    kw = dict(dropout_p=0.1, dropout_seed=jnp.asarray(DROP_SEED)) \
        if drop else {}
    y, vjp = jax.vjp(lambda *a: jmf.fused_proj_ln_2d(*a, eps=eps,
                                                     interpret=True, **kw),
                     x, w, b, res, lnw, lnb)
    return y, vjp(g)


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    assert err <= tol, f"error {err} of the largest |ref| > {tol}"


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cluster_emulation_matches_pallas_kernels(shape, drop):
    r, hin, hout = shape
    arrays = _arrays(sum(shape) + drop, *shape)
    eps = 1e-12
    jy, (jdx, jdw, jdb, jdres, jdg, jdbeta) = _reference(arrays, eps, drop)
    x, w, b, res, lnw, lnb, g = map(torch.from_numpy, arrays)
    key = _key(r, hin, hout) if drop else None
    _, y, mean, rstd = _emulate_fwd(x, w, b, res, lnw, lnb, eps, key)
    _close(y, jy)
    dz, dp, hi, lo, (dg, dbeta, db) = _emulate_bwd(x, w, b, res, lnw, mean,
                                                   rstd, g, key)
    for got, ref in ((dz, jdres), (dg, jdg), (dbeta, jdbeta), (db, jdb)):
        _close(got, ref)
    # the pair products: [hi | lo]·[Wᵀ; Wᵀ] and xᵀ·[hi | lo], f32
    pair = torch.cat([hi, lo], 1).float()
    _close(pair @ torch.cat([w, w], 1).T, jdx, PAIR_TOL)
    dwp = x.T @ pair
    _close(dwp[:, :hout] + dwp[:, hout:], jdw, PAIR_TOL)


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "dropout"])
def test_pair_ref_reconstructs_the_reference_dp(drop):
    """fused_proj_ln_bwd_pair_ref's hi + lo: within 2^-16 of the plain
    f32 dp element by element (the pair's own error), and within 2^-16 of
    the largest magnitude of the reference kernel's f32 dp (its backward
    Pallas kernel in interpret mode: the same f32 arithmetic in another
    summation order moves small elements further, relative to
    themselves); hi is 0 exactly where the mask drops; dres, dgamma, dbeta
    and db against the reference kernel's."""
    r, hin, hout = 200, 64, 256
    arrays = _arrays(11 + drop, r, hin, hout)
    x, w, b, res, lnw, lnb, g = map(jnp.asarray, arrays)
    block_r, block_k = jmf.mlp_blocks(r, hout, hin, dtype=jnp.float32)
    seeds = jmf._canonical_seeds(jnp.asarray(DROP_SEED)) if drop else None
    kw = dict(eps=1e-12, dropout_p=0.1 if drop else 0.0, block_r=block_r,
              block_k=block_k, interpret=True)
    _, jmean, jrstd = jmf._proj_ln_fwd(x, w, b, res, lnw, lnb, seeds, **kw)
    jdz, jdp, jdg, jdbeta = jmf._proj_ln_bwd(x, w, b, res, lnw, seeds,
                                             jmean, jrstd, g, **kw)
    jdp = np.asarray(jdp, np.float64)
    t = dict(zip("x w b res lnw lnb g".split(),
                 map(torch.from_numpy, arrays)))
    key = pfa.DropKey(0.1, int(DROP_SEED[0]), int(DROP_SEED[1]), block_r,
                      hout) if drop else None
    mean = torch.from_numpy(np.asarray(jmean)[:, 0].copy())
    rstd = torch.from_numpy(np.asarray(jrstd)[:, 0].copy())
    dres, hi, lo, dg, dbeta, db = pmf.fused_proj_ln_bwd_pair_ref(
        t["x"], t["w"], t["b"], t["res"], t["lnw"], mean, rstd, t["g"], key)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert dres.dtype == torch.float32   # res's dtype
    pair = hi.double().numpy() + lo.double().numpy()
    _, dp, _, _ = pmf.fused_proj_ln_bwd_ref(t["x"], t["w"], t["b"], t["res"],
                                            t["lnw"], mean, rstd, t["g"], key)
    dp = dp.double().numpy()
    assert np.all(np.abs(pair - dp) <= PAIR_TOL * np.abs(dp))
    _close(pair, jdp, PAIR_TOL)
    if drop:
        keep = pnf.row_keep_ref(key, t["g"]).numpy()
        assert 0 < (~keep).sum() < keep.size
        np.testing.assert_array_equal((hi == 0).numpy(), ~keep)
        np.testing.assert_array_equal(jdp == 0, ~keep)
    for got, ref in ((dres, jdz), (dg, jdg), (dbeta, jdbeta),
                     (db, jdp.sum(0))):
        _close(got, ref)


def _old_backward(x, w, b, res, lnw, lnb, mean, rstd, g, key):
    """What the autograd backward computed before fused_proj_ln_grads:
    the f32 kernel's plain version, then the f32 products and casts."""
    dz, dp, dg, dbeta = pmf.fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean,
                                                  rstd, g, key)
    dx = dp @ w.float().T
    dw = x.float().T @ dp
    return (dx.to(x.dtype), dw.to(w.dtype), dp.sum(0).to(b.dtype),
            dz.to(res.dtype), dg.to(lnw.dtype), dbeta.to(lnb.dtype))


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grads_op_on_cpu_is_the_old_backward_bit_for_bit(dtype, drop):
    r, hin, hout = 37, 96, 256
    x, w, b, res, lnw, lnb, g = map(torch.from_numpy,
                                    _arrays(5 + drop, r, hin, hout))
    x, w, res, g = (t.to(dtype) for t in (x, w, res, g))
    dargs = (0.1, int(DROP_SEED[0]), int(DROP_SEED[1]), 8) if drop else ()
    key = pfa.DropKey(*dargs, hout) if drop else None
    _, mean, rstd = pmf.fused_proj_ln_fwd_ref(x, w, b, res, lnw, lnb, 1e-12,
                                              key)
    before = dict(pmf.pl_routes), dict(pmf.launches)
    got = torch.ops.paddle_tpu_torch.fused_proj_ln_grads(
        x, w, b, res, lnw, lnb, mean, rstd, g, *dargs)
    want = _old_backward(x, w, b, res, lnw, lnb, mean, rstd, g, key)
    assert all(a.dtype == e.dtype and torch.equal(a, e)
               for a, e in zip(got, want))
    assert all(a.dtype == e.dtype and torch.equal(a, e)
               for a, e in zip(pmf.fused_proj_ln_grads_ref(
                   x, w, b, res, lnw, lnb, mean, rstd, g, key), want))
    # autograd through the forward op reaches the same arithmetic
    leaves = [t.detach().requires_grad_(True) for t in (x, w, b, res, lnw,
                                                       lnb)]
    y, _, _ = pmf.fused_proj_ln_fwd(*leaves, 1e-12, *dargs)
    y.backward(g)
    assert all(torch.equal(t.grad, e) for t, e in zip(leaves, want))
    assert (dict(pmf.pl_routes), dict(pmf.launches)) == before


def test_cluster_ctypes_signatures_match_the_cuda_source():
    src = (Path(pmf.__file__).parent / "csrc" / "proj_ln.cu").read_text()
    for name, argtypes in pmf._PL_CLUSTER_ARGTYPES.items():
        m = re.search(rf"int {name}_bf16\(([^)]*)\)", src)
        assert m is not None, name
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float
                 if "float" in p else ctypes.c_uint if "unsigned" in p
                 else ctypes.c_int for p in m.group(1).split(",")]
        assert kinds == argtypes, name
        assert f"int {name}_f32(" not in src    # bf16 only
    for name in ("proj_ln_cluster_max_hout", "proj_ln_cluster_rows"):
        assert f"int {name}()" in src
    assert re.search(r"constexpr int kMaxHout = "
                     rf"{pmf.PL_CLUSTER_MAX_HOUT};", src)
    assert re.search(rf"constexpr int kRows = {ROWS};", src)
    assert re.search(rf"constexpr int kCtas = {pmf.PL_CLUSTER_CTAS};", src)


def test_cluster_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library the cluster route raises, and a
    named route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._pl_lib.cache_clear()
    before = dict(pmf.pl_routes), dict(pmf.launches)
    try:
        x, w, b, res, lnw, lnb, g = map(torch.from_numpy,
                                        _arrays(2, 8, 16, 256))
        x, w, res, g = (t.bfloat16() for t in (x, w, res, g))
        mean, rstd = torch.zeros(8), torch.ones(8)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._proj_ln_fwd_cuda(x, w, b, res, lnw, lnb, 1e-5,
                                  route="cluster")
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._proj_ln_grads_cuda(x, w, b, res, lnw, lnb, mean, rstd, g)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._proj_ln_bwd_pair_cuda(x, w, b, res, lnw, mean, rstd, g)
        with pytest.raises(ValueError, match="cluster route"):
            pmf._proj_ln_fwd_cuda(x.float(), w.float(), b, res.float(), lnw,
                                  lnb, 1e-5, route="cluster")
        with pytest.raises(ValueError, match="route"):
            pmf._proj_ln_fwd_cuda(x, w, b, res, lnw, lnb, 1e-5, route="wide")
    finally:
        pmf._pl_lib.cache_clear()
    assert (dict(pmf.pl_routes), dict(pmf.launches)) == before
