"""The SwiGLU backward's wgmma route (TPU kernels 8, 9 on Hopper),
reckoned on the CPU.

``swiglu_bwd_route`` sends bfloat16 with H and F multiples of 8 and
aligned tensors to the wgmma kernels and everything else to the generic
ones. ``swiglu_bwd_plan`` mirrors the route's launches chunk by chunk (P1
dag, dau, act; P2 dX over K = 2 nc; P3 [dWg | dWu]; P4 dWd) and
``gemm_tiles`` the persistent grid's walk over each product's output
tiles: brute force shows every output element written exactly once per
chunk (dX once per chunk, into its f32 sum) and 16 RHF flops in all,
ragged chunks and tiles included. An emulation of the route's arithmetic
in the chunk order, with its rounding points (dag, dau, act rounded once;
dX summed over the chunks in f32 from the rounded dag, dau and rounded
once; dWg, dWu, dWd products of the rounded operands, rounded once), is
held against the reference's Pallas backward in interpret mode
(``jax.vjp`` through ``fused_swiglu_2d(..., interpret=True)``).

Tolerances, of each output's largest magnitude:
- f32: 2e-5. Rounding is the identity in f32, so both sides compute the
  same f32 products in other summation orders.
- bf16: 2^-7, two bf16 units at the top of the range. The emulation feeds
  the dW products round(dag) and round(dau) where the reference keeps
  them f32 (one bf16 rounding of each addend, ~2^-9 relative, averaged
  over R), and both round the outputs to bf16 once (one unit, 2^-8). The
  test shows the tolerance rejects the emulation with one chunk's dau
  product left out of dX.
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
from paddle_tpu_torch.kernels import mlp_fusion as pmf

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7
# (r, h, f, fc): three chunks, the last ragged (320 = 2 x 128 + 64), rows
# and H not multiples of the tiles; one chunk at H = 96 (P1's K not a
# multiple of the 64-wide k step); two chunks, the second of 40 columns
# (not a multiple of 64)
SHAPES = [(48, 32, 320, 128), (37, 96, 64, 2048), (130, 40, 200, 160)]


@pytest.mark.parametrize("dtype,h,f,aligned,route", [
    (torch.bfloat16, 4096, 11008, True, "wgmma"),
    (torch.bfloat16, 96, 320, True, "wgmma"),
    (torch.bfloat16, 2048, 2560, True, "wgmma"),
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 100, 200, True, "generic"),
    (torch.bfloat16, 96, 324, True, "generic"),
    (torch.bfloat16, 4096, 11008, False, "generic"),
    (torch.float32, 4096, 11008, True, "generic"),
    (torch.float16, 4096, 11008, True, "generic"),
])
def test_route_rule(dtype, h, f, aligned, route):
    assert pmf.swiglu_bwd_route(dtype, h, f, aligned) == route


@pytest.mark.parametrize("m,n,bm,bn", [(2048, 4096, 128, 256),
                                       (1000, 96, 128, 256),
                                       (333, 320, 128, 64), (8, 8, 128, 128),
                                       (4096, 768, 128, 256)])
@pytest.mark.parametrize("nsplit", [False, True], ids=["one", "nsplit"])
def test_tile_walk_is_a_permutation_of_the_grid(m, n, bm, bn, nsplit):
    tiles = pmf.gemm_tiles(m, n, bm, bn, nsplit)
    grid = {(i * bm, j * bn, half) for i in range(-(-m // bm))
            for j in range(-(-n // bn)) for half in range(2 if nsplit else 1)}
    assert len(tiles) == len(grid) and set(tiles) == grid
    # the first group's row tiles come first, row fastest
    rows = min(-(-m // bm), pmf.SW_GROUP_M)
    assert [t[0] for t in tiles[:rows]] == [i * bm for i in range(rows)]
    assert {t[1] for t in tiles[:rows]} == {0}


@pytest.mark.parametrize("m,n", [(2048, 2048), (1000, 320), (333, 200),
                                 (130, 40)])
def test_cluster_walk_pairs_neighbouring_column_tiles(m, n):
    """P1's clusters: each walks a row tile and a pair of neighbouring
    64-column tiles, its blocks in rank order; every column tile of the
    grid is some block's, once (a pair past an odd count of column tiles
    lies wholly outside n)."""
    cl, bn = pmf.SW_DACT_CLUSTER, pmf.SW_DACT_BN
    tiles = pmf.gemm_tiles(m, n, pmf.SW_BM, bn, cluster=cl)
    assert len(tiles) % cl == 0
    for i in range(0, len(tiles), cl):
        pair = tiles[i:i + cl]
        assert len({t[0] for t in pair}) == 1
        assert [t[1] for t in pair] == [pair[0][1] + bn * q for q in range(cl)]
        assert pair[0][1] % (bn * cl) == 0
    inside = [t for t in tiles if t[1] < n]
    grid = {(i * pmf.SW_BM, j * bn, 0) for i in range(-(-m // pmf.SW_BM))
            for j in range(-(-n // bn))}
    assert len(inside) == len(grid) and set(inside) == grid


def _covered(shape, tiles, bm, bn):
    """How many times each element of an output of `shape` is written by
    the tiles (clipped at its edge)."""
    count = np.zeros(shape, np.int32)
    for r0, c0, _ in tiles:
        count[r0:r0 + bm, c0:c0 + bn] += 1
    return count


@pytest.mark.parametrize("shape", [(2048, 4096, 11008, 4096),
                                   (2048, 4096, 11008, 2048),
                                   (1000, 96, 320, 4096), (1000, 2048, 4608, 4096),
                                   *SHAPES],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_once_and_counts_16_rhf(shape):
    r, h, f, fc = shape
    plan = pmf.swiglu_bwd_plan(r, h, f, fc)
    assert [c[0] for c in plan] == list(range(0, f, fc))
    assert sum(c[1] for c in plan) == f
    dwg = np.zeros((h, f), np.int32)
    dwu = np.zeros((h, f), np.int32)
    dwd = np.zeros((f, h), np.int32)
    flops = 0
    for f0, nc, products in plan:
        for name, (m, n, k, halves, _) in products.items():
            flops += 2 * m * n * k * halves
        m, n, _, _, (bm, bn, cl) = products["P1"]
        assert (m, n, cl) == (r, nc, pmf.SW_DACT_CLUSTER)
        # P1's three outputs share each tile: the workspace once
        assert (_covered((r, nc), pmf.gemm_tiles(m, n, bm, bn, cluster=cl),
                         bm, bn) == 1).all()
        m, n, k, _, (bm, bn, _) = products["P2"]
        assert (m, n, k) == (r, h, nc)
        # dX's f32 sum: each element once a chunk
        assert (_covered((r, h), pmf.gemm_tiles(m, n, bm, bn), bm, bn)
                == 1).all()
        m, n, k, _, (bm, bn, _) = products["P3"]
        assert (m, n, k) == (h, nc, r)
        for half, out in ((0, dwg), (1, dwu)):
            tiles = [t for t in pmf.gemm_tiles(m, n, bm, bn, nsplit=True)
                     if t[2] == half]
            out[:, f0:f0 + nc] += _covered((h, nc), tiles, bm, bn)
        m, n, k, _, (bm, bn, _) = products["P4"]
        assert (m, n, k) == (nc, h, r)
        dwd[f0:f0 + nc] += _covered((nc, h), pmf.gemm_tiles(m, n, bm, bn),
                                    bm, bn)
    for out in (dwg, dwu, dwd):
        assert (out == 1).all()
    assert flops == 16 * r * h * f


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="positive"):
        pmf.swiglu_bwd_plan(0, 8, 8, 8)


def _emulate(x, wg, wu, wd, g, fc, rnd, skip_dau_chunk=None):
    """The wgmma route's arithmetic in its chunk order (f32 products,
    ``rnd`` the rounding to the working dtype): per chunk P1's dag, dau,
    act rounded once; P2's [dag | dau]·[Wg_c | Wu_c]ᵀ into the f32 dX
    sum (``skip_dau_chunk``: that chunk's dau product left out, a planted
    fault); P3's and P4's products of the rounded operands, rounded once.
    Returns (dx, dwg, dwu, dwd)."""
    r, h = x.shape
    f = wg.shape[1]
    acc = torch.zeros(r, h)
    dwg, dwu, dwd = torch.empty(h, f), torch.empty(h, f), torch.empty(f, h)
    for c, f0 in enumerate(range(0, f, fc)):
        sl = slice(f0, min(f, f0 + fc))
        ag, au = x @ wg[:, sl], x @ wu[:, sl]
        dact = g @ wd[sl].T
        s = torch.sigmoid(ag)
        dag = rnd(dact * au * (s * (1.0 + ag * (1.0 - s))))
        dau = rnd(dact * (ag * s))
        act = rnd((ag * s) * au)
        if c == skip_dau_chunk:
            acc = acc + dag @ wg[:, sl].T
        else:
            acc = acc + torch.cat([dag, dau], 1) @ torch.cat(
                [wg[:, sl], wu[:, sl]], 1).T
        dwg[:, sl] = rnd(x.T @ dag)
        dwu[:, sl] = rnd(x.T @ dau)
        dwd[sl] = rnd(act.T @ g)
    return rnd(acc), dwg, dwu, dwd


def _arrays(seed, r, h, f, dtype):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        return torch.from_numpy(a).to(dtype).float().numpy()  # exact in dtype

    return (n(r, h), n(h, f, s=0.3), n(h, f, s=0.3), n(f, h, s=0.3),
            n(r, h))


def _reference(arrays, jdtype):
    x, wg, wu, wd, g = (jnp.asarray(a, jdtype) for a in arrays)
    _, vjp = jax.vjp(lambda *a: jmf.fused_swiglu_2d(*a, interpret=True),
                     x, wg, wu, wd)
    return [np.asarray(t, np.float64) for t in vjp(g)]


def _reading(got, ref):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_pallas_backward_f32(shape):
    r, h, f, fc = shape
    arrays = _arrays(sum(shape), r, h, f, torch.float32)
    ref = _reference(arrays, jnp.float32)
    got = _emulate(*map(torch.from_numpy, arrays), fc, lambda t: t)
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd"), got, ref):
        assert _reading(a, b) <= F32_TOL, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_pallas_backward_bf16(shape):
    r, h, f, fc = shape
    arrays = _arrays(sum(shape) + 1, r, h, f, torch.bfloat16)
    ref = _reference(arrays, jnp.bfloat16)
    tensors = list(map(torch.from_numpy, arrays))
    got = _emulate(*tensors, fc, _bf16)
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd"), got, ref):
        assert _reading(a, b) <= BF16_TOL, name
    # the tolerance rejects dX with one chunk's dau product left out, in
    # every chunk (the ragged last one included)
    for c in range(len(range(0, f, fc))):
        wrong = _emulate(*tensors, fc, _bf16, skip_dau_chunk=c)[0]
        assert _reading(wrong, ref[0]) > BF16_TOL, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_op_counts_no_route_and_keeps_the_plain_bits(dtype):
    r, h, f = 37, 96, 320
    x, wg, wu, wd, g = (torch.from_numpy(a).to(dtype)
                        for a in _arrays(3, r, h, f, dtype))
    before = dict(pmf.swiglu_bwd_routes), dict(pmf.launches)
    got = torch.ops.paddle_tpu_torch.fused_swiglu_bwd(x, wg, wu, wd, g)
    dx = pmf.fused_swiglu_dx_ref(x, wg, wu, wd, g)
    dws = pmf.fused_swiglu_dw_ref(x, wg, wu, wd, g)
    want = (dx, *(t.to(dtype) for t in dws))
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))
    assert (dict(pmf.swiglu_bwd_routes), dict(pmf.launches)) == before


def test_wgmma_ctypes_signature_matches_the_cuda_source():
    src = (Path(pmf.__file__).parent / "csrc" / "fused_mlp.cu").read_text()
    for name, argtypes in pmf._SWIGLU_WGMMA_ARGTYPES.items():
        m = re.search(rf"int {name}_bf16\(([^)]*)\)", src)
        assert m is not None, name
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in m.group(1).split(",")]
        assert kinds == argtypes, name
        assert f"int {name}_f32(" not in src    # bf16 only
    core = (Path(pmf.__file__).parent / "csrc" / "gemm_core.cuh").read_text()
    assert re.search(rf"constexpr int kBM = {pmf.SW_BM};", core)
    assert re.search(rf"constexpr int kBK = {pmf.SW_BK};", core)
    assert re.search(rf"constexpr int kGroupM = {pmf.SW_GROUP_M};", core)
    assert re.search(rf"constexpr int kBN = {pmf.SW_BN}, kStages", src)
    assert re.search(rf"constexpr int kDactBN = {pmf.SW_DACT_BN},", src)
    assert re.search(rf"constexpr int kDactCluster = {pmf.SW_DACT_CLUSTER};",
                     src)


def test_wgmma_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library the wgmma route raises, and a
    named route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._mlp_lib.cache_clear()
    before = dict(pmf.swiglu_bwd_routes), dict(pmf.launches)
    try:
        x, wg, wu, wd, g = (torch.from_numpy(a).bfloat16()
                            for a in _arrays(2, 8, 16, 24, torch.bfloat16))
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._swiglu_bwd_cuda(x, wg, wu, wd, g)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._swiglu_bwd_cuda(x, wg, wu, wd, g, route="generic")
        with pytest.raises(ValueError, match="wgmma route"):
            pmf._swiglu_bwd_cuda(x.float(), wg.float(), wu.float(),
                                 wd.float(), g.float(), route="wgmma")
        with pytest.raises(ValueError, match="route"):
            pmf._swiglu_bwd_cuda(x, wg, wu, wd, g, route="fast")
    finally:
        pmf._mlp_lib.cache_clear()
    assert (dict(pmf.swiglu_bwd_routes), dict(pmf.launches)) == before
