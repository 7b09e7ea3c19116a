"""The GeLU and SwiGLU forwards' wgmma route (TPU kernels 4 and 7 on
Hopper), reckoned on the CPU.

``mlp_fwd_route`` (and ``swiglu_fwd_route``: the backwards' rule) sends
bfloat16 with H and F multiples of 8 and aligned tensors to the wgmma
kernels and everything else to the generic ones. ``mlp_fwd_plan`` and
``swiglu_fwd_plan`` mirror the route's two launches a chunk (P1 act_c,
the SwiGLU's on the core's paired B; P2 y's product into the f32 sum
across chunks, its epilogue by the chunk's place) and ``gemm_tiles`` the
persistent grid's walk: brute force shows every element of act_c written
once a chunk and of y's sum once a chunk, and 4 RHF (GeLU) and 6 RHF
(SwiGLU) flops in all, ragged chunks and tiles included. An emulation of
the route's arithmetic driven by the plan, with its rounding points (act
rounded once; y's f32 sum over the chunks, b2 added to the whole sum, the
mask on the f32 value, one rounding), is held against the reference's
Pallas forwards in interpret mode (``fused_mlp_2d(..., interpret=True)``
in both GeLU forms at dropout 0 and 0.1, the mask keyed by the
reference's row tile from ``dropout_seed``; ``fused_swiglu_2d``).

Tolerances, of each output's largest magnitude:
- f32: 2e-5. Rounding is the identity in f32, so both sides compute the
  same f32 products in other summation orders.
- bf16: 2^-7, two bf16 units at the top of the range. Both round act
  once (an f32 sum in another order may land act on the other side of a
  rounding boundary: one unit of one addend) and y once (one unit,
  2^-8). The test shows the tolerance rejects the emulation with one
  chunk's down product left out, with b2 left out, and with the mask keyed
  by the CUDA tile's 128 rows in place of the reference's row tile.
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

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7
DROP_SEED = (0x9E3779B9, 0x80000001)   # one generator key; words above 2^31
# (r, h, f, fc): three chunks, the last ragged (320 = 2 x 128 + 64), rows
# past two 128-row tiles and the reference's 256-row tile; one chunk at H
# = 96 (P1's K not a multiple of the 64-wide k step); two chunks, the
# second of 40 columns (not a multiple of 64), rows just past one 128-row
# tile
SHAPES = [(300, 32, 320, 128), (37, 96, 64, 4096), (130, 40, 200, 160)]
FORMS = {"erf": False, "tanh": True}


@pytest.mark.parametrize("dtype,h,f,aligned,route", [
    (torch.bfloat16, 2048, 8192, True, "wgmma"),
    (torch.bfloat16, 768, 3072, True, "wgmma"),
    (torch.bfloat16, 4096, 11008, True, "wgmma"),
    (torch.bfloat16, 96, 360, True, "wgmma"),
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 100, 200, True, "generic"),
    (torch.bfloat16, 96, 324, True, "generic"),
    (torch.bfloat16, 2048, 8192, False, "generic"),
    (torch.float32, 2048, 8192, True, "generic"),
    (torch.float16, 2048, 8192, True, "generic"),
])
def test_route_rule(dtype, h, f, aligned, route):
    assert pmf.mlp_fwd_route(dtype, h, f, aligned) == route
    # the SwiGLU forward and both backwards take the same rule
    assert pmf.swiglu_fwd_route(dtype, h, f, aligned) == route
    assert pmf.mlp_bwd_route(dtype, h, f, aligned) == route


def _covered(shape, tiles, bm, bn):
    """How many times each element of an output of `shape` is written by
    the tiles (clipped at its edge)."""
    count = np.zeros(shape, np.int32)
    for r0, c0, _ in tiles:
        count[r0:r0 + bm, c0:c0 + bn] += 1
    return count


PLAN_SHAPES = [(8192, 2048, 8192, 4096), (8192, 2048, 8192, 2048),
               (16384, 768, 3072, 4096), (2048, 4096, 11008, 4096),
               (1000, 96, 360, 4096), (1000, 2048, 2560, 2048), *SHAPES]


@pytest.mark.parametrize("kind,rhf", [("gelu", 4), ("swiglu", 6)])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_once_a_chunk(shape, kind, rhf):
    r, h, f, fc = shape
    plan = (pmf.mlp_fwd_plan if kind == "gelu" else pmf.swiglu_fwd_plan)(
        r, h, f, fc)
    assert [c[0] for c in plan] == list(range(0, f, fc))
    assert sum(c[1] for c in plan) == f
    n = len(plan)
    want = (["one"] if n == 1 else
            ["sum_store"] + ["sum_add"] * (n - 2) + ["sum_last"])
    assert [c[3] for c in plan] == want
    flops = 0
    for f0, nc, products, epi in plan:
        for m, nn, k, halves, _ in products.values():
            flops += 2 * m * nn * k * halves
        m, nn, k, halves, (bm, bn, cl) = products["P1"]
        assert (m, nn, k, cl) == (r, nc, h, 1)
        # the SwiGLU's two products side by side in one [128, 256]
        # accumulator: output tiles half as wide
        assert (halves, bm, bn) == (
            (1, pmf.SW_BM, pmf.FW_GELU_BN) if kind == "gelu"
            else (2, pmf.SW_BM, pmf.SW_BN // 2))
        assert (_covered((r, nc), pmf.gemm_tiles(m, nn, bm, bn), bm, bn)
                == 1).all()
        m, nn, k, _, (bm, bn, _) = products["P2"]
        assert (m, nn, k) == (r, h, nc)
        # the GeLU's last of several chunks on the narrower tile
        assert bn == (pmf.FW_LAST_BN if (kind, epi) == ("gelu", "sum_last")
                      else pmf.SW_BN)
        # y's f32 sum (or y): each element once a chunk
        assert (_covered((r, h), pmf.gemm_tiles(m, nn, bm, bn), bm, bn)
                == 1).all()
    assert flops == rhf * r * h * f


@pytest.mark.parametrize("m,n", [(8192, 2048), (16384, 768), (2048, 4096)])
def test_down_product_keeps_the_wide_tile(m, n):
    """P2 stays on the core's [128, 256] tiles: at each model's y the
    backward's wave rule (``dw_tile``: fewer waves times the width) would
    not pick the narrower tile either (bert-base's 384 tiles of 256 and
    512 of 192 both end at 768 columns' worth of waves)."""
    assert pmf.dw_tile(m, n) == pmf.SW_BN


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="positive"):
        pmf.mlp_fwd_plan(8, 0, 8, 8)
    with pytest.raises(ValueError, match="positive"):
        pmf.swiglu_fwd_plan(8, 8, 8, 0)


def _down(plan, act_of, w2, skip_chunk=None):
    """P2 over the plan's chunks: act_c · W2_c into the f32 sum by each
    chunk's epilogue (``skip_chunk``: that chunk's product left out, a
    planted fault). Returns the f32 sum before any bias."""
    out = None
    for c, (f0, nc, _, epi) in enumerate(plan):
        sl = slice(f0, f0 + nc)
        prod = act_of(sl) @ w2[sl]
        if c == skip_chunk:
            prod = torch.zeros_like(prod)
        out = prod if epi in ("one", "sum_store") else out + prod
    return out


def _emulate_gelu(x, w1, b1, w2, b2, fc, approximate, rnd, drop=None,
                  skip_chunk=None, with_b2=True):
    """The GeLU forward's wgmma route in its chunk order (f32 products,
    ``rnd`` the rounding to the working dtype): P1 act_c = rnd(gelu(x·W1_c
    + b1_c)); P2 into the f32 sum; where y is written, b2 added to the
    whole sum (``with_b2`` False: left out, a planted fault), then the
    mask, then one rounding."""
    plan = pmf.mlp_fwd_plan(x.shape[0], x.shape[1], w1.shape[1], fc)
    s = _down(plan, lambda sl: rnd(pmf._gelu_f32(x @ w1[:, sl] + b1[sl],
                                                 approximate)),
              w2, skip_chunk)
    return rnd(pnf._dropped(s + b2 if with_b2 else s, drop))


def _emulate_swiglu(x, wg, wu, wd, fc, rnd, skip_chunk=None):
    """The SwiGLU forward's wgmma route in its chunk order: P1 act_c =
    rnd(silu(x·Wg_c)·(x·Wu_c)) from the paired accumulator; P2 into the f32
    sum; one rounding."""
    plan = pmf.swiglu_fwd_plan(x.shape[0], x.shape[1], wg.shape[1], fc)
    return rnd(_down(plan, lambda sl: rnd(pmf._silu_f32(x @ wg[:, sl])
                                          * (x @ wu[:, sl])), wd, skip_chunk))


def _arrays(seed, dtype, *shapes):
    """Normal arrays of `shapes` (scale 1 for the first, 0.3 after), each
    exact in the dtype, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = (rng.standard_normal(shape) * (1.0 if i == 0 else 0.3)).astype(
            np.float32)
        out.append(torch.from_numpy(a).to(dtype).float().numpy())
    return out


def _gelu_arrays(seed, r, h, f, dtype):
    """x, w1, b1, w2, b2 (the biases stay f32 arrays)."""
    return _arrays(seed, dtype, (r, h), (h, f), (f,), (f, h), (h,))


def _key(p, r, h, f, dtype, rows=None):
    """The port's dropout key of ``fused_mlp_2d`` at rate p (None at 0):
    the seed pair and the reference's row tile in the dtype (``rows``: that
    row tile instead, a planted fault)."""
    if p == 0.0:
        return None
    if rows is None:
        rows = pmf.mlp_blocks(r, h, f, dtype=dtype)[0]
    return pfa.DropKey(p, *DROP_SEED, rows, h)


def _gelu_reference(arrays, jdtype, approximate, p):
    x, w1, b1, w2, b2 = arrays
    kw = dict(approximate=approximate, interpret=True)
    if p > 0.0:
        kw.update(dropout_p=p, dropout_seed=jnp.asarray(DROP_SEED, jnp.uint32))
    y = jmf.fused_mlp_2d(jnp.asarray(x, jdtype),
                         *map(jnp.asarray, (w1, b1, w2, b2)), **kw)
    return np.asarray(y, np.float64)


def _reading(got, ref):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gelu_emulation_matches_pallas_forward_f32(shape, form, p):
    r, h, f, fc = shape
    arrays = _gelu_arrays(sum(shape) + int(10 * p), r, h, f, torch.float32)
    ref = _gelu_reference(arrays, jnp.float32, FORMS[form], p)
    key = _key(p, r, h, f, torch.float32)
    got = _emulate_gelu(*map(torch.from_numpy, arrays), fc, FORMS[form],
                        lambda t: t, key)
    assert _reading(got, ref) <= F32_TOL


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gelu_emulation_matches_pallas_forward_bf16(shape, form, p):
    r, h, f, fc = shape
    arrays = _gelu_arrays(sum(shape) + 1 + int(10 * p), r, h, f,
                          torch.bfloat16)
    ref = _gelu_reference(arrays, jnp.bfloat16, FORMS[form], p)
    key = _key(p, r, h, f, torch.bfloat16)
    args = (*map(torch.from_numpy, arrays), fc, FORMS[form], _bf16, key)
    assert _reading(_emulate_gelu(*args), ref) <= BF16_TOL
    # the tolerance rejects y with one chunk's down product left out (in
    # every chunk, the ragged last included) and with b2 left out
    for c in range(len(range(0, f, fc))):
        assert _reading(_emulate_gelu(*args, skip_chunk=c), ref) > BF16_TOL, c
    assert _reading(_emulate_gelu(*args, with_b2=False), ref) > BF16_TOL
    # and the mask keyed by the CUDA tile's 128 rows, wherever that mask
    # differs from the reference's
    if key is not None:
        tile = _key(p, r, h, f, torch.bfloat16, rows=pmf.SW_BM)
        ones = torch.ones(r, h)
        if not torch.equal(pnf._dropped(ones, tile), pnf._dropped(ones, key)):
            wrong = _emulate_gelu(*args[:-1], tile)
            assert _reading(wrong, ref) > BF16_TOL


def test_the_cuda_tile_key_differs_where_the_fault_is_planted():
    """The bf16 test's planted mask fault is live: at p = 0.1 the
    reference's row tile differs from the CUDA tile's 128 rows at the two
    shapes whose R passes 128 rows."""
    for r, h, f, _ in SHAPES:
        if r <= pmf.SW_BM:
            continue
        key = _key(0.1, r, h, f, torch.bfloat16)
        tile = _key(0.1, r, h, f, torch.bfloat16, rows=pmf.SW_BM)
        ones = torch.ones(r, h)
        assert key.rows != pmf.SW_BM
        assert not torch.equal(pnf._dropped(ones, tile),
                               pnf._dropped(ones, key))


def _swiglu_arrays(seed, r, h, f, dtype):
    """x, wg, wu, wd."""
    return _arrays(seed, dtype, (r, h), (h, f), (h, f), (f, h))


def _swiglu_reference(arrays, jdtype):
    x, wg, wu, wd = arrays
    y = jmf.fused_swiglu_2d(jnp.asarray(x, jdtype),
                            *(jnp.asarray(w, jdtype) for w in (wg, wu, wd)),
                            interpret=True)
    return np.asarray(y, np.float64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_swiglu_emulation_matches_pallas_forward(shape, dtype):
    r, h, f, fc = shape
    tdt, jdt, rnd, tol = {
        "f32": (torch.float32, jnp.float32, lambda t: t, F32_TOL),
        "bf16": (torch.bfloat16, jnp.bfloat16, _bf16, BF16_TOL)}[dtype]
    arrays = _swiglu_arrays(sum(shape) + len(dtype), r, h, f, tdt)
    ref = _swiglu_reference(arrays, jdt)
    args = (*map(torch.from_numpy, arrays), fc, rnd)
    assert _reading(_emulate_swiglu(*args), ref) <= tol
    if dtype == "bf16":   # one chunk's down product left out, each chunk
        for c in range(len(range(0, f, fc))):
            assert _reading(_emulate_swiglu(*args, skip_chunk=c),
                            ref) > BF16_TOL, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_ops_count_no_route_and_keep_the_plain_bits(dtype):
    r, h, f = 37, 96, 320
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in
                         _gelu_arrays(3, r, h, f, dtype))
    x, w1, w2 = (t.to(dtype) for t in (x, w1, w2))
    sx, wg, wu, wd = (torch.from_numpy(a).to(dtype) for a in
                      _swiglu_arrays(4, r, h, f, dtype))
    counters = (pmf.mlp_fwd_routes, pmf.swiglu_fwd_routes, pmf.launches,
                pmf.dropout_launches)
    before = [dict(c) for c in counters]
    for p in (0.0, 0.1):
        key = _key(p, r, h, f, dtype)
        drop = () if key is None else (p, *DROP_SEED, key.rows)
        got = torch.ops.paddle_tpu_torch.fused_mlp_fwd(x, w1, b1, w2, b2,
                                                       True, *drop)
        want = pmf.fused_mlp_fwd_ref(x, w1, b1, w2, b2, True, key)
        assert got.dtype == want.dtype and torch.equal(got, want)
    got = torch.ops.paddle_tpu_torch.fused_swiglu_fwd(sx, wg, wu, wd)
    want = pmf.fused_swiglu_fwd_ref(sx, wg, wu, wd)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert [dict(c) for c in counters] == before


def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_wgmma_ctypes_signatures_match_the_cuda_source():
    csrc = Path(pmf.__file__).parent / "csrc"
    src = (csrc / "fused_mlp.cu").read_text()
    for name, argtypes in pmf._FWD_WGMMA_ARGTYPES.items():
        m = re.search(rf"int {name}_bf16\(([^)]*)\)", src)
        assert m is not None, name
        assert _kinds(m.group(1)) == argtypes, name
        assert f"int {name}_f32(" not in src    # bf16 only
        # the probe's entry: the same arguments and the parts' bitmask
        m = re.search(rf"int {name}_parts_bf16\(([^)]*)\)", src)
        assert m is not None, name
        assert _kinds(m.group(1)) == argtypes[:-1] + [ctypes.c_int,
                                                      ctypes.c_void_p]
    # the GeLU's takes the generic entry's arguments; the SwiGLU's the
    # generic entry's without the f32 gate workspace (ag_ws)
    assert pmf._FWD_WGMMA_ARGTYPES["fused_mlp_fwd_wgmma"] == (
        pmf._MLP_ARGTYPES["fused_mlp_fwd"])
    generic = pmf._MLP_ARGTYPES["fused_swiglu_fwd"]
    assert pmf._FWD_WGMMA_ARGTYPES["fused_swiglu_fwd_wgmma"] == (
        generic[:5] + generic[6:])
    # P1's and P2's accumulator widths: the plans' tiles
    for const, width in (("kGeluBN", pmf.FW_GELU_BN), ("kSwigluBN", pmf.SW_BN),
                         ("kBN", pmf.SW_BN), ("kLastBN", pmf.FW_LAST_BN)):
        assert re.search(rf"^constexpr int {const} = {width}, k\w*Stages",
                         src, re.M), const
    assert pmf._MLP_FWD_CHUNK_F % 8 == 0


def test_wgmma_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library the wgmma route raises, and a
    named route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._mlp_lib.cache_clear()
    counters = (pmf.mlp_fwd_routes, pmf.swiglu_fwd_routes, pmf.launches)
    before = [dict(c) for c in counters]
    try:
        x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in
                             _gelu_arrays(2, 8, 16, 24, torch.bfloat16))
        x, w1, w2 = (t.bfloat16() for t in (x, w1, w2))
        sx, wg, wu, wd = (torch.from_numpy(a).bfloat16() for a in
                          _swiglu_arrays(5, 8, 16, 24, torch.bfloat16))
        for route in (None, "generic"):
            with pytest.raises(RuntimeError, match="nvcc"):
                pmf._fwd_cuda(x, w1, b1, w2, b2, True, route=route)
            with pytest.raises(RuntimeError, match="nvcc"):
                pmf._swiglu_fwd_cuda(sx, wg, wu, wd, route=route)
        with pytest.raises(ValueError, match="wgmma route"):
            pmf._fwd_cuda(x.float(), w1.float(), b1, w2.float(), b2, True,
                          route="wgmma")
        with pytest.raises(ValueError, match="wgmma route"):
            pmf._swiglu_fwd_cuda(sx.float(), wg.float(), wu.float(),
                                 wd.float(), route="wgmma")
        with pytest.raises(ValueError, match="route"):
            pmf._fwd_cuda(x, w1, b1, w2, b2, True, route="fast")
    finally:
        pmf._mlp_lib.cache_clear()
    assert [dict(c) for c in counters] == before
