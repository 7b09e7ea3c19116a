"""The GeLU MLP backward's wgmma route (TPU kernels 5, 6 on Hopper),
reckoned on the CPU.

``mlp_bwd_route`` sends bfloat16 with H and F multiples of 8 and aligned
tensors to the wgmma kernels and everything else to the generic ones.
``mlp_bwd_plan`` mirrors the route's launches chunk by chunk (P1 da, act
and db1's row-block partials; P2 dX over K = nc; P3 dW1; P4 dW2) and
``gemm_tiles`` the persistent grid's walk over each product's output
tiles: brute force shows every output element written exactly once per
chunk (dX once per chunk, into its f32 sum; each row block's db1
partial once) and 10 RHF flops in all, ragged chunks and tiles
included. An emulation of the route's arithmetic in the chunk order,
with its rounding points (gm = round(drop(g)) read by the products; da
and act rounded once; dX summed over the chunks in f32 from the rounded
da and rounded once; dW1, dW2 products of the rounded operands, rounded
once; db1 and db2 f32 sums of the unrounded da and drop(g) by 128-row
block, then over the blocks in order), is held against the reference's
Pallas backward in interpret mode (``jax.vjp`` through
``fused_mlp_2d(..., interpret=True)``), both GeLU forms, at dropout 0 and
0.1 (the mask keyed by the reference's row tile from ``dropout_seed``).

Tolerances, of each output's largest magnitude:
- f32: 2e-5. Rounding is the identity in f32, so both sides compute the
  same f32 products in other summation orders.
- bf16: 2^-7, two bf16 units at the top of the range. The emulation feeds
  the dW products round(da), round(act) and, at dropout, round(drop(g))
  where the reference keeps them f32 (one bf16 rounding of each addend,
  ~2^-9 relative, averaged over R), and both round the outputs to bf16
  once (one unit, 2^-8). The test shows the tolerance rejects the
  emulation with one chunk's dX product left out, and with one row
  block's db1 partial left out.
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
# and H not multiples of the tiles; one chunk at H = 96 (P1's K not a
# multiple of the 64-wide k step); two row blocks, two chunks, the second
# of 40 columns (not a multiple of 64)
SHAPES = [(48, 32, 320, 128), (37, 96, 64, 2048), (130, 40, 200, 160)]
FORMS = {"erf": False, "tanh": True}


@pytest.mark.parametrize("dtype,h,f,aligned,route", [
    (torch.bfloat16, 2048, 8192, True, "wgmma"),
    (torch.bfloat16, 768, 3072, True, "wgmma"),
    (torch.bfloat16, 96, 360, True, "wgmma"),
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 100, 200, True, "generic"),
    (torch.bfloat16, 96, 324, True, "generic"),
    (torch.bfloat16, 2048, 8192, False, "generic"),
    (torch.float32, 2048, 8192, True, "generic"),
    (torch.float16, 2048, 8192, True, "generic"),
])
def test_route_rule(dtype, h, f, aligned, route):
    assert pmf.mlp_bwd_route(dtype, h, f, aligned) == route
    # the SwiGLU backward takes the same rule
    assert pmf.swiglu_bwd_route(dtype, h, f, aligned) == route


def _covered(shape, tiles, bm, bn):
    """How many times each element of an output of `shape` is written by
    the tiles (clipped at its edge)."""
    count = np.zeros(shape, np.int32)
    for r0, c0, _ in tiles:
        count[r0:r0 + bm, c0:c0 + bn] += 1
    return count


@pytest.mark.parametrize("shape", [(8192, 2048, 8192, 4096),
                                   (8192, 2048, 8192, 2048),
                                   (16384, 768, 3072, 4096),
                                   (1000, 96, 360, 4096), *SHAPES],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_once_and_counts_10_rhf(shape):
    r, h, f, fc = shape
    plan = pmf.mlp_bwd_plan(r, h, f, fc)
    assert [c[0] for c in plan] == list(range(0, f, fc))
    assert sum(c[1] for c in plan) == f
    blocks = -(-r // pmf._ROW_BLOCK)
    dw1 = np.zeros((h, f), np.int32)
    dw2 = np.zeros((f, h), np.int32)
    part = np.zeros((blocks, f), np.int32)     # db1's partials
    flops = 0
    for f0, nc, products in plan:
        for m, n, k, halves, _ in products.values():
            flops += 2 * m * n * k * halves
        m, n, _, _, (bm, bn, cl) = products["P1"]
        assert (m, n, cl) == (r, nc, pmf.GE_DACT_CLUSTER)
        assert bm == pmf._ROW_BLOCK     # a tile's rows are one row block
        tiles = pmf.gemm_tiles(m, n, bm, bn, cluster=cl)
        # da and act: the workspace once
        assert (_covered((r, nc), tiles, bm, bn) == 1).all()
        # db1's partials: each (row block, column) of the chunk once
        for r0, c0, _ in tiles:
            part[r0 // bm, f0 + c0:f0 + min(c0 + bn, nc)] += 1
        m, n, k, _, (bm, bn, _) = products["P2"]
        assert (m, n, k) == (r, h, nc)
        # dX's f32 sum: each element once a chunk
        assert (_covered((r, h), pmf.gemm_tiles(m, n, bm, bn), bm, bn)
                == 1).all()
        m, n, k, _, (bm, bn, _) = products["P3"]
        assert (m, n, k) == (h, nc, r)
        dw1[:, f0:f0 + nc] += _covered((h, nc), pmf.gemm_tiles(m, n, bm, bn),
                                       bm, bn)
        m, n, k, _, (bm, bn, _) = products["P4"]
        assert (m, n, k) == (nc, h, r)
        dw2[f0:f0 + nc] += _covered((nc, h), pmf.gemm_tiles(m, n, bm, bn),
                                    bm, bn)
    for out in (dw1, dw2, part):
        assert (out == 1).all()
    assert flops == 10 * r * h * f


@pytest.mark.parametrize("m,n,sms,bn", [
    (768, 3072, 132, 192),     # bert-base's P3: 72 tiles of 256, 96 of 192
    (3072, 768, 132, 192),     # its P4
    (2048, 4096, 132, 256),    # gpt3-1.3b's P3 at the chunk of 4096
    (4096, 2048, 132, 256),    # its P4
    (2048, 8192, 132, 256),    # one chunk of 8192: 512 tiles, 4 waves
    (768, 3072, 64, 192),      # on 64 SMs: 2 waves either way, narrower
    (1024, 8192, 64, 256),     # 256 tiles of 256 fill 4 waves; 344 of 192 6
])
def test_dw_tile_leaves_the_last_wave_fuller(m, n, sms, bn):
    """P3 and P4 take the narrower tile only where its waves times its
    width fall below the wide tile's."""
    assert pmf.dw_tile(m, n, sms) == bn

    def cost(w):
        return -(-(-(-m // pmf.SW_BM) * -(-n // w)) // sms) * w

    assert (cost(pmf.GE_DW_BN) < cost(pmf.SW_BN)) == (bn == pmf.GE_DW_BN)


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="positive"):
        pmf.mlp_bwd_plan(8, 0, 8, 8)


def _by_blocks(t, rows=128):
    """Column sums of t by row block of `rows`, then over the blocks in
    order (sum_parts' one way): the route's f32 bias gradients."""
    parts = [t[i:i + rows].sum(0) for i in range(0, t.shape[0], rows)]
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out, parts


def _emulate(x, w1, b1, w2, g, fc, approximate, rnd, drop=None,
             skip_dx_chunk=None, skip_db1_block=None):
    """The wgmma route's arithmetic in its chunk order (f32 products,
    ``rnd`` the rounding to the working dtype): gm = drop(g) in f32 (the
    products read round(gm)); per chunk P1's da and act rounded once and
    db1's row-block partials of the unrounded da; P2's da·W1_cᵀ into the
    f32 dX sum (``skip_dx_chunk``: that chunk's product left out, a
    planted fault); P3's and P4's products of the rounded operands,
    rounded once; db1 and db2 summed over the row blocks in order
    (``skip_db1_block``: that block's db1 partial left out). Returns (dx,
    dw1, db1, dw2, db2)."""
    r, h = x.shape
    f = w1.shape[1]
    gm = pnf._dropped(g, drop)
    gr = rnd(gm)
    db2, _ = _by_blocks(gm)
    acc = torch.zeros(r, h)
    dw1, dw2 = torch.empty(h, f), torch.empty(f, h)
    parts = [torch.empty(f) for _ in range(0, r, 128)]
    for c, f0 in enumerate(range(0, f, fc)):
        sl = slice(f0, min(f, f0 + fc))
        a = x @ w1[:, sl] + b1[sl]
        da = (gr @ w2[sl].T) * pmf._dgelu_f32(a, approximate)
        dar, act = rnd(da), rnd(pmf._gelu_f32(a, approximate))
        for i, p in enumerate(_by_blocks(da)[1]):
            parts[i][sl] = p
        if c != skip_dx_chunk:
            acc = acc + dar @ w1[:, sl].T
        dw1[:, sl] = rnd(x.T @ dar)
        dw2[sl] = rnd(act.T @ gr)
    db1 = torch.zeros(f)
    for i, p in enumerate(parts):
        if i != skip_db1_block:
            db1 = db1 + p
    return rnd(acc), dw1, db1, dw2, db2


def _arrays(seed, r, h, f, dtype):
    """x, w1, b1, w2, b2, g, each exact in the dtype (the biases stay f32
    arrays, so the reference keeps db1 and db2 in f32)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        return torch.from_numpy(a).to(dtype).float().numpy()

    return (n(r, h), n(h, f, s=0.3), n(f, s=0.3), n(f, h, s=0.3),
            n(h, s=0.3), n(r, h))


def _key(p, r, h, f, dtype):
    """The port's dropout key of ``fused_mlp_2d`` at rate p (None at 0):
    the seed pair and the reference's row tile in the dtype."""
    if p == 0.0:
        return None
    return pfa.DropKey(p, *DROP_SEED, pmf.mlp_blocks(r, h, f, dtype=dtype)[0],
                       h)


def _reference(arrays, jdtype, approximate, p):
    x, w1, b1, w2, b2, g = arrays
    kw = dict(approximate=approximate, interpret=True)
    if p > 0.0:
        kw.update(dropout_p=p, dropout_seed=jnp.asarray(DROP_SEED, jnp.uint32))
    _, vjp = jax.vjp(lambda *a: jmf.fused_mlp_2d(*a, **kw),
                     jnp.asarray(x, jdtype),
                     *map(jnp.asarray, (w1, b1, w2, b2)))
    return [np.asarray(t, np.float64) for t in vjp(jnp.asarray(g, jdtype))]


def _reading(got, ref):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _bf16(t):
    return t.bfloat16().float()


NAMES = ("dx", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_pallas_backward_f32(shape, form, p):
    r, h, f, fc = shape
    arrays = _arrays(sum(shape) + int(10 * p), r, h, f, torch.float32)
    ref = _reference(arrays, jnp.float32, FORMS[form], p)
    key = _key(p, r, h, f, torch.float32)
    tx, tw1, tb1, tw2, _, tg = map(torch.from_numpy, arrays)
    got = _emulate(tx, tw1, tb1, tw2, tg, fc, FORMS[form], lambda t: t, key)
    for name, a, b in zip(NAMES, got, ref):
        assert _reading(a, b) <= F32_TOL, name


@pytest.mark.parametrize("p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_pallas_backward_bf16(shape, form, p):
    r, h, f, fc = shape
    arrays = _arrays(sum(shape) + 1 + int(10 * p), r, h, f, torch.bfloat16)
    ref = _reference(arrays, jnp.bfloat16, FORMS[form], p)
    key = _key(p, r, h, f, torch.bfloat16)
    tx, tw1, tb1, tw2, _, tg = map(torch.from_numpy, arrays)
    args = (tx, tw1, tb1, tw2, tg, fc, FORMS[form], _bf16, key)
    got = _emulate(*args)
    for name, a, b in zip(NAMES, got, ref):
        assert _reading(a, b) <= BF16_TOL, name
    # the tolerance rejects dX with one chunk's product left out, and db1
    # with one row block's partial left out, in every chunk and block
    # (the ragged last ones included)
    for c in range(len(range(0, f, fc))):
        wrong = _emulate(*args, skip_dx_chunk=c)[0]
        assert _reading(wrong, ref[0]) > BF16_TOL, c
    for i in range(-(-r // 128)):
        wrong = _emulate(*args, skip_db1_block=i)[2]
        assert _reading(wrong, ref[2]) > BF16_TOL, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_op_counts_no_route_and_keeps_the_plain_bits(dtype):
    r, h, f = 37, 96, 320
    x, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in
                            _arrays(3, r, h, f, dtype))
    x, w1, w2, g = (t.to(dtype) for t in (x, w1, w2, g))
    before = (dict(pmf.mlp_bwd_routes), dict(pmf.launches),
              dict(pmf.dropout_launches))
    for p in (0.0, 0.1):
        key = _key(p, r, h, f, dtype)
        drop = () if key is None else (p, *DROP_SEED, key.rows)
        got = torch.ops.paddle_tpu_torch.fused_mlp_bwd(x, w1, b1, w2, b2, g,
                                                       True, *drop)
        dx = pmf.fused_mlp_dx_ref(x, w1, b1, w2, g, True, key)
        dws = pmf.fused_mlp_dw_ref(x, w1, b1, w2, g, True, key)
        want = (dx, dws[0].to(dtype), dws[1], dws[2].to(dtype), dws[3])
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
    assert (dict(pmf.mlp_bwd_routes), dict(pmf.launches),
            dict(pmf.dropout_launches)) == before


def _kinds(params):
    return [ctypes.c_void_p if "*" in p else ctypes.c_float if "float" in p
            else ctypes.c_uint if "unsigned" in p else ctypes.c_int
            for p in params.split(",")]


def test_wgmma_ctypes_signature_matches_the_cuda_source():
    csrc = Path(pmf.__file__).parent / "csrc"
    src = (csrc / "fused_mlp.cu").read_text()
    for name, argtypes in pmf._MLP_WGMMA_ARGTYPES.items():
        m = re.search(rf"int {name}_bf16\(([^)]*)\)", src)
        assert m is not None, name
        assert _kinds(m.group(1)) == argtypes, name
        assert f"int {name}_f32(" not in src    # bf16 only
        # the probe's entry: the same arguments and the products' bitmask
        m = re.search(rf"int {name}_parts_bf16\(([^)]*)\)", src)
        assert m is not None, name
        assert _kinds(m.group(1)) == argtypes[:-1] + [ctypes.c_int,
                                                      ctypes.c_void_p]
    # the generic entry's arguments without the f32 pre-activation
    generic = pmf._MLP_ARGTYPES["fused_mlp_bwd"]
    assert pmf._MLP_WGMMA_ARGTYPES["fused_mlp_bwd_wgmma"] == (
        generic[:10] + generic[11:])
    assert re.search(rf"constexpr int kTileN = {pmf.GE_DACT_BN}, kRing", src)
    assert re.search(rf"constexpr int kCluster = {pmf.GE_DACT_CLUSTER};", src)
    assert re.search(rf"constexpr int kDwBN = {pmf.GE_DW_BN}, kDwStages", src)
    assert re.search(rf"constexpr int kRowBlock = {pmf._ROW_BLOCK};", src)
    core = (csrc / "gemm_core.cuh").read_text()
    assert re.search(rf"constexpr int kBM = {pmf.SW_BM};", core)
    assert pmf._MLP_BWD_CHUNK_F % 8 == 0


def test_wgmma_route_raises_without_nvcc(monkeypatch):
    """No fallback: without the library the wgmma route raises, and a
    named route the shapes do not allow is refused, not rerouted."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._mlp_lib.cache_clear()
    before = dict(pmf.mlp_bwd_routes), dict(pmf.launches)
    try:
        x, w1, b1, w2, _, g = (torch.from_numpy(a) for a in
                               _arrays(2, 8, 16, 24, torch.bfloat16))
        x, w1, w2, g = (t.bfloat16() for t in (x, w1, w2, g))
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._bwd_cuda(x, w1, b1, w2, g, True)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._bwd_cuda(x, w1, b1, w2, g, True, route="generic")
        with pytest.raises(ValueError, match="wgmma route"):
            pmf._bwd_cuda(x.float(), w1.float(), b1, w2.float(), g.float(),
                          True, route="wgmma")
        with pytest.raises(ValueError, match="route"):
            pmf._bwd_cuda(x, w1, b1, w2, g, True, route="fast")
    finally:
        pmf._mlp_lib.cache_clear()
    assert (dict(pmf.mlp_bwd_routes), dict(pmf.launches)) == before
