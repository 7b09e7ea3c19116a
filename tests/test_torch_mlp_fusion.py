"""The port's fused GeLU MLP against the JAX reference's Pallas kernels.

The reference runs as its own tests run it on the CPU
(tests/test_mlp_fusion.py): ``fused_mlp_2d(..., interpret=True)`` and
``jax.grad`` through it, and its dX and dW kernels (``_mlp_dx``,
``_mlp_dw``) in interpret mode at the tiles ``mlp_blocks`` picks. The
port's plain versions (``fused_mlp_fwd_ref``, ``fused_mlp_dx_ref``,
``fused_mlp_dw_ref``) and ``fused_mlp_2d`` with autograd (the custom ops
take the plain versions for CPU tensors) see the same numpy inputs.

Tolerances (readings at these seeds in brackets):
- f32: atol 2e-5 relative to each output's largest magnitude — the same
  f32 arithmetic in other summation orders (the reference sums over its
  ffn tiles, torch over whole rows) [worst 1.4e-6].
- bf16 I/O: each element within one bf16 unit in the last place of the
  output's largest magnitude (2^-8 of it): both round the same f32
  values, a sum lying on a rounding boundary may round the other way
  [worst 1.8e-7: one element in a few thousand flips].
The reference's own erf-form backward test fails on its tolerance
(ROADMAP.md §C), so these come from readings, not from that test.

Dropout (kernels 4-6's keep-mask epilogue): the reference's interpret
mode draws its portable hash keyed (row // block_r, 0, 0), block_r being
``mlp_blocks``'s row tile; the port's plain versions draw the same bits
(``row_bits_ref``), so the zeros agree element for element and the
values within the tolerances above. The tests run at R = 600, where
block_r is 256 (three row blocks, the last ragged), not the CUDA
kernels' 128-row block: a mask keyed by that block is shown to fail.
Readings with dropout at these seeds (p 0.1 and 0.5, both forms, y and
the five gradients): f32 worst 8.6e-7, bf16 worst 1.1e-3.
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import generator as jgen
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import mlp_fusion as jmf
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import mlp as jmlp
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import mlp as pmlp

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -8
# (r, h, f): a tile of rows; ragged rows; f <= 512 not a multiple of 128;
# f a multiple of 128 over several ffn tiles
SHAPES = [(48, 32, 64), (37, 32, 320), (24, 64, 1024)]


def _arrays(seed, r, h, f, scale=0.3):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    # x, w1, b1, w2, b2, g
    return (n(r, h), n(h, f, s=scale), n(f, s=scale), n(f, h, s=scale),
            n(h, s=scale), n(r, h))


def _close(got, ref, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"error {err} of the largest |ref| > {tol}"


def _ref_blocks(r, h, f):
    blocks = jmf.mlp_blocks(r, h, f)
    assert blocks is not None
    return dict(block_r=blocks[0], block_f=blocks[1])


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_pallas_kernels(shape, approximate):
    r, h, f = shape
    x, w1, b1, w2, b2, g = _arrays(sum(shape), r, h, f)
    jx, jw1, jb1, jw2, jb2, jg = map(jnp.asarray, (x, w1, b1, w2, b2, g))
    kw = dict(approximate=approximate, dropout_p=0.0, interpret=True,
              **_ref_blocks(r, h, f))
    jy = jmf._mlp_fwd(jx, jw1, jb1, jw2, jb2, None, **kw)
    jdx = jmf._mlp_dx(jx, jw1, jb1, jw2, jg, None, **kw)
    jdw = jmf._mlp_dw(jx, jw1, jb1, jw2, jg, None, **kw)
    tx, tw1, tb1, tw2, tb2, tg = map(torch.from_numpy, (x, w1, b1, w2, b2, g))
    _close(pmf.fused_mlp_fwd_ref(tx, tw1, tb1, tw2, tb2, approximate), jy,
           F32_TOL)
    _close(pmf.fused_mlp_dx_ref(tx, tw1, tb1, tw2, tg, approximate), jdx,
           F32_TOL)
    pdw = pmf.fused_mlp_dw_ref(tx, tw1, tb1, tw2, tg, approximate)
    for got, ref in zip(pdw, jdw):
        assert got.dtype == torch.float32
        _close(got, ref, F32_TOL)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_matches_reference_vjp(shape, approximate):
    r, h, f = shape
    x, w1, b1, w2, b2, g = _arrays(3 * sum(shape), r, h, f)

    def ref(*a):
        return jmf.fused_mlp_2d(*a, approximate=approximate, interpret=True)

    jy, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    jgrads = vjp(jnp.asarray(g))
    before = dict(pmf.launches)
    prim = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, w1, b1, w2, b2)]
    y = pmf.fused_mlp_2d(*prim, approximate=approximate)
    grads = torch.autograd.grad(y, prim, torch.from_numpy(g))
    assert pmf.launches == before        # CPU tensors launch nothing
    _close(y, jy, F32_TOL)
    for got, want in zip(grads, jgrads):
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(
    map(str, s)))
def test_bf16_io_matches_reference(shape):
    r, h, f = shape
    x, w1, b1, w2, b2, g = _arrays(5 * sum(shape), r, h, f)
    jargs = [jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray,
                                                       (w1, b1, w2, b2))]
    jy, vjp = jax.vjp(lambda *a: jmf.fused_mlp_2d(*a, approximate=True,
                                                  interpret=True), *jargs)
    jdx = vjp(jnp.asarray(g).astype(jnp.bfloat16))[0]
    prim = [torch.from_numpy(x).bfloat16().requires_grad_(True),
            *(torch.from_numpy(a).requires_grad_(True)
              for a in (w1, b1, w2, b2))]
    y = pmf.fused_mlp_2d(*prim, approximate=True)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y, np.asarray(jy, np.float32), BF16_TOL)
    dx = torch.autograd.grad(y, prim[0],
                             torch.from_numpy(g).bfloat16())[0]
    assert dx.dtype == torch.bfloat16
    _close(dx, np.asarray(jdx, np.float32), BF16_TOL)


def _errors(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["3d_x", "w1_rows", "w2_shape", "b1_shape",
                                  "no_tile", "seedless_dropout"])
def test_errors_match_reference(case):
    r, h, f = 8, 16, 64
    x, w1, b1, w2, b2, _ = _arrays(9, r, h, f)
    kw = {}
    if case == "3d_x":
        x = x.reshape(2, 4, h)
    elif case == "w1_rows":
        w1 = w1[:8]
    elif case == "w2_shape":
        w2 = w2[:, :8]
    elif case == "b1_shape":
        b1 = b1[:8]
    elif case == "no_tile":
        f = 520
        x, w1, b1, w2, b2, _ = _arrays(9, r, h, f)
    else:
        kw = dict(dropout_p=0.1)
    jerr = _errors(jmf.fused_mlp_2d, *map(jnp.asarray, (x, w1, b1, w2, b2)),
                   interpret=True, **kw)
    perr = _errors(pmf.fused_mlp_2d, *map(torch.from_numpy,
                                          (x, w1, b1, w2, b2)), **kw)
    assert jerr is not None and perr == jerr


# ---------------------------------------------------------------------------
# dropout (the keep-mask epilogue of kernels 4-6)
# ---------------------------------------------------------------------------

DROP_SEED = (0x9E3779B9, 0x80000001)   # one generator key; words above 2^31
DROP_SHAPE = (600, 32, 64)              # block_r 256: three row blocks
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _drop_inputs(seed, dtype_name):
    """The numpy arrays, and x and g in the dtype for each package (the
    weights stay f32: ``fused_mlp_2d`` casts them to x's dtype)."""
    r, h, f = DROP_SHAPE
    arrays = _arrays(seed, r, h, f)
    tdt, jdt, tol = DTYPES[dtype_name]
    x, w1, b1, w2, b2, g = arrays
    jargs = [jnp.asarray(x).astype(jdt), *map(jnp.asarray, (w1, b1, w2, b2))]
    targs = [torch.from_numpy(x).to(tdt),
             *map(torch.from_numpy, (w1, b1, w2, b2))]
    return jargs, targs, g, tol


def _ref_dropout(approximate, p, seed=DROP_SEED):
    def ref(*a):
        return jmf.fused_mlp_2d(*a, approximate=approximate, dropout_p=p,
                                dropout_seed=jnp.asarray(seed, jnp.uint32),
                                interpret=True)
    return ref


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def test_dropout_row_tile_is_the_references():
    r, h, f = DROP_SHAPE
    for tdt, jdt, _ in DTYPES.values():
        assert pmf.mlp_blocks(r, h, f, dtype=tdt)[0] == 256
        assert jmf.mlp_blocks(r, h, f, dtype=jdt)[0] == 256


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_forward_matches_reference(p, approximate, dtype):
    """y = dropout(gelu(x·W1 + b1)·W2 + b2) against the reference's
    interpret-mode kernel from the same key: the values within the
    tolerance, the zeros element for element."""
    jargs, targs, _, tol = _drop_inputs(20 + int(10 * p), dtype)
    jy = _ref_dropout(approximate, p)(*jargs)
    y = pmf.fused_mlp_2d(*targs, approximate=approximate, dropout_p=p,
                         dropout_seed=DROP_SEED)
    assert y.dtype == targs[0].dtype
    _close(y, _np(jy), tol)
    np.testing.assert_array_equal(_np(y) == 0, _np(jy) == 0)
    assert 0 < int((y == 0).sum()) < y.numel()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_backward_matches_reference_vjp(p, approximate, dtype):
    """dx, dW1, db1, dW2 and db2 through autograd against the reference's
    ``jax.vjp`` of the same call, the mask regenerated from the key on
    both sides. In f32 also with g nonzero in one row of the ragged last
    row block only: dW2 = actᵀ·(masked g) and db2 are then 0 exactly in
    the columns the mask drops in that row, in both packages."""
    jargs, targs, g, tol = _drop_inputs(40 + int(10 * p), dtype)
    tdt, jdt, _ = DTYPES[dtype]
    ref = _ref_dropout(approximate, p)
    gs = [g]
    if dtype == "float32":
        one_row = np.zeros_like(g)
        one_row[555] = g[555]
        gs.append(one_row)
    for cot in gs:
        _, vjp = jax.vjp(ref, *jargs)
        jgrads = vjp(jnp.asarray(cot).astype(jdt))
        prim = [t.clone().requires_grad_(True) for t in targs]
        y = pmf.fused_mlp_2d(*prim, approximate=approximate, dropout_p=p,
                             dropout_seed=DROP_SEED)
        grads = torch.autograd.grad(y, prim, torch.from_numpy(cot).to(tdt))
        for got, want in zip(grads, jgrads):
            _close(got, _np(want), tol)
    # the last cotangent (one row in f32): dW2's and db2's zeros
    key = pfa.DropKey(p, *DROP_SEED, 256, DROP_SHAPE[1])
    if dtype == "float32":
        dropped = ~pnf.row_keep_ref(key, torch.from_numpy(g))[555].numpy()
        np.testing.assert_array_equal(_np(grads[4]) == 0, dropped)
        np.testing.assert_array_equal(_np(jgrads[4]) == 0, dropped)
        np.testing.assert_array_equal(_np(grads[3]) == 0, _np(jgrads[3]) == 0)
        assert (_np(grads[3]) == 0).all(0).tolist() == dropped.tolist()


@pytest.mark.parametrize("shape,block_r", [((4096, 2048, 8192), 32),
                                           ((1024, 768, 3072), 16)],
                         ids=["r4096", "r1024"])
def test_dropout_mask_at_table_row_tiles(shape, block_r):
    """The tuning table's fused_mlp entries set block_r in bf16 (32 and 16
    here, not the heuristic's 128 and 256): the port's mask at that tile
    against the reference's ``_keep_mask`` (interpret mode), row block by
    row block, at two seeds; the MLP itself is not run."""
    r, h, f = shape
    assert pmf.mlp_blocks(r, h, f, dtype=torch.bfloat16)[0] == block_r
    assert jmf.mlp_blocks(r, h, f, dtype=jnp.bfloat16)[0] == block_r
    zero = jnp.int32(0)
    for seed in (DROP_SEED, (7, 0xFFFFFFFF)):
        key = pfa.DropKey(0.1, *seed, block_r, h)
        keep = pnf.row_keep_ref(key, torch.empty(r, h)).numpy()
        seeds = jmf._canonical_seeds(jnp.asarray(seed, jnp.uint32))
        jkeep = np.concatenate([np.asarray(jfa._keep_mask(
            seeds, jnp.int32(i), zero, zero, (block_r, h), 0.1, True))
            for i in range(r // block_r)])
        np.testing.assert_array_equal(keep, jkeep)


def test_dropout_check_rejects_a_key_by_the_cuda_row_block():
    """A planted fault: the port's forward op keyed by the CUDA kernels'
    128-row block in place of the reference's 256 draws a self-consistent
    mask that the comparison with the reference rejects."""
    jargs, targs, _, _ = _drop_inputs(60, "float32")
    jy = _np(_ref_dropout(True, 0.1)(*jargs))
    x, w1, b1, w2, b2 = targs
    wrong = _np(pmf.fused_mlp_fwd(x, w1, b1, w2, b2, True, 0.1,
                                  *DROP_SEED, 128))
    assert ((wrong == 0) != (jy == 0)).sum() > 0
    with pytest.raises(AssertionError):
        _close(wrong, jy, F32_TOL)
    # rows of the first 128-row block draw the same bits in both keys
    np.testing.assert_array_equal(wrong[:128] == 0, jy[:128] == 0)


def test_dropout_determinism_and_keep_rate():
    """The same key gives the same bits; another key another mask; the
    kept share within 4 sigma of 1 - p (as the reference's
    ``test_mlp_dropout_keep_rate_and_determinism``)."""
    _, targs, _, _ = _drop_inputs(70, "float32")
    p = 0.3

    def run(seed):
        return pmf.fused_mlp_2d(*targs, approximate=True, dropout_p=p,
                                dropout_seed=seed)

    a, b, c = run(DROP_SEED), run(DROP_SEED), run((1, 2))
    assert torch.equal(a, b)
    assert not torch.equal(a == 0, c == 0)
    kept = float((a != 0).double().mean())
    sigma = (p * (1 - p) / a.numel()) ** 0.5
    assert abs(kept - (1 - p)) <= 4 * sigma


def test_eligibility_matches_reference_mlp_blocks():
    for r in (1, 37, 256, 8192):
        for h in (32, 96, 2048):
            for f in (64, 100, 320, 512, 520, 640, 1000, 1024, 3000, 8192):
                assert pmf.mlp_eligible(r, h, f) == (
                    jmf.mlp_blocks(r, h, f) is not None), (r, h, f)


@pytest.fixture
def flags():
    """FLAGS_fused_mlp (and the reference's interpret flag) restored."""
    old = (jax_get_flag("fused_mlp"), jax_get_flag("fused_mlp_interpret"),
           pt_get_flag("fused_mlp"))
    yield
    paddle.set_flags({"FLAGS_fused_mlp": old[0],
                      "FLAGS_fused_mlp_interpret": old[1]})
    pt_set_flags({"FLAGS_fused_mlp": old[2]})


@pytest.mark.parametrize("route", ["fused", "no_bias", "flag_off",
                                   "no_tile"])
def test_functional_routes_and_last_mlp_path(route, flags):
    r, h, f = 6, 16, 520 if route == "no_tile" else 64
    x, w1, b1, w2, b2, _ = _arrays(11, r, h, f)
    x = x.reshape(2, 3, h)
    if route == "no_bias":
        b2 = None
    on = route != "flag_off"
    paddle.set_flags({"FLAGS_fused_mlp": on,
                      "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_mlp": on})
    jmlp._DENSE_FALLBACK_WARNED = pmlp._DENSE_FALLBACK_WARNED = False
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jy = JF.fused_mlp(paddle.to_tensor(x), paddle.to_tensor(w1),
                          paddle.to_tensor(b1),
                          paddle.to_tensor(w2),
                          None if b2 is None else paddle.to_tensor(b2),
                          approximate=True)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        py = PF.fused_mlp(torch.from_numpy(x), torch.from_numpy(w1),
                          torch.from_numpy(b1), torch.from_numpy(w2),
                          None if b2 is None else torch.from_numpy(b2),
                          approximate=True)
    want = {"fused": ("fused_mlp/interpret", "fused_mlp/plain")}.get(
        route, ("dense", "dense"))
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == want
    assert py.shape == x.shape
    _close(py, np.asarray(jy.numpy()), F32_TOL)
    # the reference warns once when the fused route was asked for but the
    # arguments take the dense one; so does the port
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    PF.reset_last_mlp_path()
    assert PF.last_mlp_path() is None


@pytest.mark.parametrize("route", ["fused", "flag_off"])
def test_functional_dropout_matches_reference(route, flags):
    """fused_mlp with dropout 0.1 while training, both generators seeded
    alike: the fused route (the kernels' keep-mask; the reference's
    interpret mode against the port's plain versions) and the dense route
    (the reference's mask on the output) give the reference's values and
    zeros, each taking one generator split; eval mode takes none."""
    on = route == "fused"
    paddle.set_flags({"FLAGS_fused_mlp": on, "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_mlp": on})
    r, h, f = DROP_SHAPE
    x, w1, b1, w2, b2, _ = _arrays(12, r, h, f)
    x = x.reshape(2, r // 2, h)
    targs = list(map(torch.from_numpy, (x, w1, b1, w2, b2)))
    paddle.seed(6)
    pt_seed(6)
    jy = JF.fused_mlp(*map(paddle.to_tensor, (x, w1, b1, w2, b2)),
                      dropout_rate=0.1)
    y = PF.fused_mlp(*targs, dropout_rate=0.1)
    want = ("fused_mlp/interpret", "fused_mlp/plain") if on else ("dense",
                                                                  "dense")
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == want
    assert y.shape == x.shape
    _close(y, np.asarray(jy.numpy()), F32_TOL)
    np.testing.assert_array_equal(y.numpy() == 0,
                                  np.asarray(jy.numpy()) == 0)
    assert int((y == 0).sum()) > 0
    state = pgen.default_generator.get_state().numpy()
    np.testing.assert_array_equal(
        state, np.asarray(jgen.default_generator.get_state()))
    fresh = pgen.Generator(6)
    fresh.split_key()
    np.testing.assert_array_equal(state, fresh.get_state().numpy())
    y_eval = PF.fused_mlp(*targs, dropout_rate=0.1, training=False)
    np.testing.assert_array_equal(
        pgen.default_generator.get_state().numpy(), state)
    assert int((y_eval == 0).sum()) == 0


def test_ctypes_signatures_match_the_cuda_source():
    """The kernels build only on a card; their C entry points' parameters
    (pointers, ints, and the dropout key's unsigned words and float) must
    match the ctypes argument types here."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(pmf.__file__).parent / "csrc" / "fused_mlp.cu").read_text()
    for name, argtypes in pmf._MLP_ARGTYPES.items():
        for suffix in ("f32", "bf16"):
            m = re.search(rf"int {name}_{suffix}\(([^)]*)\)", src)
            assert m is not None, f"{name}_{suffix}"
            kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float
                     if "float" in p else ctypes.c_uint if "unsigned" in p
                     else ctypes.c_int for p in m.group(1).split(",")]
            assert kinds == argtypes, f"{name}_{suffix}"
