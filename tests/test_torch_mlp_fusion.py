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
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import mlp_fusion as jmf
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import mlp as jmlp
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import mlp_fusion as pmf
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


def test_dropout_raises_naming_a6():
    x, w1, b1, w2, b2, _ = map(torch.from_numpy, _arrays(10, 8, 16, 64))
    with pytest.raises(NotImplementedError, match="A6"):
        pmf.fused_mlp_2d(x, w1, b1, w2, b2, dropout_p=0.1,
                         dropout_seed=torch.tensor([1, 2]))


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
def test_functional_dropout_raises(route, flags):
    """fused_mlp with dropout while training: the fused route (the dropout
    epilogue of kernels 4-6) raises naming ROADMAP A6c; the dense route
    applies the reference's mask to the output, from the same generator
    seed; eval mode runs either route."""
    pt_set_flags({"FLAGS_fused_mlp": route == "fused"})
    x, w1, b1, w2, b2, _ = _arrays(12, 6, 16, 64)
    tx, tw1, tb1, tw2, tb2 = map(torch.from_numpy, (x, w1, b1, w2, b2))
    if route == "fused":
        with pytest.raises(NotImplementedError, match="A6c"):
            PF.fused_mlp(tx, tw1, tb1, tw2, tb2, dropout_rate=0.1)
    else:
        paddle.set_flags({"FLAGS_fused_mlp": False})
        paddle.seed(6)
        pt_seed(6)
        jy = JF.fused_mlp(*map(paddle.to_tensor, (x, w1, b1, w2, b2)),
                          dropout_rate=0.1)
        y = PF.fused_mlp(tx, tw1, tb1, tw2, tb2, dropout_rate=0.1)
        assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == ("dense",
                                                              "dense")
        _close(y, np.asarray(jy.numpy()), F32_TOL)
        np.testing.assert_array_equal(y.numpy() == 0,
                                      np.asarray(jy.numpy()) == 0)
    PF.fused_mlp(tx, tw1, tb1, tw2, tb2, dropout_rate=0.1, training=False)


def test_ctypes_signatures_match_the_cuda_source():
    """The kernels build only on a card; their C entry points' parameters
    (pointers and ints) must match the ctypes argument types here."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(pmf.__file__).parent / "csrc" / "fused_mlp.cu").read_text()
    for name, argtypes in pmf._MLP_ARGTYPES.items():
        for suffix in ("f32", "bf16"):
            m = re.search(rf"int {name}_{suffix}\(([^)]*)\)", src)
            assert m is not None, f"{name}_{suffix}"
            kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                     for p in m.group(1).split(",")]
            assert kinds == argtypes, f"{name}_{suffix}"
