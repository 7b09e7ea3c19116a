"""The port's fused SwiGLU MLP against the JAX reference's Pallas kernels.

The reference runs as its own tests run it on the CPU:
``fused_swiglu_2d(..., interpret=True)`` (its forward kernel) and
``jax.vjp`` through it (its dX and dW kernels, in interpret mode at the
tiles ``mlp_blocks`` picks). The port's plain versions
(``fused_swiglu_fwd_ref``, ``fused_swiglu_dx_ref``, ``fused_swiglu_dw_ref``)
and ``fused_swiglu_2d`` with autograd (the custom ops take the plain
versions for CPU tensors) see the same numpy inputs.

Tolerances:
- f32: 2e-5 of each output's largest magnitude, the same f32 arithmetic
  in other summation orders (the reference sums over its ffn tiles,
  torch over whole rows).
- bf16 I/O: one bf16 unit in the last place of the output's largest
  magnitude (2^-8 of it): both round the same f32 values; a sum lying on
  a rounding boundary may round the other way.
"""
import ctypes
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import mlp_fusion as jmf
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import mlp as jmlp
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import mlp as pmlp

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -8
# (r, h, f): a tile of rows; ragged rows with f <= 512 not a multiple of
# 128 (a ragged ffn tile); f a multiple of 128 over several ffn tiles
SHAPES = [(48, 32, 64), (37, 32, 320), (24, 64, 1024)]


def _arrays(seed, r, h, f, scale=0.3):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    # x, wg, wu, wd, g
    return (n(r, h), n(h, f, s=scale), n(h, f, s=scale), n(f, h, s=scale),
            n(r, h))


def _close(got, ref, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"error {err} of the largest |ref| > {tol}"


def _ref_vjp(x, wg, wu, wd, g):
    """The reference's y and (dx, dwg, dwu, dwd) through its Pallas
    kernels in interpret mode."""
    y, vjp = jax.vjp(lambda *a: jmf.fused_swiglu_2d(*a, interpret=True),
                     *map(jnp.asarray, (x, wg, wu, wd)))
    return y, vjp(jnp.asarray(g))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_pallas_kernels(shape):
    r, h, f = shape
    x, wg, wu, wd, g = _arrays(sum(shape), r, h, f)
    jy, (jdx, jdwg, jdwu, jdwd) = _ref_vjp(x, wg, wu, wd, g)
    tx, twg, twu, twd, tg = map(torch.from_numpy, (x, wg, wu, wd, g))
    _close(pmf.fused_swiglu_fwd_ref(tx, twg, twu, twd), jy, F32_TOL)
    _close(pmf.fused_swiglu_dx_ref(tx, twg, twu, twd, tg), jdx, F32_TOL)
    pdw = pmf.fused_swiglu_dw_ref(tx, twg, twu, twd, tg)
    for got, ref in zip(pdw, (jdwg, jdwu, jdwd)):
        assert got.dtype == torch.float32
        _close(got, ref, F32_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_matches_reference_vjp(shape):
    r, h, f = shape
    x, wg, wu, wd, g = _arrays(3 * sum(shape), r, h, f)
    jy, jgrads = _ref_vjp(x, wg, wu, wd, g)
    before = dict(pmf.launches)
    prim = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu, wd)]
    y = pmf.fused_swiglu_2d(*prim)
    grads = torch.autograd.grad(y, prim, torch.from_numpy(g))
    assert pmf.launches == before        # CPU tensors launch nothing
    _close(y, jy, F32_TOL)
    for got, want in zip(grads, jgrads):
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(
    map(str, s)))
def test_bf16_io_matches_reference(shape):
    """x and g in bf16, the weights f32 (cast to x's dtype inside, as the
    reference does): y and dx in bf16 within one bf16 unit; the weight
    gradients come out in the weights' dtype."""
    r, h, f = shape
    x, wg, wu, wd, g = _arrays(5 * sum(shape), r, h, f)
    jy, vjp = jax.vjp(lambda *a: jmf.fused_swiglu_2d(*a, interpret=True),
                      jnp.asarray(x).astype(jnp.bfloat16),
                      *map(jnp.asarray, (wg, wu, wd)))
    jgrads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    prim = [torch.from_numpy(x).bfloat16().requires_grad_(True),
            *(torch.from_numpy(a).requires_grad_(True) for a in (wg, wu, wd))]
    y = pmf.fused_swiglu_2d(*prim)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y, np.asarray(jy, np.float32), BF16_TOL)
    grads = torch.autograd.grad(y, prim, torch.from_numpy(g).bfloat16())
    assert [t.dtype for t in grads] == [torch.bfloat16] + [torch.float32] * 3
    assert [str(t.dtype) for t in jgrads] == ["bfloat16"] + ["float32"] * 3
    _close(grads[0], np.asarray(jgrads[0], np.float32), BF16_TOL)


def _errors(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["3d_x", "gate_rows", "up_shape",
                                  "down_shape", "no_tile"])
def test_errors_match_reference(case):
    r, h, f = 8, 16, 64
    x, wg, wu, wd, _ = _arrays(9, r, h, f)
    if case == "3d_x":
        x = x.reshape(2, 4, h)
    elif case == "gate_rows":
        wg = wg[:8]
    elif case == "up_shape":
        wu = wu[:, :32]
    elif case == "down_shape":
        wd = wd[:, :8]
    else:
        x, wg, wu, wd, _ = _arrays(9, r, h, 520)
    jerr = _errors(jmf.fused_swiglu_2d, *map(jnp.asarray, (x, wg, wu, wd)),
                   interpret=True)
    perr = _errors(pmf.fused_swiglu_2d, *map(torch.from_numpy,
                                             (x, wg, wu, wd)))
    assert jerr is not None and perr == jerr


@pytest.fixture
def flags():
    """FLAGS_fused_mlp (and the reference's interpret flag) restored."""
    old = (jax_get_flag("fused_mlp"), jax_get_flag("fused_mlp_interpret"),
           pt_get_flag("fused_mlp"))
    yield
    paddle.set_flags({"FLAGS_fused_mlp": old[0],
                      "FLAGS_fused_mlp_interpret": old[1]})
    pt_set_flags({"FLAGS_fused_mlp": old[2]})


@pytest.mark.parametrize("route", ["fused", "flag_off", "no_tile"])
def test_functional_routes_and_last_mlp_path(route, flags):
    r, h, f = 6, 16, 520 if route == "no_tile" else 64
    x, wg, wu, wd, _ = _arrays(11, r, h, f)
    x = x.reshape(2, 3, h)
    on = route != "flag_off"
    paddle.set_flags({"FLAGS_fused_mlp": on,
                      "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_mlp": on})
    jmlp._DENSE_FALLBACK_WARNED = pmlp._DENSE_FALLBACK_WARNED = False
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jy = JF.fused_swiglu(*map(paddle.to_tensor, (x, wg, wu, wd)))
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        py = PF.fused_swiglu(*map(torch.from_numpy, (x, wg, wu, wd)))
    want = {"fused": ("fused_swiglu/interpret", "fused_swiglu/plain")}.get(
        route, ("dense", "dense"))
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == want
    assert py.shape == x.shape
    _close(py, np.asarray(jy.numpy()), F32_TOL)
    # the reference warns once when the fused route was asked for but the
    # arguments take the dense one; so does the port
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]


def test_ctypes_signatures_match_the_cuda_source():
    """The kernels build only on a card; the SwiGLU C entry points'
    parameters (pointers and ints) must match the ctypes argument types."""
    src = (Path(pmf.__file__).parent / "csrc" / "fused_mlp.cu").read_text()
    for name in ("fused_swiglu_fwd", "fused_swiglu_bwd"):
        for suffix in ("f32", "bf16"):
            m = re.search(rf"int {name}_{suffix}\(([^)]*)\)", src)
            assert m is not None, f"{name}_{suffix}"
            kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                     for p in m.group(1).split(",")]
            assert kinds == pmf._MLP_ARGTYPES[name], f"{name}_{suffix}"


def test_launch_counts_name_each_tpu_kernel():
    """One count per TPU kernel: the forward and the backward call's dX
    and dW parts, zero until a CUDA tensor launches them."""
    assert {k for k in pmf.launches if "swiglu" in k} == {
        "fused_swiglu_fwd", "fused_swiglu_dx", "fused_swiglu_dw"}
