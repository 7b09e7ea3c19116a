"""The port's fused projection-LayerNorm (TPU kernels 10, 11) and
``fused_attn_proj_residual_layer_norm`` against the JAX reference.

The reference runs as its own tests run it on the CPU:
``fused_proj_ln_2d(..., interpret=True)`` and ``jax.vjp`` through it (its
forward and backward Pallas kernels in interpret mode at the tiles
``mlp_blocks`` picks, ragged R padded there; dx, dW and db as its f32
products outside the kernel). The functional runs with
``FLAGS_fused_mlp`` on and ``FLAGS_fused_mlp_interpret`` on (the
reference's kernels) or with the flag off (the dense projection and
add → LN close in both packages); every flag is restored. The port's
custom ops take their plain versions (``fused_proj_ln_fwd_ref``,
``fused_proj_ln_bwd_ref``) for CPU tensors.

Tolerances:
- f32: 1e-5 of each output's largest magnitude: the same f32 arithmetic
  in other summation orders (the reference accumulates the projection
  over its k tiles and dgamma/dbeta over its row tiles).
- bf16 I/O: one bf16 unit in the last place of the output's largest
  magnitude (2^-8 of it) for y and the bf16 gradients; the f32 outputs
  (dgamma, dbeta, and dx, dW, db before their casts) at 1e-5.

The dropout epilogue runs the same way with the same seed pair in both
packages, the port's plain hash keyed by the reference's row tile
(``mlp_blocks``); dp's zeros are the mask, exactly.
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
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.core import generator as jgen
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import mlp as pmlp

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
# (r, hin, hout): Hin below and above Hout; ragged R (37 and 100, padded
# by the reference to its row tile); one k tile, and five (640 over the
# reference's 128-wide k tiles)
SHAPES = [(64, 128, 96), (37, 96, 160), (100, 640, 128)]


def _arrays(seed, r, hin, hout):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    # x, w, b, residual, ln_w, ln_b, g
    return (n(r, hin), n(hin, hout, s=hin ** -0.5), n(hout, s=0.2),
            n(r, hout), n(hout, s=0.2, m=1.0), n(hout, s=0.2), n(r, hout))


def _close(got, ref, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"error {err} of the largest |ref| > {tol}"


def _ref(arrays, eps, dtype=jnp.float32, **drop):
    x, w, b, res, lnw, lnb, g = arrays
    args = [jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
            jnp.asarray(b), jnp.asarray(res).astype(dtype), jnp.asarray(lnw),
            jnp.asarray(lnb)]
    y, vjp = jax.vjp(lambda *a: jmf.fused_proj_ln_2d(*a, eps=eps,
                                                     interpret=True, **drop),
                     *args)
    return y, vjp(jnp.asarray(g).astype(dtype))


def _port(arrays, eps, dtype=torch.float32, **drop):
    x, w, b, res, lnw, lnb, g = arrays
    leaves = [torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
              torch.from_numpy(b), torch.from_numpy(res).to(dtype),
              torch.from_numpy(lnw), torch.from_numpy(lnb)]
    for t in leaves:
        t.requires_grad_(True)
    y = pmf.fused_proj_ln_2d(*leaves, eps=eps, **drop)
    y.backward(torch.from_numpy(g).to(dtype))
    return y, [t.grad for t in leaves]


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_every_gradient_match_pallas_kernels(shape, eps):
    arrays = _arrays(sum(shape), *shape)
    jy, jgrads = _ref(arrays, eps)
    before = dict(pmf.launches)
    y, grads = _port(arrays, eps)
    assert pmf.launches == before
    assert before["fused_proj_ln_fwd"] == before["fused_proj_ln_bwd"] == 0
    _close(y, jy, F32_TOL)
    # dx, dW, db, dres, dgamma, dbeta
    for got, ref in zip(grads, jgrads):
        _close(got, ref, F32_TOL)


def test_bf16_io_matches_pallas_kernels():
    arrays = _arrays(7, 48, 128, 128)
    jy, jgrads = _ref(arrays, 1e-12, jnp.bfloat16)
    y, grads = _port(arrays, 1e-12, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    _close(y, jy, BF16_TOL)
    for got, ref in zip(grads, jgrads):
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
        _close(got, ref, BF16_TOL if got.dtype == torch.bfloat16
               else F32_TOL)


def test_plain_versions_are_the_ops():
    x, w, b, res, lnw, lnb, g = map(torch.from_numpy,
                                    _arrays(3, 21, 64, 32))
    y, mean, rstd = torch.ops.paddle_tpu_torch.fused_proj_ln_fwd(
        x, w, b, res, lnw, lnb, 1e-5)
    ry, rmean, rrstd = pmf.fused_proj_ln_fwd_ref(x, w, b, res, lnw, lnb,
                                                 1e-5)
    assert torch.equal(y, ry) and torch.equal(mean, rmean)
    assert torch.equal(rstd, rrstd) and mean.shape == (21,)
    got = torch.ops.paddle_tpu_torch.fused_proj_ln_bwd(x, w, b, res, lnw,
                                                       mean, rstd, g)
    ref = pmf.fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean, rstd, g)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert all(t.dtype == torch.float32 for t in got)
    assert torch.equal(got[0], got[1])     # dz == dp without dropout


def test_reference_errors_keep_their_messages():
    x, w, b, res, lnw, lnb, _ = _arrays(1, 8, 16, 24)
    cases = [
        (ValueError, lambda a: (a(x[None]), a(w), a(b), a(res), a(lnw),
                                a(lnb)), {}),
        (ValueError, lambda a: (a(x), a(w[:8]), a(b), a(res), a(lnw),
                                a(lnb)), {}),
        (NotImplementedError, lambda a: (a(x), a(w), None, a(res), a(lnw),
                                         a(lnb)), {}),
        (ValueError, lambda a: (a(x), a(w), a(b), a(res[:4]), a(lnw),
                                a(lnb)), {}),
        (ValueError, lambda a: (a(x), a(w), a(b[:3]), a(res), a(lnw),
                                a(lnb)), {}),
        (ValueError, lambda a: (a(x), a(w), a(b), a(res), a(lnw), a(lnb)),
         dict(dropout_p=0.1)),
    ]
    for exc, args, kw in cases:
        with pytest.raises(exc) as jerr:
            jmf.fused_proj_ln_2d(*args(jnp.asarray), interpret=True, **kw)
        with pytest.raises(exc) as terr:
            pmf.fused_proj_ln_2d(*args(torch.from_numpy), **kw)
        assert str(terr.value) == str(jerr.value)
    # dropout is ported: a seed pair keys the mask, rate 0 is no dropout
    args = list(map(torch.from_numpy, (x, w, b, res, lnw, lnb)))
    y0 = pmf.fused_proj_ln_2d(*args)
    assert torch.equal(pmf.fused_proj_ln_2d(*args, dropout_p=0.0,
                                            dropout_seed=[1, 2]), y0)
    y1 = pmf.fused_proj_ln_2d(*args, dropout_p=0.1,
                              dropout_seed=torch.tensor([1, 2]))
    assert torch.isfinite(y1).all() and not torch.equal(y1, y0)


DROP_SEED = np.array([0xABCDEF01, 0x80000000], np.uint32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dropout_forward_and_every_gradient_match_pallas_kernels(shape):
    """fused_proj_ln_2d with dropout 0.1 and autograd against the
    reference's kernels in interpret mode, same seed pair: the mask keyed
    by mlp_blocks's row tile (ragged R padded to it by the reference); dx,
    dW and db come from the dropped dp, dres from dz."""
    arrays = _arrays(sum(shape) + 1, *shape)
    jy, jgrads = _ref(arrays, 1e-12, dropout_p=0.1,
                      dropout_seed=jnp.asarray(DROP_SEED))
    y, grads = _port(arrays, 1e-12, dropout_p=0.1,
                     dropout_seed=DROP_SEED.tolist())
    _close(y, jy, F32_TOL)
    for got, ref in zip(grads, jgrads):
        _close(got, ref, F32_TOL)


def test_dropout_ops_regenerate_the_mask():
    """The backward op regenerates the forward's mask from its key: dp =
    where(keep, dz / (1 - p), 0), dz undropped; dp's zeros are the mask's
    (row tile 8 by Hout)."""
    x, w, b, res, lnw, lnb, g = map(torch.from_numpy, _arrays(5, 21, 64, 32))
    drop = (0.1, 2 ** 32 - 3, 99, 8)
    y, mean, rstd = torch.ops.paddle_tpu_torch.fused_proj_ln_fwd(
        x, w, b, res, lnw, lnb, 1e-5, *drop)
    ry, _, _ = pmf.fused_proj_ln_fwd_ref(
        x, w, b, res, lnw, lnb, 1e-5, pfa.DropKey(*drop, 32))
    assert torch.equal(y, ry)
    dz, dp, dg, dbeta = torch.ops.paddle_tpu_torch.fused_proj_ln_bwd(
        x, w, b, res, lnw, mean, rstd, g, *drop)
    key = pfa.DropKey(*drop, 32)
    keep = pnf.row_keep_ref(key, dz)
    assert torch.equal(dp, torch.where(keep, dz * key.inv_f32("cpu"), 0.0))
    assert torch.equal(dp == 0, ~keep)
    with pytest.raises(ValueError, match="reference's tile"):
        pmf.fused_proj_ln_fwd(x, w, b, res, lnw, lnb, 1e-5, 0.1, 1, 2, 0)


def test_cuda_route_raises_when_the_kernels_cannot_build(monkeypatch):
    """No fallback: without the library the kernel route raises."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pmf._pl_lib.cache_clear()
    try:
        x, w, b, res, lnw, lnb, g = map(torch.from_numpy,
                                        _arrays(2, 8, 16, 16))
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._proj_ln_fwd_cuda(x, w, b, res, lnw, lnb, 1e-5)
        with pytest.raises(RuntimeError, match="nvcc"):
            pmf._proj_ln_bwd_cuda(x, w, b, res, lnw, torch.zeros(8),
                                  torch.ones(8), g)
    finally:
        pmf._pl_lib.cache_clear()
    assert pmf.launches["fused_proj_ln_fwd"] == 0


def test_ctypes_signatures_match_the_cuda_source():
    src = (Path(pmf.__file__).parent / "csrc" / "proj_ln.cu").read_text()
    for name, argtypes in pmf._PL_ARGTYPES.items():
        m = re.search(rf"int {name}_##SUFFIX\(([^)]*)\)", src)
        assert m is not None, name
        params = m.group(1).replace("\\", "").split(",")
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float
                 if "float" in p else ctypes.c_uint if "unsigned" in p
                 else ctypes.c_int for p in params]
        assert kinds == argtypes, name
        for suffix in ("f32", "bf16"):
            macro = {"proj_ln_fwd": "PL_FWD", "proj_ln_bwd": "PL_BWD"}[name]
            assert f"{macro}({suffix}," in src


# ---------------------------------------------------------------------------
# fused_attn_proj_residual_layer_norm
# ---------------------------------------------------------------------------

@pytest.fixture
def mlp_flags():
    old = (jax_get_flag("fused_mlp"), jax_get_flag("fused_mlp_interpret"),
           pt_get_flag("fused_mlp"))
    yield
    paddle.set_flags({"FLAGS_fused_mlp": old[0],
                      "FLAGS_fused_mlp_interpret": old[1]})
    pt_set_flags({"FLAGS_fused_mlp": old[2]})


@pytest.mark.parametrize("route", ["fused", "flag_off", "no_bias"])
def test_functional_routes_as_the_reference(route, mlp_flags, monkeypatch):
    fused = route != "flag_off"
    paddle.set_flags({"FLAGS_fused_mlp": fused,
                      "FLAGS_fused_mlp_interpret": fused})
    pt_set_flags({"FLAGS_fused_mlp": fused})
    monkeypatch.setattr(pmlp, "_DENSE_FALLBACK_WARNED", False)
    monkeypatch.setattr(jmlp, "_DENSE_FALLBACK_WARNED", False)
    x, w, b, res, lnw, lnb, _ = _arrays(4, 24, 64, 64)
    x, res = x.reshape(2, 12, 64), res.reshape(2, 12, 64)
    b = None if route == "no_bias" else b
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jy = JF.fused_attn_proj_residual_layer_norm(
            paddle.to_tensor(x), paddle.to_tensor(w),
            None if b is None else paddle.to_tensor(b), paddle.to_tensor(res),
            paddle.to_tensor(lnw), paddle.to_tensor(lnb), ln_epsilon=1e-12)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        y = PF.fused_attn_proj_residual_layer_norm(
            torch.from_numpy(x), torch.from_numpy(w),
            None if b is None else torch.from_numpy(b), torch.from_numpy(res),
            torch.from_numpy(lnw), torch.from_numpy(lnb), ln_epsilon=1e-12)
    want = {"fused": ("fused_proj_ln/interpret", "fused_proj_ln/plain")}.get(
        route, ("dense", "dense"))
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == want
    if route != "fused":
        # the dense route closes through the norm's own route: the port's
        # fused LN (plain on the CPU) at FLAGS_fused_norm's default; the
        # reference's dense LN, its fused-norm interpret flag being off
        assert PF.last_norm_path() == "fused_adln/plain"
        assert jnorm.last_norm_path() == "dense"
    assert y.shape == res.shape
    _close(y, np.asarray(jy.numpy()), F32_TOL)
    assert [str(m.message) for m in pw] == [str(m.message) for m in jw]
    # dropout 0.1 while training from one seed: one split in both, and the
    # reference's mask on each route (the in-kernel mask on the fused route;
    # on the dense ones the add → LN close's, here through the dense norm
    # in both packages)
    old_norm = pt_get_flag("fused_norm")
    pt_set_flags({"FLAGS_fused_norm": fused and route == "fused"})
    try:
        paddle.seed(8)
        pt_seed(8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jy = JF.fused_attn_proj_residual_layer_norm(
                paddle.to_tensor(x), paddle.to_tensor(w),
                None if b is None else paddle.to_tensor(b),
                paddle.to_tensor(res), paddle.to_tensor(lnw),
                paddle.to_tensor(lnb), dropout_rate=0.1, ln_epsilon=1e-12)
            y = PF.fused_attn_proj_residual_layer_norm(
                torch.from_numpy(x), torch.from_numpy(w),
                None if b is None else torch.from_numpy(b),
                torch.from_numpy(res), torch.from_numpy(lnw),
                torch.from_numpy(lnb), dropout_rate=0.1, ln_epsilon=1e-12)
    finally:
        pt_set_flags({"FLAGS_fused_norm": old_norm})
    assert (jmlp.last_mlp_path(), PF.last_mlp_path()) == want
    _close(y, np.asarray(jy.numpy()), F32_TOL)
    np.testing.assert_array_equal(
        pgen.default_generator.get_state().numpy(),
        np.asarray(jgen.default_generator.get_state()))
