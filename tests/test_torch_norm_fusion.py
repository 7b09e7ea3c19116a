"""The port's fused LayerNorm (TPU kernels 13, 14) and the norm
functionals against the JAX reference.

The reference runs as its own tests run it on the CPU
(tests/test_norm_fusion.py): ``fused_layer_norm_2d(..., interpret=True)``
and ``jax.vjp`` through it (its forward and backward Pallas kernels in
interpret mode, at the row tile its picker gives: ragged R is padded
there). The functionals run with ``FLAGS_fused_norm`` on and
``FLAGS_fused_norm_interpret`` on (the reference's kernels) or with the
flag off (the dense path in both packages); every flag is restored. The
port's custom ops take their plain versions (``fused_ln_fwd_ref``,
``fused_ln_bwd_ref``) for CPU tensors.

Tolerances:
- f32: 1e-5 of each output's largest magnitude: the same f32 arithmetic
  in other summation orders (the reference sums dw and db over its row
  tiles, the plain version over all rows at once).
- bf16 I/O: one bf16 unit in the last place of the output's largest
  magnitude (2^-8 of it): both round the same f32 values, and a value on
  a rounding boundary may round the other way.

The dropout epilogue runs the same way with the same seed pair in both
packages: the reference's interpret-mode keep-mask against the port's
plain hash keyed by the reference's row tile; the masks are compared
exactly (dh's zeros), the values at the tolerances above.
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
from paddle_tpu.kernels import norm_fusion as jnf
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.core import generator as jgen
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import norm as pnorm

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -8
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


def _vid(v):
    return {(False, False): "plain", (True, False): "res",
            (False, True): "bias", (True, True): "res_bias"}[v]


def _arrays(seed, r, hd):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, m=0.0):
        return (m + rng.standard_normal(shape) * s).astype(np.float32)

    # h, residual, lin_bias, weight, bias, g
    return (n(r, hd, s=2.0, m=0.5), n(r, hd), n(hd, s=0.3),
            n(hd, s=0.2, m=1.0), n(hd, s=0.2), n(r, hd))


def _close(got, ref, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"error {err} of the largest |ref| > {tol}"


def _ref(h, w, b, res, lb, g, eps, dtype=jnp.float32, **drop):
    """The reference's y and (dh, dres, dlin_b, dw, db) through its Pallas
    kernels in interpret mode (``drop``: dropout_p, dropout_seed)."""
    args = [jnp.asarray(h).astype(dtype), jnp.asarray(w), jnp.asarray(b),
            None if res is None else jnp.asarray(res).astype(dtype),
            None if lb is None else jnp.asarray(lb)]

    def fn(h, w, b, res, lb):
        return jnf.fused_layer_norm_2d(h, w, b, residual=res, lin_bias=lb,
                                       eps=eps, interpret=True, **drop)

    y, vjp = jax.vjp(fn, *args)
    return y, vjp(jnp.asarray(g).astype(dtype))


def _port(h, w, b, res, lb, g, eps, dtype=torch.float32, **drop):
    th = torch.from_numpy(h).to(dtype).requires_grad_(True)
    tres = (None if res is None
            else torch.from_numpy(res).to(dtype).requires_grad_(True))
    tlb = None if lb is None else torch.from_numpy(lb).requires_grad_(True)
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (w, b))
    y = pnf.fused_layer_norm_2d(th, tw, tb, residual=tres, lin_bias=tlb,
                                eps=eps, **drop)
    y.backward(torch.from_numpy(g).to(dtype))
    return y, (th.grad, tw.grad, tb.grad,
               None if tres is None else tres.grad,
               None if tlb is None else tlb.grad)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("r", [200, 37])
@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
def test_forward_and_backward_match_pallas_kernels(variant, r, eps):
    has_res, has_lb = variant
    h, res, lb, w, b, g = _arrays(r + int(eps < 1e-6), r, 96)
    res = res if has_res else None
    lb = lb if has_lb else None
    jy, (jdh, jdw, jdb, jdres, jdlb) = _ref(h, w, b, res, lb, g, eps)
    before = dict(pnf.launches)
    y, (dh, dw, db, dres, dlb) = _port(h, w, b, res, lb, g, eps)
    assert pnf.launches == before == {"fused_ln_fwd": 0, "fused_ln_bwd": 0,
                                      "fused_bn_fwd": 0, "fused_bn_bwd": 0}
    assert y.dtype == torch.float32
    for got, ref in ((y, jy), (dh, jdh), (dw, jdw), (db, jdb),
                     (dres, jdres), (dlb, jdlb)):
        assert (got is None) == (ref is None)
        if got is not None:
            _close(got, ref, F32_TOL)


@pytest.mark.parametrize("variant", [(False, False), (True, False)],
                         ids=_vid)
def test_bf16_io_matches_pallas_kernels(variant):
    """bf16 h, residual and g (the model's I/O), f32 statistics inside."""
    has_res, _ = variant
    h, res, _, w, b, g = _arrays(5, 70, 128)
    res = res if has_res else None
    jy, (jdh, jdw, jdb, jdres, _) = _ref(h, w, b, res, None, g, 1e-12,
                                         jnp.bfloat16)
    y, (dh, dw, db, dres, _) = _port(h, w, b, res, None, g, 1e-12,
                                     torch.bfloat16)
    assert y.dtype == dh.dtype == torch.bfloat16
    for got, ref in ((y, jy), (dh, jdh), (dres, jdres)):
        if got is not None:
            _close(got, ref, BF16_TOL)
    # the column sums are f32 sums of the same bf16 inputs
    _close(dw, jdw, F32_TOL)
    _close(db, jdb, F32_TOL)


def test_plain_versions_are_the_ops_and_save_the_row_stats():
    h, res, lb, w, b, g = map(torch.from_numpy, _arrays(3, 33, 64))
    y, mean, rstd = torch.ops.paddle_tpu_torch.fused_ln_fwd(h, res, lb, w, b,
                                                            1e-5)
    ry, rmean, rrstd = pnf.fused_ln_fwd_ref(h, res, lb, w, b, 1e-5)
    assert torch.equal(y, ry) and torch.equal(mean, rmean)
    assert torch.equal(rstd, rrstd)
    assert mean.shape == rstd.shape == (33,) and mean.dtype == torch.float32
    dh, dres, dlb, dw, db = torch.ops.paddle_tpu_torch.fused_ln_bwd(
        h, res, lb, w, b, mean, rstd, g)
    dz, rdw, rdb, rdlb = pnf.fused_ln_bwd_ref(h, res, lb, w, mean, rstd, g)
    for got, ref in ((dh, dz), (dres, dz), (dlb, rdlb), (dw, rdw), (db, rdb)):
        assert torch.equal(got, ref)
    none = torch.ops.paddle_tpu_torch.fused_ln_bwd(h, None, None, w, b, mean,
                                                   rstd, g)
    assert none[1] is None and none[2] is None


def test_reference_errors_keep_their_messages():
    h = np.zeros((2, 3, 8), np.float32)
    w = np.ones(8, np.float32)
    for call in (
            lambda m, a: m.fused_layer_norm_2d(a(h), a(w), a(w)),
            lambda m, a: m.fused_layer_norm_2d(a(h[0]), a(w), a(w),
                                               dropout_p=0.1)):
        with pytest.raises(ValueError) as jerr:
            call(jnf, jnp.asarray)
        with pytest.raises(ValueError) as terr:
            call(pnf, torch.from_numpy)
        assert str(terr.value) == str(jerr.value)


@pytest.fixture
def norm_flags():
    old = (jax_get_flag("fused_norm"), jax_get_flag("fused_norm_interpret"),
           pt_get_flag("fused_norm"))
    yield
    paddle.set_flags({"FLAGS_fused_norm": old[0],
                      "FLAGS_fused_norm_interpret": old[1]})
    pt_set_flags({"FLAGS_fused_norm": old[2]})


def _set(fused):
    paddle.set_flags({"FLAGS_fused_norm": fused,
                      "FLAGS_fused_norm_interpret": fused})
    pt_set_flags({"FLAGS_fused_norm": fused})


def test_dropout_raises_naming_a6b(norm_flags):
    """Dropout in the add → LN close is ported on both routes: one
    generator split per call while training (none in eval mode), the
    fused route's in-kernel mask and the dense route's bernoulli mask,
    each the reference's from the same seed (f32, F32_TOL)."""
    h, res, lb, w, b, _ = _arrays(12, 24, 64)
    x, r = h.reshape(2, 12, 64), res.reshape(2, 12, 64)
    for fused in (True, False):
        _set(fused)
        paddle.seed(3)
        pt_seed(3)
        jz = JF.fused_bias_dropout_residual_layer_norm(
            paddle.to_tensor(x), paddle.to_tensor(r),
            bias=paddle.to_tensor(lb), ln_scale=paddle.to_tensor(w),
            ln_bias=paddle.to_tensor(b), dropout_rate=0.1, ln_epsilon=1e-12)
        z = PF.fused_bias_dropout_residual_layer_norm(
            torch.from_numpy(x), torch.from_numpy(r),
            bias=torch.from_numpy(lb), ln_scale=torch.from_numpy(w),
            ln_bias=torch.from_numpy(b), dropout_rate=0.1, ln_epsilon=1e-12)
        assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
            ("fused_adln/interpret", "fused_adln/plain") if fused
            else ("dense", "dense"))
        _close(z, np.asarray(jz.numpy()), F32_TOL)
        state = pgen.default_generator.get_state()
        np.testing.assert_array_equal(
            state.numpy(), np.asarray(jgen.default_generator.get_state()))
        PF.fused_bias_dropout_residual_layer_norm(
            torch.from_numpy(x), torch.from_numpy(r), ln_scale=torch.ones(64),
            ln_bias=torch.zeros(64), dropout_rate=0.1, training=False)
        assert torch.equal(pgen.default_generator.get_state(), state)
    t = torch.from_numpy(h)
    ones = torch.ones(64)
    y0 = pnf.fused_layer_norm_2d(t, ones, ones)
    assert torch.equal(pnf.fused_layer_norm_2d(
        t, ones, ones, dropout_p=0.0, dropout_seed=[1, 2]), y0)
    assert not torch.equal(pnf.fused_layer_norm_2d(
        t, ones, ones, dropout_p=0.1, dropout_seed=[1, 2]), y0)


DROP_SEED = np.array([0xF00DFACE, 12345], np.uint32)


@pytest.mark.parametrize("r", [200, 37])
@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
def test_dropout_forward_and_backward_match_pallas_kernels(variant, r):
    """fused_layer_norm_2d with dropout 0.1 (keyed by the reference's row
    tile, ``ln_block_r``: 128-row tiles at R=200, one padded 40-row tile
    at R=37) and autograd against the reference's kernels in interpret
    mode with the same seed pair; dh is zero exactly where the mask
    drops (the rows dropped in both), dres and the column sums as the
    reference's."""
    has_res, has_lb = variant
    h, res, lb, w, b, g = _arrays(r + 50, r, 96)
    res = res if has_res else None
    lb = lb if has_lb else None
    drop = dict(dropout_p=0.1)
    jy, (jdh, jdw, jdb, jdres, jdlb) = _ref(
        h, w, b, res, lb, g, 1e-12, dropout_seed=jnp.asarray(DROP_SEED),
        **drop)
    y, (dh, dw, db, dres, dlb) = _port(h, w, b, res, lb, g, 1e-12,
                                       dropout_seed=DROP_SEED.tolist(),
                                       **drop)
    for got, ref in ((y, jy), (dh, jdh), (dw, jdw), (db, jdb),
                     (dres, jdres), (dlb, jdlb)):
        assert (got is None) == (ref is None)
        if got is not None:
            _close(got, ref, F32_TOL)
    key = pfa.DropKey(0.1, *map(int, DROP_SEED), pnf.ln_block_r(r, 96), 96)
    keep = pnf.row_keep_ref(key, dh).numpy()
    np.testing.assert_array_equal(np.asarray(jdh) == 0, ~keep)
    np.testing.assert_array_equal(dh.numpy() == 0, ~keep)


def test_dropout_bf16_io_matches_pallas_kernels():
    """bf16 I/O with dropout: the same mask (dh's zeros) and the bf16
    tolerances."""
    h, res, lb, w, b, g = _arrays(15, 70, 128)
    seed = dict(dropout_p=0.1)
    jy, (jdh, jdw, jdb, jdres, jdlb) = _ref(
        h, w, b, res, lb, g, 1e-12, jnp.bfloat16,
        dropout_seed=jnp.asarray(DROP_SEED), **seed)
    y, (dh, dw, db, dres, dlb) = _port(h, w, b, res, lb, g, 1e-12,
                                       torch.bfloat16,
                                       dropout_seed=DROP_SEED.tolist(),
                                       **seed)
    for got, ref in ((y, jy), (dh, jdh), (dres, jdres)):
        _close(got, ref, BF16_TOL)
    for got, ref in ((dw, jdw), (db, jdb), (dlb, jdlb)):
        _close(got, ref, F32_TOL)
    np.testing.assert_array_equal(dh.float().numpy() == 0,
                                  np.asarray(jdh.astype(jnp.float32)) == 0)


def test_dropout_ops_regenerate_the_mask():
    """The backward op takes the forward's key and regenerates its mask:
    dh = where(keep, dz / (1 - p), 0) and dlin_b = Σ dh; without the key
    the backward is the undropped one."""
    h, res, lb, w, b, g = map(torch.from_numpy, _arrays(17, 40, 32))
    drop = (0.1, 7, 2 ** 31 + 7, 16)
    y, mean, rstd = pnf.fused_ln_fwd(h, res, lb, w, b, 1e-5, *drop)
    dh, dres, dlb, dw, db = pnf.fused_ln_bwd(h, res, lb, w, b, mean, rstd, g,
                                             *drop)
    key = pfa.DropKey(drop[0], drop[1], drop[2], drop[3], 32)
    dz, rdw, rdb, rdlb = pnf.fused_ln_bwd_ref(h, res, lb, w, mean, rstd, g,
                                              key)
    keep = pnf.row_keep_ref(key, h)
    assert torch.equal(dh, torch.where(keep, dz * key.inv_f32("cpu"), 0.0))
    assert torch.equal(dres, dz) and torch.equal(dlb, rdlb)
    assert torch.equal(dlb, dh.sum(0)) and torch.equal(dw, rdw)
    plain = pnf.fused_ln_bwd(h, res, lb, w, b, mean, rstd, g)
    assert not torch.equal(plain[0], dh)
    with pytest.raises(ValueError, match="reference's tile"):
        pnf.fused_ln_fwd(h, res, lb, w, b, 1e-5, 0.1, 1, 2, 0)


def test_cuda_route_raises_when_the_kernels_cannot_build(monkeypatch):
    """No fallback: the kernel route without a library raises (here nvcc
    is missing); it never takes the plain version."""
    def no_nvcc():
        raise RuntimeError("paddle_tpu_torch: nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_target",
                        lambda name: Path("/nonexistent") / name)
    pnf._lib.cache_clear()
    try:
        h, w = torch.zeros(4, 8), torch.ones(8)
        with pytest.raises(RuntimeError, match="nvcc"):
            pnf._fwd_cuda(h, None, None, w, w, 1e-5)
        with pytest.raises(RuntimeError, match="nvcc"):
            pnf._bwd_cuda(h, None, None, w, torch.zeros(4), torch.ones(4), h)
    finally:
        pnf._lib.cache_clear()
    assert pnf.launches == {"fused_ln_fwd": 0, "fused_ln_bwd": 0,
                            "fused_bn_fwd": 0, "fused_bn_bwd": 0}


def test_kernel_sources_share_one_header_and_rebuild_on_its_edit(
        tmp_path, monkeypatch):
    """Every CUDA source includes csrc/common.cuh and defines none of what
    it provides; a library's name carries a digest of its source and of
    the header, so an edit of either names a new library (a rebuild)."""
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert [p.name for p in sources] == _build.sources()
    for p in sources:
        text = p.read_text()
        assert '#include "common.cuh"' in text, p.name
        assert "error_string" not in text, p.name
        assert "sum_parts_kernel" not in text, p.name
    for p in [*sources, _build.CSRC / "common.cuh"]:
        (tmp_path / p.name).write_text(p.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("norm_fusion.cu")
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = _build._target("norm_fusion.cu")
    src = tmp_path / "norm_fusion.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after_source = _build._target("norm_fusion.cu")
    assert len({before, after_header, after_source}) == 3


def test_ctypes_signatures_match_the_cuda_source():
    """The kernels build only on a card; their C entry points' parameters
    (pointers, ints, floats) must match the ctypes argument types here."""
    src = (Path(pnf.__file__).parent / "csrc" / "norm_fusion.cu").read_text()
    for name, argtypes in pnf._ARGTYPES.items():
        m = re.search(rf"int {name}_##SUFFIX\(([^)]*)\)", src)
        assert m is not None, name
        params = m.group(1).replace("\\", "").split(",")
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float
                 if "float" in p else ctypes.c_uint if "unsigned" in p
                 else ctypes.c_int for p in params]
        assert kinds == argtypes, name
        for suffix in ("f32", "bf16"):
            assert f"{name.upper()}({suffix}," in src


# ---------------------------------------------------------------------------
# the functionals and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_layer_norm_routes_as_the_reference(fused, norm_flags):
    _set(fused)
    h, res, lb, w, b, _ = _arrays(8, 24, 64)
    x = h.reshape(2, 12, 64)
    jy = JF.layer_norm(paddle.to_tensor(x), 64, paddle.to_tensor(w),
                       paddle.to_tensor(b), 1e-12)
    y = PF.layer_norm(torch.from_numpy(x), 64, torch.from_numpy(w),
                      torch.from_numpy(b), 1e-12)
    assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
        ("fused_ln/interpret", "fused_ln/plain") if fused
        else ("dense", "dense"))
    assert y.shape == x.shape
    _close(y, np.asarray(jy.numpy()), F32_TOL)
    jz = JF.fused_bias_dropout_residual_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(res.reshape(x.shape)),
        bias=paddle.to_tensor(lb), ln_scale=paddle.to_tensor(w),
        ln_bias=paddle.to_tensor(b), dropout_rate=0.0, ln_epsilon=1e-12)
    z = PIF.fused_bias_dropout_residual_layer_norm(
        torch.from_numpy(x), torch.from_numpy(res.reshape(x.shape)),
        bias=torch.from_numpy(lb), ln_scale=torch.from_numpy(w),
        ln_bias=torch.from_numpy(b), dropout_rate=0.0, ln_epsilon=1e-12)
    assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
        ("fused_adln/interpret", "fused_adln/plain") if fused
        else ("dense", "dense"))
    _close(z, np.asarray(jz.numpy()), F32_TOL)
    PF.reset_last_norm_path()
    assert PF.last_norm_path() is None


def test_unsupported_layer_norm_goes_dense_with_the_warning(norm_flags,
                                                            monkeypatch):
    _set(True)
    monkeypatch.setattr(pnorm, "_DENSE_FALLBACK_WARNED", False)
    monkeypatch.setattr(jnorm, "_DENSE_FALLBACK_WARNED", False)
    x = np.random.default_rng(2).standard_normal((3, 4, 8)).astype(
        np.float32)
    w = np.ones((4, 8), np.float32)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jy = JF.layer_norm(paddle.to_tensor(x), [4, 8], paddle.to_tensor(w),
                           paddle.to_tensor(w * 0))
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        y = PF.layer_norm(torch.from_numpy(x), [4, 8], torch.from_numpy(w),
                          torch.from_numpy(w * 0))
    assert PF.last_norm_path() == jnorm.last_norm_path() == "dense"
    assert len(pw) == len(jw) == 1
    _close(y, np.asarray(jy.numpy()), F32_TOL)
    with pytest.raises(NotImplementedError, match="upscale_in_train"):
        PIF.fused_bias_dropout_residual_layer_norm(
            torch.zeros(2, 8), torch.zeros(2, 8), mode="downscale_in_infer")


def test_layer_norm_layer_has_paddles_names_and_init():
    layer = LayerNorm(16, epsilon=1e-12, device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    assert torch.equal(layer.weight, torch.ones(16))
    assert torch.equal(layer.bias, torch.zeros(16))
    x = torch.randn(3, 16)
    assert torch.equal(layer(x), PF.layer_norm(x, [16], layer.weight,
                                               layer.bias, 1e-12))
    bare = LayerNorm([2, 8], weight_attr=False, bias_attr=False,
                     device="cpu")
    assert bare.weight is None and bare.bias is None
    assert list(bare.state_dict()) == []
