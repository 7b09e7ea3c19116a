"""The port's fused BatchNorm-train (TPU kernels 15-18), the BatchNorm
functionals and the BatchNorm layers against the JAX reference.

The reference runs as its own tests run it on the CPU
(tests/test_norm_fusion.py:179-247, :354-406): ``fused_batch_norm_train(
..., block_c=8, interpret=True)`` and ``jax.grad`` through it (its stats,
apply, backward-reduce and backward-apply Pallas kernels in interpret
mode); the functionals and layers with ``FLAGS_fused_norm`` and
``FLAGS_fused_norm_interpret`` on (its kernels) or with the flag off (the
dense path in both packages). Every flag is restored. The port's custom
ops take their plain versions (``fused_bn_fwd_ref``, ``fused_bn_bwd_ref``)
for CPU tensors.

Tolerances, the reference tests' own:
- forward y: rtol 1e-4 / atol 1e-5; mean and var: rtol 1e-5 / atol 1e-6
  (the same one-pass f32 statistics summed in other orders);
- bf16 I/O: y within one bf16 unit of the largest |y| (2^-8 of it) of the
  reference's kernel output (both round the same f32 values), the f32
  statistics as above;
- gradients, with y, mean and var all in the loss: rtol 1e-4 / atol 1e-4;
- fused against dense and the running statistics: 2e-5, and rtol 1e-5 /
  atol 1e-6.
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import norm_fusion as jnf
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import norm as pnorm

EPILOGUES = [(False, False), (True, False), (True, True), (False, True)]


def _eid(v):
    return {(False, False): "plain", (True, False): "relu",
            (True, True): "relu_res", (False, True): "res"}[v]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


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


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# fused_batch_norm_train against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue", EPILOGUES, ids=_eid)
def test_forward_matches_pallas_kernels(epilogue):
    relu, with_res = epilogue
    x, w, b = _rand((2, 16, 8, 8), 16), _rand((16,), 17), _rand((16,), 18)
    res = _rand((2, 16, 8, 8), 19) if with_res else None
    jy, jmean, jvar = jnf.fused_batch_norm_train(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        residual=None if res is None else jnp.asarray(res), fuse_relu=relu,
        block_c=8, interpret=True)
    before = dict(pnf.launches)
    y, mean, var = pnf.fused_batch_norm_train(
        _t(x), _t(w), _t(b), residual=None if res is None else _t(res),
        fuse_relu=relu)
    assert pnf.launches == before       # CPU tensors: the plain versions
    assert y.shape == x.shape and mean.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)


def test_forward_bf16_io():
    x, w, b = _rand((2, 16, 32), 20), _rand((16,), 21), _rand((16,), 22)
    jy, jmean, jvar = jnf.fused_batch_norm_train(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        block_c=8, interpret=True)
    y, mean, var = pnf.fused_batch_norm_train(_t(x).bfloat16(), _t(w), _t(b))
    assert y.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    ref = np.asarray(jy, np.float32)
    err = float(np.abs(y.float().numpy() - ref).max())
    assert err <= 2.0 ** -8 * float(np.abs(ref).max())
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("stats_in_loss", [True, False],
                         ids=["y_mean_var", "y_only"])
@pytest.mark.parametrize("epilogue", EPILOGUES, ids=_eid)
def test_backward_matches_pallas_kernels(epilogue, stats_in_loss):
    """Gradients of sum(y cos y) (+ sum(sin mean) + sum(cos var)) through
    the reference's kernels and the port's ops: with the statistics in the
    loss their cotangents fold into dx; without, they arrive as None."""
    relu, with_res = epilogue
    x, w, b = _rand((2, 16, 6, 6), 23), _rand((16,), 24), _rand((16,), 25)
    res = _rand((2, 16, 6, 6), 26) if with_res else None

    def jloss(x, w, b, *rest):
        y, mean, var = jnf.fused_batch_norm_train(
            x, w, b, residual=rest[0] if rest else None, fuse_relu=relu,
            block_c=8, interpret=True)
        out = jnp.sum(y * jnp.cos(y))
        if stats_in_loss:
            out = out + jnp.sum(jnp.sin(mean)) + jnp.sum(jnp.cos(var))
        return out

    args = [x, w, b] + ([res] if with_res else [])
    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [_t(a, True) for a in args]
    y, mean, var = pnf.fused_batch_norm_train(
        leaves[0], leaves[1], leaves[2],
        residual=leaves[3] if with_res else None, fuse_relu=relu)
    loss = (y * torch.cos(y)).sum()
    if stats_in_loss:
        loss = loss + torch.sin(mean).sum() + torch.cos(var).sum()
    loss.backward()
    for leaf, ref in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def test_untileable_channels_raise_the_reference_errors():
    x = _rand((2, 6, 8, 8), 27)
    w = np.ones(6, np.float32)
    with pytest.raises(NotImplementedError) as jerr:
        jnf.fused_batch_norm_train(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(w), interpret=True)
    with pytest.raises(NotImplementedError) as perr:
        pnf.fused_batch_norm_train(_t(x), _t(w), _t(w))
    assert str(perr.value) == str(jerr.value)
    assert pnf.bn_eligible(64) and not pnf.bn_eligible(6)
    x16, w16 = _rand((2, 16, 4), 28), np.ones(16, np.float32)
    for bad in (dict(x=x16[0, 0], res=None), dict(x=x16, res=x16[:1])):
        with pytest.raises(ValueError) as jerr:
            jnf.fused_batch_norm_train(
                jnp.asarray(bad["x"]), jnp.asarray(w16), jnp.asarray(w16),
                residual=None if bad["res"] is None
                else jnp.asarray(bad["res"]), block_c=8, interpret=True)
        with pytest.raises(ValueError) as perr:
            pnf.fused_batch_norm_train(
                _t(bad["x"]), _t(w16), _t(w16),
                residual=None if bad["res"] is None else _t(bad["res"]))
        assert str(perr.value) == str(jerr.value)


def test_ops_cast_the_sums_and_never_alias():
    """The backward op returns dx in x's dtype, dres in the residual's and
    dw, db in w's and b's (bf16 gains, as the bf16 model holds them); no
    output aliases an input or another output (torch.library checks)."""
    x = _t(_rand((2, 8, 5), 29)).bfloat16()
    w, b = _t(_rand((8,), 30)).bfloat16(), _t(_rand((8,), 31)).bfloat16()
    for res, relu in ((None, True), (x.clone(), False), (x.clone(), True)):
        y, mean, var = pnf.fused_bn_fwd(x, res, w, b, 1e-5, relu)
        dx, dres, dw, db = pnf.fused_bn_bwd(x, res, w, b, mean, var, x, None,
                                            None, 1e-5, relu)
        assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16,) * 3
        assert (dres is None) == (res is None)


def test_kernel_contract_rejects_what_the_kernels_do_not_take():
    """The kernels' argument checks, which run before any launch: f32 or
    bf16, [N, C, HW] with C % 8 == 0, one dtype and shape for the rows,
    f32 per-channel vectors, contiguous 16-byte aligned rows."""
    x = torch.zeros(2, 16, 7)
    vec = torch.zeros(16)
    assert pnf._bn_check("k", x, (x,), (vec,)) == (2, 16, 7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pnf._bn_check("k", x.half(), (), ())
    with pytest.raises(ValueError, match="C % 8"):
        pnf._bn_check("k", torch.zeros(2, 12, 7), (), ())
    with pytest.raises(TypeError, match="one dtype and shape"):
        pnf._bn_check("k", x, (x.bfloat16(),), ())
    with pytest.raises(ValueError, match="float32"):
        pnf._bn_check("k", x, (), (vec.bfloat16(),))
    flat = torch.zeros(2 * 16 * 7 + 1)
    with pytest.raises(ValueError, match="aligned"):
        pnf._bn_check("k", flat[1:].view(2, 16, 7), (), ())
    with pytest.raises(ValueError, match="aligned"):
        pnf._bn_check("k", torch.zeros(2, 7, 16).transpose(1, 2), (), ())


# ---------------------------------------------------------------------------
# the functionals
# ---------------------------------------------------------------------------

def _bn_run(fwd, to, xn, wn, bn, momentum=0.8, **kw):
    x = to(xn)
    rm, rv = to(np.zeros(16, np.float32)), to(np.ones(16, np.float32))
    out = fwd(x, rm, rv, to(wn), to(bn), training=True, momentum=momentum,
              **kw)
    return [np.asarray(v.numpy() if hasattr(v, "numpy") else v, np.float32)
            for v in (out.detach() if isinstance(out, torch.Tensor) else out,
                      rm, rv)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_batch_norm_matches_the_reference_and_its_ema(fused, norm_flags):
    """tests/test_norm_fusion.py:354-383 in both packages: the output and
    Paddle's running-statistic update (momentum 0.8 keeps 80% of the old
    value; the biased batch variance)."""
    rng = np.random.default_rng(1)
    xn = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    wn = rng.normal(size=(16,)).astype(np.float32)
    bn = rng.normal(size=(16,)).astype(np.float32)
    _set(fused)
    jout = _bn_run(JF.batch_norm, paddle.to_tensor, xn, wn, bn)
    pout = _bn_run(PF.batch_norm, torch.from_numpy, xn, wn, bn)
    assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
        ("fused_bn/interpret", "fused_bn/plain") if fused
        else ("dense", "dense"))
    np.testing.assert_allclose(pout[0], jout[0], rtol=2e-5, atol=2e-5)
    for got, ref in zip(pout[1:], jout[1:]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    mean = xn.mean((0, 2, 3))
    np.testing.assert_allclose(pout[1], 0.2 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pout[2], 0.8 + 0.2 * xn.var((0, 2, 3)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_forward_act_epilogue_matches_the_reference(fused, norm_flags):
    """relu(bn(x) + res) through BatchNorm2D.forward_act in both packages
    (the reference test's layer, :384-406), against each package's dense
    composition."""
    rng = np.random.default_rng(2)
    xn = rng.normal(size=(2, 16, 4, 4)).astype(np.float32)
    rn = rng.normal(size=(2, 16, 4, 4)).astype(np.float32)
    _set(False)
    jlayer, player = jnn.BatchNorm2D(16), pnn.BatchNorm2D(16, device="cpu")
    jdense = JF.relu(jlayer(paddle.to_tensor(xn)) + paddle.to_tensor(rn))
    _set(fused)
    jout = jlayer.forward_act(paddle.to_tensor(xn), activation="relu",
                              residual=paddle.to_tensor(rn))
    pout = player.forward_act(torch.from_numpy(xn), activation="relu",
                              residual=torch.from_numpy(rn))
    assert PF.last_norm_path() == ("fused_bn/plain" if fused else "dense")
    np.testing.assert_allclose(pout.detach().numpy(), jout.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pout.detach().numpy(), jdense.numpy(),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="unsupported activation"):
        PF.batch_norm_act(torch.from_numpy(xn), None, None, training=True,
                          activation="gelu")


@pytest.mark.parametrize("case", ["float16", "c12", "nhwc", "flag_off",
                                  "eval", "bfloat16", "float32"])
def test_batch_norm_routes_by_its_arguments(case, norm_flags, monkeypatch):
    """f32 and bf16 channel-second with C % 8 == 0 take the fused route;
    fp16, C % 8 != 0 and channels-last take the dense route with the
    once-warning (the kernels are never reached); the flag off and eval
    mode take it silently."""
    calls = []
    real = pnorm.fused_batch_norm_train

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pnorm, "fused_batch_norm_train", spy)
    monkeypatch.setattr(pnorm, "_DENSE_FALLBACK_WARNED", False)
    pt_set_flags({"FLAGS_fused_norm": case != "flag_off"})
    c = 12 if case == "c12" else 16
    dtype = {"float16": torch.float16,
             "bfloat16": torch.bfloat16}.get(case, torch.float32)
    x = torch.randn(2, c, 3, 3).to(dtype)
    fmt = "NCHW"
    if case == "nhwc":
        x, fmt = x.permute(0, 2, 3, 1).contiguous(), "NHWC"
    rm, rv = torch.zeros(c), torch.ones(c)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = PF.batch_norm_act(x, rm, rv, training=case != "eval",
                                data_format=fmt, activation="relu")
    fused = case in ("bfloat16", "float32")
    assert len(calls) == int(fused)
    assert PF.last_norm_path() == ("fused_bn/plain" if fused else "dense")
    warned = [w for w in seen if "taking the dense path" in str(w.message)]
    assert len(warned) == int(case in ("float16", "c12", "nhwc"))
    assert out.dtype == dtype and out.shape == x.shape
    assert bool((out >= 0).all())
    if case != "eval":      # train mode moved the running statistics
        assert not torch.equal(rm, torch.zeros(c))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def test_layers_keep_the_reference_names_and_buffers():
    for jcls, pcls in ((jnn.BatchNorm1D, pnn.BatchNorm1D),
                       (jnn.BatchNorm2D, pnn.BatchNorm2D),
                       (jnn.BatchNorm3D, pnn.BatchNorm3D)):
        jsd, psd = jcls(8).state_dict(), pcls(8, device="cpu").state_dict()
        assert list(psd) == list(jsd) == ["weight", "bias", "_mean",
                                          "_variance"]
    layer = pnn.BatchNorm2D(8, device="cpu", dtype=torch.bfloat16)
    assert layer.weight.dtype == torch.bfloat16
    assert layer._mean.dtype == layer._variance.dtype == torch.float32
    assert pnn.BatchNorm2D(8, weight_attr=False, bias_attr=False,
                           device="cpu").weight is None


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("kind", ["BatchNorm1D_NC", "BatchNorm1D_NCL",
                                  "BatchNorm2D", "BatchNorm3D",
                                  "BatchNorm_relu"])
def test_layers_train_and_eval_match_the_reference(kind, fused, norm_flags):
    """Two train-mode calls (the running statistics move by Paddle's rule),
    then an eval-mode call (they normalise), in both packages."""
    shape = {"BatchNorm1D_NC": (6, 16), "BatchNorm1D_NCL": (4, 16, 5),
             "BatchNorm2D": (2, 16, 3, 5), "BatchNorm3D": (2, 16, 2, 3, 2),
             "BatchNorm_relu": (2, 16, 3, 3)}[kind]
    _set(fused)
    if kind == "BatchNorm_relu":
        jl, pl = jnn.BatchNorm(16, act="relu"), pnn.BatchNorm(
            16, act="relu", device="cpu")
    else:
        cls = kind.split("_")[0]
        jl, pl = getattr(jnn, cls)(16), getattr(pnn, cls)(16, device="cpu")
    rng = np.random.default_rng(3)
    for step in range(3):
        if step == 2:
            jl.eval()
            pl.eval()
        xn = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
        jy = jl(paddle.to_tensor(xn))
        py = pl(torch.from_numpy(xn))
        np.testing.assert_allclose(py.detach().numpy(), jy.numpy(),
                                   rtol=2e-5, atol=2e-5)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(pl, name).numpy(),
                np.asarray(getattr(jl, name).numpy()), rtol=1e-5, atol=1e-6)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pnn.BatchNorm2D(8)
