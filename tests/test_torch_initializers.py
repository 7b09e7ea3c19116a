"""The port's ``nn.initializer`` classes and ``create_parameter`` against
the JAX reference.

From the same ``seed`` each class draws the reference's values from the
framework generator: ``Uniform``, ``XavierUniform``, ``KaimingUniform``,
``Constant``, ``Assign`` and ``Dirac`` bit for bit; the normal draws
(``Normal``, ``XavierNormal``, ``KaimingNormal``) within 2 ulps of the
largest value (torch's and XLA's float32 ``log1p`` differ,
``ops/random.py``); ``TruncatedNormal`` within 2e-4 of its std: its
uniform's bounds erf(lo/√2), erf(hi/√2) come from each library's float32
``erf``, which differ by an ulp near ±1, where ``erfinv`` magnifies the
difference; ``Orthogonal`` within 1e-5
(the two libraries' QR round differently); bf16 draws within one bf16
ulp. ``Layer.create_parameter`` and ``paddle.create_parameter`` resolve a
``ParamAttr`` (initializer, name, trainable flag, learning rate) as the
reference does, and draw the same values.
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import initializer as PI

SHAPE = [48, 40]
CONV = [16, 8, 3, 3]


@pytest.fixture(autouse=True)
def _cpu():
    """The port's layers on the CPU; both places put back."""
    yield from cpu_place()


def _draw(pkg, init_mod, cls, args, shape, dtype="float32"):
    pkg.seed(123)
    if pkg is paddle:
        return np.asarray(getattr(init_mod, cls)(*args)(shape, dtype),
                          np.float32)
    out = getattr(init_mod, cls)(*args)(shape, dtype, torch.device("cpu"))
    return out.float().numpy()


EXACT = [("Constant", (0.7,)), ("Uniform", (-0.3, 0.4)),
         ("XavierUniform", ()), ("XavierUniform", (None, None, 2.0)),
         ("KaimingUniform", ()), ("KaimingUniform", (5, 0.2, "leaky_relu")),
         ("Assign", (np.arange(48 * 40, dtype=np.float32).reshape(48, 40),)),
         ("Dirac", (2,))]
NORMAL = [("Normal", (0.5, 2.0)), ("TruncatedNormal", (0.1, 0.5)),
          ("TruncatedNormal", (0.0, 1.0, -1.0, 0.5)), ("XavierNormal", ()),
          ("KaimingNormal", ()), ("KaimingNormal", (None, 0.0, "tanh"))]


@pytest.mark.parametrize("cls, args", EXACT)
def test_exact_draws(cls, args):
    shape = SHAPE if cls == "Assign" else CONV
    want = _draw(paddle, JI, cls, args, shape)
    got = _draw(pt, PI, cls, args, shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls, args", NORMAL)
@pytest.mark.parametrize("shape", [SHAPE, CONV])
def test_normal_draws(cls, args, shape):
    want = _draw(paddle, JI, cls, args, shape)
    got = _draw(pt, PI, cls, args, shape)
    ulp = np.spacing(np.abs(want).max()).astype(np.float32)
    tol = 2e-4 * args[1] if cls == "TruncatedNormal" else 2 * ulp
    assert np.abs(got - want).max() <= tol


def test_orthogonal_and_bf16_draws():
    want = _draw(paddle, JI, "Orthogonal", (1.5,), [12, 30])
    got = _draw(pt, PI, "Orthogonal", (1.5,), [12, 30])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got @ got.T, 2.25 * np.eye(12), atol=1e-4)
    for cls, args in (("Uniform", (-1.0, 1.0)), ("Normal", ())):
        want = _draw(paddle, JI, cls, args, SHAPE, "bfloat16")
        got = _draw(pt, PI, cls, args, SHAPE, "bfloat16")
        tol = np.spacing(np.abs(want).max() * np.float32(2 ** 16))
        assert np.abs(got - want).max() <= tol, cls


def test_generator_advances_alike():
    """One split per draw: after the same draws both generators hold the
    same key, so a later dropout draws the same mask."""
    for pkg, mod in ((paddle, JI), (pt, PI)):
        pkg.seed(9)
        kw = {} if pkg is paddle else {"device": torch.device("cpu")}
        for cls in ("Normal", "Uniform", "XavierNormal", "Constant"):
            getattr(mod, cls)()([3, 4], "float32", **kw)
    from paddle_tpu.core.generator import default_generator as jg
    from paddle_tpu_torch.core.generator import default_generator as pg
    np.testing.assert_array_equal(pg.get_state().numpy(),
                                  np.asarray(jg.get_state()).astype(np.int64))


def test_helpers():
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert PI.calculate_gain(nl, p) == JI.calculate_gain(nl, p)
    assert isinstance(PI._resolve_initializer(PI.Normal), PI.Normal)
    fn = (lambda s, d: None)
    assert PI._resolve_initializer(fn) is fn
    with pytest.raises(TypeError, match="cannot use 3 as initializer"):
        PI._resolve_initializer(3)
    PI.set_global_initializer(PI.Normal(), PI.Constant(0.0))
    assert isinstance(PI._GLOBAL_WEIGHT_INIT, PI.Normal)
    PI.set_global_initializer(None)


def test_create_parameter():
    for pkg in (paddle, pt):
        pkg.seed(5)
    jl, pl = paddle.nn.Layer(), pt.nn.Layer()
    attr = dict(name="my_w", initializer=None, learning_rate=0.5,
                trainable=False)
    jw = jl.create_parameter([6, 4], attr=paddle.ParamAttr(
        **{**attr, "initializer": JI.Uniform(-0.1, 0.1)}))
    pw = pl.create_parameter([6, 4], attr=pt.ParamAttr(
        **{**attr, "initializer": PI.Uniform(-0.1, 0.1)}))
    np.testing.assert_array_equal(pw.detach().numpy(),
                                  np.asarray(jw.numpy()))
    assert pw.name == jw.name == "my_w"
    assert pw.trainable is jw.trainable is False
    assert pw.optimize_attr == jw.optimize_attr == {"learning_rate": 0.5}
    jb = jl.create_parameter([4], is_bias=True)
    pb = pl.create_parameter([4], is_bias=True)
    assert float(pb.abs().sum()) == 0.0 and not pb.stop_gradient
    assert pb.name.endswith(".w_0") and jb.name.endswith(".w_0")
    jx = jl.create_parameter([5, 3], attr="named")
    px = pl.create_parameter([5, 3], attr="named")
    ulp = np.spacing(np.abs(np.asarray(jx.numpy())).max())
    assert np.abs(px.detach().numpy() - np.asarray(jx.numpy())).max() \
        <= 2 * ulp
    assert px.name == "named"
    jt = paddle.create_parameter([3, 2], "float32",
                                 default_initializer=JI.Constant(2.0))
    ptp = pt.create_parameter([3, 2], "float32",
                              default_initializer=PI.Constant(2.0))
    np.testing.assert_array_equal(ptp.detach().numpy(),
                                  np.asarray(jt.numpy()))
    assert not ptp.stop_gradient and ptp.device.type == "cpu"
    custom = pl.create_parameter(
        [2, 2], default_initializer=lambda s, d: np.full(s, 3.0, np.float32))
    assert float(custom.sum()) == 12.0


def test_layers_draw_the_reference_weights():
    """A Linear and an Embedding built after the same seed hold the
    reference's weights; with a torch.Generator they draw from it
    instead (the built-in models' seeded resets)."""
    for pkg in (paddle, pt):
        pkg.seed(31)
    jlin, plin = paddle.nn.Linear(20, 12), pt.nn.Linear(20, 12)
    jemb = paddle.nn.Embedding(30, 8, padding_idx=3)
    pemb = pt.nn.Embedding(30, 8, padding_idx=3)
    for j, p in ((jlin.weight, plin.weight), (jemb.weight, pemb.weight)):
        ref = np.asarray(j.numpy())
        assert np.abs(p.detach().numpy() - ref).max() <= \
            2 * np.spacing(np.abs(ref).max())
    assert float(pemb.weight[3].abs().sum()) == 0.0
    g = torch.Generator().manual_seed(0)
    lin = pt.nn.Linear(20, 12, generator=g)
    std = math.sqrt(2.0 / 32)
    assert float(lin.weight.std()) == pytest.approx(std, rel=0.2)
