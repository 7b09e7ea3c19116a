"""The port's ``ops/creation.py`` and ``ops/random.py`` against the
reference's.

- The op audit's specs for the ops the reference registers in those two
  files run through both registries (``torch_ops_audit``), the random
  ones with the spec's threefry key: the draws are the reference's
  (uniform, randint, randperm, bernoulli, exponential, multinomial,
  poisson exact; normal at rtol 1e-5).
- The public random functions, after ``seed(s)`` in both packages, draw
  the reference's sequence: ``uniform``, ``rand``, ``randint``,
  ``randperm``, ``bernoulli``, ``multinomial`` (with and without
  replacement), ``poisson`` (rates below and above 10) and ``uniform_``
  bit for bit; ``exponential_`` (``-log1p(-u)``) within one float32 ulp
  and ``randn``, ``normal`` and ``gaussian`` within two (XLA's erfinv
  polynomial is ported; the float32 log1p of the two libraries differs);
  ``standard_gamma`` by its mean and variance (a rejection
  sampler: one rejection decided the other way shifts the rest).
- The creation functions: values, shapes and dtypes (Python floats and
  float64 data become float32, integers int64 where the reference's
  int32 is its TPU width, ROADMAP C), ``stop_gradient`` and the place.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import torch_ops_audit as A
from paddle_tpu_torch import ops as pops

SPECS = A.specs_for("creation") + A.specs_for("random")


@pytest.fixture(scope="module", autouse=True)
def cpu_place():
    yield from A.cpu_place()


@pytest.mark.parametrize("spec", SPECS, ids=A.ids(SPECS))
def test_op_matches_the_reference(spec):
    A.check_forward(spec)


GRADS = [s for s in SPECS if s.wants_grad()]


@pytest.mark.parametrize("spec", GRADS, ids=A.ids(GRADS))
def test_gradient_matches_the_reference(spec):
    A.check_grad(spec)


def _ref(t):
    return np.asarray(t.numpy())


def _draws(mod, seed):
    """The same sequence of public random calls in either package."""
    mod.seed(seed)
    probs = [0.1, 0.2, 0.3, 0.4]
    out = {
        "uniform": mod.uniform([3, 5], min=-2.0, max=3.0),
        "rand": mod.rand([4]),
        "randint": mod.randint(3, 11, [6]),
        "randint_neg": mod.randint(-5, 5, [2, 3], dtype="int32"),
        "randperm": mod.randperm(40),
        "bernoulli": mod.bernoulli(mod.to_tensor(np.full((2, 6), 0.35,
                                                         np.float32))),
        "multinomial": mod.multinomial(mod.to_tensor(np.array(
            probs, np.float32)), 3),
        "multinomial_replace": mod.multinomial(mod.to_tensor(np.array(
            probs, np.float32)), 6, replacement=True),
        "poisson": mod.poisson(mod.to_tensor(np.array(
            [0.5, 3.0, 9.5, 12.0, 40.0, 0.0], np.float32))),
        "uniform_bf16": mod.uniform([8], dtype="bfloat16"),
        "uniform_f16": mod.uniform([8], dtype="float16"),
    }
    out["exponential_"] = mod.zeros([5]).exponential_(2.0)
    out["uniform_"] = mod.zeros([2, 3]).uniform_(-1.0, 1.0)
    out["randn"] = mod.randn([64])
    out["normal"] = mod.normal(1.0, 2.0, [64])
    out["gaussian"] = mod.gaussian([3, 4], mean=0.5, std=0.1)
    return out


# the draws that pass the uniform bits through a transcendental function
# whose float32 implementations differ between XLA and torch (log1p; the
# erfinv polynomial is XLA's, its log1p torch's): within these ulps
ULPS = {"randn": 2, "normal": 2, "gaussian": 2, "exponential_": 1}


def test_public_draws_are_the_reference_draws():
    want = _draws(paddle, 11)
    dtypes = dict(zip(want, A.want_dtypes(
        list(want.values()), lambda: list(_draws(paddle, 11).values()))))
    want = _draws(paddle, 11)       # the reference's generator as the port's
    got = _draws(pt, 11)
    for name, w in want.items():
        w = _ref(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        if name in ULPS:
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(g - w) <= ULPS[name] * ulp), (name, g, w)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=name)
        assert A.port_dtype(got[name]) == dtypes[name], name
    # the generator advanced identically: the next split is the same
    assert pt.core.generator.default_generator._key == tuple(
        int(v) for v in np.asarray(
            paddle.core.generator.default_generator._state._value))


def test_standard_gamma_matches_its_moments():
    pt.seed(3)
    alpha = np.array([0.5] * 2000 + [2.0] * 2000 + [7.0] * 2000, np.float32)
    x = pops.standard_gamma(pops.to_tensor(alpha)).numpy()
    assert x.dtype == np.float32 and np.all(x > 0)
    for a, part in zip((0.5, 2.0, 7.0), np.split(x, 3)):
        assert abs(part.mean() - a) < 0.12 * max(a, 1), (a, part.mean())
        assert abs(part.var() - a) < 0.3 * max(a, 1), (a, part.var())
    # the reparameterisation gradient: d sample / d alpha is finite, > 0
    t = pops.to_tensor(np.full(8, 2.0, np.float32), stop_gradient=False)
    pops.standard_gamma(t).sum().backward()
    assert torch.isfinite(t.grad).all() and (t.grad > 0).all()


CREATION = [
    ("to_tensor-float", lambda m: m.to_tensor([1.5, 2.0])),
    ("to_tensor-f64", lambda m: m.to_tensor(np.arange(4, dtype=np.float64))),
    ("to_tensor-int", lambda m: m.to_tensor([[1, 2], [3, 4]])),
    ("to_tensor-bool", lambda m: m.to_tensor([True, False])),
    ("to_tensor-dtype", lambda m: m.to_tensor([1.7, -2.2], dtype="int32")),
    ("to_tensor-scalar", lambda m: m.to_tensor(3.25)),
    ("zeros", lambda m: m.zeros([2, 3])),
    ("ones-int", lambda m: m.ones([3], dtype="int32")),
    ("full-int", lambda m: m.full([2, 2], 7)),
    ("full-float", lambda m: m.full([2], 0.5)),
    ("full-bool", lambda m: m.full([2], True)),
    ("arange-int", lambda m: m.arange(2, 11, 3)),
    ("arange-float", lambda m: m.arange(0.0, 1.0, 0.25)),
    ("arange-one", lambda m: m.arange(5)),
    ("linspace", lambda m: m.linspace(-1.0, 2.0, 7)),
    ("logspace", lambda m: m.logspace(0.0, 2.0, 5)),
    ("eye", lambda m: m.eye(3, 4)),
    ("empty", lambda m: m.empty([2, 2])),
    ("tril_indices", lambda m: m.tril_indices(4, 3, 0)),
    ("triu_indices", lambda m: m.triu_indices(3, 4, 1)),
    ("diag-padding", lambda m: m.diag(m.to_tensor([1.0, 2.0]), offset=1,
                                      padding_value=9.0)),
    ("full_like", lambda m: m.full_like(m.to_tensor([[1, 2]]), 5)),
    ("zeros_like-dtype", lambda m: m.zeros_like(m.to_tensor([1.0]),
                                                dtype="int32")),
    ("clone", lambda m: m.clone(m.to_tensor([1.0, 2.0]))),
    ("assign", lambda m: m.assign(np.array([[1.0, 2.0]]))),
]


@pytest.mark.parametrize("case", CREATION, ids=[c[0] for c in CREATION])
def test_creation_matches_the_reference(case):
    name, fn = case
    w, g = fn(paddle), fn(pt)
    want = A.want_dtypes(w, lambda: fn(paddle))[0]
    # a registered op wraps its output as a facade when an argument was
    # one: assign of a numpy array returns a plain tensor
    assert isinstance(g, pt.Tensor) or name == "assign"
    g = pt.Tensor(g)
    assert g.place == pt.core.place.CPUPlace() and g.stop_gradient
    wv = _ref(w)
    assert g.shape == list(wv.shape)
    assert A.port_dtype(g) == want, (g.dtype, want)
    np.testing.assert_allclose(g.numpy(), wv.astype(g.numpy().dtype),
                               rtol=1e-6, atol=1e-7)


def test_meshgrid_and_stop_gradient():
    a, b = pops.meshgrid(pops.to_tensor([1.0, 2.0]),
                         pops.to_tensor([3.0, 4.0, 5.0]))
    ja, jb = paddle.meshgrid(paddle.to_tensor([1.0, 2.0]),
                             paddle.to_tensor([3.0, 4.0, 5.0]))
    np.testing.assert_array_equal(a.numpy(), _ref(ja))
    np.testing.assert_array_equal(b.numpy(), _ref(jb))
    t = pops.to_tensor([1.0, 2.0], stop_gradient=False)
    assert not t.stop_gradient and t.requires_grad and t.is_leaf
    # to_tensor copies: the new tensor does not alias its source
    src = torch.zeros(3)
    c = pops.to_tensor(src)
    src.fill_(1.0)
    assert c.numpy().tolist() == [0.0, 0.0, 0.0]
