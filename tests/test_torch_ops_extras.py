"""The port's ``ops/extras.py`` against the reference's, op by op.

The op audit's specs for the ops the reference registers in
``paddle_tpu/ops/extras.py`` run through both registries on the same
numpy inputs (``torch_ops_audit``: floats at rtol 1e-5 / atol 1e-6 unless
listed in ``TOL``, integers exact, dtypes with the 64-bit rule of
ROADMAP C, shapes, and the gradients of the grad-checked specs at rtol
1e-4 / atol 1e-5; ``gammainc``'s gradient in its first argument is a
float64 central difference in the port, held at rtol 1e-3). The cases
below add ``take``'s three modes with out-of-range indices,
``masked_scatter`` with fewer values than masked places, ``cdist`` and
``pdist`` at p = 1, ``logcumsumexp`` over a wide range, integer inputs to
the special functions, and the unregistered helpers (``tensor_split``
and friends, ``svd_lowrank`` / ``pca_lowrank``, ``combinations``,
``shard_index``, the dtype predicates).

Not ported, so not compared: ``binomial`` (its sampler is
``distribution/``'s op, not ported yet). ``create_parameter`` is held to
the reference's in ``test_torch_initializers.py``.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import torch_ops_audit as A
from op_audit.harness import S, T

MODULE = "extras"
SPECS = A.specs_for(MODULE)

EXTRA = [
    S("take", T(3, 4), T(5, gen="custom", fn=lambda rng: np.array(
        [0, 13, -2, -20, 11], np.int64)), mode="wrap", suffix="wrap"),
    S("take", T(3, 4), T(5, gen="custom", fn=lambda rng: np.array(
        [0, 13, -2, -20, 11], np.int64)), mode="clip", suffix="clip"),
    S("take", T(3, 4), T(5, gen="custom", fn=lambda rng: np.array(
        [0, 13, -2, -20, 11], np.int64)), suffix="raise-clamps"),
    S("masked_scatter", T(3, 4), T(3, 4, gen="bool"), T(3, gen="custom",
                                                        fn=lambda rng:
                                                        np.arange(
                                                            3, dtype=np.float32)),
      suffix="short-values"),
    S("cdist", T(4, 3), T(5, 3), p=1.0, suffix="p1"),
    S("pdist", T(5, 3), p=1.0, suffix="p1"),
    S("logcumsumexp", T(3, 6, gen="uniform", lo=-40.0, hi=40.0), axis=1,
      suffix="wide"),
    S("gammaln", T(3, 4, gen="int", lo=1, hi=6, dtype="int32"),
      suffix="int"),
    S("i0", T(3, 4, gen="int", lo=-3, hi=3, dtype="int32"), suffix="int"),
    S("renorm", T(3, 4), 1.0, 0, 0.5, suffix="p1"),
    S("unflatten", T(2, 12), 1, [3, -1], suffix="infer"),
    S("tensor_unfold", T(2, 9), 1, 3, 2, suffix="step2"),
    S("reduce_as", T(2, 3, 4), T(3, 1), suffix="broadcast"),
    S("vander", T(4), n=3, increasing=True, suffix="increasing"),
    S("diagonal_scatter", T(3, 4), T(3), offset=1, suffix="offset"),
]
A.TOL.update({"cond": (1e-4, 1e-5), "cholesky_inverse": (1e-4, 1e-5),
              "ormqr": (1e-5, 1e-5), "householder_product": (1e-5, 1e-5)})


@pytest.fixture(scope="module", autouse=True)
def cpu_place():
    yield from A.cpu_place()


@pytest.mark.parametrize("spec", SPECS, ids=A.ids(SPECS))
def test_op_matches_the_reference(spec):
    A.check_forward(spec)


GRADS = [s for s in SPECS if s.wants_grad()]


@pytest.mark.parametrize("spec", GRADS, ids=A.ids(GRADS))
def test_gradient_matches_the_reference(spec):
    if spec.op in ("gammainc", "gammaincc"):
        A.check_grad(spec, rtol=1e-3, atol=1e-5)
    else:
        A.check_grad(spec)


@pytest.mark.parametrize("spec", EXTRA, ids=A.ids(EXTRA))
def test_case_matches_the_reference(spec):
    A.check_forward(spec)


def _same(got, want, dtypes):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want) == len(dtypes)
    for g, w, wd in zip(got, want, dtypes):
        w = np.asarray(w.numpy())
        assert A.port_dtype(g) == wd, (g.dtype, wd)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


HELPERS = [
    ("tensor_split", lambda m, x: m.tensor_split(x, 3, axis=1)),
    ("tensor_split-idx", lambda m, x: m.tensor_split(x, [1, 4], axis=1)),
    ("hsplit", lambda m, x: m.hsplit(x, 5)),
    ("vsplit", lambda m, x: m.vsplit(x, 2)),
    ("atleast_3d", lambda m, x: m.atleast_3d(x)),
    ("view_as", lambda m, x: m.view_as(x, m.zeros([5, 4]))),
    ("svd_lowrank", lambda m, x: [v.abs() for v in m.svd_lowrank(x, q=2)]),
    ("pca_lowrank", lambda m, x: [v.abs() for v in m.pca_lowrank(x, q=2)]),
    ("combinations", lambda m, x: m.combinations(x[0], r=2)),
    ("shard_index", lambda m, x: m.shard_index(
        m.to_tensor(np.array([[1], [6], [9], [3]], np.int64)), 10, 3, 1)),
    ("rank", lambda m, x: m.rank(x)),
    ("log_normal", lambda m, x: m.log_normal(0.0, 0.1, [3]).shape and
     m.ones([1])),
]


@pytest.mark.parametrize("case", HELPERS, ids=[h[0] for h in HELPERS])
def test_helper_matches_the_reference(case):
    _, fn = case
    x = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    def ref():
        return fn(paddle, paddle.to_tensor(x))

    want = ref()
    _same(fn(pt, pt.to_tensor(x)), want, A.want_dtypes(want, ref))


def test_dtype_predicates_and_infos():
    for dt in ("float32", "bfloat16", "int32", "complex64", "bool"):
        x, jx = pt.zeros([1], dtype=dt), paddle.zeros([1], dtype=dt)
        for fn in ("is_complex", "is_floating_point", "is_integer"):
            assert getattr(pt, fn)(x) == getattr(paddle, fn)(jx), (dt, fn)
    assert pt.finfo("bfloat16").eps == float(paddle.finfo("bfloat16").eps)
    assert pt.iinfo("int32").max == paddle.iinfo("int32").max
    assert pt.tolist(pt.to_tensor([1, 2])) == [1, 2]


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    assert not hasattr(pt, "binomial") and hasattr(pt, "create_parameter")
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(GRADS)} gradients, {len(EXTRA)} extra cases")
