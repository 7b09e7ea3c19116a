"""The port's ``ops/math.py`` against the reference's, op by op.

Every spec of ``tests/op_audit`` whose op the reference registers in
``paddle_tpu/ops/math.py`` runs through both registries on the same numpy
inputs (``torch_ops_audit``): values (rtol 1e-5, atol 1e-6 for floats;
exact for integers and bools), dtypes (the 64-bit rule of ROADMAP C) and
shapes; and, for every spec the audit grad-checks, the input gradients
under a seeded cotangent (rtol 1e-4, atol 1e-5). The cases below add what
the specs leave out: integer division and modulo signs, the promotion of
mixed and weakly typed operands, bf16 arithmetic with Python scalars,
ties in cummax / cummin; and float64 tensors, which stay float64 where
the reference's op keeps them with x64 on (ROADMAP C, "64-bit dtypes"),
the index outputs int64, an explicit cast to float32 float32.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import torch_ops_audit as A
from op_audit.harness import S, T

MODULE = "math"
SPECS = A.specs_for(MODULE)


def _ints(*shape, lo=-9, hi=10, dtype="int32"):
    return T(*shape, gen="int", lo=lo, hi=hi, dtype=dtype)


def _nonzero_ints(*shape):
    return T(*shape, gen="custom", fn=lambda rng: np.where(
        rng.random(shape) < 0.5, -1, 1).astype(np.int32)
        * rng.integers(1, 7, shape).astype(np.int32))


def _bf16(*shape):
    import ml_dtypes
    return T(*shape, gen="custom", fn=lambda rng: rng.standard_normal(
        shape).astype(ml_dtypes.bfloat16))


EXTRA = [
    S("divide", _ints(3, 4), _nonzero_ints(3, 4), suffix="int-int"),
    S("floor_divide", _ints(3, 4), _nonzero_ints(3, 4), suffix="int-signs"),
    S("remainder", _ints(3, 4), _nonzero_ints(3, 4), suffix="int-signs"),
    S("remainder", T(3, 4), -1.5, suffix="float-neg-scalar"),
    S("floor_divide", T(3, 4), -0.7, suffix="float-neg-scalar"),
    S("add", _ints(3, 4), 1.5, suffix="int-weak-float"),
    S("multiply", _ints(3, 4), T(3, 4), suffix="int-by-float"),
    S("add", T(3, 4, dtype="float16"), T(3, 4), suffix="f16-f32"),
    S("add", _bf16(3, 4), 1e-6, suffix="bf16-scalar"),
    S("multiply", _bf16(3, 4), -1e9, suffix="bf16-scalar"),
    S("subtract", 1.0, _bf16(3, 4), suffix="scalar-bf16"),
    S("divide", _bf16(3, 4), 3.0, suffix="bf16-scalar"),
    S("pow", _ints(3, 4, lo=0, hi=4), 2, suffix="int-int"),
    S("maximum", T(3, 4), 0.25, suffix="scalar"),
    S("cummax", T(3, 6, gen="custom", fn=lambda rng: rng.integers(
        0, 3, (3, 6)).astype(np.float32)), axis=1, suffix="ties"),
    S("cummin", T(3, 6, gen="custom", fn=lambda rng: rng.integers(
        0, 3, (3, 6)).astype(np.float32)), axis=1, suffix="ties"),
    S("cumsum", _ints(3, 5), axis=1, suffix="int32"),
    S("cumsum", T(2, 64, gen="custom", fn=lambda rng: rng.standard_normal(
        (2, 64)).astype("float32")), axis=1, suffix="long"),
    S("abs", _ints(3, 4), suffix="int"),
    S("exp", _ints(3, 4, lo=-3, hi=3), suffix="int"),
    S("clip", T(3, 4), min=-0.5, suffix="min-only"),
    S("scale", _ints(3, 4), scale=2, bias=1, suffix="int"),
]

# bf16 results: within one bf16 unit of the reference (both round a
# float32 result; the reference may keep more precision between ops)
BF16_TOL = (2 ** -7, 0.0)


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


@pytest.mark.parametrize("spec", EXTRA, ids=A.ids(EXTRA))
def test_case_matches_the_reference(spec):
    A.check_forward(spec, BF16_TOL if "bf16" in spec.id else None)


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(GRADS)} gradients, {len(EXTRA)} extra cases")


# ops on a float64 tensor (the caller asked for 64 bits) and the dtypes
# of their outputs
F64 = [
    ("add", lambda m, a: m.add(a, a), ["float64"]),
    ("weak-scalars", lambda m, a: a * 2.5 + 1, ["float64"]),
    ("matmul", lambda m, a: m.matmul(a, a, transpose_y=True), ["float64"]),
    ("sum", lambda m, a: m.sum(a, axis=1), ["float64"]),
    ("mean", lambda m, a: m.mean(a), ["float64"]),
    ("cumsum", lambda m, a: m.cumsum(a, axis=0), ["float64"]),
    ("exp", lambda m, a: m.exp(a), ["float64"]),
    ("max-argmax", lambda m, a: [m.max(a, axis=0), m.argmax(a, axis=0)],
     ["float64", "int64"]),
    ("topk", lambda m, a: m.topk(a, 2), ["float64", "int64"]),
    ("with-float32", lambda m, a: a + m.cast(a, "float32"), ["float64"]),
    ("cast-down", lambda m, a: m.cast(a, "float32"), ["float32"]),
    ("sum-dtype", lambda m, a: m.sum(m.cast(a, "float32"), dtype="float64"),
     ["float64"]),
]


@pytest.mark.parametrize("case", F64, ids=[c[0] for c in F64])
def test_float64_stays_float64_where_the_caller_asks(case):
    _, fn, dtypes = case
    x = np.random.default_rng(4).standard_normal((3, 4))

    def ref():
        return fn(paddle, paddle.to_tensor(x, dtype="float64"))

    want = ref()
    got = fn(pt, pt.to_tensor(x, dtype="float64"))
    assert A.want_dtypes(want, ref, f64=True) == dtypes
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    for g, w, wd in zip(got, want, dtypes):
        assert A.port_dtype(g) == wd, (g.dtype, wd)
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6, atol=1e-7)
