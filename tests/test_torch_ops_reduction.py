"""The port's ``ops/reduction.py`` against the reference's, op by op.

The op audit's specs for the ops the reference registers in
``paddle_tpu/ops/reduction.py`` run through both registries on the same
numpy inputs (``torch_ops_audit``: floats at rtol 1e-5 / atol 1e-6,
integers exact, dtypes with the 64-bit rule of ROADMAP C, shapes, and
the gradients of the grad-checked specs at rtol 1e-4 / atol 1e-5). The
cases below add ties in argmax / argmin (the first index) and in max
(the gradient split evenly), the even-count median (the mean of the two
middle values), the quantile interpolation modes, several axes at once,
integer and bool reductions, and bf16 sums and means, which both
packages accumulate in float32 and round once (held to one bf16 unit).
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

import torch_ops_audit as A
from op_audit.harness import S, T

MODULE = "reduction"
SPECS = A.specs_for(MODULE)


def _ties(*shape):
    return T(*shape, gen="custom", fn=lambda rng: rng.integers(
        0, 3, shape).astype(np.float32))


def _bf16(*shape):
    import ml_dtypes
    return T(*shape, gen="custom", fn=lambda rng: rng.standard_normal(
        shape).astype(ml_dtypes.bfloat16))


EXTRA = [
    S("argmax", _ties(4, 7), axis=1, suffix="ties"),
    S("argmin", _ties(4, 7), axis=0, keepdim=True, suffix="ties"),
    S("argmax", _ties(4, 7), suffix="ties-flat"),
    S("max", _ties(4, 7), axis=1, suffix="ties"),
    S("min", _ties(4, 7), suffix="ties-all"),
    S("median", T(4, 6), axis=1, suffix="even"),
    S("median", T(3, 4, 5), axis=[0, 2], keepdim=True, suffix="two-axes"),
    S("quantile", T(3, 7), [0.1, 0.5, 0.9], axis=1, suffix="list"),
    S("quantile", T(3, 7), 0.3, axis=1, interpolation="lower",
      suffix="lower"),
    S("quantile", T(3, 7), 0.3, axis=1, interpolation="higher",
      suffix="higher"),
    S("quantile", T(3, 7), 0.3, axis=1, interpolation="midpoint",
      suffix="midpoint"),
    S("quantile", T(3, 7), 0.3, axis=1, interpolation="nearest",
      suffix="nearest"),
    S("prod", T(2, 3, 4), axis=[0, 2], suffix="two-axes"),
    S("sum", T(3, 4, gen="bool"), axis=1, suffix="bool"),
    S("sum", T(3, 4, gen="int", lo=-5, hi=5, dtype="int32"), suffix="int32"),
    S("mean", T(3, 4, gen="int", lo=-5, hi=5, dtype="int32"), axis=0,
      suffix="int"),
    S("all", T(3, 4, gen="int", lo=0, hi=2, dtype="int32"), axis=1,
      suffix="int"),
    S("var", T(3, 5), axis=[0, 1], unbiased=False, suffix="biased"),
    S("sum", _bf16(4, 96), axis=1, suffix="bf16"),
    S("mean", _bf16(4, 96), axis=1, suffix="bf16"),
    S("sum", _bf16(4, 96), suffix="bf16-all"),
]
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


TIE_GRADS = [s for s in EXTRA if s.op in ("max", "min", "median")]


@pytest.mark.parametrize("spec", TIE_GRADS, ids=A.ids(TIE_GRADS))
def test_gradient_through_ties_matches_the_reference(spec):
    A.check_grad(spec)


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(GRADS)} gradients, {len(EXTRA)} extra cases")
