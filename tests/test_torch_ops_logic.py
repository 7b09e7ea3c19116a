"""The port's ``ops/logic.py`` against the reference's, op by op.

The op audit's specs for the ops the reference registers in
``paddle_tpu/ops/logic.py`` run through both registries on the same numpy
inputs (``torch_ops_audit``: bool and integer results exact, dtypes and
shapes). The cases below add comparisons of mixed dtypes and weakly typed
scalars (an integer tensor against 0.5 compares as floats), NaN,
broadcasting, the bitwise ops on signed integers and bools, shifts, and
the unregistered ``allclose``, ``equal_all`` and ``is_empty``.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
import torch_ops_audit as A
from op_audit.harness import S, T
from paddle_tpu_torch import ops as pops

MODULE = "logic"
SPECS = A.specs_for(MODULE)


def _ints(*shape, lo=-8, hi=8):
    return T(*shape, gen="int", lo=lo, hi=hi, dtype="int32")


def _nan(*shape):
    return T(*shape, gen="custom", fn=lambda rng: np.where(
        rng.random(shape) < 0.3, np.nan, rng.integers(0, 2, shape)).astype(
        np.float32))


EXTRA = [
    S("equal", _ints(3, 4), 0.5, suffix="int-weak-float"),
    S("less_than", _ints(3, 4), T(3, 4), suffix="int-float"),
    S("greater_equal", T(3, 4), _ints(1, 4), suffix="broadcast"),
    S("not_equal", _nan(3, 4), _nan(3, 4), suffix="nan"),
    S("equal", _nan(3, 4), _nan(3, 4), suffix="nan"),
    S("isclose", _nan(3, 4), _nan(3, 4), equal_nan=True, suffix="nan"),
    S("bitwise_and", _ints(3, 4), _ints(3, 4), suffix="signed"),
    S("bitwise_not", _ints(3, 4), suffix="signed"),
    S("bitwise_xor", T(3, 4, gen="bool"), T(3, 4, gen="bool"),
      suffix="bool"),
    S("bitwise_left_shift", _ints(3, 4), _ints(3, 4, lo=0, hi=4),
      suffix="signed"),
    S("bitwise_right_shift", _ints(3, 4), _ints(3, 4, lo=0, hi=4),
      suffix="arithmetic"),
    S("logical_and", _ints(3, 4, lo=0, hi=2), T(3, 4), suffix="int-float"),
    S("isin", _ints(3, 4), T(5, gen="int", lo=-3, hi=3, dtype="int32"),
      invert=True, suffix="invert"),
]


@pytest.fixture(scope="module", autouse=True)
def cpu_place():
    yield from A.cpu_place()


@pytest.mark.parametrize("spec", SPECS, ids=A.ids(SPECS))
def test_op_matches_the_reference(spec):
    A.check_forward(spec)


@pytest.mark.parametrize("spec", EXTRA, ids=A.ids(EXTRA))
def test_case_matches_the_reference(spec):
    A.check_forward(spec)


@pytest.mark.parametrize("fn", ["allclose", "equal_all", "is_empty"])
def test_unregistered_predicates_match_the_reference(fn):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    pairs = [(a, a), (a, a + 1e-7), (a, a + 1e-3), (a, a[:2])]
    for x, y in pairs:
        if fn == "is_empty":
            want = paddle.is_empty(paddle.to_tensor(x[:0] if x is y else x))
            got = pops.is_empty(pops.to_tensor(x[:0] if x is y else x))
        else:
            if x.shape != y.shape and fn == "allclose":
                continue
            want = getattr(paddle, fn)(paddle.to_tensor(x),
                                       paddle.to_tensor(y))
            got = getattr(pops, fn)(pops.to_tensor(x), pops.to_tensor(y))
        assert got.dtype == torch.bool and got.shape == []
        assert bool(got) == bool(want.numpy()), (fn, x.shape, y.shape)


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(EXTRA)} extra cases")
