"""The port's ``ops/manipulation.py`` against the reference's, op by op.

The op audit's specs for the ops the reference registers in
``paddle_tpu/ops/manipulation.py`` run through both registries on the
same numpy inputs (``torch_ops_audit``: values exact for integers and
bools and at rtol 1e-5 / atol 1e-6 for floats, dtypes with the 64-bit
rule of ROADMAP C, shapes, and the gradients of the grad-checked specs at
rtol 1e-4 / atol 1e-5). The cases below add ties (a stable sort, argsort
and topk keep the lower index first, a descending sort is the ascending
one reversed), ``unique``'s four outputs, scatter and ``index_add`` with
repeated indices (only the accumulating forms, whose result is defined;
an overwriting scatter with repeated indices picks an unspecified writer
in both packages and is not compared), ``jnp.take`` semantics of
``gather`` (negative and N-d indices), negative slice steps and integer
array indices in ``getitem`` and ``setitem``, and out-of-range ids in
``one_hot``.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

import torch_ops_audit as A
from op_audit.harness import S, T

MODULE = "manipulation"
SPECS = A.specs_for(MODULE)


def _ties(*shape):
    return T(*shape, gen="custom", fn=lambda rng: rng.integers(
        0, 3, shape).astype(np.float32))


def _idx(values, dtype=np.int64):
    return T(len(values), gen="custom",
             fn=lambda rng: np.asarray(values, dtype))


EXTRA = [
    S("sort", _ties(3, 8), axis=1, suffix="ties"),
    S("sort", _ties(3, 8), axis=1, descending=True, suffix="ties-desc"),
    S("argsort", _ties(3, 8), axis=1, suffix="ties"),
    S("argsort", _ties(3, 8), axis=1, descending=True, suffix="ties-desc"),
    S("argsort", _ties(4, 3), axis=0, descending=True, suffix="ties-axis0"),
    S("topk", _ties(3, 8), k=4, suffix="ties"),
    S("topk", _ties(3, 8), k=4, largest=False, suffix="ties-smallest"),
    S("topk", _ties(8, 3), k=2, axis=0, suffix="ties-axis0"),
    S("kthvalue", _ties(3, 8), k=3, axis=1, suffix="ties"),
    S("mode", _ties(4, 9), axis=1, suffix="ties"),
    S("unique", T(3, 5, gen="int", lo=0, hi=5, dtype="int32"),
      suffix="flags"),
    S("unique", T(6, 2, gen="custom", fn=lambda rng: rng.integers(
        0, 2, (6, 2)).astype(np.int64)), axis=0, suffix="axis0"),
    S("unique_consecutive", T(10, gen="custom", fn=lambda rng: np.array(
        [1, 1, 2, 2, 2, 3, 1, 1, 4, 4], np.int64)), suffix="runs"),
    S("scatter", T(5, 4), _idx([1, 3, 1, 0, 3]), T(5, 4), overwrite=False,
      suffix="repeated-add"),
    S("index_add", T(5, 4), _idx([2, 2, 0, 2]), 0, T(4, 4),
      suffix="repeated"),
    S("put_along_axis", T(3, 6), T(3, 4, gen="custom", fn=lambda rng: np.array(
        [[0, 0, 5, 5], [1, 2, 1, 2], [3, 3, 3, 3]], np.int64)), T(3, 4), 1,
      reduce="add", suffix="repeated-add"),
    S("scatter_nd_add", T(5, 4), T(4, 1, gen="custom", fn=lambda rng: np.array(
        [[1], [1], [4], [1]], np.int64)), T(4, 4), suffix="repeated"),
    S("gather", T(5, 4), _idx([-1, 0, -5, 2]), axis=0, suffix="negative"),
    S("gather", T(3, 6), T(2, 2, gen="int", lo=0, hi=6, dtype="int64"),
      axis=1, suffix="nd-index"),
    S("getitem", T(5, 6), (slice(None, None, -1), slice(4, 0, -2)),
      suffix="negative-steps"),
    S("getitem", T(5, 6), (Ellipsis, slice(None, None, -2)),
      suffix="ellipsis-negative-step"),
    S("getitem", T(5, 6), (np.array([0, 2, 4]), slice(1, 3)),
      suffix="int-array"),
    S("setitem", T(4, 5), (np.array([3, 0]),), 7.5, suffix="rows-scalar"),
    S("one_hot", T(5, gen="custom", fn=lambda rng: np.array(
        [0, 3, 4, 5, -1], np.int64)), 4, suffix="out-of-range"),
    S("where", T(3, 4, gen="bool"), T(3, 4), 0.0, suffix="scalar"),
    S("searchsorted", T(6, gen="custom", fn=lambda rng: np.array(
        [1, 2, 2, 2, 5, 7], np.float32)), T(4, gen="custom",
                                            fn=lambda rng: np.array(
        [2, 0, 7, 9], np.float32)), right=True, suffix="ties-right"),
    S("repeat_interleave", T(2, 3), T(3, gen="custom", fn=lambda rng:
                                      np.array([1, 0, 2], np.int64)), axis=1,
      suffix="tensor-repeats"),
    S("pad_nd", T(3, 4), ((1, 2), (2, 1)), "reflect", suffix="reflect"),
    S("pad_nd", T(3, 4), ((1, 0), (3, 2)), "replicate", suffix="replicate"),
    S("pad_nd", T(3, 4), ((0, 2), (1, 3)), "circular", suffix="circular"),
]


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
    A.check_forward(spec)


SORT_GRADS = [s for s in EXTRA if s.op in ("sort", "topk", "kthvalue")]


@pytest.mark.parametrize("spec", SORT_GRADS, ids=A.ids(SORT_GRADS))
def test_gradient_through_ties_matches_the_reference(spec):
    """Among equal values the gradient reaches the element the stable
    order puts there, in both packages."""
    A.check_grad(spec)


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(GRADS)} gradients, {len(EXTRA)} extra cases")
