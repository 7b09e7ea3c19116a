"""The port's ``ops/linalg.py`` against the reference's, op by op.

The op audit's specs for the ops the reference registers in
``paddle_tpu/ops/linalg.py`` run through both registries on the same
numpy inputs (``torch_ops_audit``: floats at rtol 1e-5 / atol 1e-6 unless
listed in ``TOL`` below, dtypes with the 64-bit rule of ROADMAP C,
shapes, and the gradients of the grad-checked specs at rtol 1e-4 /
atol 1e-5). The columns of ``svd``'s U and V and of ``eigh``'s
eigenvectors are defined up to sign, and the two packages' LAPACK routines
pick different signs: each column is compared after taking the
reference's sign. The cases below add what the specs leave out: tall,
wide and rank-deficient ``lstsq``, ``lu`` pivots, the upper and
transposed triangular forms, a negative determinant, and the norms at
p = inf, -inf, 0, 'nuc' and over two axes.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads under xdist)

import torch_ops_audit as A
from op_audit.harness import S, T

MODULE = "linalg"
SPECS = A.specs_for(MODULE)


def _mat(m, n, seed_shift=0.0):
    return T(m, n, gen="custom", fn=lambda rng: (
        rng.standard_normal((m, n)) + seed_shift).astype(np.float32))


def _rank_deficient(m, n):
    return T(m, n, gen="custom", fn=lambda rng: (
        rng.standard_normal((m, 2)) @ rng.standard_normal((2, n))).astype(
        np.float32))


def _triangular(n, upper):
    def fn(rng):
        a = rng.standard_normal((n, n)).astype(np.float32) + 3 * np.eye(n)
        return (np.triu(a) if upper else np.tril(a)).astype(np.float32)
    return T(n, n, gen="custom", fn=fn)


EXTRA = [
    S("lstsq", _mat(6, 3), _mat(6, 2), suffix="tall"),
    S("lstsq", _mat(3, 5), _mat(3, 2), suffix="wide"),
    S("lstsq", _rank_deficient(6, 4), _mat(6, 2), suffix="rank-deficient"),
    S("lu", _mat(5, 5), suffix="pivots"),
    S("triangular_solve", _triangular(4, True), _mat(4, 2), upper=True,
      transpose=True, suffix="upper-transposed"),
    S("triangular_solve", _triangular(4, False), _mat(4, 3), upper=False,
      unitriangular=True, suffix="lower-unit"),
    S("det", T(4, 4, gen="custom", fn=lambda rng: np.diag(
        [1.0, -2.0, 0.5, 3.0]).astype(np.float32) + 0.1 * rng.standard_normal(
        (4, 4)).astype(np.float32)), suffix="negative"),
    S("slogdet", T(4, 4, gen="custom", fn=lambda rng: np.diag(
        [1.0, -2.0, 0.5, 3.0]).astype(np.float32)), suffix="negative"),
    S("norm", T(3, 5), p=float("inf"), axis=1, suffix="inf"),
    S("norm", T(3, 5), p=float("-inf"), axis=0, suffix="neg-inf"),
    S("norm", T(3, 5, gen="custom", fn=lambda rng: np.where(
        rng.random((3, 5)) < 0.4, 0, 1).astype(np.float32)), p=0, axis=1,
      suffix="zero"),
    S("norm", T(3, 5), p="nuc", axis=[0, 1], suffix="nuc"),
    S("norm", T(2, 3, 4), p=3, axis=2, keepdim=True, suffix="p3"),
    S("matrix_rank", _rank_deficient(5, 4), suffix="rank2"),
    S("cholesky", T(4, 4, gen="spd"), upper=True, suffix="upper"),
    S("qr", _mat(5, 3), mode="complete", suffix="complete"),
    S("svd", _mat(3, 5), suffix="wide"),
    S("eigh", T(4, 4, gen="spd"), UPLO="U", suffix="upper"),
    S("cross", T(2, 3), T(2, 3), axis=1, suffix="axis1"),
]
# decompositions of the two LAPACK builds: a few f32 ulps apart
A.TOL.update({"lstsq": (1e-4, 1e-5), "matrix_exp": (1e-5, 1e-5),
              "pinv": (1e-4, 1e-5), "qr-complete": (1e-5, 1e-5)})


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


def test_every_registered_op_has_a_case():
    assert A.uncovered(MODULE, SPECS) == []
    print(f"{len(A.registered_in(MODULE))} ops, {len(SPECS)} specs, "
          f"{len(GRADS)} gradients, {len(EXTRA)} extra cases")
