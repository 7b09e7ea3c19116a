"""Linear-algebra ops.

Counterpart: ``paddle_tpu/ops/linalg.py``: the same 32 registered ops and
``multi_dot``. The decompositions are ``torch.linalg`` (LAPACK on the
CPU; cuSOLVER or MAGMA on the card), with the reference's conventions:
``svd`` returns V (not V^H), ``lu`` 1-based int32 pivots, ``cholesky``,
``eigh`` and ``eigvalsh`` read the symmetrised input ``(A + A^H) / 2``
as ``jnp.linalg`` does, ``lstsq`` is the reference's SVD least-squares
(solution, residuals, rank, singular values) on every device, ``norm``
and ``dist`` are the reference's formulas, and ``cross`` with the
default ``axis=9`` takes the first axis of size 3.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.dispatch import register_op
from ..core.tensor import to_plain
from ._helpers import operands, tensor


@register_op("einsum", amp="white")
def _einsum_op(equation, *operands_):
    return torch.einsum(equation, *[tensor(o) for o in operands_])


def einsum(equation, *operands_):
    return _einsum_op(equation, *operands_)


def _pnorm(x, p, axis, keepdim):
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


@register_op("norm", amp="black")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = tensor(x)
    if p is None:
        p = "fro" if axis is None or not isinstance(axis, int) else 2
    if axis is None and p == "fro":
        return torch.sqrt(torch.sum(x * x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(axis, (list, tuple)):
        return torch.linalg.norm(x, ord=p, dim=tuple(axis), keepdim=keepdim)
    return _pnorm(x, p, axis, keepdim)


@register_op("vector_norm", amp="black")
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    x = tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(axis, (list, tuple)):
        return torch.linalg.norm(x, ord=p, dim=tuple(axis), keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


@register_op("matrix_norm", amp="black")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(tensor(x), ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@register_op("dist", amp="black")
def dist(x, y, p=2, name=None):
    x, y = operands(x, y)
    return _pnorm((x - y).reshape(-1), p, 0, False)


@register_op("cross")
def cross(x, y, axis=9, name=None):
    x, y = operands(x, y)
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def _sym(x):
    return (x + x.mH) / 2


@register_op("cholesky", amp="black")
def cholesky(x, upper=False, name=None):
    L = torch.linalg.cholesky(_sym(tensor(x)))
    return L.mH if upper else L


@register_op("cholesky_solve", amp="black")
def cholesky_solve(x, y, upper=False, name=None):
    b, c = operands(x, y)
    if upper:
        c = c.transpose(-1, -2)
    return torch.cholesky_solve(b, torch.tril(c), upper=False)


@register_op("inverse", amp="black")
def inverse(x, name=None):
    return torch.linalg.inv(tensor(x))


@register_op("pinv", amp="black")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(tensor(x), rtol=rcond, hermitian=hermitian)


@register_op("solve", amp="black")
def solve(x, y, name=None):
    return torch.linalg.solve(*operands(x, y))


@register_op("triangular_solve", amp="black")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = operands(x, y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


@register_op("lstsq", amp="black", multi_out=True, differentiable=False)
def lstsq(x, y, rcond=None, driver=None, name=None):
    """``jnp.linalg.lstsq``: the minimum-norm solution through the SVD
    (singular values below ``rcond`` times the largest dropped), the
    residual sums of squares (always computed), the rank and the singular
    values."""
    a, b = operands(x, y)
    m, n = a.shape[-2], a.shape[-1]
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(a.dtype).eps
    keep = (s > 0) & (s >= rcond * s[..., :1])
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.mH @ (inv_s[..., None] * (u.mH @ b))
    res = torch.linalg.vector_norm(b - a @ sol, dim=-2) ** 2
    if vec:
        sol, res = sol[..., 0], res[..., 0]
    return sol, res, keep.sum(-1), s


@register_op("qr", amp="black", multi_out=True)
def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(tensor(x), mode=mode))


@register_op("svd", amp="black", multi_out=True)
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(tensor(x), full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


@register_op("eig", amp="black", multi_out=True, differentiable=False)
def eig(x, name=None):
    return tuple(torch.linalg.eig(tensor(x)))


@register_op("eigh", amp="black", multi_out=True)
def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_sym(tensor(x)), UPLO=UPLO))


@register_op("eigvals", amp="black", differentiable=False)
def eigvals(x, name=None):
    return torch.linalg.eigvals(tensor(x))


@register_op("eigvalsh", amp="black")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_sym(tensor(x)), UPLO=UPLO)


@register_op("matrix_power", amp="black")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(tensor(x), n)


@register_op("matrix_rank", differentiable=False)
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(tensor(x), rtol=tol, hermitian=hermitian)


@register_op("det", amp="black")
def det(x, name=None):
    return torch.linalg.det(tensor(x))


@register_op("slogdet", amp="black", multi_out=True)
def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(tensor(x))
    return sign, logdet


@register_op("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2).sum(-1)


@register_op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2)


@register_op("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    return torch.diag_embed(tensor(input), offset, dim1, dim2)


@register_op("lu", amp="black", multi_out=True, differentiable=False)
def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(tensor(x))
    return lu_, piv.to(torch.int32)       # LAPACK's pivots: 1-based


@register_op("matrix_exp", amp="black")
def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(tensor(x))


@register_op("corrcoef", amp="black")
def corrcoef(x, rowvar=True, name=None):
    x = tensor(x)
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@register_op("cov", amp="black")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = tensor(x)
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None else tensor(fweights, x),
                     aweights=None if aweights is None else tensor(aweights, x))


@register_op("histogramdd", differentiable=False, multi_out=True)
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``jnp.histogramdd``: per-dimension edges, each sample binned by
    ``searchsorted(edges, v, right)`` (the last edge inclusive), counts
    outside the range dropped; integer counts unless weighted or a
    density."""
    x = tensor(x)
    if not x.is_floating_point():
        x = x.to(dtypes.get_default_dtype())
    n, d = x.shape
    bins = [bins] * d if isinstance(bins, int) else list(bins)
    counts = weights is None and not density
    w = torch.ones(n, dtype=torch.long if counts else x.dtype,
                   device=x.device) if weights is None \
        else tensor(weights, x, x.dtype)
    edges, flat = [], torch.zeros(n, dtype=torch.long, device=x.device)
    for i in range(d):
        col = x[:, i]
        if ranges is None:
            lo, hi = float(col.min()), float(col.max())
        else:
            lo, hi = (float(v) for v in ranges[i])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        e = torch.linspace(lo, hi, bins[i] + 1, dtype=x.dtype,
                           device=x.device)
        idx = torch.searchsorted(e, col.contiguous(), right=True)
        idx = torch.where(col == e[-1], torch.full_like(idx, bins[i]), idx)
        flat = flat * (bins[i] + 2) + idx
        edges.append(e)
    sizes = [b + 2 for b in bins]
    total = 1
    for s in sizes:
        total *= s
    h = torch.zeros(total, dtype=w.dtype, device=x.device).index_add(
        0, flat, w).reshape(sizes)
    h = h[tuple(slice(1, -1) for _ in sizes)]
    if density:
        h = h / h.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            h = h / torch.diff(e).reshape(shape)
    return (h,) + tuple(edges)


def multi_dot(x, name=None):
    return _multi_dot_op(*x)


@register_op("multi_dot", amp="white")
def _multi_dot_op(*arrays):
    return torch.linalg.multi_dot([tensor(to_plain(a)) for a in arrays])


__all__ = ["cholesky", "cholesky_solve", "corrcoef", "cov", "cross", "det",
           "diag_embed", "diagonal", "dist", "eig", "eigh", "eigvals",
           "eigvalsh", "einsum", "histogramdd", "inverse", "lstsq", "lu",
           "matrix_exp", "matrix_norm", "matrix_power", "matrix_rank",
           "multi_dot", "norm", "pinv", "qr", "slogdet", "solve", "svd",
           "trace", "triangular_solve", "vector_norm"]
