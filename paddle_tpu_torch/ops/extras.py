"""Long-tail tensor ops.

Counterpart: ``paddle_tpu/ops/extras.py``: the same 55 registered ops
(special functions, split and scatter variants, dtype predicates, the
sampling utilities, the linear-algebra leftovers) and the unregistered
helpers. Where the reference has its own formula it is ported, not
torch's function of the same name: ``logcumsumexp`` (one shared max per
lane), ``cdist`` and ``pdist`` (``sqrt(sum d^2 + 1e-30)`` at p = 2),
``renorm`` (the 1e-7 guard), ``masked_scatter`` (values taken in order,
the last one repeated), ``take`` (``raise`` clamps as ``clip`` does),
``cartesian_prod`` (always [N, k]), ``svd_lowrank`` and ``pca_lowrank``
(the leading q of a full SVD, with no random projection) and
``standard_gamma`` (Marsaglia and Tsang's rejection over the framework
generator's threefry keys, one key per element, as ``jax.random.gamma``;
its gradient is torch's implicit reparameterisation gradient).

``create_parameter`` (:603) draws through ``nn.initializer``'s classes
as ``Layer.create_parameter`` does; the reference's static-mode
registration is A9's. Not ported: ``binomial`` (it draws through
``distribution/``, which is not ported yet).
"""
from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import generator as gen_mod
from ..core.dispatch import register_op
from ..core.tensor import to_plain, wrap
from ._helpers import operands, tensor
from ..nn.functional.sampling import threefry2x32
from .random import _unit_floats, categorical_bits, erfinv32, split


def _float(x):
    x = tensor(x)
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(dtypes.get_default_dtype())


# -- special functions -------------------------------------------------------

@register_op("gammaln", amp="black")
def gammaln(x, name=None):
    return torch.lgamma(_float(x))


class _IncompleteGamma(torch.autograd.Function):
    """P(a, x) (or Q with ``upper``) with both derivatives: torch has the
    one in x only; the one in a (the reference's ``igamma_grad_a``) is a
    central difference of P in float64, a step of 1e-4 * max(a, 1)."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        fn = torch.special.gammaincc if upper else torch.special.gammainc
        return fn(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        a64, x64 = a.double(), x.double()
        dx = sign * torch.exp(-x64 + (a64 - 1) * torch.log(x64)
                              - torch.lgamma(a64))
        h = 1e-4 * torch.clamp_min(a64, 1.0)
        da = sign * (torch.special.gammainc(a64 + h, x64)
                     - torch.special.gammainc(a64 - h, x64)) / (2 * h)
        ga = (g.double() * da).to(a.dtype)
        gx = (g.double() * dx).to(x.dtype)
        return _reduce_to(ga, a.shape), _reduce_to(gx, x.shape), None


def _reduce_to(g, shape):
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


@register_op("gammainc", amp="black")
def gammainc(x, y, name=None):
    x, y = operands(_float(x), _float(y))
    return _IncompleteGamma.apply(x, y, False)


@register_op("gammaincc", amp="black")
def gammaincc(x, y, name=None):
    x, y = operands(_float(x), _float(y))
    return _IncompleteGamma.apply(x, y, True)


@register_op("multigammaln", amp="black")
def multigammaln(x, p, name=None):
    x = _float(x)
    j = torch.arange(1, int(p) + 1, dtype=x.dtype, device=x.device)
    return (p * (p - 1) / 4.0 * _math.log(_math.pi)
            + torch.lgamma(x[..., None] + (1.0 - j) / 2.0).sum(-1))


@register_op("polygamma", amp="black")
def polygamma(x, n, name=None):
    return torch.polygamma(int(n), _float(x))


@register_op("i0", amp="black")
def i0(x, name=None):
    return torch.special.i0(_float(x))


@register_op("i0e", amp="black")
def i0e(x, name=None):
    return torch.special.i0e(_float(x))


@register_op("i1", amp="black")
def i1(x, name=None):
    return torch.special.i1(_float(x))


@register_op("i1e", amp="black")
def i1e(x, name=None):
    return torch.special.i1e(_float(x))


@register_op("logit", amp="black")
def logit(x, eps=None, name=None):
    x = _float(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


@register_op("sinc")
def sinc(x, name=None):
    return torch.sinc(_float(x))


@register_op("nextafter", differentiable=False)
def nextafter(x, y, name=None):
    return torch.nextafter(*operands(x, y))


@register_op("logcumsumexp")
def logcumsumexp(x, axis=-1, name=None):
    x = _float(x)
    m = torch.amax(x, dim=axis, keepdim=True)
    return torch.log(torch.cumsum(torch.exp(x - m), dim=axis)) + m


@register_op("angle", amp="black")
def angle(x, name=None):
    return torch.angle(_float(x))


@register_op("polar")
def polar(abs, angle, name=None):  # noqa: A002
    a, t = operands(abs, angle)
    return torch.complex(a * torch.cos(t), a * torch.sin(t))


@register_op("sgn")
def sgn(x, name=None):
    x = tensor(x)
    if x.is_complex():
        mag = torch.abs(x)
        return torch.where(mag == 0, torch.zeros_like(x),
                           x / torch.clamp_min(mag, 1e-38))
    return torch.sign(x)


@register_op("signbit", differentiable=False)
def signbit(x, name=None):
    return torch.signbit(tensor(x))


@register_op("frexp", multi_out=True, differentiable=False)
def frexp(x, name=None):
    m, e = torch.frexp(_float(x))
    return m, e


# -- shape / composition -----------------------------------------------------

def atleast_1d(*inputs, name=None):
    outs = [_atleast(x, 1) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [_atleast(x, 2) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [_atleast(x, 3) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


@register_op("atleast_nd")
def _atleast(x, n):
    x = tensor(x)
    while x.ndim < n:
        x = x[None] if x.ndim != 2 or n != 3 else x[..., None]
    return x


@register_op("add_n")
def add_n(inputs, name=None):
    vals = [tensor(v) for v in inputs]
    out = vals[0]
    for v in vals[1:]:
        out = torch.add(*operands(out, v))
    return out


@register_op("block_diag")
def block_diag(inputs, name=None):
    return torch.block_diag(*[tensor(v) for v in inputs])


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(x, name=None):
    from .creation import to_tensor
    x = to_plain(x)
    return to_tensor(x.ndim, dtype="int32", place=x.device)


@register_op("reverse")
def reverse(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(tensor(x), dims=axes)


@register_op("unstack", multi_out=True)
def unstack(x, axis=0, num=None, name=None):
    return tuple(torch.unbind(tensor(x), dim=axis))


@register_op("unflatten")
def unflatten(x, axis, shape, name=None):
    x = tensor(x)
    axis = axis % x.ndim
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = x.shape[axis] // known
    return x.reshape(tuple(x.shape[:axis]) + tuple(shape)
                     + tuple(x.shape[axis + 1:]))


@register_op("tensor_unfold")
def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``: that axis becomes the window count
    and a last axis of ``size`` is added (``Tensor.unfold``)."""
    x = tensor(x)
    return x.unfold(axis % x.ndim, size, step)


def tensor_split(x, num_or_indices, axis=0, name=None):
    from .manipulation import split as _split
    n_ax = to_plain(x).shape[axis]
    if isinstance(num_or_indices, int):
        n = num_or_indices
        sizes = [n_ax // n + (1 if i < n_ax % n else 0) for i in range(n)]
        return _split(x, sizes, axis=axis)
    idx = [0] + list(num_or_indices) + [n_ax]
    return _split(x, [b - a for a, b in zip(idx[:-1], idx[1:])], axis=axis)


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices,
                        axis=0 if to_plain(x).ndim == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


@register_op("vander")
def vander(x, n=None, increasing=False, name=None):
    """``x[..., None] ** p`` over the powers p = N-1 ... 0 (or 0 ... N-1),
    as ``jnp.vander`` computes it."""
    x = _float(x)
    n = x.shape[-1] if n is None else n
    p = torch.arange(n, dtype=x.dtype, device=x.device)
    if not increasing:
        p = (n - 1) - p
    return torch.pow(x[..., None], p)


def view_as(x, other, name=None):
    from .manipulation import reshape
    return reshape(x, list(to_plain(other).shape))


# -- scatter family ----------------------------------------------------------

@register_op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    x = tensor(x)
    return torch.diagonal_scatter(x, tensor(y, x, x.dtype), offset, axis1,
                                  axis2)


@register_op("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    x = tensor(x)
    return torch.select_scatter(x, tensor(values, x, x.dtype), axis, index)


@register_op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides=None, name=None):
    x = tensor(x)
    idx = [slice(None)] * x.ndim
    strides = strides or [1] * len(axes)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sd)
    out = x.clone()
    out[tuple(idx)] = tensor(value, x, x.dtype)
    return out


@register_op("masked_scatter")
def masked_scatter(x, mask, value, name=None):
    """Masked positions take consecutive values (row-major order); past
    the last value the last one repeats."""
    x = tensor(x)
    m = torch.broadcast_to(tensor(mask, x).bool(), x.shape)
    v = tensor(value, x).reshape(-1)
    pos = torch.cumsum(m.reshape(-1).long(), 0) - 1
    filler = v[pos.clamp(0, v.numel() - 1)].reshape(x.shape)
    return torch.where(m, filler.to(x.dtype), x)


@register_op("index_fill")
def index_fill(x, index, axis, value, name=None):
    x = tensor(x)
    idx = tensor(index, x).long().reshape(-1)
    if isinstance(value, torch.Tensor):
        return x.index_fill(axis, idx, value.to(x.dtype))
    return x.index_fill(axis, idx, value)


@register_op("take")
def take(x, index, mode="raise", name=None):
    """Flat-index gather; ``wrap`` takes indices modulo the size, ``raise``
    and ``clip`` clamp them."""
    x = tensor(x).reshape(-1)
    idx = tensor(index, x).long()
    n = x.numel()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(-n, n - 1)
    return x[torch.where(idx < 0, idx + n, idx)]


# -- numerics / reductions ---------------------------------------------------

@register_op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    from .reduction import _quantile
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


@register_op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _float(y)
    if x is not None:
        return torch.trapezoid(y, tensor(x, y, y.dtype), dim=axis)
    return torch.trapezoid(y, dx=dx or 1.0, dim=axis)


@register_op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = _float(y)
    axis = axis % y.ndim
    n = y.shape[axis]
    y0, y1 = y.narrow(axis, 0, n - 1), y.narrow(axis, 1, n - 1)
    if x is not None:
        xv = tensor(x, y, y.dtype)
        d = torch.diff(xv, dim=axis if xv.ndim == y.ndim else 0)
        if d.ndim != y.ndim:
            shape = [1] * y.ndim
            shape[axis] = -1
            d = d.reshape(shape)
    else:
        d = dx or 1.0
    return torch.cumsum((y0 + y1) / 2.0 * d, dim=axis)


@register_op("renorm")
def renorm(x, p, axis, max_norm, name=None):
    x = _float(x)
    axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


@register_op("reduce_as")
def reduce_as(x, target, name=None):
    x = tensor(x)
    tgt_shape = tuple(tensor(target).shape)
    while x.ndim > len(tgt_shape):
        x = x.sum(0)
    for i, (a, b) in enumerate(zip(x.shape, tgt_shape)):
        if a != b:
            x = x.sum(i, keepdim=True)
    return x


@register_op("cdist")
def cdist(x, y, p=2.0, name=None):
    x, y = operands(x, y)
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 2.0:
        return torch.sqrt((diff ** 2).sum(-1) + 1e-30)
    return (diff ** p).sum(-1) ** (1.0 / p)


@register_op("histogram_bin_edges", differentiable=False)
def histogram_bin_edges(x, bins=100, min=0, max=0, name=None):  # noqa: A002
    x = tensor(x)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    return torch.linspace(lo, hi, bins + 1, dtype=dtypes.get_default_dtype(),
                          device=x.device)


@register_op("cond", differentiable=False)
def cond(x, p=None, name=None):
    """Matrix condition number."""
    x = _float(x)
    if p is None or p == 2 or p == "2":
        s = torch.linalg.svdvals(x)
        return s[..., 0] / s[..., -1]
    return torch.linalg.matrix_norm(x, ord=p) * torch.linalg.matrix_norm(
        torch.linalg.inv(x), ord=p)


@register_op("cholesky_inverse")
def cholesky_inverse(x, upper=False, name=None):
    x = _float(x)
    L = torch.triu(x) if upper else torch.tril(x)
    a = L.T @ L if upper else L @ L.T
    return torch.linalg.inv(a)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    v = to_plain(x)
    if M is not None:
        v = v - to_plain(M)
    u, s, vh = torch.linalg.svd(v, full_matrices=False)
    q = min(q, s.shape[-1])
    return (wrap(u[..., :q]), wrap(s[..., :q]),
            wrap(vh.transpose(-1, -2)[..., :q]))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    v = to_plain(x)
    if center:
        v = v - v.mean(0, keepdim=True)
    q = q or min(6, *v.shape)
    u, s, vh = torch.linalg.svd(v, full_matrices=False)
    return (wrap(u[..., :q]), wrap(s[..., :q]),
            wrap(vh.transpose(-1, -2)[..., :q]))


# -- dtype predicates --------------------------------------------------------

def is_complex(x):
    return to_plain(x).dtype.is_complex


def is_floating_point(x):
    return to_plain(x).dtype.is_floating_point


def is_integer(x):
    return dtypes.is_integer(to_plain(x).dtype)


@register_op("isneginf", differentiable=False)
def isneginf(x, name=None):
    return torch.isneginf(tensor(x))


@register_op("isposinf", differentiable=False)
def isposinf(x, name=None):
    return torch.isposinf(tensor(x))


@register_op("isreal", differentiable=False)
def isreal(x, name=None):
    return torch.isreal(tensor(x))


# -- sampling utilities ------------------------------------------------------

@register_op("top_p_sampling", multi_out=True, differentiable=False)
def _top_p_sampling(key, probs, top_p, threshold):
    p = tensor(probs)
    tp = tensor(top_p, p).reshape(-1)[:, None]
    sorted_idx = torch.sort(-p, dim=-1, stable=True).indices
    sorted_p = torch.gather(p, -1, sorted_idx)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = cum - sorted_p < tp
    if threshold is not None:
        th = tensor(threshold, p).reshape(-1)[:, None]
        keep = keep & (sorted_p >= th)
    keep[..., 0] = True
    filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    filtered = filtered / filtered.sum(-1, keepdim=True)
    choice = categorical_bits(key, torch.log(filtered + 1e-30))
    ids = torch.gather(sorted_idx, -1, choice[..., None])
    scores = torch.gather(filtered, -1, choice[..., None])
    return scores, ids


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over probabilities [B, V] with per-row thresholds
    ``ps`` [B] → (scores, ids)."""
    return _top_p_sampling(gen_mod.default_generator.split_key(), x, ps,
                           threshold)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,  # noqa: A002
                name=None):
    v = to_plain(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    inside = (v >= lo) & (v < lo + shard_size)
    return wrap(torch.where(inside, v - lo, torch.full_like(v, ignore_value)))


# -- in-place RNG fills (Tensor.cauchy_ / geometric_ / log_normal_ /
#    bernoulli_) ---------------------------------------------------------------

def _fill_(x, values):
    xv = to_plain(x)
    with torch.no_grad():
        xv.copy_(to_plain(values).to(xv.dtype))
    return x


def _uniform_like(x, lo, hi):
    from .random import _key, _uniform
    xv = to_plain(x)
    return _uniform(_key(), tuple(xv.shape), dtypes.get_default_dtype(), lo,
                    hi, device=xv.device)


def cauchy_(x, loc=0, scale=1, name=None):
    u = _uniform_like(x, 1e-6, 1 - 1e-6)
    return _fill_(x, loc + scale * torch.tan(_math.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    u = _uniform_like(x, 1e-6, 1 - 1e-6)
    p = min(max(float(probs), 1e-6), 1 - 1e-6)
    return _fill_(x, torch.floor(torch.log(u) / _math.log1p(-p)))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    from .random import _key, _normal
    xv = to_plain(x)
    z = _normal(_key(), tuple(xv.shape), dtypes.get_default_dtype(), 0.0,
                1.0, device=xv.device)
    return _fill_(x, torch.exp(mean + std * z))


def bernoulli_(x, p=0.5, name=None):
    u = _uniform_like(x, 0.0, 1.0)
    return _fill_(x, u < p)


# -- linalg leftovers --------------------------------------------------------

@register_op("householder_product")
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(*operands(x, tau))


@register_op("ormqr")
def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """y multiplied by the full m x m Q of the geqrf factors (x, tau):
    the reflectors padded to m with zero columns and zero taus (identity
    reflectors)."""
    a, t = operands(x, tau)
    m, k = a.shape[-2], a.shape[-1]
    if k < m:
        a = torch.nn.functional.pad(a, (0, m - k))
        t = torch.nn.functional.pad(t, (0, m - k))
    q = torch.linalg.householder_product(a, t)
    if transpose:
        q = q.transpose(-1, -2)
    other = tensor(y, q, q.dtype)
    return q @ other if left else other @ q


@register_op("lu_unpack", multi_out=True)
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of a combined LU factor and its 1-based pivots, with
    ``A = P @ L @ U``."""
    lu_ = tensor(x)
    piv = tensor(y, lu_).to(torch.int32)
    return tuple(torch.lu_unpack(lu_, piv))


def create_tensor(dtype, name=None, persistable=False):
    from .creation import to_tensor
    return to_tensor(np.zeros((), np.float32), dtype=dtype)


# -- top-level namespace leftovers -------------------------------------------

@register_op("complex_op")
def complex(real, imag, name=None):  # noqa: A001
    return torch.complex(*operands(real, imag))


@register_op("cartesian_prod")
def cartesian_prod(x, name=None):
    grids = torch.meshgrid(*[tensor(v) for v in x], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False, name=None):
    v = to_plain(x)
    n = v.shape[0]
    combo = (itertools.combinations_with_replacement(range(n), r)
             if with_replacement else itertools.combinations(range(n), r))
    idx = torch.tensor(list(combo), dtype=torch.long,
                       device=v.device).reshape(-1, r)
    return wrap(v[idx])


@register_op("column_stack")
def column_stack(x, name=None):
    vals = [tensor(v) for v in x]
    vals = [v[:, None] if v.ndim == 1 else v for v in vals]
    return torch.cat(vals, dim=1)


@register_op("row_stack")
def row_stack(x, name=None):
    return torch.vstack([tensor(v) for v in x])


@register_op("dstack")
def dstack(x, name=None):
    return torch.dstack([tensor(v) for v in x])


@register_op("pdist")
def pdist(x, p=2.0, name=None):
    v = tensor(x)
    iu, ju = torch.triu_indices(v.shape[0], v.shape[0], 1, device=v.device)
    diff = torch.abs(v[iu] - v[ju])
    if p == 2.0:
        return torch.sqrt((diff ** 2).sum(-1) + 1e-30)
    return (diff ** p).sum(-1) ** (1.0 / p)


def _gamma_one(keys, alpha):
    """Marsaglia and Tsang for a vector of per-element keys (two word
    tensors) and float32 rates, as ``jax.random``'s ``_gamma_one`` runs
    each element: alpha < 1 boosted to alpha + 1 and scaled by
    u^(1/alpha)."""
    boost_mask = alpha >= 1
    a = torch.where(boost_mask, alpha, alpha + 1)
    d = a - 1.0 / 3.0
    c = (1.0 / 3.0) / torch.sqrt(d)
    key, sub = split(keys)
    X = torch.zeros_like(a)
    V = torch.ones_like(a)
    U = torch.full_like(a, 2.0)

    def more(X, V, U):
        return (U >= 1 - 0.0331 * X * X) & (
            torch.log(U) >= X * 0.5 + d * (1 - V + torch.log(V)))

    active = more(X, V, U)
    while bool(active.any()):
        nkey, xkey, ukey = split(key, 3)
        x = torch.zeros_like(a)
        v = torch.full_like(a, -1.0)
        todo = v <= 0
        while bool(todo.any()):
            xkey_n, s = split(xkey)
            xn = _normal_per_key(s)
            vn = 1 + xn * c
            x = torch.where(todo, xn, x)
            v = torch.where(todo, vn, v)
            xkey = tuple(torch.where(todo, kn, ko)
                         for kn, ko in zip(xkey_n, xkey))
            todo = v <= 0
        un = _uniform_per_key(ukey)
        X = torch.where(active, x * x, X)
        V = torch.where(active, v * v * v, V)
        U = torch.where(active, un, U)
        key = tuple(torch.where(active, kn, ko) for kn, ko in zip(nkey, key))
        active = active & more(X, V, U)
    samples = 1 - _uniform_per_key(sub)
    boost = torch.where(boost_mask, torch.ones_like(a),
                        torch.pow(samples, 1.0 / alpha))
    return d * V * boost


def _uniform_per_key(key):
    """One float32 uniform in [0, 1) per key (two word tensors): the bits
    of the counter pair (0, 0)."""
    y1, y2 = threefry2x32(key[0], key[1], 0, 0)
    return _unit_floats(y1 ^ y2, torch.float32)


def _normal_per_key(key):
    """One standard normal per key (``jax.random.normal(key, ())``)."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = torch.clamp_min(_uniform_per_key(key) * 2.0 + lo, lo)
    return _math.sqrt(2) * erfinv32(u)


class _Gamma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, key, alpha):
        a = alpha.detach().float().reshape(-1)
        n = a.numel()
        k1, k2 = key
        idx = torch.arange(n, dtype=torch.int64, device=a.device)
        keys = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
        out = _gamma_one(keys, a).reshape(alpha.shape).to(alpha.dtype)
        ctx.save_for_backward(alpha, out)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, out = ctx.saved_tensors
        return None, g * torch._standard_gamma_grad(alpha, out)


@register_op("standard_gamma", differentiable=True)
def _standard_gamma_raw(key, alpha):
    return _Gamma.apply(key, tensor(alpha).float())


def standard_gamma(x, name=None):
    return _standard_gamma_raw(gen_mod.default_generator.split_key(), x)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    from .math import add, exp, multiply
    from .random import standard_normal
    shp = list(shape) if shape is not None else []
    z = standard_normal(shp or [1])
    out = exp(add(multiply(z, std), mean))
    return out if shp else out.reshape([])


def finfo(dtype):
    return torch.finfo(dtypes.convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(dtypes.convert_dtype(dtype))


def tolist(x):
    x = to_plain(x)
    return x.tolist() if isinstance(x, torch.Tensor) else list(x)



def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``paddle.create_parameter``: a trainable parameter drawn by
    ``default_initializer`` (None: Constant(0) for a bias, XavierNormal
    otherwise) on the current place."""
    from ..nn.layer.layers import make_parameter
    from ..utils import unique_name
    return make_parameter(shape, dtypes.convert_dtype(dtype),
                          default_initializer, is_bias,
                          name or unique_name.generate("create_parameter"))
