"""Reduction ops.

Counterpart: ``paddle_tpu/ops/reduction.py``: the same 20 registered ops.
Paddle's ``axis=None`` reduces every axis and ``keepdim`` defaults to
False. The reference's semantics where torch's differ: ``median`` is the
mean of the two middle values of an even count (torch's is the lower
one), ``max`` / ``min`` return values only and split the gradient evenly
among ties (torch's ``amax``), ``mean``, ``var``, ``std`` and
``logsumexp`` of integers are taken in the default float dtype, ``prod``
and ``median`` take several axes, and a bool ``sum`` counts in int64.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtypes
from ..core.dispatch import register_op
from ._helpers import axis_arg, tensor


def _dims(x, axis):
    """Paddle's axis as a tuple of non-negative dims (all when None)."""
    axis = axis_arg(axis)
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % builtins.max(x.ndim, 1) for a in axis)


def _float(x):
    x = tensor(x)
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(dtypes.get_default_dtype())


def _merged(x, axis):
    """(x with the reduced axes moved last and flattened into one,
    the kept shape with the reduced axes as 1)."""
    dims = _dims(x, axis)
    rest = [d for d in range(x.ndim) if d not in dims]
    keep = [1 if d in dims else x.shape[d] for d in range(x.ndim)]
    y = x.permute(*rest, *dims) if x.ndim else x.reshape(1)
    return y.reshape(*[x.shape[d] for d in rest], -1), keep


def _keep(out, keep, keepdim):
    return out.reshape(keep) if keepdim else out


@register_op("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    x = tensor(x)
    if x.dtype == torch.bool and dtype is None:
        dtype = torch.int64
    dt = dtypes.convert_dtype(dtype)
    if x.ndim == 0:
        return x.to(dt) if dt is not None else x.clone()
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dt)


@register_op("mean")
def mean(x, axis=None, keepdim=False, name=None):
    x = _float(x)
    if x.ndim == 0:
        return x.clone()
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = tensor(x)
    y, keep = _merged(x, axis)
    return _keep(torch.prod(y, dim=-1, dtype=dtypes.convert_dtype(dtype)),
                 keep, keepdim)


def _extreme(fn, x, axis, keepdim):
    x = tensor(x)
    if x.ndim == 0:
        return x.clone()
    return fn(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("max")
def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _extreme(torch.amax, x, axis, keepdim)


@register_op("min")
def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _extreme(torch.amin, x, axis, keepdim)


@register_op("amax")
def amax(x, axis=None, keepdim=False, name=None):
    return _extreme(torch.amax, x, axis, keepdim)


@register_op("amin")
def amin(x, axis=None, keepdim=False, name=None):
    return _extreme(torch.amin, x, axis, keepdim)


@register_op("all", differentiable=False)
def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = tensor(x).bool()
    if x.ndim == 0:
        return x.clone()
    return torch.all(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("any", differentiable=False)
def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = tensor(x).bool()
    if x.ndim == 0:
        return x.clone()
    return torch.any(x, dim=_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    x = tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return fn(x, dim=int(axis), keepdim=keepdim).to(
        dtypes.convert_dtype(dtype))


@register_op("argmax", differentiable=False)
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The index of the first maximum (NaN counts as the maximum)."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@register_op("argmin", differentiable=False)
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@register_op("logsumexp", amp="black")
def logsumexp(x, axis=None, keepdim=False, name=None):
    x = _float(x)
    if x.ndim == 0:
        return x.clone()
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation="linear"):
    x = _float(x)
    y, keep = _merged(x, axis)
    qt = q if isinstance(q, torch.Tensor) else torch.tensor(q)
    qt = qt.to(device=x.device, dtype=x.dtype)
    out = fn(y, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out


@register_op("median")
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@register_op("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


@register_op("quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


@register_op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = tensor(x)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=dtypes.convert_dtype(dtype))


@register_op("nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    x = _float(x)
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


@register_op("count_nonzero", differentiable=False)
def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = tensor(x)
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.ndim)])
    return out


def _moment(fn, x, axis, unbiased, keepdim):
    x = _float(x)
    return fn(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
              keepdim=keepdim)


@register_op("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.var, x, axis, unbiased, keepdim)


@register_op("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.std, x, axis, unbiased, keepdim)


__all__ = ["all", "amax", "amin", "any", "argmax", "argmin",
           "count_nonzero", "logsumexp", "max", "mean", "median", "min",
           "nanmean", "nanmedian", "nansum", "prod", "quantile", "std",
           "sum", "var"]
