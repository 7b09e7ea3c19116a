"""Tensor creation ops.

Counterpart: ``paddle_tpu/ops/creation.py``: ``to_tensor``, ``zeros``,
``ones``, ``full``, ``empty``, ``arange``, ``linspace``, ``logspace``,
``eye``, ``meshgrid``, ``clone``, ``tril_indices`` / ``triu_indices``
and the 8 registered ops (``zeros_like``, ``ones_like``, ``full_like``,
``assign``, ``diag``, ``diagflat``, ``tril``, ``triu``).

The creation functions are user entry points: they return facade
tensors (``core/tensor.py``) on the current place (``core/place.py``:
the card unless ``set_device("cpu")`` or ``place=`` asks for the CPU).
Dtypes follow Paddle: Python floats and float64 host data become the
default dtype (float32), integers int64, booleans bool; a dtype the
caller names is kept, 64-bit included (the reference narrows 64-bit
integers to int32 on the TPU; see ``core/dtype.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.dispatch import register_op
from ..core.place import Place, _parse, default_device
from ..core.tensor import Tensor, to_plain, wrap
from ._helpers import shape_arg, tensor


def _dt(dtype, default=None):
    return default if dtype is None else dtypes.convert_dtype(dtype)


def _device(place=None) -> torch.device:
    if place is None:
        return default_device()
    return (place if isinstance(place, Place) else _parse(place)).torch_device()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new facade tensor holding ``data`` (a copy)
    on ``place`` (default: the current place; a tensor keeps its own
    device unless ``place`` is given)."""
    if isinstance(data, torch.Tensor):
        t = to_plain(data).detach()
        if dtype is not None:
            t = t.to(dtypes.convert_dtype(dtype))
        t = t.to(_device(place)) if place is not None else t
        return Tensor(t.clone(), stop_gradient=stop_gradient)
    dev = _device(place)
    if isinstance(data, (list, tuple)) and data and all(
            isinstance(v, torch.Tensor) for v in data):
        t = torch.stack([to_plain(v).detach().to(dev) for v in data])
    else:
        arr = np.asarray(data)
        t = torch.from_numpy(np.array(arr, copy=True))
        if arr.dtype == np.float64 and dtype is None:
            t = t.to(dtypes.get_default_dtype())
    if dtype is not None:
        t = t.to(dtypes.convert_dtype(dtype))
    return Tensor(t.to(dev), stop_gradient=stop_gradient)


def _new(fn, shape, dtype):
    return wrap(fn(shape_arg(shape), dtype=dtype, device=default_device()))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, shape, _dt(dtype, dtypes.get_default_dtype()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, shape, _dt(dtype, dtypes.get_default_dtype()))


def full(shape, fill_value, dtype=None, name=None):
    fill = to_plain(fill_value)
    if isinstance(fill, torch.Tensor):
        fill = fill.item()
    if dtype is None:
        if isinstance(fill, bool):
            dtype = dtypes.bool_
        elif isinstance(fill, int):
            dtype = dtypes.int64
        else:
            dtype = dtypes.get_default_dtype()
    return wrap(torch.full(shape_arg(shape), fill, dtype=_dt(dtype),
                           device=default_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@register_op("zeros_like", amp="promote")
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(tensor(x), dtype=_dt(dtype))


@register_op("ones_like")
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(tensor(x), dtype=_dt(dtype))


@register_op("full_like")
def full_like(x, fill_value, dtype=None, name=None):
    x = tensor(x)
    dt = _dt(dtype, x.dtype)
    if isinstance(fill_value, torch.Tensor):
        return torch.broadcast_to(fill_value.to(dt), x.shape).clone()
    return torch.full_like(x, torch.tensor(fill_value).to(dt).item(),
                           dtype=dt)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (to_plain(v) for v in (start, end, step))
    start, end, step = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = dtypes.int64 if all(
            isinstance(v, (int, np.integer)) for v in (start, end, step)) \
            else dtypes.get_default_dtype()
    return wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=default_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap(torch.linspace(
        float(to_plain(start)), float(to_plain(stop)), int(to_plain(num)),
        dtype=_dt(dtype, dtypes.get_default_dtype()), device=default_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap(torch.logspace(
        float(to_plain(start)), float(to_plain(stop)), int(to_plain(num)),
        base=float(to_plain(base)),
        dtype=_dt(dtype, dtypes.get_default_dtype()), device=default_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return wrap(torch.eye(n, m, dtype=_dt(dtype, dtypes.get_default_dtype()),
                          device=default_device()))


@register_op("assign")
def assign(x, output=None):
    return tensor(x).clone()


@register_op("diag")
def diag(x, offset=0, padding_value=0, name=None):
    x = tensor(x)
    if x.ndim == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            on = torch.zeros(out.shape, dtype=torch.bool, device=x.device)
            on.diagonal(offset).fill_(True)
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset)


@register_op("diagflat")
def diagflat(x, offset=0, name=None):
    return torch.diagflat(tensor(x), offset)


@register_op("tril")
def tril(x, diagonal=0, name=None):
    return torch.tril(tensor(x), diagonal)


@register_op("triu")
def triu(x, diagonal=0, name=None):
    return torch.triu(tensor(x), diagonal)


def meshgrid(*args, **kwargs):
    kwargs.pop("name", None)
    if kwargs:
        raise TypeError(
            f"meshgrid() got unexpected keyword arguments {sorted(kwargs)}")
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return [wrap(o) for o in torch.meshgrid(
        *[tensor(to_plain(a)) for a in arrs], indexing="ij")]


def clone(x):
    from .manipulation import _clone_op
    return _clone_op(x)


def tril_indices(row, col, offset=0, dtype=dtypes.int64):
    return wrap(torch.tril_indices(row, col, offset, device=default_device())
                .to(_dt(dtype)))


def triu_indices(row, col=None, offset=0, dtype=dtypes.int64):
    return wrap(torch.triu_indices(row, row if col is None else col, offset,
                                   device=default_device()).to(_dt(dtype)))


__all__ = ["arange", "assign", "clone", "diag", "diagflat", "empty",
           "empty_like", "eye", "full", "full_like", "linspace", "logspace",
           "meshgrid", "ones", "ones_like", "to_tensor", "tril",
           "tril_indices", "triu", "triu_indices", "zeros", "zeros_like"]
