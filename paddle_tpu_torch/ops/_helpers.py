"""Shared argument handling of the ops.

Counterpart: none as a file; these are the conversions that
``jnp.asarray`` and JAX's promotion rules do for the reference's op
bodies (``paddle_tpu/ops/*.py``):

- ``operands(x, y)``: two operands under JAX's promotion. Two tensors of
  different dtypes are both cast to ``torch.promote_types`` of the pair
  (JAX has no rule that lowers a 0-d tensor's rank in promotion, torch
  does). A Python scalar is weakly typed: it takes the tensor's dtype
  when its kind (bool < int < float < complex) is not above the
  tensor's, and is rounded to that dtype first, as JAX converts it;
  otherwise it takes the default dtype of its kind. A scalar never
  leaves the host unless it must be a tensor (a scalar first operand, or
  an op without a scalar overload): then it is a 0-d ``torch.full`` on
  the other operand's device, a fill, not a host-to-device copy.
- ``tensor(x, like)``: any array-like as a tensor on ``like``'s device
  (or the current place's).
- ``axis_arg``, ``shape_arg``: Paddle's axis and shape arguments.
"""
from __future__ import annotations

import functools
import numbers

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.place import default_device

__all__ = ["axis_arg", "const", "operands", "scalar_like", "shape_arg",
           "tensor"]


def _kind(dtype) -> int:
    if dtype == torch.bool:
        return 0
    if dtype.is_complex:
        return 3
    if dtype.is_floating_point:
        return 2
    return 1


def _scalar_kind(v) -> int:
    if isinstance(v, (bool, np.bool_)):
        return 0
    if isinstance(v, numbers.Integral):
        return 1
    if isinstance(v, numbers.Real):
        return 2
    return 3


_KIND_DEFAULT = {0: torch.bool, 1: torch.int64, 3: torch.complex64}


@functools.lru_cache(maxsize=4096, typed=True)
def _host_cast(v, dtype):
    """``v`` converted to ``dtype`` on the host (JAX's conversion of a weak
    scalar), back as a Python number."""
    if dtype in (torch.float64, torch.int64, torch.complex128):
        return v
    return torch.tensor(v).to(dtype).item()


def scalar_like(v, like: torch.Tensor):
    """(value, dtype) of the Python scalar ``v`` beside the tensor
    ``like``, by JAX's weak typing."""
    k = _scalar_kind(v)
    if k <= _kind(like.dtype):
        return _host_cast(v, like.dtype), like.dtype
    dt = dtypes.get_default_dtype() if k == 2 else _KIND_DEFAULT[k]
    return _host_cast(v, dt), dt


def const(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor of the Python number ``v`` in ``dtype`` on ``device``
    (a fill on the device, no copy from the host)."""
    return torch.full((), _host_cast(v, dtype), dtype=dtype, device=device)


def _is_scalar(v) -> bool:
    return isinstance(v, (numbers.Number, np.bool_)) and \
        not isinstance(v, np.ndarray)


def tensor(x, like=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device (a tensor, a device or None
    for the current place's); a tensor is returned as it is, cast to
    ``dtype`` when one is given."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if isinstance(like, torch.Tensor) else (
        like if like is not None else default_device())
    if _is_scalar(x):
        if dtype is None:
            k = _scalar_kind(x)
            dtype = dtypes.get_default_dtype() if k == 2 else _KIND_DEFAULT[k]
        return const(x, dtype, dev)
    if isinstance(x, (list, tuple)) and any(isinstance(v, torch.Tensor)
                                            for v in x):
        t = torch.stack([tensor(v, dev) for v in x])
        return t if dtype is None else t.to(dtype)
    a = np.asarray(x)
    if a.dtype == np.float64 and dtype is None:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype) if dtype is not None or \
        dev.type != "cpu" else t


def operands(x, y, scalars=False):
    """(x, y) ready for a torch binary function, by JAX's promotion (see
    the module docstring). With ``scalars`` True a Python scalar second
    operand stays a (rounded) Python number, for torch functions with a
    scalar overload."""
    tx, ty = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if tx and ty:
        if x.dtype != y.dtype:
            dt = torch.promote_types(x.dtype, y.dtype)
            x, y = x.to(dt), y.to(dt)
        return x, y
    if tx:
        if _is_scalar(y):
            v, dt = scalar_like(y, x)
            if scalars:
                return x, v
            return operands(x, torch.full((), v, dtype=dt, device=x.device))
        return operands(x, tensor(y, x))
    if ty:
        if _is_scalar(x):
            v, dt = scalar_like(x, y)
            return operands(torch.full((), v, dtype=dt, device=y.device), y)
        return operands(tensor(x, y), y)
    return operands(tensor(x), y)


def axis_arg(axis):
    """Paddle's ``axis``: None (all), an int, or a list / tuple of ints,
    as torch's ``dim``."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape_arg(shape):
    """Paddle's shape argument (an int, a sequence of ints or 0-d tensors,
    or a 1-D tensor) as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)
