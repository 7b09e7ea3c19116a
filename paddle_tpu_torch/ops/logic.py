"""Comparison, logical and bitwise ops.

Counterpart: ``paddle_tpu/ops/logic.py``: the same 18 registered ops, and
``allclose``, ``equal_all`` and ``is_empty`` (unregistered, 0-d bool
results). Comparisons promote their operands by JAX's rules first
(``_helpers.operands``), so ``int_tensor == 0.5`` compares as floats.
"""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.tensor import to_plain, wrap
from ._helpers import operands, tensor


def _cmp(fn, x, y):
    return fn(*operands(x, y, scalars=True))


@register_op("equal", differentiable=False)
def equal(x, y, name=None):
    return _cmp(torch.eq, x, y)


@register_op("not_equal", differentiable=False)
def not_equal(x, y, name=None):
    return _cmp(torch.ne, x, y)


@register_op("greater_than", differentiable=False)
def greater_than(x, y, name=None):
    return _cmp(torch.gt, x, y)


@register_op("greater_equal", differentiable=False)
def greater_equal(x, y, name=None):
    return _cmp(torch.ge, x, y)


@register_op("less_than", differentiable=False)
def less_than(x, y, name=None):
    return _cmp(torch.lt, x, y)


@register_op("less_equal", differentiable=False)
def less_equal(x, y, name=None):
    return _cmp(torch.le, x, y)


@register_op("logical_and", differentiable=False)
def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*operands(x, y))


@register_op("logical_or", differentiable=False)
def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*operands(x, y))


@register_op("logical_xor", differentiable=False)
def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*operands(x, y))


@register_op("logical_not", differentiable=False)
def logical_not(x, out=None, name=None):
    return torch.logical_not(tensor(x))


@register_op("bitwise_and", differentiable=False)
def bitwise_and(x, y, out=None, name=None):
    return torch.bitwise_and(*operands(x, y))


@register_op("bitwise_or", differentiable=False)
def bitwise_or(x, y, out=None, name=None):
    return torch.bitwise_or(*operands(x, y))


@register_op("bitwise_xor", differentiable=False)
def bitwise_xor(x, y, out=None, name=None):
    return torch.bitwise_xor(*operands(x, y))


@register_op("bitwise_not", differentiable=False)
def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(tensor(x))


@register_op("bitwise_left_shift", differentiable=False)
def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return torch.bitwise_left_shift(*operands(x, y))


@register_op("bitwise_right_shift", differentiable=False)
def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    return torch.bitwise_right_shift(*operands(x, y))


@register_op("isclose", differentiable=False)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*operands(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = operands(to_plain(x), to_plain(y))
    return wrap(torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                            equal_nan=equal_nan),
                             device=x.device))


def equal_all(x, y, name=None):
    x, y = to_plain(x), to_plain(y)
    same = x.shape == y.shape and bool(torch.equal(*operands(x, y)))
    return wrap(torch.tensor(same, device=x.device))


def is_empty(x, name=None):
    x = to_plain(x)
    return wrap(torch.tensor(x.numel() == 0, device=x.device))


@register_op("isin", differentiable=False)
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = tensor(x)
    return torch.isin(x, tensor(test_x, x), invert=invert)


__all__ = ["allclose", "bitwise_and", "bitwise_left_shift", "bitwise_not",
           "bitwise_or", "bitwise_right_shift", "bitwise_xor", "equal",
           "equal_all", "greater_equal", "greater_than", "is_empty",
           "isclose", "isin", "less_equal", "less_than", "logical_and",
           "logical_not", "logical_or", "logical_xor", "not_equal"]
