"""Elementwise, scalar and cumulative math ops.

Counterpart: ``paddle_tpu/ops/math.py``: the same 78 registered ops,
names, AMP categories, ``multi_out`` and ``differentiable`` flags, each a
plain PyTorch body on its operands' device. Binary ops promote by JAX's
rules (``_helpers.operands``): under AMP at O2 a promote op computes in
the low dtype, where torch's ``+`` would promote to f32. Where the
reference's formula differs from torch's function of the same name, the
formula is ported: ``lerp`` is ``x + w * (y - x)``, ``dot`` sums over the
last axis, ``outer`` flattens its operands, ``cummax`` / ``cummin`` keep
the first index of a tie, ``cumsum`` keeps an integer input's dtype
(bool sums in int64) and ``scale`` casts its factor to ``x``'s dtype.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.dispatch import register_op
from ._helpers import const, operands, tensor

# --- binary arithmetic -----------------------------------------------------


@register_op("add")
def add(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.add(x, y)


@register_op("subtract")
def subtract(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.subtract(x, y)


@register_op("multiply")
def multiply(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.multiply(x, y)


@register_op("divide")
def divide(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.true_divide(x, y)


@register_op("floor_divide")
def floor_divide(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.floor_divide(x, y)


@register_op("remainder")
def remainder(x, y, name=None):
    x, y = operands(x, y, scalars=True)
    return torch.remainder(x, y)


mod = remainder
floor_mod = remainder

# the bodies, for use inside other ops' bodies (a call through the
# dispatcher there would count as a second op)
_add, _sub, _mul = add.__wrapped__, subtract.__wrapped__, multiply.__wrapped__


@register_op("pow")
def pow(x, y, name=None):  # noqa: A001
    x, y = operands(x, y, scalars=True)
    return torch.pow(x, y)


@register_op("maximum")
def maximum(x, y, name=None):
    return torch.maximum(*operands(x, y))


@register_op("minimum")
def minimum(x, y, name=None):
    return torch.minimum(*operands(x, y))


@register_op("fmax")
def fmax(x, y, name=None):
    return torch.fmax(*operands(x, y))


@register_op("fmin")
def fmin(x, y, name=None):
    return torch.fmin(*operands(x, y))


@register_op("atan2", amp="black")
def atan2(x, y, name=None):
    return torch.atan2(*operands(x, y))


@register_op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = tensor(x)
    s = scale.to(x.dtype) if isinstance(scale, torch.Tensor) else \
        const(scale, x.dtype, x.device)
    b = const(bias, x.dtype, x.device)
    return x * s + b if bias_after_scale else (x + b) * s


@register_op("inner")
def inner(x, y, name=None):
    return torch.inner(*operands(x, y))


@register_op("outer")
def outer(x, y, name=None):
    x, y = operands(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op("logaddexp", amp="black")
def logaddexp(x, y, name=None):
    x, y = operands(x, y)
    if not x.is_floating_point():
        x, y = x.float(), y.float()
    return torch.logaddexp(x, y)


# --- unary -----------------------------------------------------------------


@register_op("neg")
def neg(x, name=None):
    return torch.neg(tensor(x))


@register_op("abs")
def abs(x, name=None):  # noqa: A001
    return torch.abs(tensor(x))


@register_op("sign")
def sign(x, name=None):
    return torch.sign(tensor(x))


def _float(x):
    """``x`` as a tensor, an integer or bool one in the default float dtype
    (jnp's unary float functions promote so)."""
    x = tensor(x)
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtypes.get_default_dtype())


@register_op("exp", amp="black")
def exp(x, name=None):
    return torch.exp(_float(x))


@register_op("expm1", amp="black")
def expm1(x, name=None):
    return torch.expm1(_float(x))


@register_op("log", amp="black")
def log(x, name=None):
    return torch.log(_float(x))


@register_op("log2", amp="black")
def log2(x, name=None):
    return torch.log2(_float(x))


@register_op("log10", amp="black")
def log10(x, name=None):
    return torch.log10(_float(x))


@register_op("log1p", amp="black")
def log1p(x, name=None):
    return torch.log1p(_float(x))


@register_op("sqrt")
def sqrt(x, name=None):
    return torch.sqrt(_float(x))


@register_op("rsqrt")
def rsqrt(x, name=None):
    return torch.rsqrt(_float(x))


@register_op("square")
def square(x, name=None):
    x = tensor(x)
    return x * x


@register_op("reciprocal")
def reciprocal(x, name=None):
    return torch.reciprocal(_float(x))


@register_op("floor")
def floor(x, name=None):
    return torch.floor(tensor(x))


@register_op("ceil")
def ceil(x, name=None):
    return torch.ceil(tensor(x))


@register_op("round")
def round(x, name=None):  # noqa: A001
    return torch.round(tensor(x))


@register_op("trunc")
def trunc(x, name=None):
    return torch.trunc(tensor(x))


@register_op("frac")
def frac(x, name=None):
    x = tensor(x)
    return x - torch.trunc(x)


@register_op("sin")
def sin(x, name=None):
    return torch.sin(_float(x))


@register_op("cos")
def cos(x, name=None):
    return torch.cos(_float(x))


@register_op("tan")
def tan(x, name=None):
    return torch.tan(_float(x))


@register_op("asin", amp="black")
def asin(x, name=None):
    return torch.asin(_float(x))


@register_op("acos", amp="black")
def acos(x, name=None):
    return torch.acos(_float(x))


@register_op("atan", amp="black")
def atan(x, name=None):
    return torch.atan(_float(x))


@register_op("sinh")
def sinh(x, name=None):
    return torch.sinh(_float(x))


@register_op("cosh")
def cosh(x, name=None):
    return torch.cosh(_float(x))


@register_op("tanh")
def tanh(x, name=None):
    return torch.tanh(_float(x))


@register_op("asinh", amp="black")
def asinh(x, name=None):
    return torch.asinh(_float(x))


@register_op("acosh", amp="black")
def acosh(x, name=None):
    return torch.acosh(_float(x))


@register_op("atanh", amp="black")
def atanh(x, name=None):
    return torch.atanh(_float(x))


@register_op("erf", amp="black")
def erf(x, name=None):
    return torch.erf(_float(x))


@register_op("erfinv", amp="black")
def erfinv(x, name=None):
    return torch.erfinv(_float(x))


@register_op("lgamma", amp="black")
def lgamma(x, name=None):
    return torch.lgamma(_float(x))


@register_op("digamma", amp="black")
def digamma(x, name=None):
    return torch.digamma(_float(x))


@register_op("clip")
def clip(x, min=None, max=None, name=None):  # noqa: A002
    x = tensor(x)
    if min is None and max is None:
        return x.clone()
    if isinstance(min, torch.Tensor) or isinstance(max, torch.Tensor):
        lo = None if min is None else tensor(min, x, x.dtype)
        hi = None if max is None else tensor(max, x, x.dtype)
        return torch.clamp(x, lo, hi)
    return torch.clamp(x, min, max)


@register_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = _float(x)
    return _mul(scale_b, torch.tanh(_mul(x, scale_a)))


@register_op("rad2deg")
def rad2deg(x, name=None):
    return torch.rad2deg(_float(x))


@register_op("deg2rad")
def deg2rad(x, name=None):
    return torch.deg2rad(_float(x))


# --- tests / predicates ----------------------------------------------------


@register_op("isnan", differentiable=False)
def isnan(x, name=None):
    return torch.isnan(tensor(x))


@register_op("isinf", differentiable=False)
def isinf(x, name=None):
    return torch.isinf(tensor(x))


@register_op("isfinite", differentiable=False)
def isfinite(x, name=None):
    return torch.isfinite(tensor(x))


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(tensor(x), nan=nan, posinf=posinf, neginf=neginf)


# --- matrix products --------------------------------------------------------


@register_op("matmul", amp="white")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, either operand's last two axes swapped first on request."""
    x, y = operands(x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op("bmm", amp="white")
def bmm(x, y, name=None):
    return torch.matmul(*operands(x, y))


@register_op("dot", amp="white")
def dot(x, y, name=None):
    x, y = operands(x, y)
    return torch.sum(x * y, dim=-1)


@register_op("addmm", amp="white")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return _add(_mul(beta, tensor(input)),
                _mul(alpha, torch.matmul(*operands(x, y))))


@register_op("mv", amp="white")
def mv(x, vec, name=None):
    return torch.matmul(*operands(x, vec))


@register_op("multiply_", differentiable=False)
def _multiply_raw(x, y):
    x, y = operands(x, y, scalars=True)
    return torch.multiply(x, y)


# --- cumulative ------------------------------------------------------------


def _flat_axis(x, axis):
    x = tensor(x)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def _acc_dtype(x, dtype):
    """jnp's cumulative dtype: the input's, bool summed as int64."""
    if dtype is not None:
        return dtypes.convert_dtype(dtype)
    return torch.int64 if x.dtype == torch.bool else x.dtype


@register_op("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=_acc_dtype(x, dtype))


@register_op("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=_acc_dtype(x, dtype))


def _cum_extreme(x, axis, fn):
    """Running max / min with the index of its FIRST occurrence (the
    reference's scan keeps the earlier index on a tie; torch's cummax
    takes the later one)."""
    vals = fn(x, dim=axis).values
    n = x.shape[axis]
    prev = vals.narrow(axis, 0, max(n - 1, 0))
    changed = torch.ones_like(vals, dtype=torch.bool)
    changed.narrow(axis, 1, max(n - 1, 0)).copy_(
        vals.narrow(axis, 1, max(n - 1, 0)) != prev)
    shape = [1] * x.ndim
    shape[axis] = n
    pos = torch.arange(n, device=x.device).reshape(shape).expand_as(x)
    idx = torch.where(changed, pos, torch.zeros_like(pos))
    return vals, torch.cummax(idx, dim=axis).values.to(torch.int64)


@register_op("cummax", differentiable=False, multi_out=True)
def cummax(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(x, axis)
    return _cum_extreme(x, axis % max(x.ndim, 1), torch.cummax)


@register_op("cummin", differentiable=False, multi_out=True)
def cummin(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_axis(x, axis)
    return _cum_extreme(x, axis % max(x.ndim, 1), torch.cummin)


@register_op("kron")
def kron(x, y, name=None):
    return torch.kron(*operands(x, y))


@register_op("gcd", differentiable=False)
def gcd(x, y, name=None):
    return torch.gcd(*operands(x, y))


@register_op("lcm", differentiable=False)
def lcm(x, y, name=None):
    return torch.lcm(*operands(x, y))


@register_op("heaviside")
def heaviside(x, y, name=None):
    return torch.heaviside(*operands(x, y))


@register_op("lerp")
def lerp(x, y, weight, name=None):
    x = tensor(x)
    return _add(x, _mul(weight, _sub(y, x)))


@register_op("ldexp")
def ldexp(x, y, name=None):
    x, y = tensor(x), tensor(y, x)
    if not x.is_floating_point():
        x = x.to(dtypes.get_default_dtype())
    return x * torch.pow(const(2.0, x.dtype, x.device), y.to(x.dtype))


@register_op("hypot")
def hypot(x, y, name=None):
    return torch.hypot(*operands(x, y))


@register_op("copysign")
def copysign(x, y, name=None):
    x, y = operands(x, y)
    if not x.is_floating_point():
        x, y = x.to(dtypes.get_default_dtype()), y.to(dtypes.get_default_dtype())
    return torch.copysign(x, y)


@register_op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = tensor(x)
    return torch.diff(x, n=n, dim=axis,
                      prepend=None if prepend is None else tensor(prepend, x),
                      append=None if append is None else tensor(append, x))


@register_op("multiplex")
def multiplex(inputs, index, name=None):
    stacked = torch.stack([tensor(i) for i in inputs], dim=0)
    idx = tensor(index, stacked).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


__all__ = [n for n, v in list(globals().items())
           if hasattr(v, "opdef") and not n.startswith("_")] + [
    "floor_mod", "mod"]
