"""Activation functionals.

Counterpart: ``paddle_tpu/nn/functional/activation.py``: every
activation of that module (:15-193), registered under the reference's
names and AMP categories (``log_sigmoid``, ``softplus``, ``softmax``,
``log_softmax`` and ``gumbel_softmax`` black, the rest promote); ``swish``
is ``silu``; ``tanh`` and ``tanh_act`` are ``ops.math.tanh``. Each is the
reference's formula in torch: ``softplus`` is ``logaddexp(x·β, 0) / β``
past the threshold test, ``rrelu`` the deterministic slope (lower +
upper) / 2 in training too, ``gumbel_softmax`` one generator split per
call and ``jax.random.gumbel``'s noise (``ops/random.py``). The
piecewise ones are ``torch.where`` forms whose backward keeps no copy of
x, so the in-place forms of ``extra.py`` may overwrite it.
"""
from __future__ import annotations

import torch

from ...core import dtype as dtypes
from ...core.dispatch import register_op
from ...ops.math import tanh

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softplus", "softshrink", "softsign", "swish", "tanh", "tanh_act",
           "tanhshrink", "thresholded_relu"]

_F = torch.nn.functional


@register_op("relu")
def relu(x, name=None):
    """max(x, 0), in x's dtype."""
    return torch.relu(x)


@register_op("relu6")
def relu6(x, name=None):
    return _F.relu6(x)


@register_op("sigmoid")
def sigmoid(x, name=None):
    """1 / (1 + exp(-x)), in x's dtype."""
    return torch.sigmoid(x)


@register_op("log_sigmoid", amp="black")
def log_sigmoid(x, name=None):
    return _F.logsigmoid(x)


@register_op("gelu")
def gelu(x, approximate=False, name=None):
    """x·Φ(x), the erf form, or the tanh form with ``approximate``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


@register_op("silu")
def silu(x, name=None):
    """x · sigmoid(x), in x's dtype."""
    return _F.silu(x)


swish = silu


@register_op("mish")
def mish(x, name=None):
    return x * torch.tanh(_F.softplus(x))


@register_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@register_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    """x where x ≥ 0, weight·x elsewhere; a weight of several entries
    runs along the channel axis."""
    w = weight
    if w.numel() > 1 and x.ndim > 1:
        shape = [1] * x.ndim
        shape[1 if data_format[1] == "C" else x.ndim - 1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@register_op("elu")
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("celu")
def celu(x, alpha=1.0, name=None):
    return _F.celu(x, alpha)


@register_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("hardswish")
def hardswish(x, name=None):
    return _F.hardswish(x)


@register_op("hardsigmoid")
def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@register_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.where(x < min, min, torch.where(x > max, max, x))


@register_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@register_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


@register_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@register_op("softplus", amp="black")
def softplus(x, beta=1, threshold=20, name=None):
    """x where x·beta > threshold (the tie takes the log), else
    log(1 + exp(x·beta)) / beta, the reference's formula (:123-126):
    ``jax.nn.softplus`` is ``logaddexp(·, 0)``."""
    xb = x * beta
    return torch.where(xb > threshold, x,
                       torch.logaddexp(xb, torch.zeros_like(xb)) / beta)


@register_op("softsign")
def softsign(x, name=None):
    return x / (1 + x.abs())


@register_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@register_op("softmax", amp="black")
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.softmax(x, axis)


@register_op("log_softmax", amp="black")
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.log_softmax(x, axis)


@register_op("gumbel_softmax", amp="black", differentiable=False)
def _gumbel_softmax_raw(key, x, temperature, hard, axis):
    from ...ops.random import gumbel_bits
    g = gumbel_bits(key, tuple(x.shape), torch.float32, x.device)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, y.argmax(axis, keepdim=True), 1.0)
        y = onehot - y.detach() + y        # straight-through
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    from ...core.generator import default_generator
    return _gumbel_softmax_raw(default_generator.split_key(), x,
                               temperature, hard, axis)


@register_op("maxout")
def maxout(x, groups, axis=1, name=None):
    axis = axis % x.ndim
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(axis + 1)


@register_op("glu")
def glu(x, axis=-1, name=None):
    a, b = x.chunk(2, axis)
    return a * torch.sigmoid(b)


@register_op("rrelu")
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """x where x ≥ 0, else x·(lower + upper) / 2 (the reference's
    deterministic form, in training too)."""
    return torch.where(x >= 0, x, (lower + upper) / 2 * x)


def tanh_act(x, name=None):
    return tanh(x)
