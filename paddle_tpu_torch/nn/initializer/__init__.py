"""Weight initialisers.

Counterpart: ``paddle_tpu/nn/initializer/__init__.py``: ``_fan_in_out``
(:28-38), ``Constant`` (:41), ``Uniform`` (:75), ``XavierNormal`` (:86)
and ``KaimingUniform`` (:133), the ones the vision layers use. The
reference's initialisers are callables drawing from its global
generator's key stream; here each is a plain function that fills a tensor
in place from an explicit ``torch.Generator`` (None: torch's default
generator of the tensor's device). The distributions are the
reference's; the values are not (the generators differ), so the tests
carry weights across with ``load_numpy``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "kaiming_uniform", "uniform", "xavier_normal"]


def _fan_in_out(shape):
    """(fan_in, fan_out): [in, out] for a Linear weight; in·receptive and
    out·receptive for a conv weight [out, in, *kernel]."""
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def constant(t, value=0.0):
    return t.fill_(value)


@torch.no_grad()
def uniform(t, low=-1.0, high=1.0, generator=None):
    return t.uniform_(low, high, generator=generator)


@torch.no_grad()
def xavier_normal(t, fan_in=None, fan_out=None, gain=1.0, generator=None):
    """normal(0, gain·sqrt(2 / (fan_in + fan_out)))."""
    fi, fo = _fan_in_out(t.shape)
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    return t.normal_(0.0, gain * math.sqrt(2.0 / (fi + fo)),
                     generator=generator)


@torch.no_grad()
def kaiming_uniform(t, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                    generator=None):
    """uniform(±gain·sqrt(3 / fan_in)), gain sqrt(2 / (1 + slope²)) for
    relu and leaky_relu, else 1."""
    fi = _fan_in_out(t.shape)[0] if fan_in is None else fan_in
    gain = (math.sqrt(2.0 / (1 + negative_slope ** 2))
            if nonlinearity in ("relu", "leaky_relu") else 1.0)
    limit = gain * math.sqrt(3.0 / fi)
    return t.uniform_(-limit, limit, generator=generator)
