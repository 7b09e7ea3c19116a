"""Activation functionals.

Counterpart: ``paddle_tpu/nn/functional/activation.py``: ``relu`` (:16),
``sigmoid`` (:26), ``gelu`` (:36), ``silu`` (:41) and ``softplus``
(:123), registered ops under the reference's names and AMP categories
(all promote but ``softplus``, black); ``tanh`` is ``ops.math.tanh``.
The other activations come with later slices (the transformer paths call
GeLU and SiLU inside their MLP functionals).
"""
from __future__ import annotations

import torch

from ...core.dispatch import register_op
from ...ops.math import tanh

__all__ = ["gelu", "relu", "sigmoid", "silu", "softplus", "tanh"]


@register_op("relu")
def relu(x, name=None):
    """max(x, 0), in x's dtype."""
    return torch.relu(x)


@register_op("sigmoid")
def sigmoid(x, name=None):
    """1 / (1 + exp(-x)), in x's dtype."""
    return torch.sigmoid(x)


@register_op("gelu")
def gelu(x, approximate=False, name=None):
    """x·Φ(x), the erf form, or the tanh form with ``approximate``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


@register_op("silu")
def silu(x, name=None):
    """x · sigmoid(x), in x's dtype."""
    return torch.nn.functional.silu(x)


@register_op("softplus", amp="black")
def softplus(x, beta=1, threshold=20, name=None):
    """x where x·beta > threshold (the tie takes the log), else
    log(1 + exp(x·beta)) / beta, the reference's formula (:123-126):
    ``jax.nn.softplus`` is ``logaddexp(·, 0)``."""
    xb = x * beta
    return torch.where(xb > threshold, x,
                       torch.logaddexp(xb, torch.zeros_like(xb)) / beta)
