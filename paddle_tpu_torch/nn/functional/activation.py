"""Activation functionals.

Counterpart: ``paddle_tpu/nn/functional/activation.py``: ``relu`` (:16),
the activation of the vision path, and ``sigmoid`` (:26), ``silu`` (:41)
and ``softplus`` (:123), PP-YOLOE's. The other activations come with
later slices (the transformer paths call GeLU and SiLU inside their MLP
functionals).
"""
from __future__ import annotations

import torch

__all__ = ["relu", "sigmoid", "silu", "softplus"]


def relu(x, name=None):
    """max(x, 0), in x's dtype."""
    return torch.relu(x)


def sigmoid(x, name=None):
    """1 / (1 + exp(-x)), in x's dtype."""
    return torch.sigmoid(x)


def silu(x, name=None):
    """x · sigmoid(x), in x's dtype."""
    return torch.nn.functional.silu(x)


def softplus(x, beta=1, threshold=20, name=None):
    """x where x·beta > threshold (the tie takes the log), else
    log(1 + exp(x·beta)) / beta, the reference's formula (:123-126):
    ``jax.nn.softplus`` is ``logaddexp(·, 0)``."""
    xb = x * beta
    return torch.where(xb > threshold, x,
                       torch.logaddexp(xb, torch.zeros_like(xb)) / beta)
