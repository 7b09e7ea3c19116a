"""Common functionals.

Counterpart: ``paddle_tpu/nn/functional/common.py``: ``linear`` (:20),
``_dropout_raw`` (:29) and ``dropout`` (:47). Padding, interpolation and
the rest of that module come with later slices (ROADMAP A5, A11).

``dropout`` takes one split of the framework generator
(``core/generator.py``) per call in training mode at p > 0, none
otherwise, and draws the reference's mask from it: ``jax.random
.bernoulli(key, 1 - p, shape)`` through the port's threefry
(``sampling.bernoulli``), bit for bit. ``upscale_in_train`` scales the
kept values by 1 / (1 − p) as the reference's compiled op does: its
``x / keep`` (a weak-typed constant, so in x's dtype) becomes ``x · (1 /
keep)`` under XLA, the reciprocal rounded to x's dtype (``_inv_keep``).
``downscale_in_infer`` multiplies by 1 − p in eval mode; ``axis`` draws
one mask over the named axes and broadcasts it over the others.
"""
from __future__ import annotations

import torch

from ...core import generator as gen_mod
from .sampling import bernoulli

__all__ = ["dropout", "linear"]


def _inv_keep(keep: float, like: torch.Tensor) -> torch.Tensor:
    """1 / keep with keep rounded to like's dtype and the quotient too:
    the scale XLA multiplies by where the reference divides by the
    constant keep."""
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return one / torch.tensor(keep, dtype=like.dtype, device=like.device)


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with Paddle's weight layout [in, out]."""
    out = x @ weight
    return out if bias is None else out + bias


def _dropout_raw(x, key, p, training, mode, axis):
    """Dropout under a drawn key (two uint32 words): the reference's
    ``_dropout_raw`` (:29-44)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.ndim))
    keep = 1.0 - p
    k = torch.tensor(key, dtype=torch.int64, device=x.device)
    mask = bernoulli(k, keep, shape)
    if mode == "upscale_in_train":
        return torch.where(mask, x * _inv_keep(keep, x), torch.zeros_like(x))
    return torch.where(mask, x, torch.zeros_like(x))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's ``F.dropout``: in training mode at p > 0 one generator
    split and the reference's mask; otherwise the identity (and the
    ``downscale_in_infer`` scaling in eval), consuming no split."""
    if isinstance(p, torch.Tensor):
        p = float(p)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    key = gen_mod.default_generator.split_key()
    return _dropout_raw(x, key, float(p), bool(training), mode, axis)
