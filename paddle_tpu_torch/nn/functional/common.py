"""Common functionals.

Counterpart: ``paddle_tpu/nn/functional/common.py``: ``linear`` (:20,
a registered white op), ``_dropout_raw`` (:29, the promote op
``dropout_raw``), ``dropout`` (:47), and ``interpolate`` with its
alias ``upsample`` (:120-136, ``_interpolate_raw`` :92) in ``"nearest"``
mode. Padding, the other interpolation modes and the rest of that module
come with later slices (ROADMAP A5b, A11).

``interpolate``'s nearest mode is ``jax.image.resize(..., "nearest")``'s:
output pixel i reads input pixel floor((i + 0.5) · in / out), which is
torch's ``"nearest-exact"`` (torch's ``"nearest"`` reads floor(i · in /
out) and differs off integer ratios). A ``scale_factor`` gives the output
size ``int(s · float(f))``, as the reference reckons it (:128-129); the
resize then follows the sizes, not the factor.

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
from ...core.dispatch import register_op
from .sampling import bernoulli

__all__ = ["dropout", "interpolate", "linear", "upsample"]


def _inv_keep(keep: float, like: torch.Tensor) -> torch.Tensor:
    """1 / keep with keep rounded to like's dtype and the quotient too:
    the scale XLA multiplies by where the reference divides by the
    constant keep."""
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return one / torch.tensor(keep, dtype=like.dtype, device=like.device)


@register_op("linear", amp="white")
def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with Paddle's weight layout [in, out]."""
    out = x @ weight
    return out if bias is None else out + bias


@register_op("dropout_raw")
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


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the two spatial axes of an NCHW or NHWC x to ``size`` ([oh,
    ow], ints or an int tensor) or by ``scale_factor`` (a number, a pair or
    a tensor). Only ``mode="nearest"`` is ported; the linear and cubic
    modes antialias when they downsample in the reference and raise here
    (ROADMAP A11)."""
    if mode != "nearest":
        raise NotImplementedError(
            f"interpolate: mode {mode!r} is ROADMAP A11; the port takes "
            "'nearest'")
    nchw = data_format.startswith("NC")
    spatial = x.shape[2:] if nchw else x.shape[1:-1]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s) for s in size]
    else:
        if isinstance(scale_factor, torch.Tensor):
            scale_factor = scale_factor.tolist()
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        size = [int(s * float(f)) for s, f in zip(spatial, sf)]
    if len(size) == 1:
        raise NotImplementedError("1-D interpolate: use 2-D with H=1")
    if len(size) != 2:
        raise NotImplementedError(
            f"interpolate: {len(size)}-D resizing is ROADMAP A11; the port "
            "takes 2-D")
    xc = x if nchw else x.permute(0, 3, 1, 2)
    out = torch.nn.functional.interpolate(xc, size=tuple(size),
                                          mode="nearest-exact")
    return out if nchw else out.permute(0, 2, 3, 1)


upsample = interpolate
