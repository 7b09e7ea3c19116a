"""Common functionals.

Counterpart: ``paddle_tpu/nn/functional/common.py``: ``linear`` (:20,
a registered white op), ``_dropout_raw`` (:29, the promote op
``dropout_raw``), ``dropout`` (:47), ``dropout2d`` / ``dropout3d``,
``alpha_dropout`` (the op ``alpha_dropout_raw``), ``interpolate`` with its
alias ``upsample`` (:90-136, the op ``interpolate``) in ``"nearest"``
mode, ``unfold``, ``fold``, ``bilinear``, ``cosine_similarity``,
``pixel_shuffle``, ``pixel_unshuffle``, ``channel_shuffle``,
``label_smooth``, ``normalize``, ``zeropad2d`` and ``pad`` (``ops``'
own). The other interpolation modes are ROADMAP A11.

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
from ...ops.manipulation import pad
from .sampling import bernoulli

__all__ = ["alpha_dropout", "bilinear", "channel_shuffle",
           "cosine_similarity", "dropout", "dropout2d", "dropout3d", "fold",
           "interpolate", "label_smooth", "linear", "normalize", "pad",
           "pixel_shuffle", "pixel_unshuffle", "unfold", "upsample",
           "zeropad2d"]


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


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    key = gen_mod.default_generator.split_key()
    return _alpha_dropout_raw(x, key, float(p))


@register_op("alpha_dropout_raw")
def _alpha_dropout_raw(x, key, p):
    """SELU-preserving dropout: a·where(keep, x, α') + b."""
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = bernoulli(torch.tensor(key, dtype=torch.int64, device=x.device),
                     keep, tuple(x.shape))
    return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


@register_op("interpolate")
def _interpolate_raw(x, out_hw, mode, align_corners, data_format):
    """Resize the two spatial axes to ``out_hw``: the reference's op
    (:90-117) in its nearest mode (``jax.image.resize``'s, torch's
    ``nearest-exact``)."""
    if mode != "nearest":
        raise NotImplementedError(
            f"interpolate: mode {mode!r} is ROADMAP A11; the port takes "
            "'nearest'")
    nchw = data_format.startswith("NC")
    xc = x if nchw else x.permute(0, 3, 1, 2)
    out = torch.nn.functional.interpolate(xc, size=tuple(out_hw),
                                          mode="nearest-exact")
    return out if nchw else out.permute(0, 2, 3, 1)


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
    return _interpolate_raw(x, tuple(size), mode, bool(align_corners),
                            data_format)


upsample = interpolate


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(paddings):
    """(top, left, bottom, right) from an int, [h, w] or [t, l, b, r]."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return paddings[0], paddings[1], paddings[0], paddings[1]
    return tuple(paddings)


@register_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW → [N, C·kh·kw, L], channels outermost."""
    pt, pl, pb, pr = _pads4(paddings)
    x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      dilation=_pair(dilations),
                                      stride=_pair(strides))


@register_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of the overlapping patches (:166-189)."""
    oh_out, ow_out = output_sizes
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    pt, pl, pb, pr = _pads4(paddings)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    h, w = oh_out + pt + pb, ow_out + pl + pr
    oh = (h - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w - (dw * (kw - 1) + 1)) // sw + 1
    cols = x.reshape(n, c, kh, kw, oh, ow)
    out = torch.zeros((n, c, h, w), dtype=x.dtype, device=x.device)
    for i in range(kh):
        for j in range(kw):
            hi, wj = i * dh, j * dw
            out[:, :, hi:hi + sh * oh:sh, wj:wj + sw * ow:sw] += \
                cols[:, :, i, j]
    return out[:, :, pt:h - pb, pl:w - pr]


@register_op("bilinear", amp="white")
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@register_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = (x1 * x2).sum(axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


@register_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@register_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    raise NotImplementedError


@register_op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    raise NotImplementedError


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    smooth = epsilon / k if prior_dist is None else epsilon * prior_dist
    return (1 - epsilon) * label + smooth


@register_op("normalize", amp="black")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = (x.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)
