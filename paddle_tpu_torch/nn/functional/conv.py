"""Convolution functionals.

Counterpart: ``paddle_tpu/nn/functional/conv.py``: ``_pair`` and
``_padding`` (:16-35) and ``conv2d`` (:38, a registered white op). The reference lowers every
convolution to ``lax.conv_general_dilated``; here ``conv2d`` is
``torch.nn.functional.conv2d`` in NCHW with Paddle's OIHW weight
(``[out, in/groups, kh, kw]``), the weight cast to x's dtype as the
reference casts it. Symmetric padding goes to the call; asymmetric and
nested padding goes through ``torch.nn.functional.pad`` first (a negative
pad crops, as XLA's does); ``"SAME"`` and ``"VALID"`` are reckoned as XLA
reckons them. The channels-last layout, and conv1d, conv3d and the
transposed convolutions, are ROADMAP A11: they are registered under the
reference's names and category and raise naming it.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...core.dispatch import register_op

__all__ = ["conv1d", "conv1d_transpose", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose"]


def _pair(v, n):
    """An int → n copies; a sequence of n ints stays; half as many ints
    as n each repeat twice (the reference's rule, :16-20)."""
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == n:
        return v
    return tuple(v[i // 2] for i in range(n)) if len(v) * 2 == n else v


def _padding(padding, nsp, strides, ksize, dilations):
    """'SAME' / 'VALID', or one (low, high) pair per spatial dim (:23-35):
    an int, one int per dim, 2·nsp ints (low, high per dim), or nested
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nsp:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    return [tuple(p) for p in padding]


def _same_pads(sizes, strides, ksize, dilations):
    """XLA's SAME padding: the output has ceil(in / stride) positions, the
    total padding split with the odd unit at the high end."""
    pads = []
    for n, s, k, d in zip(sizes, strides, ksize, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve_pads(pad, sizes, strides, ksize, dilations):
    """(low, high) pairs for every spatial dim from ``_padding``'s value."""
    if pad == "SAME":
        return _same_pads(sizes, strides, ksize, dilations)
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if isinstance(pad, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or integers, got "
                         f"{pad!r}")
    return [(int(lo), int(hi)) for lo, hi in pad]


def _torch_pad(pads):
    """(low, high) per spatial dim → F.pad's last-dim-first flat list."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


@register_op("conv2d", amp="white")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of x [N, C, H, W] by weight [O, C/groups, kh, kw]."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"conv2d: data_format {data_format!r} (channels-last) is ROADMAP "
            "A11; the port takes NCHW")
    s = _pair(stride, 2)
    d = _pair(dilation, 2)
    pads = _resolve_pads(_padding(padding, 2, s, weight.shape[2:], d),
                         x.shape[2:], s, weight.shape[2:], d)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if all(lo == hi >= 0 for lo, hi in pads):
        return F.conv2d(x, w, b, s, tuple(lo for lo, _ in pads), d, groups)
    return F.conv2d(F.pad(x, _torch_pad(pads)), w, b, s, 0, d, groups)


def _a11(name):
    from .._not_ported import functional
    return functional(name, "A11", __name__, op=name, amp="white")


conv1d = _a11("conv1d")
conv1d_transpose = _a11("conv1d_transpose")
conv2d_transpose = _a11("conv2d_transpose")
conv3d = _a11("conv3d")
conv3d_transpose = _a11("conv3d_transpose")
