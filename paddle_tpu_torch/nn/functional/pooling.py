"""Pooling functionals.

Counterpart: ``paddle_tpu/nn/functional/pooling.py``: ``_pool_pad``
(:63-73), ``max_pool2d`` (:74) and ``adaptive_avg_pool2d`` (:185), the
pools of the vision path, registered promote ops. ``max_pool2d`` takes the reference's paddings
(an int, one per dim, low/high pairs), padding with -inf, and also
``"SAME"`` / ``"VALID"``, reckoned as XLA's ``reduce_window`` reckons
them (the reference's own NCHW path fails on a string padding); NCHW
only.
``return_mask=True``, the channels-last max pool and ``ceil_mode=True``
(which the reference accepts and ignores) are ROADMAP A11 and raise.
``adaptive_avg_pool2d`` uses Paddle's buckets ``[floor(i·L/O),
ceil((i+1)·L/O))``, which ``torch.nn.functional.adaptive_avg_pool2d``
shares; an output size of None keeps the input's. The other pools of
that module are ROADMAP A11: registered under the reference's names and
category, they raise naming it.
"""
from __future__ import annotations

import torch.nn.functional as F

from ...core.dispatch import register_op

from .conv import _resolve_pads, _torch_pad

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
           "max_pool3d"]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(int(x) for x in v)


def _pool_pad(padding, nsp):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nsp:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nsp)]
    return [tuple(p) for p in padding]


@register_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over kernel_size windows of x [N, C, H, W]; stride defaults to
    the window."""
    if return_mask:
        raise NotImplementedError(
            "max_pool2d: return_mask=True (the indices MaxUnPool2D takes) is "
            "ROADMAP A11")
    if data_format != "NCHW":
        raise NotImplementedError(
            f"max_pool2d: data_format {data_format!r} (channels-last) is "
            "ROADMAP A11; the port takes NCHW")
    if ceil_mode:
        raise NotImplementedError(
            "max_pool2d: ceil_mode=True (accepted and ignored by the "
            "reference) is ROADMAP A11")
    k = _pair(kernel_size, 2)
    s = _pair(stride, 2) if stride is not None else k
    pads = _resolve_pads(_pool_pad(padding, 2), x.shape[2:], s, k, (1, 1))
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        return F.max_pool2d(x, k, s, tuple(lo for lo, _ in pads))
    xp = F.pad(x, _torch_pad(pads), value=float("-inf"))
    return F.max_pool2d(xp, k, s, 0)


@register_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Average over Paddle's adaptive buckets to output_size (an int, or a
    pair whose None entries keep the input's size)."""
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    h, w = x.shape[2], x.shape[3]
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    out = F.adaptive_avg_pool2d(x, (oh or h, ow or w))
    if data_format != "NCHW":
        out = out.permute(0, 2, 3, 1)
    return out


def _a11(name):
    from .._not_ported import functional
    return functional(name, "A11", __name__, op=name)


adaptive_avg_pool1d = _a11("adaptive_avg_pool1d")
adaptive_max_pool1d = _a11("adaptive_max_pool1d")
adaptive_max_pool2d = _a11("adaptive_max_pool2d")
avg_pool1d = _a11("avg_pool1d")
avg_pool2d = _a11("avg_pool2d")
avg_pool3d = _a11("avg_pool3d")
max_pool1d = _a11("max_pool1d")
max_pool3d = _a11("max_pool3d")
