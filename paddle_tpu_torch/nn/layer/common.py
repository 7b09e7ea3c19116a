"""Common layers.

Counterpart: ``paddle_tpu/nn/layer/common.py``, ``Linear`` (:9-30):
weight ``[in_features, out_features]`` (Paddle's layout) from
XavierNormal, a zero bias; ``Dropout`` (:41-54), ``F.dropout`` in the
module's training mode. For ``Sequential``
(``nn/layer/layers.py:394``) ``torch.nn.Sequential`` serves: its child
names ``0``, ``1``, ... are Paddle's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.common import dropout, linear
from ..initializer import constant, xavier_normal

__all__ = ["Dropout", "Linear"]


class Linear(nn.Module):
    """y = x @ weight + bias on ``device`` (None → the CUDA card) in
    ``dtype``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.empty(out_features, **kw)))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """XavierNormal weight, zero bias; ``generator`` None: torch's
        default generator."""
        xavier_normal(self.weight, generator=generator)
        if self.bias is not None:
            constant(self.bias, 0.0)

    def forward(self, input):  # noqa: A002
        return linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Dropout(nn.Module):
    """Paddle's ``nn.Dropout``: ``F.dropout`` with the module's training
    mode (one generator split per call while training at p > 0)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002
        return dropout(input, p=self.p, axis=self.axis,
                       training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
