"""Pooling layers.

Counterpart: ``paddle_tpu/nn/layer/pooling.py``, ``MaxPool2D`` and
``AdaptiveAvgPool2D`` (:8-67): each keeps its arguments and calls its
functional. The other pools are ROADMAP A11.
"""
from __future__ import annotations

from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["AdaptiveAvgPool2D", "MaxPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = kwargs

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          **self.kwargs)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, **self.kwargs)
