"""Pooling layers.

Counterpart: ``paddle_tpu/nn/layer/pooling.py``, ``MaxPool2D`` and
``AdaptiveAvgPool2D`` (:8-67): each keeps its arguments and calls its
functional. The other pools are ROADMAP A11.
"""
from __future__ import annotations


from ..functional.pooling import adaptive_avg_pool2d, max_pool2d
from .._not_ported import layer
from .layers import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveMaxPool1D",
           "AdaptiveMaxPool2D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D"]


class MaxPool2D(Layer):
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


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, **self.kwargs)


# ROADMAP A11: each raises when constructed
AdaptiveAvgPool1D = layer("AdaptiveAvgPool1D", "A11")
AdaptiveMaxPool1D = layer("AdaptiveMaxPool1D", "A11")
AdaptiveMaxPool2D = layer("AdaptiveMaxPool2D", "A11")
AvgPool1D = layer("AvgPool1D", "A11")
AvgPool2D = layer("AvgPool2D", "A11")
AvgPool3D = layer("AvgPool3D", "A11")
MaxPool1D = layer("MaxPool1D", "A11")
MaxPool3D = layer("MaxPool3D", "A11")
