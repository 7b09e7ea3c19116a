"""Convolution layers.

Counterpart: ``paddle_tpu/nn/layer/conv.py``, ``_ConvNd`` and ``Conv2D``
(:19-78): the weight ``[out, in/groups, kh, kw]`` (Paddle's layout, so
state dicts carry over unchanged) from KaimingUniform(fan_in), the bias
``[out]`` from Uniform(±1/sqrt(fan_in)). Conv1D, Conv3D and the
transposed convolutions are ROADMAP A11.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.conv import conv2d
from ..initializer import kaiming_uniform, uniform
from .._not_ported import layer
from .layers import Layer

__all__ = ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose"]


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device: DeviceLike = None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = _ntuple(stride, ndim)
        self._padding = padding
        self._dilation = _ntuple(dilation, ndim)
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        kw = dict(device=resolve_device(device), dtype=dtype)
        shape = [out_channels, in_channels // groups, *self._kernel_size]
        self._fan_in = in_channels * math.prod(self._kernel_size) // groups
        self.weight = nn.Parameter(torch.empty(shape, **kw))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.empty(out_channels, **kw)))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """KaimingUniform(fan_in) weight, Uniform(±1/sqrt(fan_in)) bias,
        drawn from ``generator`` (None: torch's default generator)."""
        kaiming_uniform(self.weight, fan_in=self._fan_in, generator=generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self._fan_in)
            uniform(self.bias, -bound, bound, generator=generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv2D(_ConvNd):
    """Paddle's Conv2D on ``device`` (None → the CUDA card) in ``dtype``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device: DeviceLike = None, dtype=torch.float32,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)


# ROADMAP A11: each raises when constructed
Conv1D = layer("Conv1D", "A11")
Conv1DTranspose = layer("Conv1DTranspose", "A11")
Conv2DTranspose = layer("Conv2DTranspose", "A11")
Conv3D = layer("Conv3D", "A11")
Conv3DTranspose = layer("Conv3DTranspose", "A11")
