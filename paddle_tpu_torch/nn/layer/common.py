"""Common layers.

Counterpart: ``paddle_tpu/nn/layer/common.py`` (:9-249): ``Linear``,
weight ``[in_features, out_features]`` (Paddle's layout) from
XavierNormal and a zero bias; ``Identity``; ``Dropout``, ``Dropout2D``,
``Dropout3D`` and ``AlphaDropout`` in the module's training mode;
``Embedding``, weight ``[num_embeddings, embedding_dim]`` from normal(0,
1), the padding row zero, through ``F.embedding``; ``Flatten``;
``Upsample`` and its two 2-D forms (``interpolate``'s nearest mode; the
others are ROADMAP A11); ``Bilinear``; ``PixelShuffle``,
``PixelUnshuffle``, ``ChannelShuffle``; ``Pad1D`` / ``2D`` / ``3D`` and
``ZeroPad2D``; ``CosineSimilarity``; ``Unfold`` and ``Fold``. Each is an
``nn.Layer`` (``layers.py``).

``Linear`` and ``Embedding`` build their parameters through
``Layer.create_parameter`` (the framework generator, the reference's
draws) unless a ``torch.Generator`` is passed: the built-in models pass
none and re-draw from their own seeded generator (``reset_parameters``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from .. import functional as F
from ..initializer import Normal, XavierNormal, constant, xavier_normal
from .layers import Layer

__all__ = ["AlphaDropout", "Bilinear", "ChannelShuffle", "CosineSimilarity",
           "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Flatten",
           "Fold", "Identity", "Linear", "Pad1D", "Pad2D", "Pad3D",
           "PixelShuffle", "PixelUnshuffle", "Unfold", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "ZeroPad2D"]


class Linear(Layer):
    """y = x @ weight + bias on ``device`` (None → the current place) in
    ``dtype``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32, generator=None):
        super().__init__(dtype=dtype)
        self._in_features = in_features
        self._out_features = out_features
        dev = resolve_device(device)
        if generator is None:
            self.weight = self.create_parameter(
                [in_features, out_features], attr=weight_attr,
                default_initializer=XavierNormal(), device=dev)
            self.bias = None if bias_attr is False else self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True, device=dev)
            return
        kw = dict(device=dev, dtype=dtype)
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
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):  # noqa: A002
        return input


class Dropout(Layer):
    """Paddle's ``nn.Dropout``: ``F.dropout`` with the module's training
    mode (one generator split per call while training at p > 0)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002
        return F.dropout(input, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout2d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout3d(input, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):  # noqa: A002
        return F.alpha_dropout(input, p=self.p, training=self.training)


class Embedding(Layer):
    """Rows of ``weight`` [num_embeddings, embedding_dim] by id, on
    ``device`` (None → the current place) in ``dtype``; ``padding_idx``
    (negative: from the end) names a row that is zero and comes out
    zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        dev = resolve_device(device)
        if generator is None:
            self.weight = self.create_parameter(
                [num_embeddings, embedding_dim], attr=weight_attr,
                default_initializer=Normal(0.0, 1.0), device=dev)
            if self._padding_idx is not None:
                with torch.no_grad():
                    self.weight[self._padding_idx] = 0.0
            return
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=dev, dtype=dtype))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self._padding_idx is not None:
            self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):  # noqa: A002
        from ...ops.manipulation import flatten
        return flatten(input, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             align_mode=self.align_mode,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierNormal(), device=dev)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=dev)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.r, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.r, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, name)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format, name)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
