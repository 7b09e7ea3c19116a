"""Common layers.

Counterpart: ``paddle_tpu/nn/layer/common.py``, ``Linear`` (:9-30):
weight ``[in_features, out_features]`` (Paddle's layout) from
XavierNormal, a zero bias; ``Dropout`` (:41-54), ``F.dropout`` in the
module's training mode; ``Embedding`` (:87-109), weight
``[num_embeddings, embedding_dim]`` from normal(0, 1), the padding row
zero, through ``F.embedding``. Each is an ``nn.Layer``
(``layers.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.common import dropout, linear
from ..functional.input import embedding
from ..initializer import constant, xavier_normal
from .layers import Layer

__all__ = ["Dropout", "Embedding", "Linear"]


class Linear(Layer):
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


class Dropout(Layer):
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


class Embedding(Layer):
    """Rows of ``weight`` [num_embeddings, embedding_dim] by id, on
    ``device`` (None → the CUDA card) in ``dtype``; ``padding_idx``
    (negative: from the end) names a row that is zero and comes out
    zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self._padding_idx is not None:
            self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"
