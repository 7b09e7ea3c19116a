"""Normalisation layers.

Counterpart: ``paddle_tpu/nn/layer/norm.py``: ``_BatchNormBase`` with
``forward`` and ``forward_act`` (:16-63), ``BatchNorm``, ``BatchNorm1D``,
``BatchNorm2D`` and ``BatchNorm3D`` (:66-96), ``LayerNorm`` (:121-146)
``RMSNorm`` (:149-159), ``InstanceNorm1D`` / ``2D`` / ``3D``,
``GroupNorm`` and ``LocalResponseNorm`` (:162-227). ``SyncBatchNorm``
(:98) comes with the distributed slice: constructing one raises naming
ROADMAP A10. The namespace's ``SpectralNorm`` is ``layer/extra.py``'s,
as the reference's is.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.norm import batch_norm, batch_norm_act, layer_norm, rms_norm
from ..functional.norm import group_norm, instance_norm, local_response_norm
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LayerNorm", "LocalResponseNorm", "RMSNorm", "SyncBatchNorm"]


def _torch_dtype(dtype):
    """A torch dtype, or Paddle's name of one ('float32', 'bfloat16')."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class _BatchNormBase(Layer):
    """Paddle's BatchNorm: a unit-initialised ``weight`` and a zero ``bias``
    [num_features] (``weight_attr`` / ``bias_attr`` False drop them) in
    ``dtype``, and the running statistics as the buffers ``_mean`` (zeros)
    and ``_variance`` (ones), f32 whatever the dtype, all on ``device``
    (None → the CUDA card). In training (``use_global_stats`` None or
    False) the batch statistics normalise and update the buffers with
    ``momentum`` (Paddle's: 0.9 keeps 90% of the old value); in eval mode
    the buffers normalise. Train-mode calls take the fused kernels with
    ``FLAGS_fused_norm`` on (``nn.functional.batch_norm_act``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=resolve_device(device), dtype=_torch_dtype(dtype))
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw)))
        f32 = dict(device=kw["device"], dtype=torch.float32)
        self.register_buffer("_mean", torch.zeros(num_features, **f32))
        self.register_buffer("_variance", torch.ones(num_features, **f32))

    def forward(self, input):  # noqa: A002
        return batch_norm(input, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def forward_act(self, input, activation=None, residual=None):  # noqa: A002
        """forward with a fused epilogue: out = activation(bn(input) +
        residual), the ResNet block order; on the fused route the
        normalised value and the pre-activation never reach device
        memory."""
        return batch_norm_act(input, self._mean, self._variance, self.weight,
                              self.bias, training=self.training,
                              momentum=self._momentum, epsilon=self._epsilon,
                              data_format=self._data_format,
                              use_global_stats=self._use_global_stats,
                              activation=activation, residual=residual)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """Paddle's legacy ``nn.BatchNorm``: the same math, with an optional
    activation by name (``act``) after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 dtype="float32", data_layout="NCHW", *,
                 device: DeviceLike = None, **kwargs):
        super().__init__(num_channels, momentum, epsilon,
                         data_format=data_layout, device=device, dtype=dtype)
        self._act = act

    def forward(self, input):  # noqa: A002
        out = super().forward(input)
        if self._act:
            from .. import functional as F
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def forward(self, input):  # noqa: A002
        fmt = "NCL" if self._data_format in ("NCHW", "NCL") else "NLC"
        return batch_norm(input, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=fmt,
                          use_global_stats=self._use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class LayerNorm(Layer):
    """Paddle's LayerNorm over the trailing ``normalized_shape`` axes,
    with a unit-initialised gain ``weight`` and a zero-initialised
    ``bias`` of that shape (``weight_attr`` / ``bias_attr`` False drop
    them), on ``device`` (None → the CUDA card) in ``dtype``. Routes
    through ``nn.functional.layer_norm``: the fused kernels with
    ``FLAGS_fused_norm`` on."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(dtype=_torch_dtype(dtype))
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = (None if weight_attr is False else
                       self.create_parameter(
                           self._normalized_shape, attr=weight_attr,
                           default_initializer=Constant(1.0), device=dev))
        self.bias = (None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            device=dev))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    """RMSNorm over the last dim with a unit-initialised gain named
    ``weight`` ([hidden_size]), on ``device`` (None → the CUDA card) in
    ``dtype``."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class SyncBatchNorm(_BatchNormBase):
    """Cross-device BatchNorm: ROADMAP A10 (the distributed slice)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm is not ported yet (ROADMAP A10)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm is not ported yet (ROADMAP A10)")


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device: DeviceLike = None):
        super().__init__()
        self._epsilon = epsilon
        self._momentum = momentum
        self._data_format = data_format
        dev = resolve_device(device)
        self.scale = (None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0), device=dev))
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=dev))

    def forward(self, x):
        return instance_norm(x, weight=self.scale, bias=self.bias,
                             momentum=self._momentum, eps=self._epsilon,
                             data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device: DeviceLike = None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device: DeviceLike = None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device: DeviceLike = None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        dev = resolve_device(device)
        self.weight = (None if weight_attr is False else
                       self.create_parameter(
                           [num_channels], attr=weight_attr,
                           default_initializer=Constant(1.0), device=dev))
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, device=dev))

    def forward(self, x):
        return group_norm(x, self._num_groups, self._epsilon, self.weight,
                          self.bias, self._data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return local_response_norm(x, *self.args)
