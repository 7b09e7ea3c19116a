"""Normalisation layers.

Counterpart: ``paddle_tpu/nn/layer/norm.py``, ``LayerNorm`` (:121-146)
and ``RMSNorm`` (:149-159). The BatchNorm family comes with vision
(ROADMAP A8), the other norm layers with later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.norm import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """Paddle's LayerNorm over the trailing ``normalized_shape`` axes,
    with a unit-initialised gain ``weight`` and a zero-initialised
    ``bias`` of that shape (``weight_attr`` / ``bias_attr`` False drop
    them), on ``device`` (None → the CUDA card) in ``dtype``. Routes
    through ``nn.functional.layer_norm``: the fused kernels with
    ``FLAGS_fused_norm`` on."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, **kw)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, **kw)))

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(nn.Module):
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
