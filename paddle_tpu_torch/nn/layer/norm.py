"""Normalisation layers.

Counterpart: ``paddle_tpu/nn/layer/norm.py``, ``RMSNorm`` (:149-159).
The LayerNorm, BatchNorm and the other norm layers come with later
slices (ROADMAP A5, A6, A8).
"""
from __future__ import annotations

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ..functional.norm import rms_norm

__all__ = ["RMSNorm"]


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
