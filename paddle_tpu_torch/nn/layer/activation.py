"""Activation layers.

Counterpart: ``paddle_tpu/nn/layer/activation.py``, ``ReLU`` (:28). The
other activation layers come with later slices.
"""
from __future__ import annotations

from torch import nn

from ..functional.activation import relu

__all__ = ["ReLU"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
