"""Activation layers.

Counterpart: ``paddle_tpu/nn/layer/activation.py``, ``ReLU`` (:28). The
other activation layers come with later slices.
"""
from __future__ import annotations


from ..functional.activation import relu
from .layers import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
