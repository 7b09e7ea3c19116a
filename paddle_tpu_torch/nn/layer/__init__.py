"""Counterpart: ``paddle_tpu/nn/layer/__init__.py`` (the layers ported
so far)."""
from .activation import ReLU
from .common import Dropout, Embedding, Linear
from .conv import Conv2D
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MaxPool2D", "RMSNorm", "ReLU"]
