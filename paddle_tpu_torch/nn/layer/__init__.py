"""Counterpart: ``paddle_tpu/nn/layer/__init__.py`` (the layers ported
so far, the ``Layer`` base and its containers)."""
from .activation import ReLU
from .common import Dropout, Embedding, Linear
from .conv import Conv2D
from .layers import (HookRemoveHelper, Layer, LayerDict, LayerList,
                     ParameterList, Sequential)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, RMSNorm)
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "Dropout", "Embedding",
           "HookRemoveHelper", "Layer", "LayerDict", "LayerList", "LayerNorm",
           "Linear", "MaxPool2D", "ParameterList", "RMSNorm", "ReLU",
           "Sequential"]
