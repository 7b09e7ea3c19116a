"""Counterpart: ``paddle_tpu/nn/__init__.py`` (the functionals and
layers ported so far, the ``Layer`` base and its containers of
``layer/layers.py``, and the gradient clipping of ``clip.py``)."""

from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from . import functional
from .layer import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, Conv2D, Dropout, Embedding,
                    HookRemoveHelper, Layer, LayerDict, LayerList, LayerNorm,
                    Linear, MaxPool2D, ParameterList, RMSNorm, ReLU,
                    Sequential)

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Conv2D", "Dropout", "Embedding",
           "HookRemoveHelper", "Layer", "LayerDict", "LayerList", "LayerNorm",
           "Linear", "MaxPool2D", "ParameterList", "RMSNorm", "ReLU",
           "Sequential", "clip_grad_norm_", "clip_grad_value_", "functional"]
