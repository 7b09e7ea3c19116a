"""Counterpart: ``paddle_tpu/nn/__init__.py`` (the functionals and
layers ported so far, and the gradient clipping of ``clip.py``).
``Sequential`` is ``torch.nn.Sequential``: its
child names ``0``, ``1``, ... are Paddle's."""
from torch.nn import Sequential

from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, Conv2D, Dropout, Embedding, LayerNorm,
                    Linear, MaxPool2D, RMSNorm, ReLU)

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Conv2D", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MaxPool2D", "RMSNorm", "ReLU", "Sequential", "clip_grad_norm_",
           "clip_grad_value_"]
