"""Counterpart: ``paddle_tpu/nn/__init__.py`` (the functionals and
layers ported so far). ``Sequential`` is ``torch.nn.Sequential``: its
child names ``0``, ``1``, ... are Paddle's."""
from torch.nn import Sequential

from .layer import (AdaptiveAvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, Conv2D, Dropout, LayerNorm, Linear,
                    MaxPool2D, RMSNorm, ReLU)

__all__ = ["AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv2D", "Dropout", "LayerNorm", "Linear",
           "MaxPool2D", "RMSNorm", "ReLU", "Sequential"]
