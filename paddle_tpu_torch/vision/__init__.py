"""Counterpart: ``paddle_tpu/vision/__init__.py`` (the ResNet family and
``ops.matrix_nms`` so far; transforms, datasets, the other models and
the other ops are ROADMAP A11)."""
from . import models, ops

__all__ = ["models", "ops"]
