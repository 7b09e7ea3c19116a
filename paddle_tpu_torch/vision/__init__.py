"""Counterpart: ``paddle_tpu/vision/__init__.py`` (the models ported so
far: the ResNet family; transforms, datasets and ops are ROADMAP A11)."""
from . import models

__all__ = ["models"]
