"""Counterpart: ``paddle_tpu/nn/__init__.py`` (functionals and
``RMSNorm`` so far)."""
from .layer import RMSNorm

__all__ = ["RMSNorm"]
