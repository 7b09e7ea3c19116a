"""Counterpart: ``paddle_tpu/nn/layer/__init__.py`` (``RMSNorm`` so far)."""
from .norm import RMSNorm

__all__ = ["RMSNorm"]
