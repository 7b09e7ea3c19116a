"""Counterpart: ``paddle_tpu/nn/layer/__init__.py`` (``LayerNorm`` and
``RMSNorm`` so far)."""
from .norm import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm"]
