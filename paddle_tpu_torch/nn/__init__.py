"""Counterpart: ``paddle_tpu/nn/__init__.py`` (functionals,
``LayerNorm`` and ``RMSNorm`` so far)."""
from .layer import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm"]
