"""Counterpart: ``paddle_tpu/ops/__init__.py`` (``add``, ``matmul`` and
``tanh`` of ``math.py`` so far: the rest of ``ops/`` is ROADMAP A5b)."""
from .math import add, matmul, tanh

__all__ = ["add", "matmul", "tanh"]
