"""Counterpart: ``paddle_tpu/incubate/__init__.py``: the rotary
embedding of ``incubate.nn.functional`` and ``incubate.optimizer``
(``GradientMergeOptimizer``, ``LookAhead``). ``asp``, ``autotune``,
``distributed`` and the rest of ``incubate.nn`` are ROADMAP A10 / A11."""
from . import nn, optimizer

__all__ = ["nn", "optimizer"]
