"""Counterpart: ``paddle_tpu/optimizer/__init__.py`` (the base
``Optimizer``, ``SGD``, ``Momentum``, ``Adam`` and ``AdamW`` so far; the
other optimizers and ``lr`` are ROADMAP A5)."""
from .optimizer import L2Decay, Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Adam", "AdamW", "L2Decay", "Momentum", "Optimizer", "SGD"]
