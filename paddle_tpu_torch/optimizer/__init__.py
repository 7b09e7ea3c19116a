"""Counterpart: ``paddle_tpu/optimizer/__init__.py`` (the base
``Optimizer``, ``Adam`` and ``AdamW`` so far; the other optimizers and
``lr`` are ROADMAP A5)."""
from .optimizer import L2Decay, Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "L2Decay", "Optimizer"]
