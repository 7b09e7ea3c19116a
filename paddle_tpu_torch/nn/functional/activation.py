"""Activation functionals.

Counterpart: ``paddle_tpu/nn/functional/activation.py``, ``relu`` (:16),
the activation of the vision path. The other activations come with later
slices (the transformer paths call GeLU and SiLU inside their MLP
functionals).
"""
from __future__ import annotations

import torch

__all__ = ["relu"]


def relu(x, name=None):
    """max(x, 0), in x's dtype."""
    return torch.relu(x)
