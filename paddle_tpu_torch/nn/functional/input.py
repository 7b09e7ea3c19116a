"""Input functionals.

Counterpart: ``paddle_tpu/nn/functional/input.py``, ``one_hot`` (:8, the
re-export of ``paddle_tpu/ops/manipulation.py:592``). ``embedding`` comes
with a later slice.
"""
from __future__ import annotations

import torch

__all__ = ["one_hot"]


def one_hot(x, num_classes, name=None):
    """x [...] int → [..., num_classes] float32, as ``jax.nn.one_hot``
    gives it: an index outside [0, num_classes) gives a row of zeros."""
    n = int(num_classes)
    classes = torch.arange(n, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)
