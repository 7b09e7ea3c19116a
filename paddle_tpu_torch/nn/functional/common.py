"""Common functionals.

Counterpart: ``paddle_tpu/nn/functional/common.py``, ``linear`` (:20).
Dropout, padding, interpolation and the rest of that module come with
later slices (ROADMAP A5, A11).
"""
from __future__ import annotations

__all__ = ["linear"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with Paddle's weight layout [in, out]."""
    out = x @ weight
    return out if bias is None else out + bias
