"""Math ops.

Counterpart: ``paddle_tpu/ops/math.py``, the ops the ported models
dispatch where the reference's dispatch decides a dtype: ``add`` (:20),
every tensor ``+`` of the reference's models (under AMP at O2 a promote
op casts both operands to the low dtype, where torch's ``+`` would
promote to f32), ``tanh`` (:241), both promote, and ``matmul`` (:327,
white), BERT's tied MLM logits. The rest of ``ops/`` is ROADMAP A5b.
"""
from __future__ import annotations

import torch

from ..core.dispatch import register_op

__all__ = ["add", "matmul", "tanh"]


@register_op("add")
def add(x, y, name=None):
    return torch.add(x, y)


@register_op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


@register_op("matmul", amp="white")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """x @ y, either operand's last two axes swapped first on request."""
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
