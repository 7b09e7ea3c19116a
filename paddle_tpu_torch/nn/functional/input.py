"""Input functionals.

Counterpart: ``paddle_tpu/nn/functional/input.py``: ``embedding`` (:11,
a registered promote op) and ``one_hot`` (:8, the re-export of the registered op of
``ops/manipulation.py``).
"""
from __future__ import annotations

import torch

from ...core.dispatch import register_op
from ...ops.manipulation import one_hot  # the registered op, as re-exported

__all__ = ["embedding", "one_hot"]


@register_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` gathered by the ids ``x``; with ``padding_idx``
    (≥ 0) that id's rows come out zero and pass no gradient, as the
    reference masks them at the output."""
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out
