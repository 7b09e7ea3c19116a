"""Loss functionals.

Counterpart: ``paddle_tpu/nn/functional/loss.py``, ``chunked_mlm_xent``
(:238-251), BERT's tied MLM head. The other losses of that module come
with later slices.
"""
from __future__ import annotations

from ...kernels.chunked_xent import chunked_softmax_xent_per_token

__all__ = ["chunked_mlm_xent"]


def chunked_mlm_xent(h, w, bias, labels):
    """Per-position cross-entropy of the tied head ``h @ wᵀ + bias`` with
    the vocabulary streamed in chunks: [B, S, V] logits never exist at
    once. h [B, S, H]; w [V, H]; bias [V] or None; labels [B, S] int.
    Returns f32 [B, S]."""
    return chunked_softmax_xent_per_token(h, w, bias, labels)
