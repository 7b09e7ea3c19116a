"""Attention functionals.

Counterpart: ``paddle_tpu/nn/functional/attention.py``:
``paged_attention_math`` (:106), the one arithmetic the serving prefill,
the no-cache forward and the composite decode step share, and
``scaled_dot_product_attention`` (:231) on its unmasked, dropout-free
route to the flash kernel (:198-228). The masked and dropout routes
belong to BERT (ROADMAP A6).
"""
from __future__ import annotations

import torch

from ...kernels.flash_attention import flash_attention_bshd

__all__ = ["paged_attention_math", "scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention on Paddle's [b, s, h, d] layout through
    ``flash_attention_bshd`` (the Hopper kernels on a card, their plain
    versions on the CPU). An attention mask, or dropout while training,
    is the BERT route (ROADMAP A6) and raises NotImplementedError."""
    p = float(dropout_p) if training else 0.0
    if attn_mask is not None or p > 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask and dropout take the "
            "masked flash-attention kernels, ported with BERT (ROADMAP A6)")
    return flash_attention_bshd(query, key, value, causal=bool(is_causal))


def paged_attention_math(q, k, v, pos_ids, scale):
    """Masked-softmax attention over gathered cache context.

    q [B, Q, NH, D]; k/v [B, CTX, KVH, D]; pos_ids [B, Q] — the absolute
    position of each query row. Context slot j is attended iff
    j <= pos_ids[b, q]. GQA folds NH into [KVH, G]. Scores and softmax
    run in f32; masked lanes are -inf (exp gives exactly 0), unlike the
    decode kernel's -1e30. Returns [B, Q, NH, D] in q's dtype."""
    B, Q, NH, D = q.shape
    CTX, KVH = k.shape[1], k.shape[2]
    if NH % KVH != 0:
        raise ValueError(f"query heads {NH} not a multiple of kv heads "
                         f"{KVH}")
    G = NH // KVH
    qf = q.float().reshape(B, Q, KVH, G, D)
    scores = torch.einsum("bqkgd,bjkd->bqkgj", qf, k.float()) * scale
    mask = (torch.arange(CTX, device=q.device)[None, None, :]
            <= pos_ids[:, :, None])
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    w = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bqkgj,bjkd->bqkgd", w, v.float())
    return out.reshape(B, Q, NH, D).to(q.dtype)
