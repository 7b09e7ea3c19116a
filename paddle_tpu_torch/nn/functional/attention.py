"""Attention functionals.

Counterpart: ``paddle_tpu/nn/functional/attention.py`` — only
``paged_attention_math`` (:106) so far, the one arithmetic the serving
prefill, the no-cache forward and the composite decode step share. The
flash-attention routing belongs to the training slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

__all__ = ["paged_attention_math"]


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
