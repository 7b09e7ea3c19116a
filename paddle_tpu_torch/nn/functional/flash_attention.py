"""Flash attention's public API.

Counterpart: ``paddle_tpu/nn/functional/flash_attention.py``:
``flash_attention`` (:14) on Paddle's [batch, seq, heads, head_dim]
layout returns ``(out, None)`` through ``scaled_dot_product_attention``
(the flash kernels, the dropout variant at ``dropout > 0`` while
training); ``flash_attn_unpadded`` (:29) and
``flash_attention_with_sparse_mask`` (:46) raise with the reference's
messages.
"""
from __future__ import annotations

from .attention import scaled_dot_product_attention

__all__ = ["flash_attention", "flash_attention_with_sparse_mask",
           "flash_attn_unpadded"]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    out = scaled_dot_product_attention(query, key, value, attn_mask=None,
                                       dropout_p=dropout, is_causal=causal,
                                       training=training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    raise NotImplementedError(
        "unpadded flash attention: pad to the max sequence length and pass "
        "a [B, 1, 1, Sk] key-padding mask to scaled_dot_product_attention "
        "— the flash kernels fold the mask into their key loop")


def flash_attention_with_sparse_mask(*a, **kw):
    raise NotImplementedError(
        "sparse-mask flash attention lands with the Pallas kernel")
