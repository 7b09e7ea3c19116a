"""Attention functionals.

Counterpart: ``paddle_tpu/nn/functional/attention.py``:
``paged_attention_math`` (:106), the one arithmetic the serving prefill,
the no-cache forward and the composite decode step share, and its
registered forms ``paged_prefill_attention`` and
``paged_decode_attention`` (:147-169, white), the dense
``_sdpa_ref`` (:26-60), ``last_attn_path`` / ``reset_last_attn_path``
(:172-186), ``_is_key_padding_mask`` (:189), the flash routes
``_flash_op`` (:65-69) and ``_flash_masked_op`` (:73-103) and
``scaled_dot_product_attention`` (:231). ``sdpa_ref``,
``flash_attention`` and ``flash_attention_masked`` are registered white
ops, as in the reference: under AMP the additive mask reaches
``flash_attention_masked`` in the low dtype and is made the kernels' f32
bias row from there, as the reference's ``astype(float32)`` makes it.

``scaled_dot_product_attention`` runs on Paddle's [b, s, h, d] layout:
without a mask, and with a key-padding mask ([B, 1, 1, Sk], bool or
additive, non-causal), through ``flash_attention_bshd`` (the Hopper
kernels on a card, their plain versions on the CPU; the mask rides in as
one f32 bias row per batch). Any other mask, and a mask with
``is_causal``, take the reference's dense ``_sdpa_ref`` math with its
once-warning: that is the reference's own route for those masks. So do
tensors the kernels do not take (not all float32 or all bfloat16 after
the AMP cast, or a head dim above 256), with the same once-warning: the
reference computes them (its flash pads any head dim, :255, and its
functional falls back on a rejected kernel). The reference's exception policy (a failed
kernel falls back to the dense path) is not ported.

Attention dropout while training takes one ``default_generator`` split
per call whenever p > 0, on every route, as the reference does
(:239-244): on the flash route the kernels' in-kernel keep-mask keyed by
it (the 'flash_masked' path, with or without a padding mask, :217-218),
on the dense route ``bernoulli(key, 1 − p)`` over the [b, h, sq, sk]
probabilities (:56-58). The two routes draw different masks, in the
reference too.
"""
from __future__ import annotations

import warnings

import torch

from ...core import generator as gen_mod
from ...core.dispatch import amp_dtypes, register_op
from ...kernels._build import kernel_dtypes
from ...kernels.flash_attention import _MAX_HEAD_DIM, flash_attention_bshd
from .common import _inv_keep
from .sampling import bernoulli

__all__ = ["last_attn_path", "paged_attention_math", "reset_last_attn_path",
           "scaled_dot_product_attention"]

_LAST_PATH = None
_DENSE_MASK_WARNED = False


def last_attn_path():
    """The attention path the most recent ``scaled_dot_product_attention``
    call took: 'flash/cuda' or 'flash_masked/cuda' (the kernels, the
    latter with the key-padding bias or dropout), the same with '/plain'
    (their plain versions, CPU tensors) or 'ref' (the dense math; None
    before any call)."""
    return _LAST_PATH


def reset_last_attn_path():
    """Clear the introspection state."""
    global _LAST_PATH
    _LAST_PATH = None


@register_op("sdpa_ref", amp="white")
def _sdpa_ref(query, key, value, attn_mask, is_causal, scale=None,
              dropout_key=None, dropout_p=0.0):
    """The reference's dense attention on [b, s, h, d] (:26-60): logits in
    the input dtype, scaled, then f32 with the causal mask and the
    attention mask (bool keeps, float adds) applied at -inf; softmax in
    f32, probabilities cast to the input dtype; with ``dropout_key`` and
    p > 0 the probabilities kept with ``bernoulli(key, 1 − p)`` and
    scaled by 1 / (1 − p) in their dtype, as ``common._dropout_raw`` scales
    them; GQA broadcasts k/v heads."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    if scale is None:
        scale = d ** -0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    if kt.shape[1] != h:
        rep = h // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = (qt @ kt.transpose(-1, -2)) * scale
    logits = logits.float()
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=query.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    p = torch.softmax(logits, -1).to(query.dtype)
    if dropout_p > 0.0 and dropout_key is not None:
        keep = 1.0 - dropout_p
        dm = bernoulli(torch.tensor(dropout_key, dtype=torch.int64,
                                    device=p.device), keep, p.shape)
        p = torch.where(dm, p * _inv_keep(keep, p), torch.zeros_like(p))
    return (p @ vt).transpose(1, 2)


def _is_key_padding_mask(attn_mask):
    """Shape-only test: [B, 1, 1, Sk] broadcasts one additive row over
    heads and q rows, the key-padding regime the kernels cover."""
    shape = tuple(attn_mask.shape)
    return len(shape) == 4 and shape[1] == 1 and shape[2] == 1


def _kv_bias(attn_mask, b, sk):
    """[B, 1, 1, Sk] (or [B, Sk]) bool keep-mask or additive float → the
    [b, sk] f32 bias row per batch (:88-97): bool False → -1e30."""
    m = attn_mask.reshape(attn_mask.shape[0], attn_mask.shape[-1])
    if m.dtype == torch.bool:
        bias = torch.where(m, 0.0, -1e30).float()
    else:
        bias = m.float()
    return bias.expand(b, sk)


@register_op("flash_attention", amp="white")
def _flash_op(query, key, value, is_causal):
    """The flash kernels without a mask or dropout."""
    return flash_attention_bshd(query, key, value, causal=bool(is_causal))


@register_op("flash_attention_masked", amp="white")
def _flash_masked_op(query, key, value, kv_mask, dropout_key, dropout_p,
                     is_causal, scale):
    """The flash kernels with a key-padding mask ([B, 1, 1, Sk] or [B,
    Sk], bool or additive; None: none) as their f32 bias row and the
    in-kernel dropout keyed by ``dropout_key``."""
    bias = (None if kv_mask is None else
            _kv_bias(kv_mask, query.shape[0], key.shape[1]))
    return flash_attention_bshd(query, key, value, causal=bool(is_causal),
                                scale=scale, kv_bias=bias,
                                dropout_p=float(dropout_p),
                                dropout_seed=dropout_key)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention on Paddle's [b, s, h, d] layout; returns [b, sq, h, d] in
    query's dtype. Routes as the reference does (see the module
    docstring)."""
    global _LAST_PATH, _DENSE_MASK_WARNED
    p = float(dropout_p) if training else 0.0
    # one generator split per call whenever dropout is live, on every
    # route (:239-244)
    dk = gen_mod.default_generator.split_key() if p > 0 else None
    mode = "cuda" if query.device.type == "cuda" else "plain"
    dts = amp_dtypes(_flash_op, query, key, value)
    takes = kernel_dtypes(*dts) and query.shape[-1] <= _MAX_HEAD_DIM
    if takes and attn_mask is None and p == 0:
        _LAST_PATH = f"flash/{mode}"
        return _flash_op(query, key, value, bool(is_causal))
    if takes and (attn_mask is None
                  or (not is_causal and _is_key_padding_mask(attn_mask))):
        _LAST_PATH = f"flash_masked/{mode}"
        return _flash_masked_op(query, key, value, attn_mask, dk, p,
                                bool(is_causal), None)
    if not _DENSE_MASK_WARNED:
        _DENSE_MASK_WARNED = True
        why = ("attn_mask is not a key-padding mask ([B, 1, 1, Sk]) or is "
               "combined with is_causal" if takes else
               f"the flash kernels take q, k, v all float32 or all bfloat16 "
               f"with head_dim <= {_MAX_HEAD_DIM}, got {dts[0]}, {dts[1]}, "
               f"{dts[2]}, head_dim {query.shape[-1]}")
        warnings.warn(
            f"scaled_dot_product_attention: {why}; taking the dense "
            "reference path (materializes [B, H, Sq, Sk] scores), not the "
            "flash kernels")
    _LAST_PATH = "ref"
    return _sdpa_ref(query, key, value, attn_mask, bool(is_causal),
                     dropout_key=dk, dropout_p=p)


@register_op("paged_prefill_attention", amp="white")
def _paged_prefill_op(query, key, value, scale):
    """Serving prefill attention over [B, S, NH, D] q and [B, S, KVH, D]
    k/v (:147-157): causal within the padded prefix, pos_ids = arange(S)."""
    B, S = query.shape[0], query.shape[1]
    pos = torch.arange(S, device=query.device)[None, :].expand(B, S)
    return paged_attention_math(query, key, value, pos, scale)


@register_op("paged_decode_attention", amp="white")
def _paged_decode_op(query, key_ctx, value_ctx, positions, scale):
    """Serving decode attention (:160-169): query [B, NH, D] over the
    gathered context [B, CTX, KVH, D], each token attending up to its
    absolute position ``positions`` [B]."""
    return paged_attention_math(query[:, None], key_ctx, value_ctx,
                                positions[:, None], scale)[:, 0]


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
