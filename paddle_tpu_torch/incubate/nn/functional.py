"""Fused-op functionals.

Counterpart: ``paddle_tpu/incubate/nn/functional.py``,
``fused_bias_dropout_residual_layer_norm`` (:71-89), which delegates to
the routed functional of ``nn/functional/norm.py``, and
``fused_rotary_position_embedding`` (:117-179), the rotary embedding of
LLaMA's q and k. The other fused ops of that module come with later
slices (ROADMAP A11).

One deviation, on purpose: the reference multiplies by f32 sin/cos
tables under ``amp="promote"`` (:116), so bf16 q and k come out f32 and
carry f32 through the rest of its LLaMA model. Here the rotation is
computed in f32 and each output is rounded back to its input's dtype, as
upstream Paddle's fused op returns q's dtype: a bf16 model stays bf16.
In f32 the two agree (ROADMAP C).
"""
from __future__ import annotations

import torch

from ...nn.functional import norm as _norm

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding"]


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """out = LayerNorm(residual + dropout(bias + x)), through the routed
    functional of ``nn.functional`` (the fused kernels behind
    ``FLAGS_fused_norm``), with the reference's check on ``mode``."""
    if mode != "upscale_in_train":
        raise NotImplementedError(
            "fused_bias_dropout_residual_layer_norm: only "
            "mode='upscale_in_train' is implemented (the reference fused "
            f"kernel is upscale-only too); got {mode!r}")
    return _norm.fused_bias_dropout_residual_layer_norm(
        x, residual, bias=bias, ln_scale=ln_scale, ln_bias=ln_bias,
        dropout_rate=dropout_rate, ln_epsilon=ln_epsilon, training=training)

_ROPE_BASE = 10000.0    # the reference's table builder hard-codes it (:145)


def _tables(length, d, neox, device):
    """sin, cos [length, d] f32, the reference's table (:134-151)."""
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    inv = 1.0 / (_ROPE_BASE ** (torch.arange(0, d, 2, device=device,
                                             dtype=torch.float32) / d))
    freqs = pos * inv[None, :]
    emb = (torch.cat([freqs, freqs], -1) if neox
           else freqs.repeat_interleave(2, -1))
    return torch.sin(emb), torch.cos(emb)


def _rotate(x, sin_e, cos_e, neox):
    xf = x.float()
    if neox:
        x1, x2 = xf.chunk(2, -1)
        rotated = torch.cat([-x2, x1], -1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rotated = torch.stack([-x2, x1], -1).reshape(xf.shape)
    return (xf * cos_e + rotated * sin_e).to(x.dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """Rotate q (and k, v when given), each [B, S, num_heads, head_dim]:
    ``x·cos + rotate_half(x)·sin`` (neox: halves; else interleaved
    pairs). ``sin``/``cos``: tables with any leading-1 layout ending in
    head_dim, else built with base 10000 to cover S or the largest of
    ``position_ids`` [B, S]. Returns (q, k, v) rotated, None for an
    absent k or v."""
    _, s, _, d = q.shape
    neox = bool(use_neox_rotary_style)
    if sin is None:
        length = s
        if position_ids is not None:
            length = max(length, int(position_ids.max()) + 1)
        sin_t, cos_t = _tables(length, d, neox, q.device)
    else:
        sin_t = sin.float().reshape(-1, sin.shape[-1])
        cos_t = cos.float().reshape(-1, cos.shape[-1])
    if position_ids is not None:
        ids = position_ids.long()
        sin_e, cos_e = sin_t[ids][:, :, None, :], cos_t[ids][:, :, None, :]
    else:
        sin_e, cos_e = sin_t[None, :, None, :], cos_t[None, :, None, :]
    return tuple(None if x is None else _rotate(x, sin_e, cos_e, neox)
                 for x in (q, k, v))
