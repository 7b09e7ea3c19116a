"""Normalisation functionals.

Counterpart: ``paddle_tpu/nn/functional/norm.py``, ``rms_norm``
(:467-475), the LLaMA norm. The LayerNorm family and its fused kernels
(TPU kernels 13, 14) come with BERT (ROADMAP A6).
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """x / sqrt(mean(x², -1) + epsilon), then · weight. bf16 and fp16
    are normalised in f32 and cast back to x's dtype before the weight
    multiplies, as in the reference."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
