"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` (attention.py), the token samplers
(sampling.py), ``fused_mlp`` and ``fused_swiglu`` with their path
introspection (mlp.py) and ``rms_norm`` (norm.py).
"""
from .attention import paged_attention_math, scaled_dot_product_attention
from .mlp import fused_mlp, fused_swiglu, last_mlp_path, reset_last_mlp_path
from .norm import rms_norm
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["categorical_math", "derive_key", "fused_mlp", "fused_swiglu",
           "greedy_math", "last_mlp_path", "paged_attention_math",
           "reset_last_mlp_path", "rms_norm", "sample_categorical",
           "sample_token", "scaled_dot_product_attention"]
