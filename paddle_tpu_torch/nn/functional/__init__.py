"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` (attention.py), the token samplers
(sampling.py) and ``fused_mlp`` with its path introspection (mlp.py).
"""
from .attention import paged_attention_math, scaled_dot_product_attention
from .mlp import fused_mlp, last_mlp_path, reset_last_mlp_path
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["categorical_math", "derive_key", "fused_mlp", "greedy_math",
           "last_mlp_path", "paged_attention_math", "reset_last_mlp_path",
           "sample_categorical", "sample_token",
           "scaled_dot_product_attention"]
