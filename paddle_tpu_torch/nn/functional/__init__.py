"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` (attention.py) and the token samplers
(sampling.py).
"""
from .attention import paged_attention_math, scaled_dot_product_attention
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["categorical_math", "derive_key", "greedy_math",
           "paged_attention_math", "sample_categorical", "sample_token",
           "scaled_dot_product_attention"]
