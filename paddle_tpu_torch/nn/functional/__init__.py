"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Only the serving functionals are ported so far: ``paged_attention_math``
(attention.py) and the token samplers (sampling.py).
"""
from .attention import paged_attention_math
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["categorical_math", "derive_key", "greedy_math",
           "paged_attention_math", "sample_categorical", "sample_token"]
