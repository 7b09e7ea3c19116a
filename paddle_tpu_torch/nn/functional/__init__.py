"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` with its path introspection
(attention.py), the token samplers (sampling.py), ``fused_mlp``,
``fused_swiglu`` and ``fused_attn_proj_residual_layer_norm`` with their
path introspection (mlp.py), ``layer_norm``,
``fused_bias_dropout_residual_layer_norm`` and ``rms_norm`` with theirs
(norm.py), and ``chunked_mlm_xent`` (loss.py).
"""
from .attention import (last_attn_path, paged_attention_math,
                        reset_last_attn_path, scaled_dot_product_attention)
from .loss import chunked_mlm_xent
from .mlp import (fused_attn_proj_residual_layer_norm, fused_mlp,
                  fused_swiglu, last_mlp_path, reset_last_mlp_path)
from .norm import (fused_bias_dropout_residual_layer_norm, last_norm_path,
                   layer_norm, reset_last_norm_path, rms_norm)
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["categorical_math", "chunked_mlm_xent", "derive_key",
           "fused_attn_proj_residual_layer_norm",
           "fused_bias_dropout_residual_layer_norm", "fused_mlp",
           "fused_swiglu", "greedy_math", "last_attn_path", "last_mlp_path",
           "last_norm_path", "layer_norm", "paged_attention_math",
           "reset_last_attn_path", "reset_last_mlp_path",
           "reset_last_norm_path", "rms_norm", "sample_categorical",
           "sample_token", "scaled_dot_product_attention"]
