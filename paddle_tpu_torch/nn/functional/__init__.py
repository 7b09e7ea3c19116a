"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` with its path introspection
(attention.py), the token samplers (sampling.py), ``fused_mlp``,
``fused_swiglu`` and ``fused_attn_proj_residual_layer_norm`` with their
path introspection (mlp.py), ``layer_norm``,
``fused_bias_dropout_residual_layer_norm``, ``batch_norm``,
``batch_norm_act`` and ``rms_norm`` with theirs (norm.py),
``chunked_mlm_xent`` and ``cross_entropy`` (loss.py), ``dropout``
(common.py), ``conv2d``
(conv.py), ``max_pool2d`` and ``adaptive_avg_pool2d`` (pooling.py),
``relu`` (activation.py) and ``linear`` (common.py).
"""
from .activation import relu
from .attention import (last_attn_path, paged_attention_math,
                        reset_last_attn_path, scaled_dot_product_attention)
from .common import dropout, linear
from .conv import conv2d
from .loss import chunked_mlm_xent, cross_entropy
from .mlp import (fused_attn_proj_residual_layer_norm, fused_mlp,
                  fused_swiglu, last_mlp_path, reset_last_mlp_path)
from .norm import (batch_norm, batch_norm_act,
                   fused_bias_dropout_residual_layer_norm, last_norm_path,
                   layer_norm, reset_last_norm_path, rms_norm)
from .pooling import adaptive_avg_pool2d, max_pool2d
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["adaptive_avg_pool2d", "batch_norm", "batch_norm_act",
           "categorical_math", "chunked_mlm_xent", "conv2d", "cross_entropy",
           "dropout",
           "derive_key", "fused_attn_proj_residual_layer_norm",
           "fused_bias_dropout_residual_layer_norm", "fused_mlp",
           "fused_swiglu", "greedy_math", "last_attn_path", "last_mlp_path",
           "last_norm_path", "layer_norm", "linear", "max_pool2d",
           "paged_attention_math", "relu", "reset_last_attn_path",
           "reset_last_mlp_path", "reset_last_norm_path", "rms_norm",
           "sample_categorical", "sample_token",
           "scaled_dot_product_attention"]
