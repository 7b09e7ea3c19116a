"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``.

Ported so far: ``paged_attention_math`` and
``scaled_dot_product_attention`` with its path introspection
(attention.py), the token samplers (sampling.py), ``fused_mlp``,
``fused_swiglu`` and ``fused_attn_proj_residual_layer_norm`` with their
path introspection (mlp.py), ``layer_norm``,
``fused_bias_dropout_residual_layer_norm``, ``batch_norm``,
``batch_norm_act`` and ``rms_norm`` with theirs (norm.py),
``binary_cross_entropy``, ``chunked_mlm_xent`` and ``cross_entropy``
(loss.py), ``dropout``, ``interpolate`` / ``upsample`` (nearest) and
``linear`` (common.py), ``conv2d`` (conv.py), ``max_pool2d`` and
``adaptive_avg_pool2d`` (pooling.py), ``gelu``, ``relu``, ``sigmoid``,
``silu``, ``softplus`` and ``tanh`` (activation.py), ``embedding`` and
``one_hot`` (input.py). The ops among them are registered
(``core/dispatch.py``) under the reference's names and AMP categories.
"""
from .activation import gelu, relu, sigmoid, silu, softplus, tanh
from .attention import (last_attn_path, paged_attention_math,
                        reset_last_attn_path, scaled_dot_product_attention)
from .common import dropout, interpolate, linear, upsample
from .conv import conv2d
from .input import embedding, one_hot
from .loss import binary_cross_entropy, chunked_mlm_xent, cross_entropy
from .mlp import (fused_attn_proj_residual_layer_norm, fused_mlp,
                  fused_swiglu, last_mlp_path, reset_last_mlp_path)
from .norm import (batch_norm, batch_norm_act,
                   fused_bias_dropout_residual_layer_norm, last_norm_path,
                   layer_norm, reset_last_norm_path, rms_norm)
from .pooling import adaptive_avg_pool2d, max_pool2d
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_token)

__all__ = ["adaptive_avg_pool2d", "batch_norm", "batch_norm_act",
           "binary_cross_entropy", "categorical_math", "chunked_mlm_xent",
           "conv2d", "cross_entropy", "dropout", "embedding",
           "derive_key", "fused_attn_proj_residual_layer_norm",
           "fused_bias_dropout_residual_layer_norm", "fused_mlp",
           "fused_swiglu", "gelu", "greedy_math", "interpolate", "last_attn_path",
           "last_mlp_path", "last_norm_path", "layer_norm", "linear",
           "max_pool2d", "one_hot", "paged_attention_math", "relu",
           "reset_last_attn_path", "reset_last_mlp_path",
           "reset_last_norm_path", "rms_norm", "sample_categorical",
           "sample_token", "scaled_dot_product_attention", "sigmoid", "silu",
           "softplus", "tanh", "upsample"]
