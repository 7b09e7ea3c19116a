"""Counterpart: ``paddle_tpu/nn/functional/__init__.py``: every
functional of the modules below, under the reference's names; the ops
among them are registered (``core/dispatch.py``) under the reference's
names and AMP categories. Path introspection: ``last_attn_path``,
``last_mlp_path``, ``last_norm_path`` and their resets. Names that wait
for a later item (ROADMAP A11's convolutions and pools,
``sparse_attention``) raise naming it when called.
"""
from . import (activation, attention, common, conv, extra, input, loss,
               mlp, norm, pooling, sampling)
from . import flash_attention as _flash_attention
from .activation import *  # noqa: F401,F403
from .attention import (last_attn_path, paged_attention_math,
                        reset_last_attn_path, scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .flash_attention import *  # noqa: F401,F403
from .input import embedding, one_hot
from .loss import *  # noqa: F401,F403
from .mlp import (fused_attn_proj_residual_layer_norm, fused_mlp,
                  fused_swiglu, last_mlp_path, reset_last_mlp_path)
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .sampling import (categorical_math, derive_key, greedy_math,
                       sample_categorical, sample_greedy, sample_token)

__all__ = sorted(set(
    activation.__all__ + attention.__all__ + common.__all__ + conv.__all__
    + extra.__all__ + _flash_attention.__all__ + loss.__all__ + norm.__all__
    + pooling.__all__
    + ["categorical_math", "derive_key", "embedding",
       "fused_attn_proj_residual_layer_norm", "fused_mlp", "fused_swiglu",
       "greedy_math", "last_mlp_path", "one_hot", "reset_last_mlp_path",
       "sample_categorical", "sample_greedy", "sample_token"]))
