"""Counterpart: ``paddle_tpu/kernels/__init__.py``.

Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
``_build.py`` at first use) with their plain PyTorch versions beside
them. Importing this package builds nothing.
"""
from .chunked_xent import (chunked_softmax_xent,
                           chunked_softmax_xent_per_token)
from .flash_attention import (flash_attention_bshd, flash_bwd, flash_bwd_ref,
                              flash_fwd, flash_fwd_ref)
from .mlp_fusion import (decode_attn_proj, decode_attn_proj_ref,
                         fused_mlp_2d, fused_mlp_bwd, fused_mlp_fwd,
                         fused_mlp_fwd_ref, fused_proj_ln_2d,
                         fused_proj_ln_bwd, fused_proj_ln_fwd,
                         fused_proj_ln_fwd_ref, fused_swiglu_2d,
                         fused_swiglu_bwd, fused_swiglu_fwd,
                         fused_swiglu_fwd_ref, mlp_eligible)
from .norm_fusion import (bn_eligible, fused_batch_norm_train, fused_bn_bwd,
                          fused_bn_bwd_ref, fused_bn_fwd, fused_bn_fwd_ref,
                          fused_layer_norm_2d, fused_ln_bwd, fused_ln_fwd,
                          fused_ln_fwd_ref)

__all__ = ["bn_eligible", "chunked_softmax_xent",
           "chunked_softmax_xent_per_token", "fused_batch_norm_train",
           "fused_bn_bwd", "fused_bn_bwd_ref", "fused_bn_fwd",
           "fused_bn_fwd_ref",
           "decode_attn_proj", "decode_attn_proj_ref",
           "flash_attention_bshd", "flash_bwd", "flash_bwd_ref", "flash_fwd",
           "flash_fwd_ref", "fused_layer_norm_2d", "fused_ln_bwd",
           "fused_ln_fwd", "fused_ln_fwd_ref", "fused_mlp_2d",
           "fused_mlp_bwd", "fused_mlp_fwd", "fused_mlp_fwd_ref",
           "fused_proj_ln_2d", "fused_proj_ln_bwd", "fused_proj_ln_fwd",
           "fused_proj_ln_fwd_ref", "fused_swiglu_2d", "fused_swiglu_bwd",
           "fused_swiglu_fwd", "fused_swiglu_fwd_ref", "mlp_eligible"]
