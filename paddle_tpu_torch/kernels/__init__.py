"""Counterpart: ``paddle_tpu/kernels/__init__.py``.

Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built by
``_build.py`` at first use) with their plain PyTorch versions beside
them. Importing this package builds nothing.
"""
from .mlp_fusion import decode_attn_proj, decode_attn_proj_ref

__all__ = ["decode_attn_proj", "decode_attn_proj_ref"]
