"""Automatic mixed precision.

Counterpart: ``paddle_tpu/amp/__init__.py``: ``auto_cast`` /
``amp_guard``, ``decorate`` / ``amp_decorate``, ``GradScaler`` /
``AmpScaler``, the op lists and ``debugging`` (the tensor checker,
``check_numerics``, ``collect_operator_stats``).
"""
import torch

from . import debugging
from .amp_lists import black_list, white_list
from .auto_cast import (amp_decorate, amp_guard, auto_cast, decorate,
                        get_amp_dtype, is_auto_cast_enabled)
from .grad_scaler import AmpScaler, GradScaler, OptiLevel

__all__ = ["AmpScaler", "GradScaler", "OptiLevel", "amp_decorate",
           "amp_guard", "auto_cast", "black_list", "debugging", "decorate",
           "get_amp_dtype", "is_auto_cast_enabled", "is_bfloat16_supported",
           "is_float16_supported", "white_list"]


def is_bfloat16_supported(place=None):
    """bf16 runs on the CPU and on a card that computes it (Ampere on)."""
    if torch.cuda.is_available() and (place is None or "cpu" not in str(place)):
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(place=None):
    return True
