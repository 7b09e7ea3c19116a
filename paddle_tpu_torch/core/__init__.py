"""Counterpart: ``paddle_tpu/core/__init__.py`` (flags only so far)."""
from .flags import get_flag, set_flags

__all__ = ["get_flag", "set_flags"]
