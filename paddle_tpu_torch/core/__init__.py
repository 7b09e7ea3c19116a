"""Counterpart: ``paddle_tpu/core/__init__.py`` (the flags, the op
registry ``dispatch`` and the dtype names ``dtype`` so far)."""
from .flags import get_flag, set_flags

__all__ = ["get_flag", "set_flags"]
