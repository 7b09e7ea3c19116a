"""Counterpart: ``paddle_tpu/utils/__init__.py`` (``unique_name`` so
far)."""
from . import unique_name

__all__ = ["unique_name"]
