"""Counterpart: ``paddle_tpu/utils/__init__.py`` (``unique_name`` and
``resilience.atomic_write`` so far)."""
from . import resilience, unique_name

__all__ = ["resilience", "unique_name"]
