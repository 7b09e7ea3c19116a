"""Counterpart: ``paddle_tpu/models/__init__.py`` (GPT serving so far)."""
from . import gpt

__all__ = ["gpt"]
