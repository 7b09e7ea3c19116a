"""Counterpart: ``paddle_tpu/models/__init__.py`` (GPT serving and
training, LLaMA training so far)."""
from . import gpt, llama

__all__ = ["gpt", "llama"]
