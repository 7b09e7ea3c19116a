"""Counterpart: ``paddle_tpu/models/__init__.py`` (GPT serving and
training, LLaMA and BERT training so far)."""
from . import bert, gpt, llama

__all__ = ["bert", "gpt", "llama"]
