"""Counterpart: ``paddle_tpu/models/__init__.py`` (GPT serving and
training, LLaMA serving and training, BERT training and the PP-YOLOE
detector so far)."""
from . import bert, gpt, llama, ppyoloe

__all__ = ["bert", "gpt", "llama", "ppyoloe"]
