"""Counterpart: ``paddle_tpu/nn/__init__.py`` (functionals only so far)."""
