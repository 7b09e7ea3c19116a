"""Counterpart: ``paddle_tpu/incubate/nn/__init__.py`` (functionals only
so far)."""
