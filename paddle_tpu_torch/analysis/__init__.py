"""Counterpart: ``paddle_tpu/analysis/__init__.py`` (the tuning table's
lookup only, autotune.py)."""
