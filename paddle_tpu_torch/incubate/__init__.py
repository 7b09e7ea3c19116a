"""Counterpart: ``paddle_tpu/incubate/__init__.py`` (the rotary embedding
of ``incubate.nn.functional`` so far)."""
