"""Unique names.

Counterpart: ``paddle_tpu/utils/unique_name.py``, ``generate`` (:14):
``key_0``, ``key_1``, ... from a per-thread counter a key.
"""
import threading

__all__ = ["generate"]

_local = threading.local()


def generate(key):
    counters = _local.__dict__.setdefault("counters", {})
    counters[key] = counters.get(key, -1) + 1
    return f"{key}_{counters[key]}"
