"""Unique names.

Counterpart: ``paddle_tpu/utils/unique_name.py``, ``generate`` (:14):
``key_0``, ``key_1``, ... from a per-thread counter a key; ``guard``
(:20) runs a block on fresh counters and restores the old ones after.
"""
import contextlib
import threading

__all__ = ["generate", "guard"]

_local = threading.local()


def _counters():
    return _local.__dict__.setdefault("counters", {})


def generate(key):
    counters = _counters()
    counters[key] = counters.get(key, -1) + 1
    return f"{key}_{counters[key]}"


@contextlib.contextmanager
def guard(new_generator=None):
    old = _counters()
    _local.counters = {}
    try:
        yield
    finally:
        _local.counters = old
