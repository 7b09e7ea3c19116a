"""Step-metrics flight recorder: an always-on bounded ring buffer of
structured records.

Counterpart: ``paddle_tpu/profiler/flightrec.py`` — the parts the
serving engine calls. Every record carries ``schema``, a monotonic
``seq``, a wall-clock stamp and a caller-chosen ``kind``. The engine
records "serving_step" (one per engine step), "serving_prefill" (one
per admission), "serving_device_window" (one per device decode window),
"serving_request" and "serving_span" (one each per terminal
transition). Recording is one dict append under a lock; the buffer
keeps the newest 1024 records; ``records()`` reads them back.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

SCHEMA = 1
_DEFAULT_CAPACITY = 1024

_lock = threading.Lock()
_buf: deque = deque(maxlen=_DEFAULT_CAPACITY)
_seq = 0
_total = 0


def record(kind: str, **fields) -> dict:
    """Append one structured record and return it."""
    global _seq, _total
    with _lock:
        _seq += 1
        _total += 1
        rec = {"schema": SCHEMA, "seq": _seq, "t_wall": time.time(),
               "kind": kind}
        rec.update(fields)
        _buf.append(rec)
    return rec


def records(last: Optional[int] = None, **match) -> list:
    """Snapshot of the buffer (oldest first); ``last`` keeps the newest
    n, keyword filters keep records whose field equals the value."""
    with _lock:
        out = list(_buf)
    if match:
        out = [r for r in out
               if all(r.get(k) == v for k, v in match.items())]
    if last is not None:
        out = out[-last:]
    return out
