"""Crash-safe file writes.

Counterpart: ``paddle_tpu/utils/resilience.py``, ``atomic_write``
(:452): tmp file → fsync → atomic rename, so a crash mid-write leaves the
previous file or none at the path, never a partial one. The reference's
``fault_point`` argument (the ``io.save`` site of its fault-injection
harness, :271 ``faultpoint``) is not ported: the harness, the recovery
loops and the rest of the module are ROADMAP A7.
"""
from __future__ import annotations

import os
from typing import Callable

__all__ = ["atomic_write"]


def atomic_write(path, writer: Callable):
    """``writer(fileobj)`` writes the payload into an open binary file;
    ``path`` appears only once the payload is durable. The tmp file
    (``<path>.tmp.<pid>``) is unlinked on failure."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # durability of the directory entry itself (best effort: not every
    # filesystem allows fsync on a directory fd)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
