"""paddle.device.

Counterpart: ``paddle_tpu/device/__init__.py`` (:1-128): ``device_count``,
``get_device``, ``set_device`` (``core/place.py``), the device types,
``synchronize``, ``Stream``, ``Event``, ``current_stream``,
``set_stream``, ``stream_guard`` and the ``cuda`` namespace with the
memory statistics, over ``torch.cuda``.

Streams and events are real CUDA streams and events here, where the
reference's are no-ops (XLA on a TPU has no user-visible stream): work
queued under ``stream_guard(s)`` runs on ``s``, and the caller orders it
against other streams with ``Event`` / ``wait_event`` /
``wait_stream``, as on Paddle's GPU build. Every kernel of the port
launches on torch's current stream (``kernels/_build.call``) and takes
its workspaces from ``torch.empty`` on that stream, whose caching
allocator keeps a block to the stream that freed it; the kernels'
cached plans (``functools.lru_cache`` in ``kernels/norm_fusion.py``)
are host values. So a forward under ``stream_guard`` on a second stream
shares no device scratch with the default stream. Without a card,
``Stream`` and ``Event`` raise (there is no stream to stand for), the
memory statistics read 0 (as the reference's do on a backend without
them) and ``synchronize`` returns.

Paddle's ``cuda.reset_max_memory_allocated`` and
``reset_max_memory_reserved``, which the reference lacks, reset torch's
peak (both reset the same counter set).
"""
from __future__ import annotations

import contextlib

import torch

from ..core.place import (Place, _parse, device_count,  # noqa: F401
                          get_device, is_compiled_with_cuda,
                          is_compiled_with_tpu, set_device)

__all__ = ["Event", "Stream", "cuda", "current_stream", "device_count",
           "get_all_custom_device_type", "get_all_device_type",
           "get_available_custom_device", "get_available_device",
           "get_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "set_device", "set_stream", "stream_guard", "synchronize"]


def _cuda_device(device=None):
    """A CUDA torch device from Paddle's forms; None: the current card."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, torch.device):
        return device
    return (device if isinstance(device, Place)
            else _parse(device)).torch_device()


def _need_card(what):
    if not torch.cuda.is_available():
        raise RuntimeError(f"paddle.device.{what} needs a CUDA card: the "
                           "port's streams and events are CUDA's")


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    if torch.cuda.is_available():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Block until the card has finished all queued work."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(_cuda_device(device))


class Stream:
    """A CUDA stream (Paddle's priority 1 is high, 2 normal)."""

    def __init__(self, device=None, priority=2, stream=None):
        _need_card("Stream")
        self.stream = stream if stream is not None else torch.cuda.Stream(
            _cuda_device(device), priority=-1 if priority == 1 else 0)
        self.device = self.stream.device

    @property
    def cuda_stream(self):
        return self.stream.cuda_stream

    def synchronize(self):
        self.stream.synchronize()

    def wait_event(self, event):
        self.stream.wait_event(event.event)

    def wait_stream(self, stream):
        self.stream.wait_stream(stream.stream)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event

    def query(self):
        return self.stream.query()

    def __eq__(self, other):
        return isinstance(other, Stream) and self.stream == other.stream

    def __hash__(self):
        return hash(self.stream)


class Event:
    """A CUDA event."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        _need_card("Event")
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking,
                                      interprocess=interprocess)

    def record(self, stream=None):
        self.event.record(None if stream is None else stream.stream)

    def query(self):
        return self.event.query()

    def synchronize(self):
        self.event.synchronize()

    def elapsed_time(self, end_event):
        return self.event.elapsed_time(end_event.event)


def current_stream(device=None):
    return Stream(stream=torch.cuda.current_stream(_cuda_device(device)))


def set_stream(stream):
    """Make ``stream`` current on its card; returns the stream it
    replaces."""
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream.stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    """Queue the block's work on ``stream`` (None: the current one)."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(stream.stream):
        yield


def _stat(fn, device):
    if not torch.cuda.is_available():
        return 0
    return fn(_cuda_device(device))


class cuda:
    """paddle.device.cuda."""

    Stream = Stream
    Event = Event

    @staticmethod
    def device_count():
        return device_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def current_stream(device=None):
        return current_stream(device)

    @staticmethod
    def stream_guard(stream):
        return stream_guard(stream)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def memory_allocated(device=None):
        return _stat(torch.cuda.memory_allocated, device)

    @staticmethod
    def max_memory_allocated(device=None):
        return _stat(torch.cuda.max_memory_allocated, device)

    @staticmethod
    def memory_reserved(device=None):
        return _stat(torch.cuda.memory_reserved, device)

    @staticmethod
    def max_memory_reserved(device=None):
        return _stat(torch.cuda.max_memory_reserved, device)

    @staticmethod
    def reset_max_memory_allocated(device=None):
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats(_cuda_device(device))

    reset_max_memory_reserved = reset_max_memory_allocated
