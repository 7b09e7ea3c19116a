"""Counterpart: ``paddle_tpu/profiler/__init__.py`` — the flight
recorder and the latency histogram the serving engine uses."""
from . import flightrec
from .histogram import LogHistogram

__all__ = ["LogHistogram", "flightrec"]
