"""Counterpart: ``paddle_tpu/profiler/__init__.py`` — the flight
recorder and the latency histogram the serving engine uses, and the
health vector of ``numerics`` that ``amp.debugging`` reads."""
from . import flightrec, numerics
from .histogram import LogHistogram

__all__ = ["LogHistogram", "flightrec", "numerics"]
