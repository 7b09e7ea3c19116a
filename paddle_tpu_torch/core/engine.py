"""Grad mode.

Counterpart: ``paddle_tpu/core/engine.py``, the grad-mode API (:38-64):
``is_grad_enabled``, ``set_grad_enabled``, ``no_grad_guard`` and
``enable_grad_guard``. There is one state, torch's own grad mode, which
is thread-local as the reference's ``_EngineState`` is; a tensor made
with the mode off records no graph, in either package.

The rest of the reference's engine is its tape: ``GradNode`` and ``Edge``
(grad_node_info.h), ``run_backward`` with its in-degree queue,
``backward_stats`` and the to_static trace hooks. None of it is ported:
torch autograd is the tape (``core/dispatch.py``, docstring), and the
trace hooks belong to ``jit/`` (ROADMAP A9).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["enable_grad_guard", "is_grad_enabled", "no_grad_guard",
           "set_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))     # a call sets the mode at once


@contextlib.contextmanager
def no_grad_guard():
    prev = torch.is_grad_enabled()
    set_grad_enabled(False)
    try:
        yield
    finally:
        set_grad_enabled(prev)


@contextlib.contextmanager
def enable_grad_guard():
    prev = torch.is_grad_enabled()
    set_grad_enabled(True)
    try:
        yield
    finally:
        set_grad_enabled(prev)
