"""Names of the reference's ``nn`` that wait for a later ROADMAP item.

Each stands where the reference's name stands, so ``hasattr`` holds and
a call (a layer's construction) raises NotImplementedError naming the
item; the reference's registered ops among them are registered alike
(``register_op`` with the reference's category) with a body that raises.
"""
from __future__ import annotations

from ..core.dispatch import register_op

__all__ = ["functional", "layer"]


def _error(where, item):
    return NotImplementedError(f"{where} is not ported yet (ROADMAP {item})")


def functional(name, item, module, op=None, amp="promote"):
    """A functional ``name`` of ``module`` that raises; registered as op
    ``op`` with AMP category ``amp`` when the reference registers it."""
    def fn(*args, **kwargs):
        raise _error(f"nn.functional.{name}", item)

    fn.__name__ = fn.__qualname__ = name
    fn.__module__ = module
    return fn if op is None else register_op(op, amp=amp)(fn)


def layer(name, item):
    """A layer class ``name`` whose construction raises."""
    from .layer.layers import Layer

    def __init__(self, *args, **kwargs):
        raise _error(f"nn.{name}", item)

    return type(name, (Layer,), {"__init__": __init__,
                                 "__doc__": f"ROADMAP {item}."})
