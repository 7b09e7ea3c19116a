"""The ``paddle.framework`` namespace.

Counterpart: ``paddle_tpu/framework/__init__.py``: ``get_default_dtype``
and ``set_default_dtype`` (``core/dtype.py``, which the creation ops
read), ``in_dynamic_mode``, ``seed``, the places and ``Parameter``.
The port runs eagerly only, so ``in_dynamic_mode()`` is True; ``load``
and ``save`` (``framework/io_api.py``) come with ROADMAP A5b-1b.
"""
from ..core.dtype import get_default_dtype, set_default_dtype
from ..core.generator import seed
from ..core.place import (CPUPlace, CUDAPlace, TPUPlace, get_device,
                          set_device)
from ..core.tensor import Parameter

__all__ = ["CPUPlace", "CUDAPlace", "Parameter", "TPUPlace",
           "get_default_dtype", "get_device", "in_dynamic_mode", "seed",
           "set_default_dtype", "set_device"]


def in_dynamic_mode() -> bool:
    return True
