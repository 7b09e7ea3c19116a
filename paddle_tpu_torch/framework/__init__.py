"""The ``paddle.framework`` namespace.

Counterpart: ``paddle_tpu/framework/__init__.py``: ``get_default_dtype``
and ``set_default_dtype`` (``core/dtype.py``, which the creation ops
read), ``in_dynamic_mode``, ``seed``, the places, ``Parameter`` and
``load`` / ``save`` (``io_api.py``). The port runs eagerly only, so
``in_dynamic_mode()`` is True.
"""
from ..core.dtype import get_default_dtype, set_default_dtype
from ..core.generator import seed
from ..core.place import (CPUPlace, CUDAPlace, TPUPlace, get_device,
                          set_device)
from ..core.tensor import Parameter
from .io_api import load, save

__all__ = ["CPUPlace", "CUDAPlace", "Parameter", "TPUPlace",
           "get_default_dtype", "get_device", "in_dynamic_mode", "load",
           "save", "seed", "set_default_dtype", "set_device"]


def in_dynamic_mode() -> bool:
    return True
