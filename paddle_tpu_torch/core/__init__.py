"""Counterpart: ``paddle_tpu/core/__init__.py``: the flags, the op
registry (``dispatch``), dtypes, places, the Tensor facade, the
framework generator, the error taxonomy and strings (``core/engine.py``,
the reference's tape, stands for torch autograd: ROADMAP A5b-1b ports
its grad-mode API)."""
from . import dtype, errors, flags, generator, place, strings  # noqa: F401
from .dispatch import OP_REGISTRY, OpDef, apply, register_op
from .flags import get_flag, set_flags
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, Place,
                    TPUPlace, XPUPlace, device_count, get_device, set_device)
from .tensor import Parameter, Tensor, is_tensor, to_plain, wrap

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace",
           "OP_REGISTRY", "OpDef", "Parameter", "Place", "TPUPlace",
           "Tensor", "XPUPlace", "apply", "device_count", "get_device",
           "get_flag", "is_tensor", "register_op", "set_device",
           "set_flags", "to_plain", "wrap"]
