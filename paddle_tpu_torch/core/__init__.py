"""Counterpart: ``paddle_tpu/core/__init__.py``: the flags, the op
registry (``dispatch``), dtypes, places, the Tensor facade, the
framework generator, the error taxonomy, strings and ``engine``'s
grad-mode API (torch autograd is the reference's tape)."""
from . import (dtype, engine, errors, flags, generator, place,  # noqa: F401
               strings)
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
