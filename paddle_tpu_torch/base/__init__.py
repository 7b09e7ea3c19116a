"""Counterpart: ``paddle_tpu/base/__init__.py`` (``ParamAttr`` and the
places; the ``core`` shim of the pybind module is not ported)."""
from ..core.place import CPUPlace, CUDAPlace, TPUPlace
from .param_attr import ParamAttr

__all__ = ["CPUPlace", "CUDAPlace", "ParamAttr", "TPUPlace"]
