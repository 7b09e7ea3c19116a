"""Dtype names, predicates and the default dtype.

Counterpart: ``paddle_tpu/core/dtype.py``: ``convert_dtype``,
``dtype_name``, the predicates (:103-135), ``size_of_dtype`` and
``get_default_dtype`` / ``set_default_dtype`` (:146-167), over torch
dtypes. Paddle's names (``"bfloat16"``, ``"float32"``, ...), numpy dtypes,
Python's ``bool`` / ``int`` / ``float`` / ``complex`` and torch dtypes are
all accepted.

The reference's 64-bit width policy (int64 → int32 and float64 → float32
with ``jax_enable_x64`` off) is a TPU artifact and is not ported: a 64-bit
dtype that the caller or the op asks for stays 64-bit here, and the
index-producing ops return int64.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bfloat16", "bool_", "complex64", "complex128", "convert_dtype",
           "dtype_name", "float16", "float32", "float64",
           "get_default_dtype", "int8", "int16", "int32", "int64",
           "is_complex", "is_floating_point", "is_integer",
           "set_default_dtype", "size_of_dtype", "uint8"]

bool_, uint8, int8, int16, int32, int64 = (torch.bool, torch.uint8,
                                           torch.int8, torch.int16,
                                           torch.int32, torch.int64)
bfloat16, float16, float32, float64 = (torch.bfloat16, torch.float16,
                                       torch.float32, torch.float64)
complex64, complex128 = torch.complex64, torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    # Paddle's aliases
    "float": float32, "double": float64, "half": float16, "int": int32,
    "long": int64, "bf16": bfloat16, "fp16": float16, "fp32": float32,
    "fp64": float64,
}
_DTYPE_TO_NAME = {d: n for n, d in reversed(list(_NAME_TO_DTYPE.items()))}
_PY_TYPES = {bool: bool_, int: int64, float: float64, complex: complex128}


def convert_dtype(dtype):
    """A torch dtype from a torch dtype, one of Paddle's names, a numpy
    dtype or a Python type; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise TypeError(f"unknown dtype {dtype!r}") from None
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise TypeError(f"unknown dtype {dtype!r}") from None
    try:
        return _NAME_TO_DTYPE[name]
    except KeyError:
        raise TypeError(f"unknown dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype: ``"bfloat16"``, ``"float32"``, ..."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


def size_of_dtype(dtype) -> int:
    return convert_dtype(dtype).itemsize


_DEFAULT_DTYPE = [float32]


def get_default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports float16/bfloat16/float32/"
            f"float64, got {dtype_name(d)}")
    _DEFAULT_DTYPE[0] = d
