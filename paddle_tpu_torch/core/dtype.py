"""Dtype names and predicates.

Counterpart: ``paddle_tpu/core/dtype.py``, the part AMP needs:
``convert_dtype``, ``dtype_name`` and ``is_floating_point`` (:103-135),
over torch dtypes. Paddle's names (``"bfloat16"``, ``"float16"``,
``"float32"``, ...) and torch dtypes are both accepted. The 64-bit width
policy of the reference (int64 → int32 on the TPU) is a TPU artifact and
is not ported.
"""
from __future__ import annotations

import torch

__all__ = ["bfloat16", "convert_dtype", "dtype_name", "float16", "float32",
           "float64", "is_floating_point"]

bfloat16, float16, float32, float64 = (torch.bfloat16, torch.float16,
                                       torch.float32, torch.float64)

_NAME_TO_DTYPE = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": float16, "bfloat16": bfloat16, "float32": float32,
    "float64": float64, "complex64": torch.complex64,
    "complex128": torch.complex128,
    # Paddle's aliases
    "float": float32, "double": float64, "half": float16, "int": torch.int32,
    "long": torch.int64, "bf16": bfloat16, "fp16": float16, "fp32": float32,
}
_DTYPE_TO_NAME = {d: n for n, d in reversed(list(_NAME_TO_DTYPE.items()))}


def convert_dtype(dtype):
    """A torch dtype from a torch dtype or one of Paddle's names; None stays
    None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise TypeError(f"unknown dtype {dtype!r}") from None
    raise TypeError(f"unknown dtype {dtype!r}")


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype: ``"bfloat16"``, ``"float32"``, ..."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point
