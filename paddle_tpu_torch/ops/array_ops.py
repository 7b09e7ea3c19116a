"""TensorArray ops: ``create_array``, ``array_write``, ``array_read``,
``array_length``.

Counterpart: ``paddle_tpu/ops/array_ops.py``. A TensorArray is a Python
list of tensors (the reference's dygraph behaviour); an index may be an
int or a 0-d integer tensor.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.place import default_device
from ..core.tensor import to_plain, wrap

__all__ = ["create_array", "array_write", "array_read", "array_length"]


def create_array(dtype: str = "float32", initialized_list=None):
    """A new TensorArray, optionally seeded from a list of tensors."""
    arr: List = []
    if initialized_list is not None:
        if not isinstance(initialized_list, (list, tuple)):
            raise TypeError(
                f"initialized_list must be list/tuple of Tensors, got "
                f"{type(initialized_list).__name__}")
        arr.extend(initialized_list)
    for item in arr:
        if not isinstance(item, torch.Tensor):
            raise TypeError(
                f"create_array: every element must be a Tensor, got "
                f"{type(item).__name__}")
    return arr


def _index_of(i) -> int:
    i = to_plain(i)
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


def array_write(x, i, array: Optional[list] = None):
    """Write x at position i (extending the array by one at most); returns
    the array."""
    idx = _index_of(i)
    if array is None:
        array = []
    if idx < 0 or idx > len(array):
        raise IndexError(
            f"array_write index {idx} out of range for TensorArray of "
            f"length {len(array)}")
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array: list, i):
    idx = _index_of(i)
    if idx < 0 or idx >= len(array):
        raise IndexError(
            f"array_read index {idx} out of range for TensorArray of "
            f"length {len(array)}")
    return array[idx]


def array_length(array: list):
    """The length as a 0-d int64 tensor on the current place."""
    return wrap(torch.tensor(len(array), dtype=torch.int64,
                             device=default_device()))
