"""StringTensor and its kernels.

Counterpart: ``paddle_tpu/core/strings.py``: ``StringTensor``, a host
container over a numpy object array of ``str`` (Paddle's
``phi::StringTensor``; strings never reach the card in either package),
and ``strings_empty``, ``strings_copy``, ``strings_lower`` and
``strings_upper`` (the unicode-aware path, or ASCII only with
``use_utf8_encoding=False``).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

__all__ = ["StringTensor", "strings_copy", "strings_empty",
           "strings_lower", "strings_upper"]


class StringTensor:
    """Host tensor of UTF-8 strings."""

    def __init__(self, data: Union[Sequence, np.ndarray, "StringTensor"],
                 name: str = ""):
        if isinstance(data, StringTensor):
            arr = data._arr.copy()
        else:
            arr = np.asarray(data, dtype=object)
            bad = [x for x in arr.ravel() if not isinstance(x, str)]
            if bad:
                raise TypeError(
                    f"StringTensor holds str only; got {type(bad[0]).__name__}")
        self._arr = arr
        self.name = name

    @property
    def shape(self) -> List[int]:
        return list(self._arr.shape)

    @property
    def dtype(self) -> str:
        return "pstring"

    def numel(self) -> int:
        return int(self._arr.size)

    def numpy(self) -> np.ndarray:
        return self._arr.copy()

    def tolist(self):
        return self._arr.tolist()

    def __getitem__(self, idx):
        out = self._arr[idx]
        if isinstance(out, str):
            return out
        return StringTensor(out)

    def __len__(self):
        return len(self._arr)

    def __eq__(self, other):
        if isinstance(other, StringTensor):
            return bool((self._arr == other._arr).all())
        return NotImplemented

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, data={self._arr.tolist()!r})"


def strings_empty(shape: Sequence[int]) -> StringTensor:
    """A StringTensor of empty strings."""
    return StringTensor(np.full(tuple(shape), "", dtype=object))


def strings_copy(src: StringTensor) -> StringTensor:
    return StringTensor(src)


def _case_map(x: StringTensor, fn, use_utf8_encoding: bool) -> StringTensor:
    if use_utf8_encoding:
        mapped = np.frompyfunc(fn, 1, 1)(x._arr)
    else:
        def ascii_only(s: str) -> str:
            return "".join(fn(c) if ord(c) < 128 else c for c in s)

        mapped = np.frompyfunc(ascii_only, 1, 1)(x._arr)
    return StringTensor(mapped)


def strings_lower(x: StringTensor, use_utf8_encoding: bool = True) -> StringTensor:
    return _case_map(x, str.lower, use_utf8_encoding)


def strings_upper(x: StringTensor, use_utf8_encoding: bool = True) -> StringTensor:
    return _case_map(x, str.upper, use_utf8_encoding)
