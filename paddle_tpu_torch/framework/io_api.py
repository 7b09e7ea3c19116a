"""paddle.save / paddle.load.

Counterpart: ``paddle_tpu/framework/io_api.py``: ``save`` (:55) and
``load`` (:80) of nested state (dicts, lists, tuples, scalars, tensors)
as a pickle whose tensors are ``_TensorPayload`` records (:19: the
array, the name, ``trainable``, ``is_param``), with the reference's
checks and messages: protocol an int in [2, 4], unknown config keys
rejected, ``return_numpy``. ``load`` gives ``core.tensor.Parameter``
facades for parameters and ``Tensor`` facades for the rest, on the
current place (``core/place.py``). The file lands through
``utils/resilience.atomic_write`` (without the reference's ``io.save``
fault point: ROADMAP A7).

The file format is the reference's, both ways, without importing
``paddle_tpu`` or ``ml_dtypes``:

- Reading, ``_Unpickler.find_class`` maps the reference's payload class
  (``paddle_tpu.framework.io_api._TensorPayload``) to this module's, and
  ``ml_dtypes.bfloat16`` to a marker: a bf16 array's dtype is rebuilt as
  uint16 with its raw bytes, and the marker turns it into a bfloat16
  tensor bit for bit (``return_numpy`` gives float32 for it: numpy has
  no bfloat16 without ml_dtypes). Only the globals those files name
  resolve: numpy's ``ndarray``, ``dtype``, ``_reconstruct`` and
  ``scalar``, a few plain data types, and a ``getattr`` that reaches
  ``object.__new__`` and the payload and dtype names alone. Any other
  global (``numpy.load``, ``os.system``, ``getattr`` of another object)
  refuses with UnpicklingError. The reference itself reads with plain
  ``pickle.load``.
- Writing, a payload pickles as the reference's class (``getattr`` of
  ``importlib.import_module("paddle_tpu.framework.io_api")``, made with
  ``object.__new__``), and a bfloat16 tensor as numpy pickles an
  ``ml_dtypes.bfloat16`` array (the same dtype reduction and state), so
  the reference reads the port's files, bf16 included, and the port reads
  them back in every dtype.
"""
from __future__ import annotations

import _compat_pickle
import builtins
import codecs
import collections
import importlib
import os
import pickle
import types

import numpy as np
import torch

try:
    from numpy._core import multiarray as np_multiarray
except ImportError:     # numpy < 2
    from numpy.core import multiarray as np_multiarray

from ..core.place import default_device
from ..core.tensor import Parameter, Tensor
from ..utils import resilience

__all__ = ["load", "numpy_to_torch", "save"]

_REF_MODULE = "paddle_tpu.framework.io_api"
# ml_dtypes' names of the dtypes numpy lacks, as numpy reduces them:
# (torch dtype, the unsigned carrier of the bits, numpy's dtype state)
_ML_DTYPES = {
    "bfloat16": (torch.bfloat16, "<u2", (3, "<", None, None, None, 2, 2, 64)),
}


class _TensorPayload:
    __slots__ = ("array", "name", "trainable", "is_param")

    def __init__(self, array, name, trainable, is_param):
        self.array = array
        self.name = name
        self.trainable = trainable
        self.is_param = is_param

    def __reduce__(self):
        return (object.__new__, (_Global(_REF_MODULE, "_TensorPayload"),),
                (None, {k: getattr(self, k) for k in self.__slots__}))


class _Global:
    """Pickles as ``getattr(importlib.import_module(module), name)``: a
    reference to a name of a package this one does not import."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __reduce__(self):
        return getattr, (_Module(self.module), self.name)


class _Module:
    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _MlArray:
    """A tensor of an ml_dtypes dtype, pickled as numpy pickles such an
    array: ``_reconstruct`` then the state (version, shape, dtype,
    Fortran order, raw bytes)."""

    def __init__(self, t: torch.Tensor, name):
        _, carrier, self.state = _ML_DTYPES[name]
        self.name = name
        self.shape = tuple(t.shape)
        self.raw = t.contiguous().view(torch.int16).numpy().tobytes()

    def __reduce__(self):
        dtype = _Reduced(np.dtype, (_Global("ml_dtypes", self.name), False,
                                    True), self.state)
        return (np_multiarray._reconstruct, (np.ndarray, (0,), b"b"),
                (1, self.shape, dtype, False, self.raw))


class _Reduced:
    def __init__(self, fn, args, state):
        self.fn, self.args, self.state = fn, args, state

    def __reduce__(self):
        return self.fn, self.args, self.state


def _host_array(t: torch.Tensor):
    t = t.detach().cpu()
    for name, (dt, _, _) in _ML_DTYPES.items():
        if t.dtype == dt:
            return _MlArray(t, name)
    return t.numpy()


def _to_payload(obj):
    if isinstance(obj, torch.Tensor):
        is_param = isinstance(obj, (torch.nn.Parameter, Parameter))
        trainable = (getattr(obj, "trainable", True) if is_param
                     else obj.requires_grad)
        name = getattr(obj, "name", None)
        return _TensorPayload(_host_array(obj),
                              name if isinstance(name, str) else None,
                              trainable, is_param)
    if isinstance(obj, dict):
        return {k: _to_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_payload(v) for v in obj)
    return obj


# -- reading ---------------------------------------------------------------

class _MlMarker:
    def __init__(self, name):
        self.name = name


class _Unpickler(pickle.Unpickler):
    """The reference's pickles (and the port's) without ``paddle_tpu`` or
    ``ml_dtypes``: see the module docstring. Only the globals those files
    name resolve; ``getattr`` only reaches ``object.__new__`` and the two
    names of the namespaces ``_import`` hands back."""

    _MULTIARRAY = ("numpy._core.multiarray", "numpy.core.multiarray")
    # Plain data a state dict may hold, and protocol 2's bytes.
    _DATA = {("builtins", k): getattr(builtins, k) for k in (
        "set", "frozenset", "complex", "slice", "range", "bytearray")}
    _DATA[("collections", "OrderedDict")] = collections.OrderedDict
    _DATA[("_codecs", "encode")] = codecs.encode

    def __init__(self, f):
        super().__init__(f)
        self._marked = {}       # id(carrier dtype) → (dtype, ml name)
        self._spaces = []       # the namespaces ``_import`` handed back
        unpickler = self

        class _Array(np.ndarray):
            def __setstate__(self, state):
                mark = unpickler._marked.get(id(state[2]))
                if mark is not None:
                    self.ml_dtype = mark[1]
                super().__setstate__(state)

        self._array_cls = _Array

    def _dtype(self, obj, align=False, copy=False):
        if isinstance(obj, _MlMarker):
            d = np.dtype(_ML_DTYPES[obj.name][1], align, True)
            self._marked[id(d)] = (d, obj.name)
            return d
        return np.dtype(obj, align, copy)

    def _import(self, name):
        if name == _REF_MODULE:
            space = types.SimpleNamespace(_TensorPayload=_TensorPayload)
        elif name == "ml_dtypes":
            space = types.SimpleNamespace(
                **{k: _MlMarker(k) for k in _ML_DTYPES})
        else:
            raise pickle.UnpicklingError(f"paddle.load: refusing to import "
                                         f"{name!r}")
        self._spaces.append(space)
        return space

    def _getattr(self, obj, name):
        if obj is object and name == "__new__":
            return object.__new__
        if any(obj is s for s in self._spaces) and name in vars(obj):
            return getattr(obj, name)
        raise pickle.UnpicklingError(
            f"paddle.load: refusing getattr({type(obj).__name__}, {name!r})")

    def find_class(self, module, name):
        # Protocol 2 files name Python 2's modules (``__builtin__``).
        module, name = _compat_pickle.NAME_MAPPING.get((module, name),
                                                       (module, name))
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        if (module, name) == (_REF_MODULE, "_TensorPayload"):
            return _TensorPayload
        if module == "ml_dtypes":
            if name in _ML_DTYPES:
                return _MlMarker(name)
            raise pickle.UnpicklingError(
                f"paddle.load: ml_dtypes.{name} is not supported")
        if (module, name) == ("importlib", "import_module"):
            return self._import
        if (module, name) == ("builtins", "getattr"):
            return self._getattr
        if (module, name) == ("builtins", "object"):
            return object
        if (module, name) == ("numpy", "dtype"):
            return self._dtype
        if (module, name) == ("numpy", "ndarray"):
            return self._array_cls
        if module in self._MULTIARRAY and name in ("_reconstruct", "scalar"):
            return getattr(np_multiarray, name)
        if (module, name) in self._DATA:
            return self._DATA[(module, name)]
        raise pickle.UnpicklingError(
            f"paddle.load: refusing the class {module}.{name}")


def numpy_to_torch(a) -> torch.Tensor:
    """A loaded array as a CPU tensor, bit for bit: the marked ml_dtypes
    arrays (and ``ml_dtypes`` arrays themselves, where that package is
    installed) by their bits."""
    name = getattr(a, "ml_dtype", None) or (
        a.dtype.name if a.dtype.name in _ML_DTYPES else None)
    if name is not None:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(_ML_DTYPES[name][0])
    return torch.from_numpy(np.array(a, copy=True))


def _from_payload(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = numpy_to_torch(obj.array)
        if return_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        t = t.to(default_device())
        if obj.is_param:
            return Parameter(t, name=obj.name, trainable=obj.trainable)
        return Tensor(t, stop_gradient=not obj.trainable, name=obj.name)
    if isinstance(obj, dict):
        return type(obj)((k, _from_payload(v, return_numpy))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_payload(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Parity: paddle.save (io.py:773): any config key rejects loudly;
    the file lands through the atomic writer."""
    if configs:
        raise ValueError(
            f"paddle.save: unsupported config key(s) {sorted(configs)} — "
            "no save-side configs are implemented (the reference's "
            "use_binary_format targets static-graph programs); rejecting "
            "loudly instead of silently ignoring them")
    if not isinstance(protocol, int) or not (2 <= protocol <= 4):
        raise ValueError(
            f"paddle.save: protocol must be an int in [2, 4], got "
            f"{protocol!r}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_payload(obj)
    resilience.atomic_write(
        path, lambda f: pickle.dump(payload, f, protocol=protocol))


def load(path, **configs):
    """Parity: paddle.load (io.py:1020). Only ``return_numpy`` is
    implemented; any other config key rejects loudly (no-silent-knob)."""
    unknown = set(configs) - {"return_numpy"}
    if unknown:
        raise ValueError(
            f"paddle.load: unsupported config key(s) {sorted(unknown)} — "
            "only return_numpy is implemented; rejecting loudly instead "
            "of silently ignoring them")
    return_numpy = configs.get("return_numpy", False)
    with open(path, "rb") as f:
        data = _Unpickler(f).load()
    return _from_payload(data, return_numpy)
