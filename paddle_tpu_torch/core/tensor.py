"""The Tensor facade: a ``torch.Tensor`` with Paddle's attributes.

Counterpart: ``paddle_tpu/core/tensor.py``: ``Tensor`` (``shape`` as a
list, ``size`` the element count, ``place``, ``stop_gradient``,
``grad``, ``clear_grad``, ``register_hook``, ``detach``, ``numpy``,
``item``, ``clone``, ``cpu``, ``to``, ``astype``) and ``Parameter``
(:404). The operators and the ops' methods (``x.sum(axis=...)``,
``x.transpose(perm)``, ``x + y``, ``x[idx] = v``, the in-place ``add_``
...) are set on the class by ``paddle_tpu_torch.ops``, as the reference's
``ops/__init__.py`` patches its Tensor.

The facade is what the user's entry points hand out (``to_tensor``, the
creation and random ops). ``Tensor(value)`` and ``Parameter(value)`` of
host data (a numpy array, a list) put it on the current place
(``core/place.py``, the card unless ``set_device`` says otherwise), as
the reference's ``Tensor`` falls back to its default place; a torch
tensor keeps its device unless ``place`` is given.
``__torch_function__`` is disabled, so a torch call on a facade costs
what it costs on a plain tensor and returns a plain tensor. The op
registry (``core/dispatch.py`` ``apply``) unwraps facade arguments to
plain tensors (``as_subclass``, no copy, still on the autograd graph)
before an op's body runs, and makes the outputs facades only when an
argument was one (the output objects the op made change class, so no
alias node joins the graph); inside the package every tensor is a plain
``torch.Tensor``, because Paddle's method names clash with torch's
(``transpose(perm)``, ``split``, ``flatten``, ``sum(axis=)``, ``max``,
``gather`` ...). The models' entry points unwrap what they are given
(``unwrap_args``).

``stop_gradient`` is the inverse of ``requires_grad``. An integer tensor
cannot require a gradient in torch; its ``stop_gradient`` flag is kept
for the reader and no gradient flows, as in the reference.

The reference's machinery for immutable arrays (retired gradient buffers,
``_set_value``, rebinding grad nodes) is not ported: in-place ops are
torch's own in-place ops.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from . import dtype as dtypes
from .place import Place, default_device, place_of

__all__ = ["Parameter", "Tensor", "is_tensor", "plain_args", "to_plain",
           "unwrap_args", "wrap"]

_BASE_SHAPE = torch.Tensor.shape
_BASE_GRAD = torch.Tensor.grad
_names = itertools.count(1)


class Tensor(torch.Tensor):
    """Paddle's Tensor over a torch tensor (see the module docstring)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, value=None, stop_gradient: bool = True, name=None,
                persistable: bool = False, place=None):
        dev = None if place is None else (
            place if isinstance(place, Place) else
            place_of(torch.device(place))).torch_device()
        if isinstance(value, torch.Tensor):
            data = to_plain(value)
            if dev is not None:
                data = data.to(dev)
        else:       # host data: on the current place unless one is given
            data = torch.as_tensor(
                np.asarray(value) if value is not None else [],
                device=default_device() if dev is None else dev)
        grad = not stop_gradient and _grad_dtype(data.dtype)
        t = torch.Tensor._make_subclass(cls, data.detach(), grad)
        if name is not None:
            t.name = name
        if persistable:
            t.persistable = True
        if not stop_gradient and not grad:
            t.__dict__["_stop_gradient"] = False
        return t

    def __init__(self, *args, **kwargs):
        pass

    # -- meta ------------------------------------------------------------
    @property
    def shape(self):
        return list(_BASE_SHAPE.__get__(self))

    @property
    def size(self):
        return torch.Tensor.numel(self)

    @property
    def place(self) -> Place:
        return place_of(self.device)

    @property
    def name(self):
        n = self.__dict__.get("_paddle_name")
        if n is None:
            n = self.__dict__["_paddle_name"] = \
                f"generated_tensor_{next(_names)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value

    @property
    def persistable(self):
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    @property
    def stop_gradient(self) -> bool:
        if not _grad_dtype(self.dtype):
            return self.__dict__.get("_stop_gradient", True)
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        if not _grad_dtype(self.dtype):
            self.__dict__["_stop_gradient"] = value
        elif self.is_leaf or not value:
            self.requires_grad_(not value)
        else:
            self.detach_()       # an intermediate: cut it from the graph

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self):
        g = _BASE_GRAD.__get__(self)
        return None if g is None else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, value):
        _BASE_GRAD.__set__(self, None if value is None else to_plain(value))

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        if grad_tensor is None and torch.Tensor.numel(self) != 1:
            raise RuntimeError(
                "grad must be provided for non-scalar Tensor.backward()")
        torch.autograd.backward(
            self.as_subclass(torch.Tensor),
            None if grad_tensor is None else to_plain(grad_tensor),
            retain_graph=retain_graph)

    def clear_grad(self, set_to_zero: bool = False):
        g = _BASE_GRAD.__get__(self)
        if set_to_zero and g is not None:
            g.zero_()
        else:
            _BASE_GRAD.__set__(self, None)

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """A hook on this tensor's gradient: it sees the gradient as a
        facade and may return a replacement. Returns a handle with
        ``remove()``."""
        def plain_hook(g):
            out = hook(g.as_subclass(Tensor))
            return None if out is None else to_plain(out)

        return torch.Tensor.register_hook(self, plain_hook)

    def detach(self) -> "Tensor":
        return wrap(torch.Tensor.detach(self))

    # -- conversion --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """The values on the host; bfloat16 (which numpy lacks) comes out
        as float32."""
        t = self.as_subclass(torch.Tensor).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def cpu(self) -> "Tensor":
        return _moved(self, self.as_subclass(torch.Tensor).cpu())

    def cuda(self, device=None, *args, **kwargs) -> "Tensor":
        return _moved(self, self.as_subclass(torch.Tensor).cuda(device))

    pin_memory = cpu

    def to(self, *args, **kwargs) -> "Tensor":
        """``to(device)``, ``to(dtype)`` or both (strings, places, torch
        devices and dtypes); the dtype change is the registered ``cast``."""
        from .. import ops
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in dtypes._NAME_TO_DTYPE):
                dtype = a
            elif a is not None:
                device = a
        out = self
        if dtype is not None:
            out = ops.cast(out, dtype)
        if device is not None:
            if isinstance(device, str):
                from .place import _parse
                device = _parse(device)
            dev = device.torch_device() if isinstance(device, Place) else \
                torch.device(device)
            out = _moved(out, out.as_subclass(torch.Tensor).to(dev))
        return out

    def value(self):
        return self

    def get_tensor(self):
        return self

    def __deepcopy__(self, memo):
        t = Tensor(self.as_subclass(torch.Tensor).detach().clone(),
                   stop_gradient=self.stop_gradient)
        t.__dict__.update(self.__dict__)
        memo[id(self)] = t
        return t

    def __reduce_ex__(self, protocol):
        return (_rebuild, (self.as_subclass(torch.Tensor).detach(),
                           self.stop_gradient))

    def __repr__(self):
        body = repr(self.as_subclass(torch.Tensor).detach())
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")

    __str__ = __repr__
    __hash__ = torch.Tensor.__hash__


def _moved(src, t):
    """The facade of ``t``, a device move of ``src`` (the same tensor when
    no move was needed, which is then aliased, not re-classed)."""
    return t.as_subclass(Tensor) if t.data_ptr() == src.data_ptr() and \
        t.device == src.device else wrap(t)


def _rebuild(data, stop_gradient):
    return Tensor(data, stop_gradient=stop_gradient)


def _grad_dtype(dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def wrap(t):
    """A plain tensor made for the caller, as a facade: the object itself
    becomes one (no copy, no alias); other values unchanged."""
    if type(t) is torch.Tensor:
        t.__class__ = Tensor
    return t


def to_plain(t):
    """A facade as a plain tensor (no copy); other values unchanged."""
    return t.as_subclass(torch.Tensor) if type(t) is Tensor else t


def plain_args(seq):
    """``seq`` as a list with every facade, at the top level or inside a
    list or tuple, a plain tensor (``as_subclass``: no copy, on the
    autograd graph); None when it holds none. One ``type()`` check per
    argument (per element of a list or tuple)."""
    out = None
    for i, a in enumerate(seq):
        t = type(a)
        if t is Tensor:
            a = a.as_subclass(torch.Tensor)
        elif (t is list or t is tuple) and any(type(b) is Tensor for b in a):
            a = t(to_plain(b) for b in a)
        else:
            continue
        if out is None:
            out = list(seq)
        out[i] = a
    return out


def unwrap_args(fn):
    """Decorator for the models' entry points: facade arguments (and
    facades inside list or tuple arguments) reach ``fn`` as plain
    tensors, so no module or kernel wrapper of the port sees one."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        plain = plain_args(args)
        if kwargs:
            vals = plain_args(kwargs.values())
            if vals is not None:
                kwargs = dict(zip(kwargs, vals))
        return fn(*(args if plain is None else plain), **kwargs)

    return entry


class Parameter(Tensor):
    """A trainable facade tensor (``stop_gradient`` False, persistable)
    for users of the facade; the port's layers hold
    ``nn.layer.layers.Parameter`` (an ``nn.Parameter``) instead."""

    @staticmethod
    def __new__(cls, value=None, name=None, trainable=True):
        t = Tensor.__new__(cls, value, stop_gradient=not trainable,
                           name=name, persistable=True)
        t.__dict__["trainable"] = trainable
        t.optimize_attr = {"learning_rate": 1.0}
        t.regularizer = None
        t.need_clip = True
        return t

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

