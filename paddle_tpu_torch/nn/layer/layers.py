"""The Layer base class, its containers, and seeded initialisation and
weight loading for models built of layers.

Counterpart: ``paddle_tpu/nn/layer/layers.py`` (:24-534):
``HookRemoveHelper`` (torch's ``RemovableHandle``), ``Layer``,
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``.

``Layer`` subclasses ``torch.nn.Module``: parameters, buffers and
sublayers live in torch's registries (``_parameters``, ``_buffers``,
``_modules``; ``_sub_layers`` and ``_non_persistable_buffer_names`` name
the last two as the reference does), and calls go through torch's
``__call__`` with its forward hooks, which are Paddle's
(``register_forward_pre_hook(hook(layer, inputs))``,
``register_forward_post_hook(hook(layer, inputs, outputs))``). Paddle's
members over them: ``state_dict`` (parameters, then persistable buffers,
under the structured names, as facades sharing the tensors' storage:
``core.tensor.Parameter`` for a parameter, ``Tensor`` for a buffer),
``set_state_dict`` (aliases ``set_dict``, ``load_dict``: copies in place,
cast to each tensor's dtype and device, raises the reference's ValueError
on a shape mismatch before copying anything, returns ``(missing,
unexpected)``), ``register_buffer(..., persistable=)``, ``create_tensor``,
``add_parameter``, ``add_sublayer``, ``named_sublayers``, ``sublayers``,
``parameters`` and ``buffers`` (lists), ``clear_gradients``, ``to(device,
dtype, blocking)``, ``astype``, ``float``, ``half``, ``bfloat16`` and
``full_name`` (``unique_name`` of the class's name in lower case, drawn at
construction as the reference's is).

torch calls some of these names itself: ``Module.state_dict`` recurses
into the children with ``destination=``, ``prefix=`` and
``keep_vars=``; ``load_state_dict``, ``copy.deepcopy``,
``torch.func.functional_call`` and ``_apply`` call ``named_parameters(...,
remove_duplicate=)``, ``named_buffers``, ``register_buffer(...,
persistent=)`` and ``to(device, dtype, non_blocking)``. Each override takes
both forms: a call in torch's form (``prefix`` / ``keep_vars``,
``recurse``, ``persistent``, ``non_blocking``, a tensor argument of
``to``) is torch's own method. ``to``'s third positional argument is
Paddle's ``blocking``. torch's ``load_state_dict`` takes Paddle's
``state_dict()`` too (its facades' ``shape`` is a list, so they reach
torch as plain tensors). ``train()`` and ``eval()`` are torch's, the
same as Paddle's. ``Layer`` has no ``__len__`` (the reference counts the
sublayers), so a childless layer stays true in a condition; the
containers have one. ``create_parameter`` (:103-134) resolves a
``ParamAttr`` (its initializer, name, trainable flag and learning rate)
and draws the parameter through ``nn/initializer``'s classes on the
layer's device (``device=``; None: the current place).

The rest is the port's own: ``load_numpy`` copies the reference's state
dict (name → numpy array, the reference's names and layouts) into a
module and raises where a name or a shape differs; ``reset_conv_bn``
draws the reference's initialisers for models of convolutions, Linear
layers and BatchNorms (the ResNet family, PP-YOLOE); ``name_parameters``
gives every parameter the reference's unique name
(``Layer.create_parameter``, :127): ``<full name>.w_<i>``
(``linear_0.w_0`` the first Linear's weight, ``.w_1`` its bias), the name
an optimizer's ``apply_decay_param_fun`` is called with and its state
dict keys on.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ...core import dtype as dtypes
from ...core.tensor import Parameter as _FacadeParameter, Tensor, to_plain
from ...utils import unique_name

__all__ = ["HookRemoveHelper", "Layer", "LayerDict", "LayerList", "Parameter",
           "ParameterList", "Sequential", "load_numpy", "make_parameter",
           "name_parameters", "reset_conv_bn"]


class Parameter(nn.Parameter):
    """``nn.Parameter`` with Paddle's writable ``name`` (torch's tensors
    hold a read-only one), ``stop_gradient`` (the inverse of
    ``requires_grad``) and ``trainable`` (the reference's ``Parameter``,
    ``core/tensor.py:404``: an optimizer skips a parameter that is not
    trainable). ``name_parameters`` and ``ensure_name`` turn parameters
    into this class in place: the objects stay, so optimizers and tied
    weights are untouched."""

    def __deepcopy__(self, memo):
        """torch's copy, keeping the name and flags, as the reference's
        deepcopy of a parameter keeps them."""
        if id(self) in memo:
            return memo[id(self)]
        result = super().__deepcopy__(memo)
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result

    @property
    def name(self):
        return self.__dict__.get("_paddle_name")

    @name.setter
    def name(self, value):
        self.__dict__["_paddle_name"] = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.__dict__.get("_trainable", True)

    @trainable.setter
    def trainable(self, value):
        self.__dict__["_trainable"] = bool(value)


def _named(p, key):
    if not isinstance(p, nn.Parameter):
        return p        # a plain tensor keeps torch's read-only name
    if not isinstance(p, Parameter):
        p.__class__ = Parameter
        # flags set while it was a plain nn.Parameter (plain attributes
        # then) take effect now
        for flag in ("stop_gradient", "trainable"):
            if flag in p.__dict__:
                setattr(p, flag, p.__dict__.pop(flag))
    if p.name is None:
        p.name = unique_name.generate(key)
    return p


def name_parameters(module: nn.Module) -> nn.Module:
    """Name every unnamed parameter of ``module`` by the reference's rule,
    in module order: under its layer's full name (drawn for a module that
    is not a ``Layer`` now); returns the module."""
    for mod in module.modules():
        params = [p for p in mod._parameters.values() if p is not None]
        if params and any(getattr(p, "name", None) is None for p in params):
            full = (mod._full_name if isinstance(mod, Layer) else
                    unique_name.generate(type(mod).__name__.lower()))
            for p in params:
                _named(p, full + ".w")
    return module


def make_parameter(shape, dtype, init, is_bias, name, trainable=True,
                   learning_rate=1.0, device=None):
    """The reference's parameter creation (``Layer.create_parameter``,
    ``paddle.create_parameter``): ``init`` resolved (None: Constant(0)
    for a bias, XavierNormal otherwise) and called with the shape and
    dtype on ``device`` (None: the current place)."""
    from ...core.place import default_device
    from ..initializer import Constant, Initializer, XavierNormal, \
        _resolve_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    init = _resolve_initializer(init)
    dev = _device_of(device) or default_device()
    with torch.no_grad():
        if isinstance(init, Initializer):
            value = init(list(shape), dtype, dev)
        else:   # a user's callable may hand back its own storage
            value = _to_torch(init(list(shape), dtype)).to(dev, dtype).clone()
    p = Parameter(to_plain(value).detach(), requires_grad=trainable)
    p.name = name
    p.trainable = trainable
    p.optimize_attr = {"learning_rate": learning_rate}
    return p


def ensure_name(p):
    """``p`` with a name (``param_<k>`` where an ``nn.Parameter`` has
    none)."""
    return _named(p, "param") if getattr(p, "name", None) is None else p


@torch.no_grad()
def reset_conv_bn(module: nn.Module, device: torch.device, seed: int = 0):
    """The reference's initialisers, drawn in module order from a generator
    seeded with ``seed`` on ``device``: each Conv2D's and Linear's own
    (``reset_parameters``), the BatchNorm gains 1, shifts 0 and running
    statistics 0 and 1."""
    from .common import Linear
    from .conv import Conv2D
    from .norm import _BatchNormBase

    g = torch.Generator(device=device).manual_seed(int(seed))
    for mod in module.modules():
        if isinstance(mod, (Conv2D, Linear)):
            mod.reset_parameters(g)
        elif isinstance(mod, _BatchNormBase):
            for t, v in ((mod.weight, 1.0), (mod.bias, 0.0),
                         (mod._mean, 0.0), (mod._variance, 1.0)):
                if t is not None:
                    t.fill_(v)


@torch.no_grad()
def load_numpy(module: nn.Module, state: Dict[str, Any]) -> nn.Module:
    """Copy ``state`` (name → numpy array) into the module's parameters and
    buffers, in place; returns the module."""
    mine = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    if set(state) != set(mine):
        raise KeyError(f"load_numpy: names differ from the model's: "
                       f"missing {sorted(set(mine) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(mine))}")
    for name, t in mine.items():
        src = np.array(state[name], np.float32)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"load_numpy: {name} is {tuple(src.shape)}, "
                             f"the model's {tuple(t.shape)}")
        t.copy_(torch.from_numpy(src))
    return module


# ---------------------------------------------------------------------------
# Layer and its containers
# ---------------------------------------------------------------------------

# the handle of a forward hook (``remove()``): torch's, which takes the
# reference's constructor argument (the hooks dict)
HookRemoveHelper = RemovableHandle


def _is_param(value):
    return isinstance(value, (nn.Parameter, _FacadeParameter))


def _device_of(device):
    """A torch device from Paddle's forms (``"gpu:0"``, ``"cpu"``, a
    Place) or torch's."""
    from ...core.place import Place, _parse
    if device is None or isinstance(device, torch.device):
        return device
    if isinstance(device, int):
        return torch.device("cuda", device)
    place = device if isinstance(device, Place) else _parse(device)
    return place.torch_device()


def _to_torch(value):
    """A loaded value (a tensor or facade, a numpy array, bf16 ones from
    ``ml_dtypes`` included, a list or scalar) as a torch tensor."""
    if isinstance(value, torch.Tensor):
        return to_plain(value)
    from ...framework.io_api import numpy_to_torch
    return numpy_to_torch(np.asarray(value))


class Layer(nn.Module):
    """Paddle's ``nn.Layer`` over ``torch.nn.Module`` (see the module
    docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._casted_by_pure_fp16 = False
        if name_scope is None:
            name_scope = type(self).__name__.lower()
        self._full_name = unique_name.generate(name_scope)

    def __setattr__(self, name, value):
        # a facade Parameter (core.tensor) is a parameter too
        if isinstance(value, _FacadeParameter) and \
                not isinstance(value, nn.Parameter):
            params = self.__dict__.get("_parameters")
            if params is None:
                raise RuntimeError(
                    "call super().__init__() before assigning parameters")
            for store in ("_modules", "_buffers"):
                self.__dict__.get(store, {}).pop(name, None)
            self.__dict__.pop(name, None)
            params[name] = value
            return
        super().__setattr__(name, value)

    @property
    def _sub_layers(self):
        return self._modules

    @property
    def _non_persistable_buffer_names(self):
        return self._non_persistent_buffers_set

    def full_name(self):
        return self._full_name

    # -- creation helpers --------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A ``Parameter`` of ``shape`` drawn by ``attr``'s initializer,
        else ``default_initializer``, else Constant(0) for a bias and
        XavierNormal otherwise; named ``attr``'s name or ``<full
        name>.w_<i>``."""
        dt = dtypes.convert_dtype(dtype) if dtype is not None else self._dtype
        init, name, trainable, lr = None, None, True, 1.0
        if attr is not None and attr is not False:
            from ...base.param_attr import ParamAttr
            if isinstance(attr, ParamAttr):
                init, name = attr.initializer, attr.name
                trainable, lr = attr.trainable, attr.learning_rate
            elif isinstance(attr, str):
                name = attr
        return make_parameter(
            shape, dt, init or default_initializer, is_bias,
            name or unique_name.generate(self._full_name + ".w"), trainable,
            lr, device)

    def create_tensor(self, name=None, persistable=False, dtype=None):
        from ...core.place import default_device
        dt = dtypes.convert_dtype(dtype) if dtype is not None else self._dtype
        return Tensor(torch.zeros([], dtype=dt, device=default_device()),
                      name=name)

    def add_parameter(self, name, parameter):
        if parameter is not None and not _is_param(parameter):
            raise TypeError("add_parameter requires a Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        if persistent is not None:        # torch's keyword
            persistable = persistent
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    # -- iteration ---------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        memo = set() if layers_set is None else layers_set
        for name, layer in self.named_modules(memo=memo, prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # -- hooks: register_forward_pre_hook is torch's, the same contract --
    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    # -- state dict --------------------------------------------------------
    def _state_tensors(self, prefix=""):
        """Name → the parameter or persistable buffer itself, parameters
        first, as the reference's ``state_dict`` orders them."""
        out = collections.OrderedDict(
            self.named_parameters(prefix=prefix))
        for mod_name, mod in self.named_modules(prefix=prefix):
            for name, b in mod._buffers.items():
                if b is not None and \
                        name not in mod._non_persistent_buffers_set:
                    out.setdefault(f"{mod_name}.{name}" if mod_name
                                   else name, b)
        return out

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *args,
                   prefix=None, keep_vars=None):
        if prefix is not None or keep_vars is not None or args:
            # torch's form (its recursion into children, torch.save users)
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = collections.OrderedDict() if destination is None \
            else destination
        # include_sublayers and use_hook change nothing, as in the reference
        tensors = self._state_tensors(structured_name_prefix.rstrip("."))
        for name, t in tensors.items():
            if _is_param(t):
                dest[name] = _FacadeParameter(
                    to_plain(t).detach(), name=getattr(t, "name", None),
                    trainable=getattr(t, "trainable", True)
                    and t.requires_grad)
            else:
                dest[name] = Tensor(to_plain(t).detach(), persistable=True)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` into the parameters and persistable buffers
        in place; returns ``(missing_keys, unexpected_keys)``."""
        own = self._state_tensors()
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        values = {}
        for k, v in state_dict.items():
            if k not in own:
                continue
            target = own[k]
            value = _to_torch(v)
            if list(value.shape) != list(target.shape):
                raise ValueError(
                    f"shape mismatch for {k}: loaded {list(value.shape)} vs "
                    f"model {list(target.shape)}")
            values[k] = value
        with torch.no_grad():
            for k, value in values.items():
                to_plain(own[k]).copy_(value.to(own[k].device))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """torch's, taking Paddle's ``state_dict()`` too: its facades
        (whose ``shape`` is a list) reach torch as plain tensors."""
        return super().load_state_dict(
            {k: to_plain(v) for k, v in state_dict.items()}, strict=strict,
            assign=assign)

    # -- dtype / device migration -----------------------------------------
    def to(self, *args, **kwargs):
        """Paddle's ``to(device=None, dtype=None, blocking=None)``: floating
        parameters and buffers cast, everything moved; torch's forms pass
        through."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        blocking = kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.Tensor):       # torch's to(tensor)
                return super().to(*args, **kwargs)
            if isinstance(a, bool):
                blocking = a
            elif isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in dtypes._NAME_TO_DTYPE):
                dtype = a
            elif a is not None:
                device = a
        dt = dtypes.convert_dtype(dtype)
        kwargs.setdefault("non_blocking", blocking is False)
        super().to(device=_device_of(device), dtype=dt, **kwargs)
        if dt is not None:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")


class Sequential(Layer):
    """Parity: paddle.nn.Sequential (python/paddle/nn/layer/container.py):
    layers, a list of them, or (name, layer) pairs; children ``0``, ``1``,
    ... otherwise."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                not isinstance(layers[0], nn.Module):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self.add_sublayer(list(self._modules)[idx], layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def forward(self, input):  # noqa: A002
        for layer in self._modules.values():
            input = layer(input)  # noqa: A001
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[list(self._modules)[idx]]

    def __setitem__(self, idx, layer):
        self.add_sublayer(list(self._modules)[idx], layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self._modules[str(i)] = l

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, p):
        self._parameters[str(idx)] = p

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __iter__(self):
        return iter(self._modules)

    def __len__(self):
        return len(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for k, v in sublayers:
            self.add_sublayer(k, v)

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        layer = self._modules[key]
        del self._modules[key]
        return layer
