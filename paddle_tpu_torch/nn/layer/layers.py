"""Seeded initialisation and weight loading for models built of layers.

Counterpart: ``paddle_tpu/nn/layer/layers.py``, ``Layer.state_dict``
(:269) and ``Layer.set_state_dict`` (:292), as the port's models use
them: ``load_numpy`` copies the reference's state dict (name → numpy
array: every parameter and the BatchNorm buffers ``_mean`` /
``_variance``, in the reference's names and layouts) into a module, and
raises where a name or a shape differs. ``reset_conv_bn`` draws the
reference's initialisers for models of convolutions, Linear layers and
BatchNorms (the ResNet family, PP-YOLOE). ``name_parameters`` gives
every parameter of a model the reference's unique name
(``Layer.create_parameter``, :127): ``<layer class in lower case>_<k>.w_<i>``
(``linear_0.w_0`` the first Linear's weight, ``.w_1`` its bias), the
name an optimizer's ``apply_decay_param_fun`` is called with.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ...utils import unique_name
from .common import Linear
from .conv import Conv2D
from .norm import _BatchNormBase

__all__ = ["Parameter", "load_numpy", "name_parameters", "reset_conv_bn"]


class Parameter(nn.Parameter):
    """``nn.Parameter`` with Paddle's writable ``name`` (torch's tensors
    hold a read-only one), ``stop_gradient`` (the inverse of
    ``requires_grad``) and ``trainable`` (the reference's ``Parameter``,
    ``core/tensor.py:404``: an optimizer skips a parameter that is not
    trainable). ``name_parameters`` and ``ensure_name`` turn parameters
    into this class in place: the objects stay, so optimizers and tied
    weights are untouched."""

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
    in module order; returns the module."""
    for mod in module.modules():
        params = [p for p in mod._parameters.values() if p is not None]
        if params and any(getattr(p, "name", None) is None for p in params):
            full = unique_name.generate(type(mod).__name__.lower())
            for p in params:
                _named(p, full + ".w")
    return module


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
