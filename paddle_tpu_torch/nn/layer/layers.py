"""Seeded initialisation and weight loading for models built of layers.

Counterpart: ``paddle_tpu/nn/layer/layers.py``, ``Layer.state_dict``
(:269) and ``Layer.set_state_dict`` (:292), as the port's models use
them: ``load_numpy`` copies the reference's state dict (name → numpy
array: every parameter and the BatchNorm buffers ``_mean`` /
``_variance``, in the reference's names and layouts) into a module, and
raises where a name or a shape differs. ``reset_conv_bn`` draws the
reference's initialisers for models of convolutions, Linear layers and
BatchNorms (the ResNet family, PP-YOLOE).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .common import Linear
from .conv import Conv2D
from .norm import _BatchNormBase

__all__ = ["load_numpy", "reset_conv_bn"]


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
