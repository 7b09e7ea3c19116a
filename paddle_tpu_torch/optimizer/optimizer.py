"""Optimizer base.

Counterpart: ``paddle_tpu/optimizer/optimizer.py``: ``L2Decay`` (:27)
and ``Optimizer`` (:37-194): the parameter list,
``get_lr`` / ``set_lr`` with a float rate, accumulators in the
parameter's dtype (f32 under ``multi_precision``), the f32 master
weights of bf16/fp16 parameters under ``multi_precision``, ``step`` and
``clear_grad`` (grads set to None, :189-192).

The reference rebinds new arrays; here ``step`` updates parameters,
master weights and accumulators IN PLACE under ``torch.no_grad()``, one
parameter at a time (the reference's per-leaf loop; a fused multi-tensor
update is ROADMAP D6). Not ported yet (ROADMAP A5), and raising
NotImplementedError: an ``LRScheduler`` as the rate, ``grad_clip`` and
param groups (a list of dicts). ``L1Decay``, static-graph ``minimize``
and the state dict are A5 too.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

__all__ = ["L2Decay", "Optimizer"]


def _not_ported(what):
    return NotImplementedError(f"{what} is ported with the eager framework "
                               f"core (ROADMAP A5)")


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required in eager mode "
                             "(pass model.parameters())")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            raise _not_ported("optimizer: param groups")
        if not isinstance(learning_rate, (int, float)):
            raise _not_ported("optimizer: an LRScheduler learning rate")
        if grad_clip is not None:
            raise _not_ported("optimizer: grad_clip")
        self._parameter_list = params
        self._learning_rate = float(learning_rate)
        self._multi_precision = multi_precision
        if isinstance(weight_decay, float):
            self.regularization = L2Decay(weight_decay)
        else:
            self.regularization = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._master_weights: Dict[int, torch.Tensor] = {}

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        raise _not_ported("optimizer: set_lr_scheduler")

    # -- accumulators ------------------------------------------------------
    def _get_accumulator(self, name, param, fill=0.0, dtype=None, shape=None):
        acc = self._accumulators[name].get(id(param))
        if acc is None:
            dt = dtype or (torch.float32 if self._use_master(param)
                           else param.dtype)
            shp = tuple(param.shape) if shape is None else tuple(shape)
            acc = torch.full(shp, fill, dtype=dt, device=param.device)
            self._accumulators[name][id(param)] = acc
        return acc

    def _use_master(self, param):
        return self._multi_precision and param.dtype in (torch.bfloat16,
                                                         torch.float16)

    def _master(self, param):
        if not self._use_master(param):
            return None
        mw = self._master_weights.get(id(param))
        if mw is None:
            mw = param.detach().float()
            self._master_weights[id(param)] = mw
        return mw

    # -- step --------------------------------------------------------------
    def _apply_decay(self, param, grad):
        """L2 regularisation folded into the gradient (the reference's
        appended regularisation op); AdamW decays decoupled instead."""
        reg = self.regularization
        if isinstance(reg, L2Decay) and reg.coeff:
            return grad + reg.coeff * param.to(grad.dtype)
        return grad

    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        for p in self._parameter_list:
            if not p.requires_grad or p.grad is None:
                continue
            master = self._master(p)
            grad = p.grad if master is None else p.grad.float()
            grad = self._apply_decay(p, grad)
            self._update(p, p if master is None else master, grad, lr)
            if master is not None:
                p.copy_(master)

    def _update(self, param, value, grad, lr):
        """Update ``value`` (the parameter, or its f32 master) in place."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None
