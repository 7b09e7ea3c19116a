"""Optimizer base.

Counterpart: ``paddle_tpu/optimizer/optimizer.py``: ``L2Decay`` and
``L1Decay`` (:27-34) and ``Optimizer`` (:37-254): the parameter list or
param groups (a list of dicts, each with ``"params"``; the reference
flattens them into one list and steps every parameter with the
optimizer's own rate, decay and clip, and so does the port), the rate as
a float or an ``LRScheduler`` (``get_lr``, ``set_lr``,
``set_lr_scheduler``), accumulators in the parameter's dtype (f32 under
``multi_precision``), the f32 master weights of bf16/fp16 parameters
under ``multi_precision``, ``step`` (the (parameter, gradient) list of
trainable parameters with gradients, ``grad_clip`` applied to it, then
the decay folded into each gradient and the update), ``clear_grad``,
eager ``minimize`` and ``state_dict`` / ``set_state_dict`` (keys
``<param name>_<accumulator>``, ``<param name>_master``,
``LR_Scheduler`` and ``global_step``).

The reference rebinds new arrays; here ``step`` updates parameters,
master weights and accumulators IN PLACE under ``torch.no_grad()``, one
parameter at a time (the reference's per-leaf loop; a fused multi-tensor
update is ROADMAP D6). Every parameter is given a name
(``nn.layer.layers.ensure_name``) where its model gave it none: the state
dict and ``apply_decay_param_fun`` key on it. A facade parameter
(``core/tensor.py``) is updated through a plain alias of its storage.
Static-graph ``minimize`` is ROADMAP A9.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import torch

from ..core.tensor import Tensor, to_plain
from ..nn.layer.layers import ensure_name
from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer"]


def _not_ported(what):
    return NotImplementedError(f"{what} is ported with the rest of the eager "
                               f"framework core (ROADMAP A5b)")


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class Optimizer:
    DEFAULT_ACCS: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required in eager mode "
                             "(pass model.parameters())")
        self._parameter_list = self._build_param_groups(parameters)
        for p in self._parameter_list:
            ensure_name(p)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, float):
            self.regularization = L2Decay(weight_decay)
        else:
            self.regularization = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._global_step = 0

    def _build_param_groups(self, parameters):
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = params
            return [p for g in params for p in g["params"]]
        self._param_groups = [{"params": params}]
        return params

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

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
    def _collect_params_grads(self):
        return [(self._plain(p), to_plain(p.grad))
                for p in self._parameter_list
                if p.requires_grad and p.grad is not None
                and getattr(p, "trainable", True)]

    def _plain(self, p):
        """A facade parameter (``core/tensor.py``) as a plain alias of its
        storage, the same alias every step (master weights are keyed by
        it): the update sees torch's methods, not Paddle's."""
        if type(p) is not Tensor:
            return p
        aliases = self.__dict__.setdefault("_aliases", {})
        if id(p) not in aliases:
            aliases[id(p)] = p.as_subclass(torch.Tensor)
        return aliases[id(p)]

    def _apply_decay(self, param, grad):
        """The regulariser folded into the gradient (the reference's
        appended regularisation op), on the parameter's own value cast to
        the gradient's dtype; AdamW decays decoupled instead."""
        reg = self.regularization
        if isinstance(reg, L2Decay) and reg.coeff:
            return grad + reg.coeff * param.to(grad.dtype)
        if isinstance(reg, L1Decay) and reg.coeff:
            return grad + reg.coeff * torch.sign(param.to(grad.dtype))
        return grad

    @torch.no_grad()
    def step(self):
        params_grads = self._collect_params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._global_step += 1
        for p, g in params_grads:
            master = self._master(p)
            grad = g if master is None else g.float()
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

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        names = {id(p): p.name for p in self._parameter_list}
        sd = {}
        for acc_name, by_param in self._accumulators.items():
            for pid, t in by_param.items():
                sd[f"{names.get(pid, pid)}_{acc_name}"] = t
        for pid, t in self._master_weights.items():
            sd[f"{names.get(pid, pid)}_master"] = t
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict):
        params = {p.name: p for p in self._parameter_list}
        self._global_step = state_dict.get("global_step", 0)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

        def value(val, p):
            return torch.as_tensor(val).to(p.device, copy=True)

        acc_names = self._acc_names()
        for key, val in state_dict.items():
            if key in ("LR_Scheduler", "global_step"):
                continue
            if key.endswith("_master"):
                p = params.get(key[:-len("_master")])
                if p is not None:
                    self._master_weights[id(p)] = value(val, p)
                continue
            for acc_name in acc_names:
                if key.endswith("_" + acc_name):
                    p = params.get(key[:-len(acc_name) - 1])
                    if p is not None:
                        self._accumulators[acc_name][id(p)] = value(val, p)
                    break

    def _acc_names(self):
        """The accumulators a state dict may hold: those made so far and
        the optimizer's own. (The reference asks again for each key, so a
        fresh optimizer restores only the first accumulator it meets; the
        port takes the names once.)"""
        return list(dict.fromkeys([*self._accumulators, *self.DEFAULT_ACCS]))
