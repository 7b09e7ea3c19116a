"""``paddle.incubate.optimizer``: gradient merge and Lookahead.

Counterpart: ``paddle_tpu/incubate/optimizer/__init__.py``:
``GradientMergeOptimizer`` (:15-74; ``k_steps``, ``avg``) and
``LookAhead`` (:77-120; ``alpha``, ``k``). Both wrap any port optimizer
and forward every other attribute to it (``_parameter_list``,
``state_dict``, ``get_lr`` ...), so ``GradScaler.step`` and
``minimize`` take them as they take the optimizer.

The accumulated gradients and LookAhead's slow weights stay on the
parameters' device as tensors: the reference's host numpy copies of the
slow weights (:96-100) would read the device for every parameter at
every step.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.tensor import to_plain

__all__ = ["GradientMergeOptimizer", "LookAhead"]


class GradientMergeOptimizer:
    """Sum the gradients of ``k_steps`` micro-steps and apply the inner
    optimizer once, at every k-th ``step`` (``avg``: the mean instead of
    the sum). Between boundaries the parameters do not change."""

    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        self._inner = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg
        self._step_id = 0
        self._acc = {}

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @property
    def _params(self):
        return list(self._inner._parameter_list)

    @torch.no_grad()
    def step(self):
        self._step_id += 1
        boundary = self._step_id % self.k_steps == 0
        for p in self._params:
            if p.grad is None:
                continue
            g = to_plain(p.grad).detach()
            acc = self._acc.get(id(p))
            self._acc[id(p)] = g if acc is None else acc + g
        if not boundary:
            self._inner.clear_grad()      # this micro-step's grads consumed
            return
        for p in self._params:
            acc = self._acc.pop(id(p), None)
            if acc is None:
                continue
            p.grad = acc / float(self.k_steps) if self.avg else acc
        self._inner.step()

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return [], []


class LookAhead:
    """Lookahead (Zhang et al. 2019): the inner optimizer moves the fast
    weights; every ``k`` steps the slow weights move ``alpha`` of the way
    to them and the fast weights are set to the slow ones."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name: Optional[str] = None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if k < 1:
            raise ValueError("k must be >= 1")
        self._inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_id = 0
        self._slow = {}

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @torch.no_grad()
    def step(self):
        params = list(self._inner._parameter_list)
        for p in params:
            if id(p) not in self._slow:
                self._slow[id(p)] = to_plain(p).detach().clone()
        self._inner.step()
        self._step_id += 1
        if self._step_id % self.k == 0:
            for p in params:
                slow = self._slow[id(p)]
                slow.add_(self.alpha * (to_plain(p) - slow))
                to_plain(p).copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return [], []
