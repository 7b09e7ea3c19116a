"""SGD, Momentum, Adam and AdamW.

Counterpart: ``paddle_tpu/optimizer/optimizers.py``, ``SGD`` (:11-20),
``Momentum`` (:23-41), ``Adam`` (:45-84) and ``AdamW`` (:87-110), with
the reference's defaults. The other optimizers, ``amsgrad``,
``lr_ratio`` and ``apply_decay_param_fun`` are ROADMAP A5 and raise
NotImplementedError; ``lazy_mode`` and ``use_multi_tensor`` are accepted
and change nothing, as in the reference.

Momentum's velocity lives in the parameter's dtype (f32 under
``multi_precision``): velocity = μ·velocity + rescale·g, then p −= lr·v,
or with Nesterov p −= lr·(g + μ·v); an ``L2Decay`` (or a float
``weight_decay``) is folded into g by the base first. The Adam moments
live in the parameter's dtype too and are updated in that dtype; the
step, as in the reference, divides them by the f32 bias corrections, so
the update is formed in f32 and the parameter (or its master) rounded
once.
"""
from __future__ import annotations

import torch

from .optimizer import L2Decay, Optimizer, _not_ported

__all__ = ["Adam", "AdamW", "Momentum", "SGD"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, param, value, grad, lr):
        value.sub_(grad * lr)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._rescale = rescale_grad

    def _update(self, param, value, grad, lr):
        v = self._get_accumulator("velocity", param)
        if self._rescale != 1.0:
            grad = grad * self._rescale
        v.mul_(self._momentum).add_(grad)
        if self._nesterov:
            value.sub_((grad + v * self._momentum) * lr)
        else:
            value.sub_(v * lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise _not_ported("Adam: amsgrad")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, param, value, grad, lr):
        m = self._get_accumulator("moment1", param)
        v = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param, fill=1.0, shape=(),
                                    dtype=torch.float32)
        b2p = self._get_accumulator("beta2_pow", param, fill=1.0, shape=(),
                                    dtype=torch.float32)
        b1, b2 = self._beta1, self._beta2
        b1p.mul_(b1)
        b2p.mul_(b2)
        m.mul_(b1).add_(grad, alpha=1 - b1)
        v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
        denom = (v.float() / (1 - b2p)).sqrt_().add_(self._epsilon)
        value.sub_((m.float() / (1 - b1p)).mul_(lr).div_(denom))


class AdamW(Adam):
    """Decoupled weight decay: the parameter is scaled by ``1 - lr·decay``
    before the Adam step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        if lr_ratio is not None:
            raise _not_ported("AdamW: lr_ratio")
        if apply_decay_param_fun is not None:
            raise _not_ported("AdamW: apply_decay_param_fun")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._coeff = (weight_decay.coeff if isinstance(weight_decay, L2Decay)
                       else float(weight_decay))

    def _update(self, param, value, grad, lr):
        value.mul_(1.0 - lr * self._coeff)
        super()._update(param, value, grad, lr)
