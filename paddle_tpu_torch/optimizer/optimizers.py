"""SGD, Momentum, Adam and AdamW.

Counterpart: ``paddle_tpu/optimizer/optimizers.py``, ``SGD`` (:11-20),
``Momentum`` (:23-41), ``Adam`` (:45-84, ``amsgrad`` included) and
``AdamW`` (:87-110, ``lr_ratio`` and ``apply_decay_param_fun``
included), with the reference's defaults. The other optimizers, from
``Adamax`` on, are ROADMAP A5b and raise NotImplementedError;
``lazy_mode`` and ``use_multi_tensor`` are accepted and change nothing,
as in the reference.

Momentum's velocity lives in the parameter's dtype (f32 under
``multi_precision``): velocity = μ·velocity + rescale·g, then p −= lr·v,
or with Nesterov p −= lr·(g + μ·v); an ``L2Decay`` (or a float
``weight_decay``) is folded into g by the base first. The Adam moments
live in the parameter's dtype too and are updated in that dtype; the
step, as in the reference, divides them by the f32 bias corrections, so
the update is formed in f32 and the parameter (or its master) rounded
once. With ``amsgrad`` the denominator takes the running maximum of the
second moment (the ``moment2_max`` accumulator). AdamW's ``lr_ratio(param)``
scales the rate of that parameter; ``apply_decay_param_fun(param.name)``
False exempts it from the decay.
"""
from __future__ import annotations

import torch

from .optimizer import L2Decay, Optimizer, _not_ported

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "LBFGS",
           "Lamb", "Momentum", "NAdam", "RAdam", "RMSProp", "Rprop", "SGD"]


class SGD(Optimizer):
    DEFAULT_ACCS = []

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, param, value, grad, lr):
        value.sub_(grad * lr)


class Momentum(Optimizer):
    DEFAULT_ACCS = ["velocity"]

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
    DEFAULT_ACCS = ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _acc_names(self):
        # the reference's DEFAULT_ACCS lacks moment2_max, so its fresh
        # optimizer drops it from a state dict; the port restores it
        names = super()._acc_names()
        return names + ["moment2_max"] if self._amsgrad else names

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
        if self._amsgrad:
            vmax = self._get_accumulator("moment2_max", param)
            torch.maximum(vmax, v, out=vmax)
            v = vmax
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
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._coeff = (weight_decay.coeff if isinstance(weight_decay, L2Decay)
                       else float(weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, param, value, grad, lr):
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(param)
        decay = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(param.name):
            decay = 0.0
        value.mul_(1.0 - lr * decay)
        super()._update(param, value, grad, lr)


class _A5b(Optimizer):
    """An optimizer of the reference not ported yet: constructing it
    raises, naming ROADMAP A5b."""

    def __init__(self, *args, **kwargs):
        raise _not_ported(f"optimizer.{type(self).__name__}")


class Adamax(_A5b):
    pass


class Adagrad(_A5b):
    pass


class Adadelta(_A5b):
    pass


class RMSProp(_A5b):
    pass


class Lamb(_A5b):
    pass


class LBFGS(_A5b):
    pass


class NAdam(_A5b):
    pass


class RAdam(_A5b):
    pass


class ASGD(_A5b):
    pass


class Rprop(_A5b):
    pass
