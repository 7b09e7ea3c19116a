"""The fourteen optimizers.

Counterpart: ``paddle_tpu/optimizer/optimizers.py``, ``SGD`` (:11-20),
``Momentum`` (:23-41), ``Adam`` (:45-84, ``amsgrad`` included),
``AdamW`` (:87-110, ``lr_ratio`` and ``apply_decay_param_fun``
included) and the ten of :113-441: ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp`` (``centered``), ``Lamb``
(``exclude_from_weight_decay_fn``), ``LBFGS`` (the reference's
simplified step: one two-loop direction a call, no line search), ``NAdam``,
``RAdam``, ``ASGD`` and ``Rprop``, with the reference's defaults,
accumulator names (``DEFAULT_ACCS``) and formulas. Each updates its
parameter (or f32 master) in place on the base's per-leaf loop; a formula
the reference writes as a new array is computed the same way and copied
in. The step counters of NAdam and RAdam and the beta powers are f32
scalars on the parameter's device, as the reference's are. ``lazy_mode``
and ``use_multi_tensor`` are accepted and change nothing, as in the
reference.

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

from .optimizer import L2Decay, Optimizer

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


class Adamax(Optimizer):
    DEFAULT_ACCS = ["moment", "inf_norm", "beta1_pow"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, param, value, grad, lr):
        m = self._get_accumulator("moment", param)
        u = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow", param, fill=1.0, shape=(),
                                    dtype=torch.float32)
        b1p.mul_(self._beta1)
        m.mul_(self._beta1).add_(grad, alpha=1 - self._beta1)
        torch.maximum(u * self._beta2, grad.abs(), out=u)
        value.sub_(lr / (1 - b1p) * m / (u + self._epsilon))


class Adagrad(Optimizer):
    DEFAULT_ACCS = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, param, value, grad, lr):
        m = self._get_accumulator("moment", param, fill=self._init_acc)
        m.addcmul_(grad, grad)
        value.sub_(lr * grad / (m.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    DEFAULT_ACCS = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, param, value, grad, lr):
        g2 = self._get_accumulator("avg_squared_grad", param)
        u2 = self._get_accumulator("avg_squared_update", param)
        rho, eps = self._rho, self._epsilon
        g2.copy_(rho * g2 + (1 - rho) * grad * grad)
        update = -((u2 + eps) / (g2 + eps)).sqrt() * grad
        u2.copy_(rho * u2 + (1 - rho) * update * update)
        value.add_(lr * update)


class RMSProp(Optimizer):
    DEFAULT_ACCS = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, param, value, grad, lr):
        ms = self._get_accumulator("mean_square", param)
        mom = self._get_accumulator("momentum", param)
        rho = self._rho
        ms.copy_(rho * ms + (1 - rho) * grad * grad)
        if self._centered:
            mg = self._get_accumulator("mean_grad", param)
            mg.copy_(rho * mg + (1 - rho) * grad)
            denom = (ms - mg * mg + self._epsilon).sqrt()
        else:
            denom = (ms + self._epsilon).sqrt()
        mom.copy_(self._momentum * mom + lr * grad / denom)
        value.sub_(mom)


class Lamb(Optimizer):
    DEFAULT_ACCS = ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

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
        m.copy_(b1 * m + (1 - b1) * grad)
        v.copy_(b2 * v + (1 - b2) * grad * grad)
        r = (m / (1 - b1p)) / ((v / (1 - b2p)).sqrt() + self._epsilon)
        decay = self._lamb_decay
        if self._exclude_fn is not None and self._exclude_fn(param):
            decay = 0.0
        update = r + decay * value
        w_norm = torch.linalg.vector_norm(value)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        value.sub_(lr * trust * update)


class LBFGS(Optimizer):
    """The reference's simplified L-BFGS (python/paddle/optimizer/lbfgs.py):
    one two-loop direction from the last ``history_size`` pairs per
    ``step(closure)``, a fixed step of the learning rate, no line search;
    the flattened parameters move together."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._history_size = history_size
        self._max_iter = max_iter
        self._s_hist = []
        self._y_hist = []
        self._prev_flat_grad = None
        self._prev_flat_w = None

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.reshape(-1) for t in tensors])

    def step(self, closure=None):
        if closure is not None:
            closure()
        with torch.no_grad():
            self._lbfgs_step()

    def _lbfgs_step(self):
        params_grads = self._collect_params_grads()
        if not params_grads:
            return
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        g = self._flat([gr for _, gr in params_grads])
        w = self._flat([p for p, _ in params_grads])
        if self._prev_flat_grad is not None:
            s = w - self._prev_flat_w
            y = g - self._prev_flat_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self._history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
        q = g
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = 1.0 / torch.dot(y, s)
            alpha = rho * torch.dot(s, q)
            q = q - alpha * y
            alphas.append((alpha, rho, s, y))
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for alpha, rho, s, y in reversed(alphas):
            beta = rho * torch.dot(y, q)
            q = q + (alpha - beta) * s
        neww = w + self.get_lr() * -q
        self._prev_flat_grad = g
        self._prev_flat_w = neww
        offset = 0
        for p, _ in params_grads:
            n = p.numel()
            p.copy_(neww[offset:offset + n].view_as(p))
            offset += n


class NAdam(Optimizer):
    """Nesterov-accelerated Adam (parity: optimizer/nadam.py)."""

    DEFAULT_ACCS = ["moment1", "moment2", "mu_product", "t_step"]

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update(self, param, value, grad, lr):
        m = self._get_accumulator("moment1", param)
        v = self._get_accumulator("moment2", param)
        mu_p = self._get_accumulator("mu_product", param, fill=1.0, shape=(),
                                     dtype=torch.float32)
        tc = self._get_accumulator("t_step", param, fill=0.0, shape=(),
                                   dtype=torch.float32)
        b1, b2 = self._b1, self._b2
        tc.add_(1.0)
        t = tc
        mu_t = b1 * (1.0 - 0.5 * torch.pow(0.96, t * self._psi))
        mu_t1 = b1 * (1.0 - 0.5 * torch.pow(0.96, (t + 1.0) * self._psi))
        mu_p.mul_(mu_t)
        m.copy_(b1 * m + (1 - b1) * grad)
        v.copy_(b2 * v + (1 - b2) * grad * grad)
        m_hat = (mu_t1 * m / (1 - mu_p * mu_t1)
                 + (1 - mu_t) * grad / (1 - mu_p))
        v_hat = v / (1 - torch.pow(b2, t))
        value.sub_(lr * m_hat / (v_hat.sqrt() + self._eps))


class RAdam(Optimizer):
    """Rectified Adam (parity: optimizer/radam.py)."""

    DEFAULT_ACCS = ["moment1", "moment2", "t_step"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _update(self, param, value, grad, lr):
        m = self._get_accumulator("moment1", param)
        v = self._get_accumulator("moment2", param)
        tc = self._get_accumulator("t_step", param, fill=0.0, shape=(),
                                   dtype=torch.float32)
        b1, b2 = self._b1, self._b2
        tc.add_(1.0)
        t = tc
        m.copy_(b1 * m + (1 - b1) * grad)
        v.copy_(b2 * v + (1 - b2) * grad * grad)
        b2t = torch.pow(b2, t)
        m_hat = m / (1 - torch.pow(b1, t))
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2t / (1 - b2t)
        v_hat = (v / (1 - b2t)).sqrt()
        r = torch.clamp_min(
            ((rho_t - 4) * (rho_t - 2) * rho_inf)
            / torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t, 1e-8),
            0.0).sqrt()
        rectified = value - lr * r * m_hat / (v_hat + self._eps)
        plain = value - lr * m_hat
        value.copy_(torch.where(rho_t > 5.0, rectified, plain))


class ASGD(Optimizer):
    """Averaged SGD (parity: optimizer/asgd.py): the step follows the
    running mean of the last ``batch_num`` gradients."""

    DEFAULT_ACCS = ["averaged"]

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = max(int(batch_num), 1)

    def _update(self, param, value, grad, lr):
        d = self._get_accumulator("averaged", param)
        d.copy_(d + (grad - d) / self._n)
        value.sub_(lr * d)


class Rprop(Optimizer):
    """Resilient backprop (parity: optimizer/rprop.py): per-weight step
    sizes grown or shrunk by the agreement of the gradient's sign with the
    last one; on a flip, no step and the stored gradient zeroed."""

    DEFAULT_ACCS = ["prev_grad", "step_size"]

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _update(self, param, value, grad, lr):
        prev = self._get_accumulator("prev_grad", param)
        step = self._get_accumulator("step_size", param, fill=float(lr))
        sign = torch.sign(grad * prev)
        step.copy_(torch.clamp(
            torch.where(sign > 0, step * self._eta_plus,
                        torch.where(sign < 0, step * self._eta_minus, step)),
            self._lr_min, self._lr_max))
        eff_grad = torch.where(sign < 0, 0.0, grad)
        prev.copy_(eff_grad)
        value.sub_(step * torch.sign(eff_grad))
