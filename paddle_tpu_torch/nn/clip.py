"""Gradient clipping.

Counterpart: ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` (:13-75), which an
optimizer's ``grad_clip`` applies to its (parameter, gradient) list
before the update and which return a new list, and the in-place
``clip_grad_norm_`` / ``clip_grad_value_`` (:78-101). A parameter whose
``need_clip`` attribute is False keeps its gradient. Norms are taken in
f32 and a clipped gradient keeps its dtype, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_"]


def _skip(p, g):
    return g is None or not getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient entry clamped to [min, max] (min: -max by default)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if _skip(p, g) else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            v = g.float()
            norm = v.square().sum().sqrt()
            scale = torch.clamp_max(self.clip_norm / norm.clamp_min(1e-12),
                                    1.0)
            out.append((p, (v * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by clip_norm / max(global norm, clip_norm),
    the global norm over all the gradients that are clipped."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        total = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            s = g.float().square().sum()
            total = s if total is None else total + s
        return total

    def __call__(self, params_grads):
        total = self._global_norm_sq(params_grads)
        if total is None:
            return params_grads
        scale = self.clip_norm / torch.clamp_min(total.sqrt(), self.clip_norm)
        return [(p, g if _skip(p, g) else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def _listed(parameters):
    return (list(parameters) if isinstance(parameters, (list, tuple))
            else [parameters])


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place to a total ``norm_type`` norm of at
    most ``max_norm``; returns the total norm. The 2-norm family sums in
    f32; the inf-norm keeps each gradient's max, the total and the scale
    in the gradients' own dtype (``paddle_tpu/nn/clip.py:86-93``), so bf16
    gradients give a bf16 total."""
    params = [p for p in _listed(parameters) if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.float().abs() ** norm_type).sum()
                             for p in params]).sum() ** (1.0 / norm_type)
    scale = torch.clamp_max(max_norm / total.clamp_min(1e-6), 1.0)
    for p in params:
        p.grad.copy_(p.grad.float() * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients to [-clip_value, clip_value] in place."""
    for p in _listed(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
