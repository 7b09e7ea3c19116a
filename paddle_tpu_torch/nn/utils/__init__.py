"""``paddle.nn.utils``.

Counterpart: ``paddle_tpu/nn/utils/__init__.py``:
``parameters_to_vector``, ``vector_to_parameters``, ``weight_norm`` (a
forward pre-hook that recomputes ``weight = v · g / ‖v‖`` from the new
parameters ``<name>_g`` and ``<name>_v``), ``remove_weight_norm`` (which
returns the layer unchanged, as the reference's does), ``spectral_norm``
(a forward pre-hook dividing the weight by its power-iteration estimate
of the largest singular value) and the clipping helpers of ``nn.clip``.
"""
from __future__ import annotations

import math

import torch

from ...core.tensor import to_plain
from ..clip import clip_grad_norm_, clip_grad_value_

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "remove_weight_norm", "spectral_norm", "vector_to_parameters",
           "weight_norm"]


def parameters_to_vector(parameters, name=None):
    return torch.cat([to_plain(p).detach().reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    v = to_plain(vec)
    offset = 0
    for p in parameters:
        t = to_plain(p)
        n = t.numel()
        t.copy_(v[offset:offset + n].reshape(t.shape).to(t.dtype))
        offset += n


def _rows(t, dim):
    return t.movedim(dim, 0).reshape(t.shape[dim], -1)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as g · v / ‖v‖ (norms over every
    axis but ``dim``), recomputed before each forward."""
    w = to_plain(getattr(layer, name)).detach()
    g = layer.create_parameter(
        [w.shape[dim]], default_initializer=lambda s, d: torch.linalg.norm(
            _rows(w, dim), dim=1), device=w.device)
    v = layer.create_parameter(
        list(w.shape), default_initializer=lambda s, d: w.clone(),
        device=w.device)
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def hook(lyr, inputs):
        with torch.no_grad():
            norm = torch.linalg.norm(_rows(v, dim), dim=1)
            shape = [1] * v.ndim
            shape[dim] = -1
            lyr._parameters[name].copy_(
                v * (g / torch.clamp_min(norm, 1e-12)).reshape(shape))

    layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value before each
    forward: power iteration from u = 1/sqrt(rows), the estimate kept
    between calls."""
    wdim = dim if dim is not None else 0
    state = {"u": None}

    def hook(lyr, inputs):
        with torch.no_grad():
            wv = lyr._parameters[name]
            mat = _rows(wv, wdim)
            u = state["u"]
            if u is None:
                u = torch.ones(mat.shape[0], dtype=mat.dtype,
                               device=mat.device) / math.sqrt(mat.shape[0])
            for _ in range(n_power_iterations):
                vvec = mat.T @ u
                vvec = vvec / torch.clamp_min(torch.linalg.norm(vvec), eps)
                u = mat @ vvec
                u = u / torch.clamp_min(torch.linalg.norm(u), eps)
            state["u"] = u
            wv.copy_(wv / (u @ mat @ vvec))

    layer.register_forward_pre_hook(hook)
    return layer
