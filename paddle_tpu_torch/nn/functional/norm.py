"""Normalisation functionals.

Counterpart: ``paddle_tpu/nn/functional/norm.py``: ``last_norm_path`` /
``reset_last_norm_path`` (:29-46), ``_fused_mode`` (:49), the once-warned
dense route (:61-69), the dense ``_layer_norm_ref`` (:109), ``layer_norm``
(:190), ``fused_bias_dropout_residual_layer_norm`` (:219) with its routing
body ``_adln_routed`` (:244), and ``rms_norm`` (:467-475), the LLaMA norm.
The BatchNorm family and its fused kernels (TPU kernels 15-18) are ROADMAP
A8.

With ``FLAGS_fused_norm`` on (the default), ``layer_norm`` and the
bias→residual-add→LN close take the fused route through
``kernels/norm_fusion.py`` (TPU kernels 13, 14): on a card the
hand-written CUDA kernels, on the CPU their plain PyTorch versions (as
the MLP functionals do). The reference's exception policy (a failed
kernel falls back to the dense path) is not ported: a kernel that fails
to build or launch raises. The dense route is taken only for what the
arguments decide: the flag off, a missing affine parameter, a
normalized_shape over more than the last axis or a dtype the kernels do
not take, the last three with the reference's once-warning.

Dropout is not ported on either route: on the fused route it is the
kernels' seeded keep-mask epilogue, on the dense route the reference
draws its mask from ``default_generator``; both are ROADMAP A6b and
raise NotImplementedError.
"""
from __future__ import annotations

import warnings

import torch

from ...core.flags import get_flag
from ...kernels.norm_fusion import fused_layer_norm_2d

__all__ = ["fused_bias_dropout_residual_layer_norm", "last_norm_path",
           "layer_norm", "reset_last_norm_path", "rms_norm"]

_LAST_PATH = None
_DENSE_FALLBACK_WARNED = False
_FUSED_DTYPES = (torch.float32, torch.bfloat16)


def last_norm_path():
    """The normalisation path the most recent ``layer_norm`` or
    ``fused_bias_dropout_residual_layer_norm`` call took: 'fused_ln/cuda'
    or 'fused_adln/cuda' (the kernels), 'fused_ln/plain' or
    'fused_adln/plain' (their plain versions, CPU tensors) or 'dense'
    (None before any call)."""
    return _LAST_PATH


def reset_last_norm_path():
    """Clear the introspection state."""
    global _LAST_PATH
    _LAST_PATH = None


def _fused_mode(device: torch.device):
    """'cuda' (the kernels) | 'plain' (CPU tensors) | None (dense)."""
    if not get_flag("fused_norm"):
        return None
    return "cuda" if device.type == "cuda" else "plain"


def _warn_dense(reason):
    """Loud once: the fused route was asked for but these arguments take
    the dense one."""
    global _DENSE_FALLBACK_WARNED
    if not _DENSE_FALLBACK_WARNED:
        _DENSE_FALLBACK_WARNED = True
        warnings.warn("fused_norm: taking the dense path: " + reason)


def _no_dropout(p, where):
    if p > 0:
        raise NotImplementedError(
            f"{where}: dropout (the fused kernels' seeded keep-mask, the "
            f"dense route's default_generator mask) is ROADMAP A6b")


def _layer_norm_ref(x, normalized_shape=None, weight=None, bias=None,
                    epsilon=1e-5):
    """The dense LayerNorm (norm.py:109-129): statistics in f32 for bf16
    and fp16 inputs, the biased variance, the normalised value cast back to
    x's dtype before the affine parameters apply."""
    if isinstance(normalized_shape, int) or normalized_shape is None:
        ndims = 1
    else:
        ndims = len(normalized_shape)
    axes = tuple(range(x.ndim - ndims, x.ndim))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5, name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes of x. On the
    fused route (last axis, weight and bias given, f32 or bf16) one kernel
    pass over the [R, H] view with f32 statistics, y in x's dtype."""
    global _LAST_PATH
    mode = _fused_mode(x.device)
    if mode is not None:
        ndims = (1 if isinstance(normalized_shape, int)
                 or normalized_shape is None else len(normalized_shape))
        if ndims == 1 and weight is not None and bias is not None \
                and x.ndim >= 1 and x.dtype in _FUSED_DTYPES:
            _LAST_PATH = f"fused_ln/{mode}"
            hd = x.shape[-1]
            return fused_layer_norm_2d(x.reshape(-1, hd), weight, bias,
                                       eps=float(epsilon)).reshape(x.shape)
        _warn_dense(
            "layer_norm shape/affine combination unsupported by the fused "
            "kernel (needs last-axis normalized_shape + weight + bias, "
            "float32 or bfloat16)")
    _LAST_PATH = "dense"
    return _layer_norm_ref(x, normalized_shape, weight, bias, epsilon)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5,
                                           ln_epsilon=1e-5, training=True,
                                           name=None):
    """out = LayerNorm(residual + dropout(bias + x)): the per-sublayer close
    of a post-LN transformer block, one kernel pass on the fused route.
    Dropout while training is ROADMAP A6b; with ``training=False`` any
    rate runs."""
    p = float(dropout_rate) if training else 0.0
    return _adln_routed(x, residual, bias, ln_scale, ln_bias, None, p,
                        float(ln_epsilon))


def _adln_routed(x, residual, bias, ln_scale, ln_bias, dk, p, eps):
    """Routing body of ``fused_bias_dropout_residual_layer_norm``, shared
    with ``fused_attn_proj_residual_layer_norm``'s dense route (the
    reference's :244-268). ``dk`` is the dropout key, always None here."""
    global _LAST_PATH
    mode = _fused_mode(x.device)
    if mode is not None:
        if ln_scale is not None and ln_bias is not None \
                and x.dtype in _FUSED_DTYPES:
            _LAST_PATH = f"fused_adln/{mode}"
            _no_dropout(p, "fused_bias_dropout_residual_layer_norm")
            hd = x.shape[-1]
            y = fused_layer_norm_2d(
                x.reshape(-1, hd), ln_scale, ln_bias,
                residual=residual.reshape(-1, hd), lin_bias=bias, eps=eps)
            return y.reshape(x.shape)
        _warn_dense(
            "fused_bias_dropout_residual_layer_norm needs both ln_scale and "
            "ln_bias (and float32 or bfloat16) for the fused kernel")
    _LAST_PATH = "dense"
    _no_dropout(p, "fused_bias_dropout_residual_layer_norm")
    h = x if bias is None else x + bias
    return _layer_norm_ref(residual + h, None, ln_scale, ln_bias, eps)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """x / sqrt(mean(x², -1) + epsilon), then · weight. bf16 and fp16
    are normalised in f32 and cast back to x's dtype before the weight
    multiplies, as in the reference."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
