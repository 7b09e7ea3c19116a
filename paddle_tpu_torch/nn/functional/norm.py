"""Normalisation functionals.

Counterpart: ``paddle_tpu/nn/functional/norm.py``: ``last_norm_path`` /
``reset_last_norm_path`` (:29-46), ``_fused_mode`` (:49), the once-warned
dense route (:61-69), the dense ``_bn_infer`` (:76), ``_bn_train`` (:92)
and ``_layer_norm_ref`` (:109), ``layer_norm`` (:190),
``fused_bias_dropout_residual_layer_norm`` (:219) with its routing body
``_adln_routed`` (:244), ``_apply_epilogue`` (:273), ``batch_norm_act``
(:282), ``batch_norm`` (:351), ``instance_norm`` (:373-439),
``group_norm`` (:442), ``rms_norm`` (:466, the LLaMA norm, a black op as
in the reference) and ``local_response_norm`` (:478).

With ``FLAGS_fused_norm`` on (the default), ``layer_norm`` and the
bias→residual-add→LN close take the fused route through
``kernels/norm_fusion.py`` (TPU kernels 13, 14), and so does every
train-mode ``batch_norm_act`` / ``batch_norm`` on a channel-second layout
with C % 8 == 0 (TPU kernels 15-18, the residual add and ReLU in the
kernels' epilogue): on a card the hand-written CUDA kernels, on the CPU
their plain PyTorch versions (as the MLP functionals do). The
reference's exception policy (a failed kernel falls back to the dense
path) is not ported: a kernel that fails to build or launch raises. The
dense route is taken only for what the arguments decide: the flag off,
eval mode (``use_global_stats``), a missing affine parameter, a
normalized_shape over more than the last axis, a channels-last BatchNorm,
C % 8 != 0 or a dtype the kernels do not take (float32 and bfloat16), all
but the first two with the reference's once-warning.

The ops are registered under the reference's names and AMP categories:
the dense ``layer_norm``, ``batch_norm_train`` and ``batch_norm_infer``
black (f32 in and out under AMP), the fused ``fused_layer_norm``,
``fused_bias_dropout_residual_ln`` and ``fused_bn_train`` white (the
low dtype in and out, f32 statistics inside the kernels: under O2 the
BatchNorm's weight and bias reach the kernels in bf16). A route is chosen
on the dtypes its op will see after the AMP cast (``amp_dtypes``); the
residual add of the dense epilogue and of the dense add → LN close is
``ops.add``.

The BatchNorm running statistics follow Paddle: ``running = m·running +
(1 − m)·batch`` with ``momentum`` m (0.9 keeps 90% of the old value) and
the biased batch variance, updated in place under ``torch.no_grad()``.
The dense BatchNorm takes its statistics in f32 and returns x's dtype
(f32 under AMP, where the op is black).

Dropout in the add → LN close takes one ``default_generator`` split per
call whenever p > 0, on every route (:239-241): on the fused route the
kernels' seeded keep-mask epilogue, on the dense route
``common._dropout_raw`` with the same key (:266-268). The two routes draw
different masks, in the reference too.
"""
from __future__ import annotations

import warnings

import torch

from ...core.dispatch import amp_dtypes, register_op
from ...core.flags import get_flag
from ...core import generator as gen_mod
from ...kernels._build import kernel_dtypes
from ...kernels.norm_fusion import (bn_eligible, fused_batch_norm_train,
                                    fused_layer_norm_2d)
from ...ops.math import add
from .activation import relu
from .common import _dropout_raw

__all__ = ["batch_norm", "batch_norm_act",
           "fused_bias_dropout_residual_layer_norm", "group_norm",
           "instance_norm", "last_norm_path", "layer_norm",
           "local_response_norm", "reset_last_norm_path", "rms_norm"]

_LAST_PATH = None
_DENSE_FALLBACK_WARNED = False


def last_norm_path():
    """The normalisation path the most recent ``layer_norm``,
    ``fused_bias_dropout_residual_layer_norm``, ``batch_norm`` or
    ``batch_norm_act`` call took: 'fused_ln/cuda', 'fused_adln/cuda' or
    'fused_bn/cuda' (the kernels), the same with '/plain' (their plain
    versions, CPU tensors) or 'dense' (None before any call)."""
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


@register_op("layer_norm", amp="black")
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


@register_op("fused_layer_norm", amp="white")
def _fused_layer_norm_op(x, weight, bias, epsilon):
    """The fused LayerNorm over the last axis of x (its [R, H] view)."""
    hd = x.shape[-1]
    return fused_layer_norm_2d(x.reshape(-1, hd), weight, bias,
                               eps=epsilon).reshape(x.shape)


@register_op("fused_bias_dropout_residual_ln", amp="white")
def _fused_adln_op(x, residual, bias, ln_scale, ln_bias, dropout_key,
                   dropout_p, epsilon):
    """LayerNorm(residual + dropout(bias + x)) in one kernel pass;
    ``dropout_key`` the drawn split (None at p = 0)."""
    hd = x.shape[-1]
    y = fused_layer_norm_2d(
        x.reshape(-1, hd), ln_scale, ln_bias,
        residual=residual.reshape(-1, hd), lin_bias=bias, eps=epsilon,
        dropout_p=dropout_p, dropout_seed=dropout_key)
    return y.reshape(x.shape)


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
                and x.ndim >= 1 and kernel_dtypes(
                    *amp_dtypes(_fused_layer_norm_op, x)):
            _LAST_PATH = f"fused_ln/{mode}"
            return _fused_layer_norm_op(x, weight, bias, float(epsilon))
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
    One generator split per call while training at p > 0."""
    p = float(dropout_rate) if training else 0.0
    dk = gen_mod.default_generator.split_key() if p > 0 else None
    return _adln_routed(x, residual, bias, ln_scale, ln_bias, dk, p,
                        float(ln_epsilon))


def _adln_routed(x, residual, bias, ln_scale, ln_bias, dk, p, eps):
    """Routing body of ``fused_bias_dropout_residual_layer_norm`` after the
    generator split, shared with ``fused_attn_proj_residual_layer_norm``'s
    dense route, which passes its own key (the reference's :244-268).
    ``dk`` is the drawn dropout key, None at p = 0."""
    global _LAST_PATH
    mode = _fused_mode(x.device)
    if mode is not None:
        if ln_scale is not None and ln_bias is not None \
                and kernel_dtypes(*amp_dtypes(_fused_adln_op, x)):
            _LAST_PATH = f"fused_adln/{mode}"
            return _fused_adln_op(x, residual, bias, ln_scale, ln_bias, dk,
                                  p, eps)
        _warn_dense(
            "fused_bias_dropout_residual_layer_norm needs both ln_scale and "
            "ln_bias (and float32 or bfloat16) for the fused kernel")
    _LAST_PATH = "dense"
    h = x if bias is None else add(x, bias)
    if p > 0:
        h = _dropout_raw(h, dk, p, True, "upscale_in_train", None)
    return _layer_norm_ref(add(residual, h), None, ln_scale, ln_bias, eps)


def _chan_shape(x, ch_axis):
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _compute_dtype(x):
    """f32 for the 16-bit types, else x's own (f32, f64)."""
    return torch.promote_types(x.dtype, torch.float32)


@register_op("batch_norm_infer", amp="black")
def _bn_infer(x, mean, var, weight, bias, epsilon, ch_axis):
    """The dense eval-mode BatchNorm (:76-89): (x − mean) / sqrt(var + ε)
    · weight + bias with the given statistics, in f32 (f64 for f64 x),
    returned in x's dtype."""
    shape = _chan_shape(x, ch_axis)
    ct = _compute_dtype(x)
    out = (x.to(ct) - mean.to(ct).reshape(shape)) / torch.sqrt(
        var.to(ct).reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.to(ct).reshape(shape)
    if bias is not None:
        out = out + bias.to(ct).reshape(shape)
    return out.to(x.dtype)


@register_op("batch_norm_train", amp="black", multi_out=True)
def _bn_train(x, weight, bias, epsilon, ch_axis):
    """The dense train-mode BatchNorm (:92-106): the batch mean and the
    biased (centred, two-pass) variance over every axis but the channel's,
    in f32 (f64 for f64 x); returns (out in x's dtype, mean, var)."""
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    ct = _compute_dtype(x)
    xf = x.to(ct)
    mean = xf.mean(axes)
    var = xf.var(axes, unbiased=False)
    shape = _chan_shape(x, ch_axis)
    out = (xf - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.to(ct).reshape(shape)
    if bias is not None:
        out = out + bias.to(ct).reshape(shape)
    return out.to(x.dtype), mean, var


@register_op("fused_bn_train", amp="white", multi_out=True)
def _fused_bn_op(x, residual, weight, bias, epsilon, fuse_relu):
    """The fused BatchNorm-train (+ residual + ReLU) on a channel-second
    x: (out, mean, var), the statistics f32; a missing weight or bias is
    f32 ones or zeros, made after the AMP cast as the reference makes
    them."""
    c = x.shape[1]
    w = (torch.ones(c, dtype=torch.float32, device=x.device)
         if weight is None else weight)
    b = (torch.zeros(c, dtype=torch.float32, device=x.device)
         if bias is None else bias)
    return fused_batch_norm_train(x, w, b, residual=residual, eps=epsilon,
                                  fuse_relu=fuse_relu)


def _apply_epilogue(out, activation, residual):
    if residual is not None:
        out = add(out, residual)
    if activation == "relu":
        out = relu(out)
    return out


def batch_norm_act(x, running_mean, running_var, weight=None, bias=None,
                   training=False, momentum=0.9, epsilon=1e-5,
                   data_format="NCHW", use_global_stats=None,
                   activation=None, residual=None, name=None):
    """batch_norm with an optional fused epilogue: ``residual`` (x's shape)
    adds to the normalised output BEFORE the activation, the ResNet block
    order relu(bn(conv(x)) + identity); ``activation`` None or 'relu'. On
    the fused route the normalised value and the pre-activation never reach
    device memory; the dense route composes the same epilogue. In training
    (``use_global_stats`` False; its default is ``not training``) the
    running statistics, when given, take the Paddle update."""
    global _LAST_PATH
    if activation not in (None, "relu"):
        raise ValueError(
            f"batch_norm_act: unsupported activation {activation!r} "
            "(None or 'relu')")
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        _LAST_PATH = "dense"
        out = _bn_infer(x, running_mean, running_var, weight, bias,
                        float(epsilon), ch_axis)
        return _apply_epilogue(out, activation, residual)
    stats = None
    mode = _fused_mode(x.device)
    if mode is not None:
        if (ch_axis == 1 and x.ndim >= 2
                and kernel_dtypes(*amp_dtypes(_fused_bn_op, x))
                and bn_eligible(int(x.shape[1]))):
            _LAST_PATH = f"fused_bn/{mode}"
            stats = _fused_bn_op(x, residual, weight, bias, float(epsilon),
                                 activation == "relu")
        else:
            _warn_dense(
                "batch_norm shape not eligible for the fused kernel (needs "
                "a float32 or bfloat16 channel-second layout with "
                "C % 8 == 0)")
    if stats is not None:
        out, batch_mean, batch_var = stats
    else:
        _LAST_PATH = "dense"
        out, batch_mean, batch_var = _bn_train(x, weight, bias,
                                               float(epsilon), ch_axis)
        out = _apply_epilogue(out, activation, residual)
    if running_mean is not None:
        m = float(momentum)
        with torch.no_grad():
            # Paddle: running = momentum·running + (1 − momentum)·batch
            running_mean.copy_(running_mean * m + batch_mean * (1 - m))
            running_var.copy_(running_var * m + batch_var * (1 - m))
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Paddle's batch_norm: ``batch_norm_act`` with no epilogue."""
    return batch_norm_act(x, running_mean, running_var, weight, bias,
                          training, momentum, epsilon, data_format,
                          use_global_stats, None, None, name)


_CHANNEL_FORMATS = ("NCL", "NCHW", "NCDHW", "NLC", "NHWC", "NDHWC", "NC")


def _check_data_format(where, data_format):
    if data_format not in _CHANNEL_FORMATS:
        raise ValueError(
            f"{where}: data_format must be one of {_CHANNEL_FORMATS}, "
            f"got {data_format!r}")


@register_op("instance_norm", amp="black")
def _instance_norm_ref(x, weight=None, bias=None, eps=1e-5,
                       data_format="NCHW"):
    """(x − mean) / sqrt(var + ε) over each instance's spatial axes, then
    the per-channel weight and bias."""
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    axes = (tuple(range(2, x.ndim)) if ch_axis == 1
            else tuple(range(1, x.ndim - 1)))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    shape = _chan_shape(x, ch_axis)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Instance normalisation. With ``use_input_stats`` (the default) each
    instance's own statistics normalise, and running statistics, when
    given, take ``momentum·running + (1 − momentum)·(the batch mean of
    the instance statistics)``; without it the given running statistics
    normalise per channel."""
    _check_data_format("instance_norm", data_format)
    if (running_mean is None) != (running_var is None):
        raise ValueError(
            "instance_norm: running_mean and running_var must be provided "
            "together")
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    if not use_input_stats:
        if running_mean is None:
            raise ValueError(
                "instance_norm: use_input_stats=False requires "
                "running_mean and running_var")
        return _bn_infer(x, running_mean, running_var, weight, bias,
                         float(eps), ch_axis)
    out = _instance_norm_ref(x, weight, bias, float(eps), data_format)
    if running_mean is not None:
        if not (isinstance(running_mean, torch.Tensor)
                and isinstance(running_var, torch.Tensor)):
            raise ValueError(
                "instance_norm: running stats must be Tensors to receive "
                "the EMA update (use_input_stats=True)")
        axes = tuple(i for i in range(x.ndim) if i not in (0, ch_axis))
        m = float(momentum)
        with torch.no_grad():
            xd = x.detach()
            running_mean.copy_(running_mean * m
                               + xd.mean(axes).mean(0) * (1 - m))
            running_var.copy_(running_var * m
                              + xd.var(axes, unbiased=False).mean(0)
                              * (1 - m))
    return out


@register_op("group_norm", amp="black")
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    last = data_format != "NCHW" and data_format.endswith("C")
    if last:
        x = x.movedim(-1, 1)
    n, c = x.shape[:2]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(axes, keepdim=True)
    var = xg.var(axes, unbiased=False, keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    shape = (1, c) + (1,) * len(spatial)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.movedim(1, -1) if last else out


@register_op("rms_norm", amp="black")
def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """x / sqrt(mean(x², -1) + epsilon), then · weight. bf16 and fp16
    are normalised in f32 and cast back to x's dtype before the weight
    multiplies, as in the reference."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


@register_op("local_response_norm", amp="black")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + α·Σ x²)^β, the sum over a window of ``size`` channels
    (size // 2 before, the rest after)."""
    _check_data_format("local_response_norm", data_format)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    sq = x.square()
    c = x.shape[1]
    half = size // 2
    pads = [0, 0] * (x.ndim - 2) + [half, size - half - 1]
    padded = torch.nn.functional.pad(sq, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded[:, i:i + c]
    out = x / (k + alpha * acc) ** beta
    return out.movedim(1, -1) if last else out
