"""Fused transformer-MLP functionals (kernels/mlp_fusion.py routing).

Counterpart: ``paddle_tpu/nn/functional/mlp.py``, the fused GeLU and
SwiGLU MLP parts: ``last_mlp_path`` / ``reset_last_mlp_path`` (:43-62),
``_fused_mode`` (:65-74), the once-warned dense route (:77-86),
``fused_mlp`` (:185-217), ``fused_swiglu`` (:220-235) and
``fused_attn_proj_residual_layer_norm`` (:238-272), BERT's attention
output projection folded into its post-LN sublayer close.

With ``FLAGS_fused_mlp`` on (the default), the three take the fused
route: on a card the hand-written CUDA kernels, on the CPU their plain
PyTorch versions (as flash attention does). The reference's
``_try_fused`` exception policy is not ported: a kernel that fails to
build or launch raises, nothing falls back. The dense route is taken
only for what the arguments decide: the flag off, a missing bias
(``fused_mlp``; the projection bias or an LN parameter,
``fused_attn_proj_residual_layer_norm``), an ffn dim with no legal tile
(``mlp_eligible``), tensors not all float32 or all bfloat16 (fp16, or
mixed dtypes), or, for the projection-LN, an odd Hout or one wider than
the kernels' shared-memory tile (``proj_ln_eligible``: the reference's
own route when its kernel rejects a shape, ``mlp.py:162-182``), all but
the first with the reference's once-warning. The projection-LN's dense
route is ``linear`` → ``norm._adln_routed``, itself behind
``FLAGS_fused_norm``.

The kernel ops are registered white under the reference's names
(``fused_mlp``, ``fused_swiglu``, ``fused_attn_proj_ln`` and the serving
decode's ``decode_attn_proj``, :142, not differentiable; the engine calls
the decode kernel's wrapper itself); the dense
routes compose the registered ``linear``, ``gelu`` / ``silu`` and
``dropout_raw``, as the reference's do. A route is chosen on the dtypes
its op will see after the AMP cast (``amp_dtypes``).

Dropout takes one ``default_generator`` split per call whenever p > 0,
on every route, as the reference does (:196-197, :251-252). The fused
routes apply the kernels' seeded keep-mask (the fused MLP's to its
output, the backward regenerating it on g; the projection-LN's to the
projection); the dense routes apply the reference's: the fused MLP's
``common._dropout_raw`` to its output (:214-216), the projection-LN's
``norm._adln_routed`` with the same key.
"""
from __future__ import annotations

import warnings

import torch

from ...core.dispatch import amp_dtypes, register_op
from ...core.flags import get_flag
from ...core import generator as gen_mod
from ...kernels._build import kernel_dtypes
from ...kernels.mlp_fusion import (fused_mlp_2d, fused_proj_ln_2d,
                                   fused_swiglu_2d, mlp_eligible,
                                   proj_ln_eligible)
from .activation import gelu, silu
from .common import _dropout_raw, linear
from .norm import _adln_routed

__all__ = ["fused_attn_proj_residual_layer_norm", "fused_mlp",
           "fused_swiglu", "last_mlp_path", "reset_last_mlp_path"]

_LAST_PATH = None
_DENSE_FALLBACK_WARNED = False


def last_mlp_path():
    """The MLP path the most recent ``fused_mlp``, ``fused_swiglu`` or
    ``fused_attn_proj_residual_layer_norm`` call or GPT block took:
    'fused_mlp/cuda', 'fused_swiglu/cuda' or 'fused_proj_ln/cuda' (the
    kernels), the same with '/plain' (their plain versions, CPU tensors)
    or 'dense' (None before any call)."""
    return _LAST_PATH


def reset_last_mlp_path():
    """Clear the introspection state."""
    global _LAST_PATH
    _LAST_PATH = None


def _fused_mode(device: torch.device):
    """'cuda' (the kernels) | 'plain' (CPU tensors) | None (dense)."""
    if not get_flag("fused_mlp"):
        return None
    return "cuda" if device.type == "cuda" else "plain"


def _warn_dense(reason):
    """Loud once: the fused route was asked for but these arguments take
    the dense one."""
    global _DENSE_FALLBACK_WARNED
    if not _DENSE_FALLBACK_WARNED:
        _DENSE_FALLBACK_WARNED = True
        warnings.warn("fused_mlp: taking the dense path: " + reason)


@register_op("decode_attn_proj", amp="white", differentiable=False)
def _decode_attn_proj_op(q, k_pool, v_pool, position, block_table, proj_w,
                         proj_b, block_size, scale):
    """The B=1 serving decode core: paged attention → output projection
    in one kernel (``kernels/mlp_fusion.py`` ``decode_attn_proj``)."""
    from ...kernels.mlp_fusion import decode_attn_proj
    return decode_attn_proj(q, k_pool, v_pool, position, block_table,
                            proj_w, proj_b, block_size=block_size,
                            scale=scale)


@register_op("fused_mlp", amp="white")
def _fused_mlp_op(x, fc1_w, fc1_b, fc2_w, fc2_b, dropout_key, dropout_p,
                  approximate):
    """dropout(gelu(x @ W1 + b1) @ W2 + b2) over x's [R, H] view."""
    h = x.shape[-1]
    y = fused_mlp_2d(x.reshape(-1, h), fc1_w, fc1_b, fc2_w, fc2_b,
                     approximate=approximate, dropout_p=dropout_p,
                     dropout_seed=dropout_key)
    return y.reshape(x.shape)


@register_op("fused_swiglu", amp="white")
def _fused_swiglu_op(x, gate_w, up_w, down_w):
    """(silu(x @ gate) · (x @ up)) @ down over x's [R, H] view."""
    h = x.shape[-1]
    return fused_swiglu_2d(x.reshape(-1, h), gate_w, up_w,
                           down_w).reshape(x.shape)


@register_op("fused_attn_proj_ln", amp="white")
def _fused_proj_ln_op(x, proj_w, proj_b, residual, ln_scale, ln_bias,
                      dropout_key, dropout_p, epsilon):
    """LayerNorm(residual + dropout(x @ W + b)) in one kernel pass."""
    hin, hout = x.shape[-1], residual.shape[-1]
    y = fused_proj_ln_2d(x.reshape(-1, hin), proj_w, proj_b,
                         residual.reshape(-1, hout), ln_scale, ln_bias,
                         eps=epsilon, dropout_p=dropout_p,
                         dropout_seed=dropout_key)
    return y.reshape(residual.shape)


def fused_mlp(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias, *,
              approximate=False, dropout_rate=0.0, training=True,
              name=None):
    """y = dropout(gelu(x @ W1 + b1, approximate) @ W2 + b2) — the
    transformer MLP sublayer, in one kernel pass per direction on the
    fused route. Weight layout [in, out] (nn.Linear); x [..., H]."""
    global _LAST_PATH
    p = float(dropout_rate) if training else 0.0
    dk = gen_mod.default_generator.split_key() if p > 0 else None
    mode = _fused_mode(x.device)
    if mode is not None:
        h = x.shape[-1]
        f = fc1_weight.shape[-1]
        rows = x.numel() // h
        if fc1_bias is None or fc2_bias is None:
            _warn_dense("fused_mlp needs both fc biases for the fused "
                        "kernel")
        elif not mlp_eligible(rows, h, f):
            _warn_dense(f"fused_mlp: ffn dim {f} has no legal tile (needs "
                        f"a divisor that is a multiple of 128, or f <= 512)")
        elif not kernel_dtypes(*(dts := amp_dtypes(
                _fused_mlp_op, x, fc1_weight, fc2_weight))):
            _warn_dense(f"fused_mlp: the kernels take x and the weights all "
                        f"float32 or all bfloat16, got {dts[0]}, {dts[1]}, "
                        f"{dts[2]}")
        else:
            _LAST_PATH = f"fused_mlp/{mode}"
            return _fused_mlp_op(x, fc1_weight, fc1_bias, fc2_weight,
                                 fc2_bias, dk, p, bool(approximate))
    _LAST_PATH = "dense"
    h = gelu(linear(x, fc1_weight, fc1_bias), approximate=approximate)
    h = linear(h, fc2_weight, fc2_bias)
    if p > 0:
        h = _dropout_raw(h, dk, p, True, "upscale_in_train", None)
    return h


def fused_swiglu(x, gate_weight, up_weight, down_weight, name=None):
    """y = (silu(x @ gate) * (x @ up)) @ down — the LLaMA SwiGLU MLP (no
    biases), in one kernel pass per direction on the fused route. Weight
    layout [in, out]; x [..., H]."""
    global _LAST_PATH
    mode = _fused_mode(x.device)
    if mode is not None:
        h = x.shape[-1]
        f = gate_weight.shape[-1]
        if not mlp_eligible(x.numel() // h, h, f):
            _warn_dense(f"fused_swiglu: intermediate dim {f} has no legal "
                        f"tile")
        elif not kernel_dtypes(*(dts := amp_dtypes(
                _fused_swiglu_op, x, gate_weight, up_weight, down_weight))):
            _warn_dense(f"fused_swiglu: the kernels take x and the weights "
                        f"all float32 or all bfloat16, got "
                        f"{', '.join(map(str, dts))}")
        else:
            _LAST_PATH = f"fused_swiglu/{mode}"
            return _fused_swiglu_op(x, gate_weight, up_weight, down_weight)
    _LAST_PATH = "dense"
    return linear(silu(linear(x, gate_weight)) * linear(x, up_weight),
                  down_weight)


def fused_attn_proj_residual_layer_norm(x, proj_weight, proj_bias,
                                        residual, ln_scale, ln_bias,
                                        dropout_rate=0.0, ln_epsilon=1e-5,
                                        training=True, name=None):
    """out = LayerNorm(residual + dropout(x @ W + b)): the attention output
    projection folded into the post-LN sublayer close, one kernel pass per
    direction on the fused route; the projected tensor never exists.
    Weight layout [in, out]; x [..., Hin], residual [..., Hout]. The dense
    route is ``x @ W + b`` → ``norm._adln_routed`` with the same dropout
    key (one generator split per call while training at p > 0)."""
    global _LAST_PATH
    p = float(dropout_rate) if training else 0.0
    dk = gen_mod.default_generator.split_key() if p > 0 else None
    eps = float(ln_epsilon)
    mode = _fused_mode(x.device)
    if mode is not None:
        hout = residual.shape[-1]
        if proj_bias is None or ln_scale is None or ln_bias is None:
            _warn_dense("fused_attn_proj_residual_layer_norm needs "
                        "proj_bias, ln_scale and ln_bias for the fused "
                        "kernel")
        elif not kernel_dtypes(*(dts := amp_dtypes(
                _fused_proj_ln_op, x, proj_weight, residual))):
            _warn_dense(f"fused_attn_proj_residual_layer_norm: the kernels "
                        f"take x, the weight and the residual all float32 "
                        f"or all bfloat16, got {dts[0]}, {dts[1]}, {dts[2]}")
        elif not proj_ln_eligible(hout, dts[0]):
            _warn_dense(f"fused_attn_proj_residual_layer_norm: Hout={hout} "
                        f"is odd or wider than the kernels' shared-memory "
                        f"row tile")
        else:
            _LAST_PATH = f"fused_proj_ln/{mode}"
            return _fused_proj_ln_op(x, proj_weight, proj_bias, residual,
                                     ln_scale, ln_bias, dk, p, eps)
    _LAST_PATH = "dense"
    return _adln_routed(linear(x, proj_weight, proj_bias), residual, None,
                        ln_scale, ln_bias, dk, p, eps)
