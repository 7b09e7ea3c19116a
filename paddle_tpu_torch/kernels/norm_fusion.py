"""Fused LayerNorm with the bias + residual epilogue.

Counterpart: ``paddle_tpu/kernels/norm_fusion.py``: ``_ln_fwd_kernel``
(:82), ``_ln_bwd_kernel`` (:120), ``_ln_fwd`` (:239), ``_ln_bwd`` (:274),
the ``custom_vjp`` assembly (:315) and ``fused_layer_norm_2d`` (:364).
The BatchNorm kernels of that module (:403-) are ROADMAP A8; the dropout
epilogue (the seeded keep-mask of :96-100) is A6b and raises here.

The forward and backward are ``torch.library`` custom ops,
``paddle_tpu_torch::fused_ln_fwd`` → ``(y, mean, rstd)`` and
``paddle_tpu_torch::fused_ln_bwd`` → ``(dh, dres, dbias, dw, db)``,
joined by ``register_autograd``: the backward saves the primal inputs and
the f32 row statistics ``(mean, rstd)`` [R], as the reference saves its
``fused_ln_mean`` / ``fused_ln_rstd`` residuals (:323-327), and recomputes
the normalised row. For CUDA tensors the ops launch the hand-written
Hopper kernels of ``csrc/norm_fusion.cu`` (its header names the TPU
kernels replaced, the bound and the design) or raise; for CPU tensors
they take the plain PyTorch versions ``fused_ln_fwd_ref`` /
``fused_ln_bwd_ref``. ``launches`` counts calls that launch the kernels
(CPU calls do not count); the backward's second launch, which sums the
per-block column partials of dw, db and dbias in a fixed order, counts
under ``fused_ln_bwd``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import vec32 as _vec32
from .flash_attention import _on

__all__ = ["fused_layer_norm_2d", "fused_ln_fwd", "fused_ln_bwd",
           "fused_ln_fwd_ref", "fused_ln_bwd_ref", "launches"]

launches = {"fused_ln_fwd": 0, "fused_ln_bwd": 0}


# ---------------------------------------------------------------------------
# plain versions ([R, H]; the kernels' numerics)
# ---------------------------------------------------------------------------

def _z(h, res, lin_b):
    """The normalised tensor's input in f32: h (+ lin_b) (+ res) (:96-102)."""
    z = h.float()
    if lin_b is not None:
        z = z + lin_b.float()
    if res is not None:
        z = z + res.float()
    return z


def fused_ln_fwd_ref(h, res, lin_b, w, b, eps: float):
    """Plain version of the forward kernel (:94-110): mean, then the
    centred variance, in f32; y in h's dtype, mean and rstd [R] f32."""
    z = _z(h, res, lin_b)
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    y = (zc * rstd) * w.float() + b.float()
    return y.to(h.dtype), mean[:, 0], rstd[:, 0]


def fused_ln_bwd_ref(h, res, lin_b, w, mean, rstd, g):
    """Plain version of the backward kernel (:160-195): returns (dz, dw, db,
    dbias) in f32, dz being both dh and dres before their casts."""
    xhat = (_z(h, res, lin_b) - mean[:, None]) * rstd[:, None]
    gf = g.float()
    gw = gf * w.float()
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * xhat).mean(-1, keepdim=True)
    dz = (gw - c1 - xhat * c2) * rstd[:, None]
    return dz, (gf * xhat).sum(0), gf.sum(0), dz.sum(0)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"ln_fwd": [_P] * 8 + [_I, _I, _F, _P],
             "ln_bwd": [_P] * 11 + [_I, _I, _I, _P]}


@functools.cache
def _lib():
    return _build.library("norm_fusion.cu", _ARGTYPES,
                          ints=("ln_rows_per_part",))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, h, more, vecs):
    """The kernels' contract: h [R, H] float32 or bfloat16; the row tensors
    (``more``) in h's dtype and shape; everything on h's CUDA device and
    contiguous; the [H] vectors (``vecs``) of length H."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{h.dtype}")
    r, hd = h.shape
    for t in more:
        if t.dtype != h.dtype or t.shape != h.shape:
            raise TypeError(f"{name} kernel: {t.dtype} {tuple(t.shape)} beside "
                            f"h's {h.dtype} {tuple(h.shape)} (one dtype and "
                            f"shape for the rows)")
    for t in vecs:
        if tuple(t.shape) != (hd,):
            raise ValueError(f"{name}: vector {tuple(t.shape)} must be ({hd},)")
    for t in (*more, *vecs):
        if t.device != h.device:
            raise ValueError(f"{name}: tensors on {t.device} and {h.device}")
    if not all(t.is_contiguous() for t in (h, *more)):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    return r, hd


def _fwd_cuda(h, res, lin_b, w, b, eps):
    lb, w32, b32 = _vec32(lin_b), _vec32(w), _vec32(b)
    r, hd = _check("fused_ln_fwd", h, () if res is None else (res,),
                   [v for v in (lb, w32, b32) if v is not None])
    y = torch.empty_like(h)
    mean = torch.empty(r, dtype=torch.float32, device=h.device)
    rstd = torch.empty_like(mean)
    _build.call(_lib(), "ln_fwd", h.dtype, h.device, h.data_ptr(), _ptr(res),
                _ptr(lb), w32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), r, hd, float(eps))
    launches["fused_ln_fwd"] += 1
    return y, mean, rstd


def _bwd_cuda(h, res, lin_b, w, mean, rstd, g):
    """(dh, dres or None, dw, db, dbias or None): the rows in h's dtype,
    the column sums f32."""
    lb, w32 = _vec32(lin_b), _vec32(w)
    r, hd = _check("fused_ln_bwd", h, (g,) if res is None else (res, g),
                   [v for v in (lb, w32) if v is not None])
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (r,) \
                or t.device != h.device:
            raise ValueError(f"fused_ln_bwd: mean/rstd must be float32 "
                             f"[{r}] on {h.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    nacc = 2 if lin_b is None else 3
    rows = _lib().ln_rows_per_part()
    dev = h.device
    dh = torch.empty_like(h)
    dres = None if res is None else torch.empty_like(h)
    part = torch.empty((-(-r // rows), nacc, hd), dtype=torch.float32,
                       device=dev)
    sums = torch.empty((nacc, hd), dtype=torch.float32, device=dev)
    _build.call(_lib(), "ln_bwd", h.dtype, dev, h.data_ptr(), _ptr(res),
                _ptr(lb), w32.data_ptr(), mean.contiguous().data_ptr(),
                rstd.contiguous().data_ptr(), g.data_ptr(), dh.data_ptr(),
                _ptr(dres), part.data_ptr(), sums.data_ptr(), r, hd, nacc)
    launches["fused_ln_bwd"] += 1
    return dh, dres, sums[0], sums[1], sums[2] if nacc == 3 else None


# ---------------------------------------------------------------------------
# custom ops + autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op(
    "paddle_tpu_torch::fused_ln_fwd", mutates_args=(),
    schema="(Tensor h, Tensor? res, Tensor? lin_b, Tensor w, Tensor b, "
           "float eps) -> (Tensor, Tensor, Tensor)")
def fused_ln_fwd(h, res, lin_b, w, b, eps):
    """Fused LayerNorm forward on [R, H] → (y in h's dtype, mean [R] f32,
    rstd [R] f32)."""
    if _on(h.device, "fused_ln_fwd"):
        return _fwd_cuda(h, res, lin_b, w, b, eps)
    return fused_ln_fwd_ref(h, res, lin_b, w, b, eps)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_ln_bwd", mutates_args=(),
    schema="(Tensor h, Tensor? res, Tensor? lin_b, Tensor w, Tensor b, "
           "Tensor mean, Tensor rstd, Tensor g) "
           "-> (Tensor, Tensor?, Tensor?, Tensor, Tensor)")
def fused_ln_bwd(h, res, lin_b, w, b, mean, rstd, g):
    """Fused LayerNorm backward → (dh, dres, dbias, dw, db): dh in h's
    dtype, dres in res's (None without a residual), and the f32 column
    sums cast to their primals' dtypes, as the reference's bwd does
    (:334-339; dbias None without a bias)."""
    if _on(h.device, "fused_ln_bwd"):
        dh, dres, dw, db, dbias = _bwd_cuda(h, res, lin_b, w, mean, rstd, g)
    else:
        dz, dw, db, dbias = fused_ln_bwd_ref(h, res, lin_b, w, mean, rstd, g)
        dh = dz.to(h.dtype)
        # a copy: an op's outputs may not alias each other
        dres = None if res is None else dz.to(res.dtype, copy=True)
    # copies: the kernels' column sums are rows of one tensor, and an op's
    # outputs may not alias each other
    return (dh, dres,
            None if lin_b is None else dbias.to(lin_b.dtype, copy=True),
            dw.to(w.dtype, copy=True), db.to(b.dtype, copy=True))


def _setup_context(ctx, inputs, output):
    h, res, lin_b, w, b, eps = inputs
    _, mean, rstd = output
    ctx.save_for_backward(h, res, lin_b, w, b, mean, rstd)


def _backward(ctx, dy, _dmean, _drstd):
    # mean and rstd are residuals for the backward only; fused_layer_norm_2d
    # never returns them, so their cotangents carry nothing
    h, res, lin_b, w, b, mean, rstd = ctx.saved_tensors
    dh, dres, dbias, dw, db = fused_ln_bwd(h, res, lin_b, w, b, mean, rstd,
                                           dy.contiguous())
    return dh, dres, dbias, dw, db, None


fused_ln_fwd.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def fused_layer_norm_2d(h, weight, bias, *, residual=None, lin_bias=None,
                        eps=1e-5, dropout_p=0.0, dropout_seed=None):
    """One-pass fused LayerNorm over a [R, H] view (last-axis norm).

    out = LayerNorm(residual + dropout(h + lin_bias)) * weight + bias with
    f32 statistics whatever the I/O dtype; y in h's dtype. residual and
    lin_bias None skip their stage (plain LayerNorm has neither). The
    reference's checks and messages (:378-383); ``dropout_p > 0`` (the
    seeded keep-mask epilogue) is ROADMAP A6b and raises
    NotImplementedError."""
    if h.ndim != 2:
        raise ValueError(f"fused_layer_norm_2d wants [R, H], got "
                         f"{tuple(h.shape)}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError(
            "fused_layer_norm_2d: dropout_p > 0 requires dropout_seed "
            "(a (2,) int32/uint32 key-data pair)")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "fused_layer_norm_2d: the in-kernel dropout epilogue (the "
            "portable keep-mask hash keyed by the reference's row blocks) "
            "is ROADMAP A6b")

    def c(t):
        return None if t is None else t.contiguous()

    y, _, _ = fused_ln_fwd(h.contiguous(), c(residual), c(lin_bias),
                           weight.contiguous(), bias.contiguous(), float(eps))
    return y
