"""Fused LayerNorm with the bias + residual epilogue, and fused
BatchNorm-train with the residual + ReLU epilogue.

Counterpart: ``paddle_tpu/kernels/norm_fusion.py``: ``_ln_fwd_kernel``
(:82), ``_ln_bwd_kernel`` (:120), ``_ln_fwd`` (:239), ``_ln_bwd`` (:274),
the ``custom_vjp`` assembly (:315) and ``fused_layer_norm_2d`` (:364);
``_bn_stats_kernel`` (:403), ``_bn_apply_kernel`` (:428),
``_bn_bwd_reduce_kernel`` (:455), ``_bn_bwd_apply_kernel`` (:487),
``_bn_fwd`` (:521), ``_make_fused_bn`` (:561), ``bn_block_c``'s
eligibility rule (:639-640) and ``fused_batch_norm_train`` (:658). The
LayerNorm's dropout epilogue (:104-107, :162-175): z = where(keep, (h +
lin_b) · f32(1 / (1 − p)), 0) + res in the forward; in the backward dres
= dz, dh = where(keep, dz · f32(1 / (1 − p)), 0) and dlin_b = Σ dh. The
mask is ``flash_attention.py``'s hash keyed as the reference keys it,
(row // block_r, 0, 0) with the index (row % block_r)·H + c, block_r
being the reference's row tile (``_auto_block_r`` :343, the tuning
table's entries included), whatever rows a CUDA block owns; the
backward regenerates it from the seed pair. ``bn_block_c``'s
channel-block picks, its autotune lookup and ``_BN_VMEM_TARGET`` tune
the TPU kernels and are not ported.

Each direction of each norm is a ``torch.library`` custom op, the two
joined by ``register_autograd``:

- ``paddle_tpu_torch::fused_ln_fwd`` → ``(y, mean, rstd)`` and
  ``paddle_tpu_torch::fused_ln_bwd`` → ``(dh, dres, dbias, dw, db)``: the
  backward saves the primal inputs and the f32 row statistics ``(mean,
  rstd)`` [R], as the reference saves its ``fused_ln_mean`` /
  ``fused_ln_rstd`` residuals (:323-327), and recomputes the normalised
  row (and the dropout mask, from the key it was given);
- ``paddle_tpu_torch::fused_bn_fwd`` → ``(y, mean, var)``, f32 batch
  statistics with the biased variance, and
  ``paddle_tpu_torch::fused_bn_bwd`` → ``(dx, dres, dw, db)``: the
  backward saves x, the residual, w, b and the f32 ``mean`` and ``var``
  [C] (the reference saves ``mean`` and ``rstd``, :616-619: the kernels
  recompute ``rstd = rsqrt(var + eps)`` with the forward's own
  expression, so that a = w·rstd and b′ = b − mean·a, and with them the
  ReLU gate, are the forward's bit for bit), never y or the
  pre-activation. The cotangents of ``mean`` and ``var`` fold into dx as
  :576-581 folds them; absent, they are zero. The weight and bias come
  in f32 or, where AMP's white ``fused_bn_train`` cast them (O2), both in
  bf16: the kernels read them in their own dtype and convert on load (no
  conversion launch), and dw and db leave as the f32 sums cast to w's
  and b's dtypes (:604-606), so a bf16 weight's gradient is bf16-rounded
  before the AMP cast's backward turns it f32, as in the reference.

For CUDA tensors the ops launch the hand-written Hopper kernels of
``csrc/norm_fusion.cu`` (its notes name the TPU kernels replaced, the
bound and the design) or raise. The LayerNorm backward has two routes,
picked by ``ln_bwd_route`` from the dtype, H and the alignment:
``persistent`` (float32 or bfloat16 rows of whole aligned 16-byte
vectors, at most 32 elements a lane: two blocks an SM, each over a
contiguous run of rows, ``ln_bwd_plan``; the next row in flight while a
warp computes the current one; the column sums in registers across the
run, one partial row a block) and ``generic`` (the 32-row kernels: every
other shape); ``ln_bwd_routes`` counts CUDA calls by route. The
BatchNorm forward takes the ``cluster`` route for every call the op takes
(``bn_fwd_route``): one launch of thread-block clusters, each holding a
slab of channels (``bn_fwd_plan``) in its CTAs' shared memory, so that x
is read once where it fits (the stems re-read what does not); the CTAs
meet at a cluster barrier and fold their partial sums over distributed
shared memory in rank order; the ``generic`` kernels stay reachable only
by naming them (``_bn_fwd_cuda(..., route="generic")``);
``bn_fwd_routes`` counts CUDA calls by route. The BatchNorm backward
takes the ``persistent`` route for every call the op takes
(``bn_bwd_route``): one cooperative launch that works through the
channels group by group (``bn_bwd_plan``): each block reduces its tile of
a group, the block that finishes a group last folds it, every block then
applies its tile; a tile's first vectors come through a shared-memory
slot, loaded while the block works on the group before, and so are read
once, the rest is read again from device memory by the apply (the
measured-fastest split, ``BN_L2_BYTES``); the ``generic`` kernels
(reduction, ``sum_parts``, fold, apply) stay reachable only by naming
them (``_bn_bwd_cuda(..., route="generic")``) for an in-call comparison;
``bn_bwd_routes`` counts CUDA calls by route.
For CPU tensors they take the plain PyTorch versions ``fused_ln_fwd_ref``
/ ``fused_ln_bwd_ref`` and ``fused_bn_fwd_ref`` / ``fused_bn_bwd_ref``.
``launches`` counts calls that launch the kernels (CPU calls do not
count), one per op call: the LayerNorm backward's second launch (the
fixed-order sum of its column partials) counts under ``fused_ln_bwd``,
the generic BatchNorm forward's four launches (reduction, ``sum_parts``,
the per-channel fold, apply) count once, and so does the backward's
memset of its counters and its one launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from ..analysis import autotune
from ._build import vec32 as _vec32
from .flash_attention import (DropKey, _ceil_to, _drop_args, _on, drop_key,
                              row_bits_ref)
from .flash_attention import seed_pair as _seed_pair

__all__ = ["bn_bwd_plan", "bn_bwd_route", "bn_bwd_routes", "bn_bwd_tiles",
           "bn_eligible", "bn_fwd_bytes", "bn_fwd_plan", "bn_fwd_route",
           "bn_fwd_routes", "bn_fwd_tiles", "bn_tiles", "dropout_launches",
           "fused_batch_norm_train",
           "fused_bn_bwd", "fused_bn_bwd_ref", "fused_bn_fwd",
           "fused_bn_fwd_ref", "fused_layer_norm_2d", "fused_ln_fwd",
           "fused_ln_bwd", "fused_ln_fwd_ref", "fused_ln_bwd_ref", "launches",
           "ln_block_r", "ln_bwd_parts", "ln_bwd_plan", "ln_bwd_route",
           "ln_bwd_routes", "row_keep_ref"]

launches = {"fused_ln_fwd": 0, "fused_ln_bwd": 0, "fused_bn_fwd": 0,
            "fused_bn_bwd": 0}
# launches of the LayerNorm kernels' dropout variants (``launches`` counts
# the dropout-free ones)
dropout_launches = {"fused_ln_fwd": 0, "fused_ln_bwd": 0}


_LN_VMEM_TARGET = 512 * 1024   # :59, the heuristic's row-tile target


def ln_block_r(r: int, hd: int, dtype=None) -> int:
    """``_auto_block_r`` (:343): the reference's LayerNorm row tile, which
    keys the dropout mask: an exact tuning-table hit (one that is not a
    positive multiple of 8 within the padded rows raises), else
    min(128, the VMEM target's rows, the rows rounded up to 8)."""
    hit = autotune.lookup("fused_ln", autotune.ln_sig(r, hd, dtype))
    if hit is not None:
        br = int(hit["block_r"])
        if br <= 0 or br % 8 or br > _ceil_to(r, 8):
            raise ValueError(
                f"tuning-table fused_ln entry block_r={br} cannot tile "
                f"r={r} (needs a positive multiple of 8, <= padded rows) "
                f"— regenerate the table (scripts/autotune.py search) or "
                f"set FLAGS_kernel_tuning=0")
        return br
    cap = max(8, (_LN_VMEM_TARGET // (4 * hd)) // 8 * 8)
    return min(128, cap, _ceil_to(r, 8))


def row_keep_ref(drop: DropKey, x):
    """The keep-mask of the row matrix x [R, H] under row tiles."""
    return row_bits_ref(drop, x.shape[0], x.shape[1], x.device) \
        < drop.threshold


def _dropped(x, drop: Optional[DropKey]):
    """where(keep, x · f32(1 / (1 − p)), 0) (:107, :175), x f32."""
    if drop is None:
        return x
    return torch.where(row_keep_ref(drop, x), x * drop.inv_f32(x.device),
                       0.0)


# ---------------------------------------------------------------------------
# plain versions ([R, H]; the kernels' numerics)
# ---------------------------------------------------------------------------

def _z(h, res, lin_b, drop=None):
    """The normalised tensor's input in f32: dropout(h (+ lin_b)) (+ res)
    (:96-108)."""
    z = h.float()
    if lin_b is not None:
        z = z + lin_b.float()
    z = _dropped(z, drop)
    if res is not None:
        z = z + res.float()
    return z


def fused_ln_fwd_ref(h, res, lin_b, w, b, eps: float,
                     drop: Optional[DropKey] = None):
    """Plain version of the forward kernel (:94-117): mean, then the
    centred variance, in f32; y in h's dtype, mean and rstd [R] f32."""
    z = _z(h, res, lin_b, drop)
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    y = (zc * rstd) * w.float() + b.float()
    return y.to(h.dtype), mean[:, 0], rstd[:, 0]


def fused_ln_bwd_ref(h, res, lin_b, w, mean, rstd, g,
                     drop: Optional[DropKey] = None):
    """Plain version of the backward kernel (:160-195): returns (dz, dw, db,
    dbias) in f32, dz being dres before its cast, and dh without dropout
    (with it, dh is ``_dropped(dz, drop)``, whose column sum dbias is)."""
    xhat = (_z(h, res, lin_b, drop) - mean[:, None]) * rstd[:, None]
    gf = g.float()
    gw = gf * w.float()
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * xhat).mean(-1, keepdim=True)
    dz = (gw - c1 - xhat * c2) * rstd[:, None]
    return dz, (gf * xhat).sum(0), gf.sum(0), _dropped(dz, drop).sum(0)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the dropout key: s0, s1, threshold, 1 / (1 - p), the reference's block_r
# and H (block_r 0: no dropout)
_DROP = [_U] * 3 + [_F, _I, _I]
_ARGTYPES = {"ln_fwd": [_P] * 8 + [_I, _I, _F] + _DROP + [_P],
             "ln_bwd": [_P] * 11 + [_I, _I, _I] + _DROP + [_P],
             "ln_bwd_persist": [_P] * 11 + [_I, _I, _I] + _DROP + [_I, _P],
             # ..., n, c, hw, eps, relu, vbf16 (w and b bf16)
             "fused_bn_fwd": [_P] * 9 + [_I, _I, _I, _F, _I, _I, _P],
             "fused_bn_bwd": [_P] * 15 + [_I, _I, _I, _F, _I, _I, _P],
             # fused_bn_bwd's tensors with one scratch and the bf16 dw, db
             # (or null), then n, c, hw, eps, relu, skip, vbf16
             "fused_bn_bwd_persist": [_P] * 14 + [_I, _I, _I, _F, _I, _I, _I,
                                                   _P],
             # x, res, w, b, y, mean, var, then n, c, hw, eps, relu, skip,
             # vbf16
             "fused_bn_fwd_cluster": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _I,
                                                   _P]}


@functools.cache
def _lib():
    lib = _build.library("norm_fusion.cu", _ARGTYPES,
                         ints=("ln_rows_per_part",))
    lib.fused_bn_parts.argtypes = [_I, _I]
    lib.fused_bn_parts.restype = _I
    lib.fused_bn_bwd_plan.argtypes = [_I] * 6 + [_P]
    lib.fused_bn_bwd_plan.restype = _I
    lib.fused_bn_fwd_plan.argtypes = [_I] * 6 + [_P]
    lib.fused_bn_fwd_plan.restype = _I
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"fused_bn_fwd_clusters_{suffix}")
        fn.argtypes, fn.restype = [_I] * 4 + [_P], _I
    return lib


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


def _fwd_cuda(h, res, lin_b, w, b, eps, drop=None):
    lb, w32, b32 = _vec32(lin_b), _vec32(w), _vec32(b)
    r, hd = _check("fused_ln_fwd", h, () if res is None else (res,),
                   [v for v in (lb, w32, b32) if v is not None])
    y = torch.empty_like(h)
    mean = torch.empty(r, dtype=torch.float32, device=h.device)
    rstd = torch.empty_like(mean)
    _build.call(_lib(), "ln_fwd", h.dtype, h.device, h.data_ptr(), _ptr(res),
                _ptr(lb), w32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), r, hd, float(eps),
                *_drop_args(drop))
    (launches if drop is None else dropout_launches)["fused_ln_fwd"] += 1
    return y, mean, rstd


# the persistent route's lanes: at most LN_LANE_ELEMS elements of a row a
# lane (kBwdMaxElems), in 1, 2, 3, 4, 6 or 8 16-byte vectors
LN_LANE_ELEMS = 32
LN_LANE_VECTORS = (1, 2, 3, 4, 6, 8)
LN_BLOCKS_PER_SM = 2            # kPersistBlocksPerSm
LN_WARPS = 8                    # warps a block (kWarps)


def ln_bwd_route(dtype, hd: int, aligned: bool) -> str:
    """The LayerNorm backward kernels a CUDA call takes: ``"persistent"``
    for float32 or bfloat16 rows of whole 16-byte vectors that fit a
    lane's ``LN_LANE_ELEMS`` elements (bf16 and f32 H up to 1024; bf16 H
    768 is 3 vectors a lane) with h, res and g 16-byte aligned
    (``aligned``), else ``"generic"``."""
    if dtype not in (torch.float32, torch.bfloat16) or not aligned:
        return "generic"
    v = 16 // (2 if dtype == torch.bfloat16 else 4)
    if hd < 1 or hd % v:
        return "generic"
    per_lane = -(-(hd // v) // 32)
    nv = next((n for n in LN_LANE_VECTORS if per_lane <= n), None)
    return "persistent" if nv is not None and nv * v <= LN_LANE_ELEMS \
        else "generic"


def ln_bwd_parts(r: int, sms: int) -> int:
    """The persistent route's blocks, one partial row each: two an SM,
    fewer where R is short, none empty."""
    if r < 1 or sms < 1:
        raise ValueError(f"ln_bwd_parts: R {r} and SMs {sms} must be >= 1")
    rpb = -(-r // min(LN_BLOCKS_PER_SM * sms, r))
    return -(-r // rpb)


def ln_bwd_plan(r: int, sms: int):
    """The rows of each persistent block, as the kernel reckons them from
    its grid: block b owns [b · rpb, min((b + 1) · rpb, R)), rpb = ceil(R
    / blocks); warp w of a block takes the run's rows w, w + 8, ...
    Returns [(start, stop)] in block order."""
    nparts = ln_bwd_parts(r, sms)
    rpb = -(-r // nparts)
    return [(b * rpb, min((b + 1) * rpb, r)) for b in range(nparts)]


# CUDA calls of the LayerNorm backward by route (dropout variants included)
ln_bwd_routes = {"persistent": 0, "generic": 0}


_sm_counts: dict = {}


def _sm_count(dev) -> int:
    n = _sm_counts.get(dev)
    if n is None:
        n = _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _bwd_part(lib, route, r, hd, nacc, dev):
    """The column sums' partial rows, f32 [blocks, nacc, H]: the
    persistent kernel's grid (``ln_bwd_parts``, the grid the kernel is
    launched with), or the generic kernels' one row a 32-row block."""
    if route == "persistent":
        nparts = ln_bwd_parts(r, _sm_count(dev))
    else:
        nparts = -(-r // lib.ln_rows_per_part())
    return torch.empty((nparts, nacc, hd), dtype=torch.float32, device=dev)


def _bwd_cuda(h, res, lin_b, w, mean, rstd, g, drop=None, route=None):
    """(dh, dres or None, dw, db, dbias or None): the rows in h's dtype,
    the column sums f32; on the route ``ln_bwd_route`` picks (``route``
    names one instead: a measurement holds the two on the same inputs)."""
    lb, w32 = _vec32(lin_b), _vec32(w)
    r, hd = _check("fused_ln_bwd", h, (g,) if res is None else (res, g),
                   [v for v in (lb, w32) if v is not None])
    for t in (mean, rstd):
        if t.dtype != torch.float32 or tuple(t.shape) != (r,) \
                or t.device != h.device:
            raise ValueError(f"fused_ln_bwd: mean/rstd must be float32 "
                             f"[{r}] on {h.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    natural = ln_bwd_route(h.dtype, hd, all(
        t.data_ptr() % 16 == 0 for t in (h, res, g) if t is not None))
    if route is None:
        route = natural
    elif route not in ("persistent", "generic"):
        raise ValueError(f"fused_ln_bwd: route {route!r} is 'persistent' or "
                         f"'generic'")
    elif route == "persistent" and natural != "persistent":
        raise ValueError(
            f"fused_ln_bwd: the persistent route takes float32 or bfloat16 "
            f"rows of whole 16-byte vectors, at most {LN_LANE_ELEMS} "
            f"elements a lane, 16-byte aligned; got {h.dtype}, H={hd}")
    lib = _lib()
    nacc = 2 if lin_b is None else 3
    dev = h.device
    part = _bwd_part(lib, route, r, hd, nacc, dev)
    dh = torch.empty_like(h)
    dres = None if res is None else torch.empty_like(h)
    sums = torch.empty((nacc, hd), dtype=torch.float32, device=dev)
    args = (h.data_ptr(), _ptr(res), _ptr(lb), w32.data_ptr(),
            mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
            g.data_ptr(), dh.data_ptr(), _ptr(dres), part.data_ptr(),
            sums.data_ptr(), r, hd, nacc, *_drop_args(drop))
    if route == "persistent":
        _build.call(lib, "ln_bwd_persist", h.dtype, dev, *args,
                    part.shape[0])
    else:
        _build.call(lib, "ln_bwd", h.dtype, dev, *args)
    (launches if drop is None else dropout_launches)["fused_ln_bwd"] += 1
    ln_bwd_routes[route] += 1
    return dh, dres, sums[0], sums[1], sums[2] if nacc == 3 else None


# ---------------------------------------------------------------------------
# custom ops + autograd
# ---------------------------------------------------------------------------

_DROP_SCHEMA = ("float dropout_p=0.0, int seed0=0, int seed1=0, "
                "int block_r=0")


@torch.library.custom_op(
    "paddle_tpu_torch::fused_ln_fwd", mutates_args=(),
    schema="(Tensor h, Tensor? res, Tensor? lin_b, Tensor w, Tensor b, "
           f"float eps, {_DROP_SCHEMA}) -> (Tensor, Tensor, Tensor)")
def fused_ln_fwd(h, res, lin_b, w, b, eps, dropout_p=0.0, seed0=0, seed1=0,
                 block_r=0):
    """Fused LayerNorm forward on [R, H] → (y in h's dtype, mean [R] f32,
    rstd [R] f32); with ``dropout_p > 0`` the mask keyed (seed0, seed1)
    by the row tile block_r."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, h.shape[1],
                    "fused LN dropout")
    if _on(h.device, "fused_ln_fwd"):
        return _fwd_cuda(h, res, lin_b, w, b, eps, drop)
    return fused_ln_fwd_ref(h, res, lin_b, w, b, eps, drop)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_ln_bwd", mutates_args=(),
    schema="(Tensor h, Tensor? res, Tensor? lin_b, Tensor w, Tensor b, "
           f"Tensor mean, Tensor rstd, Tensor g, {_DROP_SCHEMA}) "
           "-> (Tensor, Tensor?, Tensor?, Tensor, Tensor)")
def fused_ln_bwd(h, res, lin_b, w, b, mean, rstd, g, dropout_p=0.0, seed0=0,
                 seed1=0, block_r=0):
    """Fused LayerNorm backward → (dh, dres, dbias, dw, db): dh in h's
    dtype, dres in res's (None without a residual), and the f32 column
    sums cast to their primals' dtypes, as the reference's bwd does
    (:334-339; dbias None without a bias); the forward's dropout mask
    regenerated from its key."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, h.shape[1],
                    "fused LN dropout")
    if _on(h.device, "fused_ln_bwd"):
        dh, dres, dw, db, dbias = _bwd_cuda(h, res, lin_b, w, mean, rstd, g,
                                            drop)
    else:
        dz, dw, db, dbias = fused_ln_bwd_ref(h, res, lin_b, w, mean, rstd, g,
                                             drop)
        dh = _dropped(dz, drop).to(h.dtype)
        # a copy: an op's outputs may not alias each other
        dres = None if res is None else dz.to(res.dtype, copy=True)
    # copies: the kernels' column sums are rows of one tensor, and an op's
    # outputs may not alias each other
    return (dh, dres,
            None if lin_b is None else dbias.to(lin_b.dtype, copy=True),
            dw.to(w.dtype, copy=True), db.to(b.dtype, copy=True))


def _setup_context(ctx, inputs, output):
    h, res, lin_b, w, b, eps, *drop = inputs
    _, mean, rstd = output
    ctx.save_for_backward(h, res, lin_b, w, b, mean, rstd)
    ctx.drop = drop


def _backward(ctx, dy, _dmean, _drstd):
    # mean and rstd are residuals for the backward only; fused_layer_norm_2d
    # never returns them, so their cotangents carry nothing
    h, res, lin_b, w, b, mean, rstd = ctx.saved_tensors
    dh, dres, dbias, dw, db = fused_ln_bwd(h, res, lin_b, w, b, mean, rstd,
                                           dy.contiguous(), *ctx.drop)
    return (dh, dres, dbias, dw, db) + (None,) * 5


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
    reference's checks and messages (:378-383). ``dropout_p > 0``: the
    seeded keep-mask epilogue, keyed by ``dropout_seed`` (two uint32 or
    int32 words) and the reference's row tile (``ln_block_r``)."""
    if h.ndim != 2:
        raise ValueError(f"fused_layer_norm_2d wants [R, H], got "
                         f"{tuple(h.shape)}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError(
            "fused_layer_norm_2d: dropout_p > 0 requires dropout_seed "
            "(a (2,) int32/uint32 key-data pair)")
    drop = ()
    if dropout_p > 0.0:
        drop = (float(dropout_p), *_seed_pair(dropout_seed),
                ln_block_r(*h.shape, h.dtype))

    def c(t):
        return None if t is None else t.contiguous()

    y, _, _ = fused_ln_fwd(h.contiguous(), c(residual), c(lin_bias),
                           weight.contiguous(), bias.contiguous(), float(eps),
                           *drop)
    return y


# ---------------------------------------------------------------------------
# fused BatchNorm-train (+ residual + ReLU epilogue): plain versions
# ([N, C, HW]; the kernels' numerics)
# ---------------------------------------------------------------------------

def bn_eligible(c: int) -> bool:
    """``bn_block_c``'s eligibility rule (:639-640), the routing rule: the
    fused kernels take C % 8 == 0."""
    return c % 8 == 0


def _bn_chan(v):
    return v[None, :, None]


def _bn_fold(w, b, mean, var, eps):
    """rstd = rsqrt(var + eps), a = w·rstd, b′ = b − mean·a (:533-537), f32."""
    rstd = torch.rsqrt(var + eps)
    a = w.float() * rstd
    return rstd, a, b.float() - mean * a


def _bn_pre(xf, res, a, bb):
    pre = xf * _bn_chan(a) + _bn_chan(bb)
    return pre if res is None else pre + res.float()


def fused_bn_fwd_ref(x, res, w, b, eps: float, relu: bool):
    """Plain version of the forward kernels (:403-441, :521-548): the
    per-channel sums of x and x² in f32, mean = Σx / M, the biased one-pass
    variance max(Σx² / M − mean², 0), then y = relu?(x·a + b′ (+ res)) in
    x's dtype; mean and var [C] f32."""
    n, _, hw = x.shape
    xf = x.float()
    inv_m = 1.0 / (n * hw)
    mean = xf.sum((0, 2)) * inv_m
    var = ((xf * xf).sum((0, 2)) * inv_m - mean * mean).clamp_min(0.0)
    _, a, bb = _bn_fold(w, b, mean, var, eps)
    y = _bn_pre(xf, res, a, bb)
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype), mean, var


def fused_bn_bwd_ref(x, res, w, b, mean, var, g, gmean, gvar, eps: float,
                     relu: bool):
    """Plain version of the backward kernels (:444-506, :567-606): g′ = g
    gated by the recomputed pre-activation, Σg′ and Σg′·x̂ per channel, the
    mean and var cotangents (None: zero) folded into p2 and p3; returns (dx,
    g′, dw = Σg′·x̂, db = Σg′), all f32 (g′ is dres before its cast)."""
    n, _, hw = x.shape
    m = float(n * hw)
    xf = x.float()
    rstd, a, bb = _bn_fold(w, b, mean, var, eps)
    gf = g.float()
    if relu:
        gf = torch.where(_bn_pre(xf, res, a, bb) > 0.0, gf, 0.0)
    xhat = (xf - _bn_chan(mean)) * _bn_chan(rstd)
    sum_g = gf.sum((0, 2))
    sum_gx = (gf * xhat).sum((0, 2))
    zero = torch.zeros_like(mean)
    gm = zero if gmean is None else gmean.float()
    gv = zero if gvar is None else gvar.float()
    p2 = 2.0 * gv / m - a * (sum_gx / m) * rstd
    p3 = gm / m - a * (sum_g / m) - mean * p2
    dx = gf * _bn_chan(a) + xf * _bn_chan(p2) + _bn_chan(p3)
    return dx, gf, sum_gx, sum_g


# ---------------------------------------------------------------------------
# fused BatchNorm-train: the CUDA kernels
# ---------------------------------------------------------------------------

def _bn_check(name, x, rows, vecs, wb=()):
    """The kernels' contract: x [N, C, HW] float32 or bfloat16, C % 8 == 0;
    the row tensors (``rows``) in x's dtype and shape; everything on x's
    CUDA device, contiguous and 16-byte aligned; the [C] vectors
    (``vecs``) f32; the weight and bias (``wb``) [C], contiguous, both
    f32 or both bf16 (AMP's white cast)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{name} kernel takes x [N, C, HW], got "
                         f"{tuple(x.shape)}")
    n, c, hw = x.shape
    if not bn_eligible(c) or c > 65535:
        raise ValueError(f"{name} kernel takes C % 8 == 0 and C <= 65535, "
                         f"got C={c}")
    for t in rows:
        if t.dtype != x.dtype or t.shape != x.shape:
            raise TypeError(f"{name} kernel: {t.dtype} {tuple(t.shape)} beside "
                            f"x's {x.dtype} {tuple(x.shape)} (one dtype and "
                            f"shape for x, the residual and g)")
    for t in vecs:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name}: per-channel vectors must be float32 "
                             f"[{c}], got {t.dtype} {tuple(t.shape)}")
    for t in wb:
        if (t.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != wb[0].dtype or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: weight and bias must be contiguous "
                             f"[{c}], both float32 or both bfloat16, got "
                             f"{[(v.dtype, tuple(v.shape)) for v in wb]}")
    for t in (*rows, *vecs, *wb):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in (x, *rows):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             f"aligned tensors")
    return n, c, hw


def _bn_parts(n, hw):
    return _lib().fused_bn_parts(n, hw)


# the cluster forward (csrc/norm_fusion.cu namespace bnf): its constants,
# mirrored by bn_fwd_plan
BNF_MAX_THREADS = 512           # kMaxThreads: a CTA of over half an SM
BNF_SMALL_THREADS = 256         # kSmallThreads: a CTA of at most half
BNF_MAX_C = 256                 # kMaxC: channels a slab holds at most
BNF_MIN_SLAB = 65536            # kMinSlab: bytes of x a slab holds at least
BNF_MIN_CTA_VECS = 1024         # kMinCtaVecs: vectors a CTA at least, K raised
BNF_CTAS_PER_SM = 1             # kCtasPerSm: a CTA's share of an SM
BNF_MAX_CLUSTER = 16            # kMaxCluster: CTAs a cluster at most
BNF_PAR_PER_SM = 1              # kParPerSm: K raised while CTAs < this x SMs
BNF_STAGE_VECS = 2048           # kStageVecs: a chunk of x, a ring stage
BNF_RING = 3                    # kRing: ring stages
BNF_RES_RING = False            # kResRing: the residual through the ring
MAX_SMEM = 232448               # kMaxSmem: dynamic shared memory a block
# kMaxChunks, kScratch: the partials, sums and coefficients [2, 256] f32
# each, the chunks' and the ring's mbarriers (6400 bytes)
BNF_MAX_CHUNKS = -(-(MAX_SMEM // 16) // BNF_STAGE_VECS)
BNF_SCRATCH = (6 * BNF_MAX_C * 4 + 8 * (BNF_MAX_CHUNKS + BNF_RING)
               + 127) // 128 * 128


class BnFwdPlan(NamedTuple):
    n: int
    c: int
    hw: int
    vec: int            # elements a 16-byte vector
    res: bool           # a residual streams through the ring
    unit: int           # cg is a multiple of unit = V / gcd(HW, V)
    cg: int             # channels a slab
    k: int              # CTAs a cluster (= ns * cs)
    ns: int             # image slices
    cs: int             # row-vector slices
    rowv: int           # vectors a slab row holds (cg HW / V)
    cap: int            # resident vectors a CTA at most
    ring_t: int         # tensors a ring stage holds (0: no ring)
    smem: int           # dynamic shared memory a CTA
    slabs: int          # C / cg
    tv: int             # vectors of the largest tile
    stage: int          # vectors a chunk or ring stage
    threads: int        # a CTA's: 256 where two fit an SM, else 512


class BnFwdTile(NamedTuple):
    """CTA ``rank``'s part of a slab: images [n0, n0 + rows) by row
    vectors [v0, v0 + w); its first ``fit`` vectors resident, the rest
    streamed (read twice); channels ch_lo .. ch_lo + nch - 1."""
    rank: int
    n0: int
    rows: int
    v0: int
    w: int
    fit: int
    ch_lo: int
    nch: int


@functools.lru_cache(maxsize=256)
def _bnf_plan(n: int, c: int, hw: int, dtype, res: bool, sms: int,
              ctas_per_sm: int, max_cluster: int, stage: int, ring: int,
              res_ring: bool = BNF_RES_RING,
              small_threads: int = BNF_SMALL_THREADS,
              par_per_sm: int = BNF_PAR_PER_SM,
              min_slab: int = BNF_MIN_SLAB,
              min_cta_vecs: int = BNF_MIN_CTA_VECS) -> BnFwdPlan:
    """``bnf::plan`` under the given design constants. Slabs of cg
    channels: the least multiple of V / gcd(HW, V) dividing C whose slab
    holds ``min_slab`` bytes (at most BNF_MAX_C). K: the least CTAs whose
    shared memory holds a slab (at most ``max_cluster``), raised while the
    grid has fewer CTAs than ``par_per_sm`` x ``sms`` (not below
    ``min_cta_vecs`` vectors a CTA); cut ns = min(N, K) ways over the
    images and the rest over the row. A tile that does not
    fit keeps a whole number of chunks and streams the rest through a ring
    of ``ring`` stages, which also carries the residual where
    ``res_ring`` (else it comes into registers and takes no shared
    memory). A CTA of at most half an SM's shared memory takes
    ``small_threads`` threads, a larger one BNF_MAX_THREADS. The route's
    plan is ``bn_fwd_plan``; the last two arguments let a small tensor
    take a cluster of several CTAs."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if n < 1 or c < 1 or hw < 1 or sms < 1:
        raise ValueError(f"_bnf_plan: N {n}, C {c}, HW {hw}, {sms} SMs")
    unit = vec // math.gcd(hw, vec)
    if c % unit:
        raise ValueError(f"_bnf_plan: C {c} is not a multiple of {unit}")
    esize = 16 // vec
    cg = 0
    for m in range(unit, min(c, BNF_MAX_C) + 1, unit):
        if c % m:
            continue
        cg = m
        if n * m * hw * esize >= min_slab:
            break
    rowv = cg * hw // vec
    slabv = n * rowv
    max_chunks = -(-(MAX_SMEM // 16) // stage)
    scratch = (6 * BNF_MAX_C * 4 + 8 * (max_chunks + ring) + 127) // 128 * 128
    budget = min(MAX_SMEM, 233472 // ctas_per_sm - 1024) - scratch
    ring1 = ring * stage * 16
    in_ring = bool(res) and res_ring
    hold = (budget - (ring1 if in_ring else 0)) // 16
    if hold < stage:
        raise ValueError(f"_bnf_plan: {hold} vectors a CTA")
    slabs = c // cg
    k = min(max_cluster, -(-slabv // hold))
    k = max(k, min(max_cluster, -(-par_per_sm * sms // slabs),
                   slabv // min_cta_vecs), 1)
    ns = min(n, k)
    cs = max(1, min(-(-k // ns), max_cluster // ns, rowv))
    tv = -(-n // ns) * -(-rowv // cs)
    if tv <= hold:
        cap, ring_t = tv, 1 if in_ring else 0
    else:
        ring_t = 2 if in_ring else 1
        cap = (budget - ring_t * ring1) // 16 // stage * stage
        if cap < stage:
            raise ValueError(f"_bnf_plan: {cap} resident vectors")
    smem = scratch + cap * 16 + ring_t * ring1
    threads = small_threads if smem <= 233472 // 2 - 1024 else BNF_MAX_THREADS
    return BnFwdPlan(n, c, hw, vec, bool(res), unit, cg, ns * cs, ns, cs,
                     rowv, cap, ring_t, smem, slabs, tv, stage, threads)


def bn_fwd_plan(n: int, c: int, hw: int, dtype, res: bool,
                sms: int) -> BnFwdPlan:
    """The cluster forward's plan on ``sms`` SMs, as ``bnf::run`` reckons
    it from the kernel's constants."""
    return _bnf_plan(n, c, hw, dtype, bool(res), sms, BNF_CTAS_PER_SM,
                     BNF_MAX_CLUSTER, BNF_STAGE_VECS, BNF_RING)


def bn_fwd_tiles(plan: BnFwdPlan):
    """The tiles of a slab by rank, as the kernel's ``tile_of`` cuts it."""
    out = []
    for rank in range(plan.k):
        i, jc = divmod(rank, plan.cs)
        n0, n1 = i * plan.n // plan.ns, (i + 1) * plan.n // plan.ns
        v0, v1 = jc * plan.rowv // plan.cs, (jc + 1) * plan.rowv // plan.cs
        ch_lo = v0 * plan.vec // plan.hw
        out.append(BnFwdTile(rank, n0, n1 - n0, v0, v1 - v0,
                             min((n1 - n0) * (v1 - v0), plan.cap), ch_lo,
                             (v1 * plan.vec - 1) // plan.hw - ch_lo + 1))
    return out


def bn_fwd_bytes(plan: BnFwdPlan) -> dict:
    """The bytes the cluster forward moves: x's resident part read once
    and the rest twice (the sums, then the apply), the residual read once,
    y written once."""
    tiles = bn_fwd_tiles(plan)
    res_v = sum(t.rows * t.w for t in tiles)
    x_v = sum(t.fit + 2 * (t.rows * t.w - t.fit) for t in tiles)
    per = 16 * plan.slabs
    return dict(x_read=x_v * per, x_once=sum(t.fit for t in tiles) * per,
                res_read=res_v * per if plan.res else 0, y_written=res_v * per)


def bn_fwd_route(dtype, c: int) -> str:
    """The BatchNorm forward kernel a CUDA call takes: ``"cluster"`` for
    every call the op takes (float32 or bfloat16, C % 8 == 0, C <= 65535;
    ``_bn_check`` refuses tensors that are not contiguous and 16-byte
    aligned); anything else raises, as the op does: no shape falls back to
    the generic kernels."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bn_fwd takes float32 or bfloat16, got "
                        f"{dtype}")
    if not bn_eligible(c) or c > 65535:
        raise ValueError(f"fused_bn_fwd takes C % 8 == 0 and C <= 65535, got "
                         f"C={c}")
    return "cluster"


# CUDA calls of the BatchNorm forward by route
bn_fwd_routes = {"cluster": 0, "generic": 0}


def _bn_fwd_cuda(x, res, w, b, eps, relu, route=None, *, skip=0):
    """(y, mean, var) on the cluster route (``route="generic"`` names the
    four-launch kernels for an in-call comparison). ``skip`` plants a
    fault for the checks: rank 0's fold leaves out the last rank's
    partial; the op passes none."""
    n, c, hw = _bn_check("fused_bn_fwd", x, () if res is None else (res,),
                         (), (w, b))
    vbf16 = int(w.dtype == torch.bfloat16)
    natural = bn_fwd_route(x.dtype, c)
    if route is None:
        route = natural
    elif route not in ("cluster", "generic"):
        raise ValueError(f"fused_bn_fwd: route {route!r} is 'cluster' or "
                         f"'generic'")
    dev = x.device
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    var = torch.empty_like(mean)
    lib = _lib()
    head = (x.data_ptr(), _ptr(res), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), mean.data_ptr(), var.data_ptr())
    if route == "cluster":
        _build.call(lib, "fused_bn_fwd_cluster", x.dtype, dev, *head, n, c,
                    hw, float(eps), int(relu), int(skip), vbf16)
    else:
        part = torch.empty((_bn_parts(n, hw), 2, c), dtype=torch.float32,
                           device=dev)
        coef = torch.empty((2, c), dtype=torch.float32, device=dev)
        _build.call(lib, "fused_bn_fwd", x.dtype, dev, *head,
                    part.data_ptr(), coef.data_ptr(), n, c, hw, float(eps),
                    int(relu), vbf16)
    launches["fused_bn_fwd"] += 1
    bn_fwd_routes[route] += 1
    return y, mean, var


# the persistent backward (csrc/norm_fusion.cu namespace bnb): its
# constants, mirrored by bn_bwd_plan
BN_THREADS = 256                # kThreads
BN_SMEM_PER_SM = 233472         # kSmemPerSm: an SM's shared memory on sm_90
BN_BLOCK_RESERVE = 1024         # kBlockReserve: the runtime's share a block
BN_SCRATCH = 6400               # kScratch: a block's sums, coefficients
BN_MAX_GROUP_C = 256            # kMaxGroupC: channels a group holds at most
BN_MIN_SPAN = 64                # kMinSpan: vectors a tile's rows span at least
BN_BLOCKS_PER_SM = 2            # kBlocksPerSm: the grid, two blocks an SM
BN_TEAMS = 2                    # kTeams: teams taking every other group
BN_LAG = 1                      # kLag: two slots a block
BN_L2_BYTES = 24 * 10 ** 6      # kL2Bytes: a group's bytes past the slots
# kSlotBytes: one slot, a block's share of the SM less the runtime's
# reserve and the scratch, over the slots, in whole 128 bytes (54656)
BN_SLOT_BYTES = ((BN_SMEM_PER_SM // BN_BLOCKS_PER_SM - BN_BLOCK_RESERVE
                  - BN_SCRATCH) // (BN_LAG + 1) // 128 * 128)


def bn_bwd_route(dtype, c: int) -> str:
    """The BatchNorm backward kernel a CUDA call takes: ``"persistent"``
    for every call the op takes (float32 or bfloat16, C % 8 == 0, C <=
    65535; ``_bn_check`` refuses tensors that are not contiguous and
    16-byte aligned); anything else raises, as the op does: no shape falls
    back to the generic kernels."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bn_bwd takes float32 or bfloat16, got "
                        f"{dtype}")
    if not bn_eligible(c) or c > 65535:
        raise ValueError(f"fused_bn_bwd takes C % 8 == 0 and C <= 65535, got "
                         f"C={c}")
    return "persistent"


def bn_tiles(n: int, lv: int, parts: int) -> Tuple[int, int]:
    """(th, tw): the tile of a group of n rows of lv vectors on ``parts``
    blocks, as ``tiles()`` in the CUDA source picks it: over the image
    slices ns = 1 .. min(n, parts), cs = max(1, min(parts // ns, lv //
    BN_MIN_SPAN)) column chunks, the smallest th·tw (th = ceil(n / ns), tw
    = ceil(lv / cs)), the first ns on a tie."""
    cols_cap = max(1, lv // BN_MIN_SPAN)
    best = None
    for ns in range(1, min(n, parts) + 1):
        cs = max(1, min(parts // ns, cols_cap))
        tw, th = -(-lv // cs), -(-n // ns)
        if best is None or th * tw < best[0]:
            best = (th * tw, th, tw)
    return best[1], best[2]


class BnGroup(NamedTuple):
    """A group of channels [c0, c0 + cn): lv vectors an image row, a grid
    of th-image by tw-vector tiles, ``cols`` columns, ``tiles`` in all."""
    c0: int
    cn: int
    lv: int
    th: int
    tw: int
    cols: int
    tiles: int


class BnBwdPlan(NamedTuple):
    n: int
    c: int
    hw: int
    vec: int            # elements a 16-byte vector
    tensors: int        # x, g (2) and the residual (3) a slot holds
    parts: int          # the grid: blocks an SM x SMs
    teams: int          # team t of parts / teams blocks takes groups t, t + teams, ...
    team_parts: int     # blocks of a team: a group's tiles at most
    slot_bytes: int     # 0: the L2-only variant
    l2_bytes: int       # a group's bytes past the slots, kept in L2
    cap: int            # vectors of one tensor a slot holds
    tile_cap: int       # vectors of one tensor a tile holds (slot and L2)
    unit: int           # a group's start and size: multiples of unit channels
    cg: int             # channels a group (the last may hold fewer)
    groups: Tuple[BnGroup, ...]


class BnTile(NamedTuple):
    """Block ``block``'s share of a group: images [n0, n0 + rows) by row
    vectors [v0, v0 + w); its first ``fit`` vectors go through the slot;
    channels ch_lo .. ch_lo + nch - 1 of the group."""
    block: int
    n0: int
    rows: int
    v0: int
    w: int
    fit: int
    ch_lo: int
    nch: int


@functools.lru_cache(maxsize=256)
def _bn_plan(n: int, c: int, hw: int, dtype, tensors: int, parts: int,
            teams: int, slot_bytes: int, l2_bytes: int) -> BnBwdPlan:
    """``bnb::plan`` for a grid of ``parts`` blocks in ``teams`` teams, team
    t taking groups t, t + teams, ...: a block's share of a group is one
    slot (``slot_bytes``; 0: no slot) and l2_bytes / team_parts more that
    it reads past the slot; groups of cg consecutive channels (a multiple
    of V / gcd(HW, V), at most BN_MAX_GROUP_C), the largest whose every
    tile's ``tensors`` tensors fit that share, or one unit where even that
    does not (its tiles then read past it too); each group's tiles from
    ``bn_tiles``. The route's plan is ``bn_bwd_plan``."""
    if n < 1 or c < 1 or hw < 1 or parts < 1 or tensors not in (2, 3):
        raise ValueError(f"_bn_plan: N {n}, C {c}, HW {hw}, {parts} blocks, "
                         f"tensors {tensors}")
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    unit = vec // math.gcd(hw, vec)
    if c % unit:
        raise ValueError(f"_bn_plan: C {c} is not a multiple of {unit}")
    if teams < 1 or parts % teams:
        raise ValueError(f"_bn_plan: {teams} teams of {parts} blocks")
    team_parts = parts // teams
    share = slot_bytes + l2_bytes // team_parts
    if slot_bytes < 0 or l2_bytes < 0 or share < 16 * tensors:
        raise ValueError(f"_bn_plan: slot of {slot_bytes} bytes and "
                         f"{l2_bytes} in L2")
    cap, tile_cap = slot_bytes // (16 * tensors), share // (16 * tensors)
    per_channel = n * hw * (16 // vec) * tensors
    cg = min(c, BN_MAX_GROUP_C, team_parts * share // per_channel)
    cg = max(unit, cg // unit * unit)
    while True:
        th, tw = bn_tiles(n, cg * hw // vec, team_parts)
        if cg == unit or th * tw <= tile_cap:
            break
        cg -= unit
    groups = []
    for c0 in range(0, c, cg):
        cn = min(cg, c - c0)
        lv = cn * hw // vec
        th, tw = bn_tiles(n, lv, team_parts)
        cols = -(-lv // tw)
        groups.append(BnGroup(c0, cn, lv, th, tw, cols, -(-n // th) * cols))
    return BnBwdPlan(n, c, hw, vec, tensors, parts, teams, team_parts,
                     slot_bytes, l2_bytes, cap, tile_cap, unit, cg,
                     tuple(groups))


def bn_bwd_plan(n: int, c: int, hw: int, dtype, sms: int,
                tensors: int = 2) -> BnBwdPlan:
    """The persistent backward's plan on ``sms`` SMs, as ``bnb::run``
    reckons it from the kernel's constants: BN_BLOCKS_PER_SM · sms blocks
    in BN_TEAMS teams, slots of BN_SLOT_BYTES and BN_L2_BYTES a group past
    them; ``tensors``: 2 (x, g) or 3 (and the residual the ReLU gate
    reads)."""
    if sms < 1:
        raise ValueError(f"bn_bwd_plan: {sms} SMs")
    return _bn_plan(n, c, hw, dtype, tensors, BN_BLOCKS_PER_SM * sms,
                   BN_TEAMS, BN_SLOT_BYTES, BN_L2_BYTES)


def bn_bwd_tiles(plan: BnBwdPlan, group: BnGroup):
    """The tiles of ``group`` in the order of its team's blocks, as the
    kernel's ``tile_of`` cuts them (blocks past the last tile sit the
    group out); each one's first ``fit`` vectors go through the slot."""
    out = []
    for blk in range(group.tiles):
        i, jc = divmod(blk, group.cols)
        n0, v0 = i * group.th, jc * group.tw
        rows, w = min(group.th, plan.n - n0), min(group.tw, group.lv - v0)
        ch_lo = v0 * plan.vec // plan.hw
        ch_hi = ((v0 + w) * plan.vec - 1) // plan.hw
        out.append(BnTile(blk, n0, rows, v0, w, min(rows * w, plan.cap),
                          ch_lo, ch_hi - ch_lo + 1))
    return out


def bn_bwd_scratch_floats(plan: BnBwdPlan) -> int:
    """The persistent backward's f32 scratch: a, b', p2, p3 [4, C], dw and
    db [C] each, the partials [P, 2, C], the counters and flags [2, G]."""
    return 6 * plan.c + 2 * plan.parts * plan.c + 2 * len(plan.groups)


# CUDA calls of the BatchNorm backward by route
bn_bwd_routes = {"persistent": 0, "generic": 0}


def _bn_bwd_cuda(x, res, w, b, mean, var, g, gmean, gvar, eps, relu,
                 route=None, *, skip=-1):
    """(dx, dres or None, dw, db): the rows in x's dtype, the sums f32
    (bf16 for bf16 w and b on the persistent route, rounded once by the
    kernel); on the persistent route (``route="generic"`` names the
    four-launch kernels for an in-call comparison). ``skip`` plants a fault for the
    checks: every fold of the persistent kernel leaves out that tile's
    partial; the op passes none."""
    gm, gv = _vec32(gmean), _vec32(gvar)
    rows = (g,) if res is None else (res, g)
    vecs = [v for v in (mean, var, gm, gv) if v is not None]
    n, c, hw = _bn_check("fused_bn_bwd", x, rows, vecs, (w, b))
    vbf16 = int(w.dtype == torch.bfloat16)
    natural = bn_bwd_route(x.dtype, c)
    if route is None:
        route = natural
    elif route not in ("persistent", "generic"):
        raise ValueError(f"fused_bn_bwd: route {route!r} is 'persistent' or "
                         f"'generic'")
    dev = x.device
    dx = torch.empty_like(x)
    dres = None if res is None else torch.empty_like(x)
    lib = _lib()
    head = (x.data_ptr(), _ptr(res), w.data_ptr(), b.data_ptr(),
            mean.contiguous().data_ptr(), var.contiguous().data_ptr(),
            g.data_ptr(), _ptr(gm), _ptr(gv), dx.data_ptr(), _ptr(dres))
    if route == "persistent":
        plan = bn_bwd_plan(n, c, hw, x.dtype, _sm_count(dev),
                           3 if relu and res is not None else 2)
        scratch = torch.empty(bn_bwd_scratch_floats(plan),
                              dtype=torch.float32, device=dev)
        # bf16 w and b: the kernel rounds dw and db into tensors of their
        # own (no conversion launch)
        dw16, db16 = ((torch.empty(c, dtype=torch.bfloat16, device=dev)
                       for _ in range(2)) if vbf16 else (None, None))
        _build.call(lib, "fused_bn_bwd_persist", x.dtype, dev, *head,
                    scratch.data_ptr(), _ptr(dw16), _ptr(db16), n, c, hw,
                    float(eps), int(relu), skip, vbf16)
        dw, db = ((dw16, db16) if vbf16 else
                  (scratch[4 * c:5 * c], scratch[5 * c:6 * c]))
    else:
        sums = torch.empty((2, c), dtype=torch.float32, device=dev)
        part = torch.empty((_bn_parts(n, hw), 2, c), dtype=torch.float32,
                           device=dev)
        coef = torch.empty((4, c), dtype=torch.float32, device=dev)
        _build.call(lib, "fused_bn_bwd", x.dtype, dev, *head,
                    sums[0].data_ptr(), sums[1].data_ptr(), part.data_ptr(),
                    coef.data_ptr(), n, c, hw, float(eps), int(relu), vbf16)
        dw, db = sums[0], sums[1]
    launches["fused_bn_bwd"] += 1
    bn_bwd_routes[route] += 1
    return dx, dres, dw, db


# ---------------------------------------------------------------------------
# fused BatchNorm-train: custom ops + autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op(
    "paddle_tpu_torch::fused_bn_fwd", mutates_args=(),
    schema="(Tensor x, Tensor? res, Tensor w, Tensor b, float eps, "
           "bool relu) -> (Tensor, Tensor, Tensor)")
def fused_bn_fwd(x, res, w, b, eps, relu):
    """Fused BatchNorm-train forward on [N, C, HW] → (y in x's dtype, mean
    [C] f32, biased var [C] f32)."""
    if _on(x.device, "fused_bn_fwd"):
        return _bn_fwd_cuda(x, res, w, b, eps, relu)
    return fused_bn_fwd_ref(x, res, w, b, eps, relu)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_bn_bwd", mutates_args=(),
    schema="(Tensor x, Tensor? res, Tensor w, Tensor b, Tensor mean, "
           "Tensor var, Tensor g, Tensor? gmean, Tensor? gvar, float eps, "
           "bool relu) -> (Tensor, Tensor?, Tensor, Tensor)")
def fused_bn_bwd(x, res, w, b, mean, var, g, gmean, gvar, eps, relu):
    """Fused BatchNorm-train backward → (dx, dres, dw, db): dx in x's dtype,
    dres in res's (None without a residual), dw and db the f32 sums cast to
    w's and b's dtypes, as the reference's bwd casts them (:604-606)."""
    if _on(x.device, "fused_bn_bwd"):
        dx, dres, dw, db = _bn_bwd_cuda(x, res, w, b, mean, var, g, gmean,
                                        gvar, eps, relu)
    else:
        dx, gate, dw, db = fused_bn_bwd_ref(x, res, w, b, mean, var, g,
                                            gmean, gvar, eps, relu)
        dx = dx.to(x.dtype)
        dres = None if res is None else gate.to(res.dtype, copy=True)
    return dx, dres, _own(dw, w.dtype), _own(db, b.dtype)


def _own(t, dtype):
    """``t`` in ``dtype`` as a tensor of its own: the kernels' f32 sums are
    rows of one scratch tensor, and an op's outputs may not alias each
    other (the persistent route's bf16 dw and db are their own already)."""
    return (t if t.dtype == dtype and not t._is_view()
            else t.to(dtype, copy=True))


def _bn_setup_context(ctx, inputs, output):
    x, res, w, b, eps, relu = inputs
    _, mean, var = output
    ctx.save_for_backward(x, res, w, b, mean, var)
    ctx.eps, ctx.relu = eps, relu


def _bn_backward(ctx, dy, dmean, dvar):
    x, res, w, b, mean, var = ctx.saved_tensors
    dy = torch.zeros_like(x) if dy is None else dy.contiguous()
    dx, dres, dw, db = fused_bn_bwd(x, res, w, b, mean, var, dy,
                                    dmean, dvar, ctx.eps, ctx.relu)
    return dx, dres, dw, db, None, None


fused_bn_fwd.register_autograd(_bn_backward, setup_context=_bn_setup_context)


def fused_batch_norm_train(x, weight, bias, *, residual=None, eps=1e-5,
                           fuse_relu=False):
    """Fused BatchNorm-train over channel-second layouts ([N, C, *spatial]).

    Returns (y, mean, var) with f32 batch statistics (the biased variance,
    as the dense batch_norm_train). Epilogues: ``fuse_relu`` applies ReLU
    after the affine; ``residual`` (x's shape) adds BEFORE the ReLU, the
    ResNet block order relu(bn(conv(x)) + identity). The normalised value
    and the pre-activation never reach device memory. The reference's
    checks and messages (:670-688)."""
    if x.ndim < 2:
        raise ValueError(
            f"fused_batch_norm_train wants [N, C, ...], got {tuple(x.shape)}")
    n, c = x.shape[0], x.shape[1]
    hw = math.prod(x.shape[2:]) if x.ndim > 2 else 1
    if not bn_eligible(c):
        raise NotImplementedError(
            f"fused_batch_norm_train: C={c} is not tileable by the 8-sublane "
            "rule (the caller should take the dense path)")

    def rows(t):
        # a contiguous copy with a 16-byte aligned start (a fresh tensor)
        # where the view has neither
        t = t.reshape(n, c, hw).contiguous()
        return t.clone() if t.data_ptr() % 16 else t

    x3 = rows(x)
    res3 = None
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError(f"residual shape {tuple(residual.shape)} != x "
                             f"shape {tuple(x.shape)}")
        res3 = rows(residual)
    y3, mean, var = fused_bn_fwd(x3, res3, weight.contiguous(),
                                 bias.contiguous(), float(eps),
                                 bool(fuse_relu))
    return y3.reshape(x.shape), mean, var
