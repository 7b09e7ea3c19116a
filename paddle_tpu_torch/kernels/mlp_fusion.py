"""Fused transformer-block kernels: the GeLU and SwiGLU MLPs and the B=1
decode step.

Counterpart: ``paddle_tpu/kernels/mlp_fusion.py``: the activation
functions (``_gelu_f32`` / ``_dgelu_f32`` :66-87, ``_silu_f32`` /
``_dsilu_f32`` :90-96), the fused MLP (``_mlp_fwd_kernel`` :228,
``_mlp_dx_kernel`` :260, ``_mlp_dw_kernel`` :296, the ``custom_vjp``
assembly :443 and ``fused_mlp_2d`` :472; its shape rule ``mlp_blocks``
:118 as ``mlp_eligible``), the fused SwiGLU (``_swiglu_fwd_kernel`` :522,
``_swiglu_dx_kernel`` :543, ``_swiglu_dw_kernel`` :572, the
``custom_vjp`` assembly :611 and ``fused_swiglu_2d`` :674) and the
decode part (``_decode_kernel`` :977, ``_decode_call`` :1041,
``decode_attn_proj`` :1067), and the projection-LN epilogue
(``_proj_ln_fwd_kernel`` :714, ``_proj_ln_bwd_kernel`` :751, the
``custom_vjp`` assembly :878 and ``fused_proj_ln_2d`` :913) with its
dropout epilogue, and ``mlp_blocks`` (:118-207, the tuning table's
entries included), whose row tile keys the fused MLP's and the
projection-LN's dropout masks.

The fused MLP's forward and backward are ``torch.library`` custom ops,
``paddle_tpu_torch::fused_mlp_fwd`` → ``y`` and
``paddle_tpu_torch::fused_mlp_bwd`` → ``(dx, dw1, db1, dw2, db2)``,
joined by ``register_autograd``; the backward saves the primal inputs
only (the reference's residuals, :452-458) and recomputes the [R, F]
activation. Dropout (:250-257, :275-279, :318-345): y = round(where(keep,
(act·W2 + b2) · f32(1 / (1 − p)), 0)); the backward masks g the same way
in f32, takes round(masked g) for dact and the f32 masked g for dW2 and
db2; the mask keyed (row // block_r, 0, 0) with the index (row %
block_r)·H + c, block_r being ``mlp_blocks``'s row tile, and regenerated
from the seed pair (the op saves the key's ints, no mask). The fused
SwiGLU is built the same way:
``paddle_tpu_torch::fused_swiglu_fwd`` → ``y`` and
``paddle_tpu_torch::fused_swiglu_bwd`` → ``(dx, dwg, dwu, dwd)``, the
backward saving the primal inputs only (:637). For CUDA tensors the ops
launch the hand-written Hopper kernels of ``csrc/fused_mlp.cu`` (its
header names the TPU kernels replaced, the operation bound, the
workspace and the recompute) or raise. Each of the four ops has two
routes, picked by one rule from the dtype, the widths and the alignment
(``mlp_bwd_route``; ``swiglu_bwd_route``, ``mlp_fwd_route`` and
``swiglu_fwd_route`` are the same function): ``wgmma`` (bf16, H and F
multiples of 8, 16-byte aligned tensors) or ``generic`` (the mma.sync
kernels: f32 and every other shape). On the forwards' wgmma route each
ffn chunk of ``_MLP_FWD_CHUNK_F`` runs two launches of the TMA + wgmma
GEMM core of ``csrc/gemm_core.cuh``: P1 the activation product with the
GeLU (b1 added) or, on the core's paired B, the SwiGLU gate applied in
its epilogue, act_c stored in bf16; P2 the down product into the f32
sum across chunks, the last chunk adding b2 and the dropout mask
(``mlp_fwd_plan``, ``swiglu_fwd_plan`` mirror the launches).
On the GeLU's backward wgmma route each ffn chunk runs a P1 kernel that
keeps a = x·W1_c + b1 in registers and writes da, act and db1's
row-block partials from them, then dX, dW1 and dW2 on the TMA + wgmma
GEMM core of ``csrc/gemm_core.cuh`` (``mlp_bwd_plan`` mirrors its
launches); on the SwiGLU's a P1 kernel keeps ag and au in registers and
writes dag, dau, act, then dX, [dWg | dWu] and dWd on the core
(``swiglu_bwd_plan``); ``gemm_tiles`` mirrors the core's tile walk.
``mlp_fwd_routes``, ``swiglu_fwd_routes``, ``mlp_bwd_routes`` and
``swiglu_bwd_routes`` count CUDA calls by route.
For CPU tensors they take the plain PyTorch versions
``fused_mlp_fwd_ref`` / ``fused_mlp_dx_ref`` /
``fused_mlp_dw_ref`` and ``fused_swiglu_fwd_ref`` / ``fused_swiglu_dx_ref``
/ ``fused_swiglu_dw_ref``. ``launches`` counts calls that launch the
kernels, by kernel name (CPU calls do not count), ``dropout_launches``
those of the GeLU MLP's and the projection-LN's dropout variants; one
backward call runs the dX and dW kernels over each ffn chunk together and
counts once for each. No backward uses atomics: every call gives the same bits.

The projection-LN forward and backward are
``paddle_tpu_torch::fused_proj_ln_fwd`` → ``(y, mean, rstd)`` and
``paddle_tpu_torch::fused_proj_ln_grads`` → ``(dx, dW, db, dres, dgamma,
dbeta)`` in the autograd's dtypes; the backward saves the primal inputs
and the f32 row statistics and recomputes the product. Dropout
(:735-739, :778-788): z = where(keep, (x·W + b) · f32(1 / (1 − p)), 0) +
res, dz the LN's input gradient (dres) and dp = where(keep, dz · f32(1 /
(1 − p)), 0), the mask keyed (row // block_r, 0, 0) with the index (row %
block_r)·Hout + c, block_r being ``mlp_blocks``'s row tile; the backward
regenerates it from the seed pair. For CUDA tensors they launch
``csrc/proj_ln.cu`` or raise, on the route ``pl_route`` picks from the
dtype, the widths and the alignment: ``cluster`` (bf16, Hout a multiple
of 256 up to 768, Hin a multiple of 8, 16-byte aligned tensors: a
cluster of four blocks holds each 128-row tile's f32 rows in registers,
wgmma and TMA; ``pl_cluster_plan`` mirrors its column slices) or
``generic`` (the 32-row kernels: f32 and every other shape);
``pl_routes`` counts CUDA calls by direction and route. On the cluster
route the backward kernel writes dres = round(dz) and dp as a pair of
bf16 halves (hi, lo), and dx = dp·Wᵀ and dW = xᵀ·dp, which the reference
computes as f32 products outside its kernel (:895-904), run as bf16
tensor-core products over the pair with f32 accumulation (the same f32
products to ~2^-16); db comes from the kernel's column sums. On the
generic route the kernel writes dz and dp in f32, as the reference's
does (:857-858), and dx, dW and db are f32 products and sums of dp. For
CPU tensors the ops take ``fused_proj_ln_fwd_ref`` /
``fused_proj_ln_grads_ref``. ``paddle_tpu_torch::fused_proj_ln_bwd`` →
``(dz, dp, dgamma, dbeta)`` (all f32) is the generic backward kernel's
own op, with its plain version ``fused_proj_ln_bwd_ref``;
``fused_proj_ln_bwd_pair_ref`` is the cluster backward kernel's.

``decode_attn_proj`` is the decode wrapper. For CUDA tensors it launches
``csrc/decode_attn_proj.cu`` or raises, on the route ``decode_route``
picks from the dtype, the widths and the alignment: ``split`` (float32
or bfloat16, D 64 or 128, NH·D 1024 or 2048, NH / KVH of 1, 2, 4 or 8,
HO a whole number of 16-byte vectors, 16-byte aligned pools and weight:
flash-decoding over all SMs, one block a kv head's context split, then
the projection launched as a programmatic dependent that streams its
weight band while attention runs, merges the splits and adds the heads
through a cluster's shared memory; ``decode_split_plan`` and
``decode_proj_plan`` mirror what each block reads) or ``generic`` (the
three-launch kernels: every other shape); for CPU tensors it takes
``decode_attn_proj_ref``.
``decode_attn_proj.launches`` counts its CUDA calls, ``decode_routes``
the same by route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from . import _build
from ..analysis import autotune
from ._build import vec32 as _vec32
from .flash_attention import DropKey, _ceil_to, _drop_args, _on, drop_key
from .flash_attention import seed_pair as _seed_pair
from .norm_fusion import _dropped

__all__ = ["decode_attn_proj", "decode_attn_proj_ref", "decode_proj_plan",
           "decode_route", "decode_routes", "decode_split_plan",
           "decode_splits", "dropout_launches",
           "fused_mlp_2d",
           "fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_fwd_ref",
           "fused_mlp_dx_ref", "fused_mlp_dw_ref", "fused_swiglu_2d",
           "fused_swiglu_fwd", "fused_swiglu_bwd", "fused_swiglu_fwd_ref",
           "fused_swiglu_dx_ref", "fused_swiglu_dw_ref", "fused_proj_ln_2d",
           "fused_proj_ln_fwd", "fused_proj_ln_bwd", "fused_proj_ln_fwd_ref",
           "fused_proj_ln_bwd_ref", "fused_proj_ln_bwd_pair_ref",
           "fused_proj_ln_grads", "fused_proj_ln_grads_ref", "mlp_blocks",
           "mlp_eligible", "pl_cluster_plan", "pl_route", "pl_routes",
           "proj_ln_eligible", "proj_ln_max_hout", "launches",
           "dw_tile", "gemm_tiles", "mlp_bwd_plan", "mlp_bwd_route",
           "mlp_bwd_routes", "mlp_fwd_plan", "mlp_fwd_route",
           "mlp_fwd_routes", "swiglu_bwd_plan", "swiglu_bwd_route",
           "swiglu_bwd_routes", "swiglu_fwd_plan", "swiglu_fwd_route",
           "swiglu_fwd_routes"]

_NEG_INF = -1e30   # flash_attention.py:61 — the kernel's mask, never -inf
_MAX_HEAD_DIM = 256
_MAX_SPLITS = 16   # generic attention splits over the block table (≤ kMaxSplits)
# the split route's geometry (csrc/decode_attn_proj.cu, namespace sp): the
# attention grid aims at DECODE_TARGET_BLOCKS blocks, at most
# DECODE_MAX_SPLITS splits a kv head; DECODE_TILE positions a tile; the
# projection runs a cluster of DECODE_CLUSTER blocks a column tile of 16
# 16-byte vectors (DECODE_VECS), one row band of NH·D / DECODE_CLUSTER rows
# each (DECODE_BANDS: the bands it takes)
DECODE_TARGET_BLOCKS = 256
DECODE_MAX_SPLITS = 32
DECODE_TILE = 32
DECODE_CLUSTER = 8
DECODE_VECS = 16
DECODE_BANDS = (128, 256)
DECODE_MAX_PAGES = 1024   # the block table's entries (kMaxPages)

PositionLike = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# activation functions (f32), the reference's constants (:66-69)
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_COEF = 0.044715
_INV_SQRT_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu_f32(a, approximate):
    if approximate:  # tanh form (GPT)
        u = _SQRT_2_OVER_PI * (a + _GELU_COEF * a * a * a)
        return 0.5 * a * (1.0 + torch.tanh(u))
    return 0.5 * a * (1.0 + torch.erf(a * _INV_SQRT_2))  # erf form (BERT)


def _dgelu_f32(a, approximate):
    if approximate:
        u = _SQRT_2_OVER_PI * (a + _GELU_COEF * a * a * a)
        t = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_COEF * a * a)
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(a * _INV_SQRT_2))
    pdf = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    return cdf + a * pdf


def _silu_f32(a):
    return a * torch.sigmoid(a)


def _dsilu_f32(a):
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


# ---------------------------------------------------------------------------
# fused MLP: matmul → GeLU → matmul (+ biases)
# ---------------------------------------------------------------------------

# the ffn chunk the kernels walk: one [R, _CHUNK_F] slice of the activation
# lives in device memory at a time (csrc/fused_mlp.cu). On an H100 at
# gpt3-1.3b shape 2048 was chosen over 1024 (slower) and 4096 (twice the
# workspace; PERF.md): a quarter of the activation at F = 8192. The SwiGLU
# kernels walk the same chunks
_CHUNK_F = 2048
# the SwiGLU backward's chunk on its wgmma route: three chunks at LLaMA-7B's
# F = 11008 (4096, 4096, 2816) ran 3.7% faster than six of 2048 on an
# H100 (scripts/swiglu_bwd_variants.py, PERF.md), for 25 MB more workspace
_SWIGLU_BWD_CHUNK_F = 4096
# the GeLU backward's chunk on its wgmma route (scripts/mlp_bwd_variants.py,
# PERF.md)
_MLP_BWD_CHUNK_F = 4096
# both forwards' chunk on their wgmma route: one chunk at gpt3-1.3b's F =
# 8192 ran 9.6% faster than two of 4096 (no f32 sum across chunks), two
# at llama-7b's 11008 3.6% faster than three, for the same workspace at
# gpt3-1.3b (act [R, 8192] in place of act [R, 4096] and the f32 [R, H]
# sum) and 17 MB more at llama-7b (scripts/mlp_fwd_variants.py, PERF.md)
_MLP_FWD_CHUNK_F = 8192
# rows per block of the kernels' GEMM (kRowBlock): the backward's bias
# gradients are summed per row block, then over the blocks in order
_ROW_BLOCK = 128

launches = {"fused_mlp_fwd": 0, "fused_mlp_dx": 0, "fused_mlp_dw": 0,
            "fused_swiglu_fwd": 0, "fused_swiglu_dx": 0, "fused_swiglu_dw": 0,
            "fused_proj_ln_fwd": 0, "fused_proj_ln_bwd": 0}
# launches of the GeLU MLP and projection-LN kernels' dropout variants
# (``launches`` counts the dropout-free ones)
dropout_launches = {"fused_mlp_fwd": 0, "fused_mlp_dx": 0, "fused_mlp_dw": 0,
                    "fused_proj_ln_fwd": 0, "fused_proj_ln_bwd": 0}


def mlp_eligible(r: int, h: int, f: int) -> bool:
    """The reference's shape rule (``mlp_blocks(r, h, f) is not None``,
    mlp_fusion.py:118-207): a legal ffn tile exists iff ``f`` is a
    multiple of 128 or ``f <= 512``. The CUDA kernels take any shape; the
    routing follows the rule so that both packages compute the same
    function for every shape. The TPU's tile sizes are not ported."""
    return f % 128 == 0 or f <= 512


_LANES = 8                       # :60, the TPU row tiles' quantum
_MLP_VMEM_TARGET = 10 << 20      # :59


def _vmem_estimate(br, h, bf):
    """:110: the TPU kernels' worst-case resident bytes for one grid
    step."""
    return 4 * (4 * h * bf + 3 * br * h + 4 * br * bf)


def mlp_blocks(r, h, f, dtype=None):
    """The reference's (block_r, block_f) pick (:118-207), or None when no
    ffn tile exists: an exact tuning-table hit (a stale one raises), else
    the VMEM heuristic, which keeps the row tile large and shrinks the f
    tile first. In the port its row tile keys the projection-LN's dropout
    mask; the CUDA kernels' tiles are their own. The reference's explicit
    block arguments and sweep flags (FLAGS_mlp_block_*) are not ported."""
    hit = autotune.lookup("fused_mlp", autotune.mlp_sig(r, h, f, dtype))
    if hit is not None:
        tbr, tbf = int(hit["block_r"]), int(hit["block_f"])
        if tbr <= 0 or tbr % _LANES or f % tbf or (tbf % 128 and tbf != f):
            raise ValueError(
                f"tuning-table fused_mlp entry ({tbr}, {tbf}) cannot "
                f"tile (r={r}, h={h}, f={f}) — stale winners are "
                f"rejected, never re-rounded; regenerate the table "
                f"(scripts/autotune.py search) or set "
                f"FLAGS_kernel_tuning=0")
        return tbr, tbf

    def _best_bf(br_):
        for cand in (512, 384, 256, 128):
            if f % cand == 0 and _vmem_estimate(br_, h, cand) \
                    <= _MLP_VMEM_TARGET:
                return cand
        if f <= 512 and _vmem_estimate(br_, h, f) <= _MLP_VMEM_TARGET:
            return f
        return None

    br = min(256, _ceil_to(r, _LANES))
    while True:
        bf = _best_bf(br)
        if bf is not None:
            return br, bf
        if br <= _LANES:
            break
        br = max(_LANES, (br // 2) // _LANES * _LANES)
    for cand in (128, 256, 384, 512):     # over budget even at 128
        if f % cand == 0:
            return _LANES, cand
    return (_LANES, f) if f <= 512 else None


def _pre(x, w1, b1):
    """a = x·W1 with f32 accumulation, plus b1 in f32."""
    return x.float() @ w1.float() + b1.float()


def fused_mlp_fwd_ref(x, w1, b1, w2, b2, approximate: bool,
                      drop: Optional[DropKey] = None):
    """Plain version of the forward kernel (mlp_fusion.py:243-257): x [R,
    H], w1 [H, F], w2 [F, H] in x's dtype, b1 [F], b2 [H]. The activation
    is rounded to x's dtype before the second product; with ``drop`` the
    f32 output is dropped before its rounding; y in x's dtype."""
    dt = x.dtype
    act = _gelu_f32(_pre(x, w1, b1), approximate).to(dt)
    return _dropped(act.float() @ w2.float() + b2.float(), drop).to(dt)


def _da(x, w1, b1, w2, g32, approximate):
    """(a, da) in f32 from the f32 (masked) g: dact = round(g)·W2ᵀ, da =
    dact·gelu'(a) (:275-286)."""
    a = _pre(x, w1, b1)
    dact = g32.to(x.dtype).float() @ w2.float().T
    return a, dact * _dgelu_f32(a, approximate)


def fused_mlp_dx_ref(x, w1, b1, w2, g, approximate: bool,
                     drop: Optional[DropKey] = None):
    """Plain version of the dX kernel (:275-293): g masked in f32 with
    ``drop``; da rounded to x's dtype before ``da·W1ᵀ``; dx in x's
    dtype."""
    _, da = _da(x, w1, b1, w2, _dropped(g.float(), drop), approximate)
    return (da.to(x.dtype).float() @ w1.float().T).to(x.dtype)


def fused_mlp_dw_ref(x, w1, b1, w2, g, approximate: bool,
                     drop: Optional[DropKey] = None):
    """Plain version of the dW kernel (:318-353): g masked in f32 with
    ``drop``; the activation, da and the masked g stay f32, not rounded.
    Returns (dw1, db1, dw2, db2), all f32."""
    g32 = _dropped(g.float(), drop)
    a, da = _da(x, w1, b1, w2, g32, approximate)
    return (x.float().T @ da, da.sum(0),
            _gelu_f32(a, approximate).T @ g32, g32.sum(0))


def _gate_up(x, wg, wu):
    """(ag, au) = (x·Wg, x·Wu) with f32 accumulation."""
    x32 = x.float()
    return x32 @ wg.float(), x32 @ wu.float()


def fused_swiglu_fwd_ref(x, wg, wu, wd):
    """Plain version of the SwiGLU forward kernel (mlp_fusion.py:531-540):
    x [R, H], wg/wu [H, F], wd [F, H] in x's dtype. The activation
    ``silu(ag)·au`` is rounded to x's dtype before the down product; y in
    x's dtype."""
    ag, au = _gate_up(x, wg, wu)
    act = (_silu_f32(ag) * au).to(x.dtype)
    return (act.float() @ wd.float()).to(x.dtype)


def _swiglu_da(x, wg, wu, wd, g):
    """(ag, au, dag, dau) in f32 (:552-562): dact = g·Wdᵀ, dag =
    dact·au·silu'(ag), dau = dact·silu(ag)."""
    ag, au = _gate_up(x, wg, wu)
    dact = g.to(x.dtype).float() @ wd.float().T
    return ag, au, dact * au * _dsilu_f32(ag), dact * _silu_f32(ag)


def fused_swiglu_dx_ref(x, wg, wu, wd, g):
    """Plain version of the SwiGLU dX kernel (:552-569): dag and dau
    rounded to x's dtype before their products with Wgᵀ and Wuᵀ, the two
    summed in f32; dx in x's dtype."""
    _, _, dag, dau = _swiglu_da(x, wg, wu, wd, g)
    dt = x.dtype
    return (dag.to(dt).float() @ wg.float().T
            + dau.to(dt).float() @ wu.float().T).to(dt)


def fused_swiglu_dw_ref(x, wg, wu, wd, g):
    """Plain version of the SwiGLU dW kernel (:584-607): dag, dau and the
    activation stay f32, not rounded. Returns (dwg, dwu, dwd), all f32."""
    ag, au, dag, dau = _swiglu_da(x, wg, wu, wd, g)
    x32 = x.float()
    return (x32.T @ dag, x32.T @ dau,
            (_silu_f32(ag) * au).T @ g.to(x.dtype).float())


_P, _I = ctypes.c_void_p, ctypes.c_int
# the dropout key: s0, s1, threshold, 1 / (1 - p), the reference's block_r
# and the row's width (block_r 0: no dropout)
_DROP = [ctypes.c_uint] * 3 + [ctypes.c_float, _I, _I]
_MLP_ARGTYPES = {"fused_mlp_fwd": [_P] * 8 + [_I] * 5 + _DROP + [_P],
                 "fused_mlp_bwd": [_P] * 16 + [_I] * 6 + _DROP + [_P],
                 "fused_swiglu_fwd": [_P] * 8 + [_I] * 4 + [_P],
                 "fused_swiglu_bwd": [_P] * 15 + [_I] * 4 + [_P]}


# the SwiGLU backward's wgmma route, bf16 only (``<name>_bf16``): x, wg,
# wu, wd, g, dx, dwg, dwu, dwd, the dag, dau and act workspaces, the f32
# accumulator; r, h, f, fc; the stream
_SWIGLU_WGMMA_ARGTYPES = {"fused_swiglu_bwd_wgmma": [_P] * 13 + [_I] * 4
                          + [_P]}
# the GeLU backward's wgmma route, bf16 only: fused_mlp_bwd's arguments
# without the f32 pre-activation workspace
_MLP_WGMMA_ARGTYPES = {"fused_mlp_bwd_wgmma": [_P] * 15 + [_I] * 6 + _DROP
                       + [_P]}
# the forwards' wgmma route, bf16 only: the GeLU's takes fused_mlp_fwd's
# arguments, the SwiGLU's fused_swiglu_fwd's without the f32 gate
# workspace (x, wg, wu, wd, y, act, the f32 sum; r, h, f, fc; the stream)
_FWD_WGMMA_ARGTYPES = {
    "fused_mlp_fwd_wgmma": _MLP_ARGTYPES["fused_mlp_fwd"],
    "fused_swiglu_fwd_wgmma": [_P] * 7 + [_I] * 4 + [_P]}


@functools.cache
def _mlp_lib():
    lib = _build.library("fused_mlp.cu", _MLP_ARGTYPES)
    for name, types in {**_SWIGLU_WGMMA_ARGTYPES, **_MLP_WGMMA_ARGTYPES,
                        **_FWD_WGMMA_ARGTYPES}.items():
        fn = getattr(lib, f"{name}_bf16")
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _mlp_check(name, x, w1, w2, more=(), vecs=()):
    """The kernels' contract: x [R, H], w1 [H, F], w2 [F, H]; float32 or
    bfloat16, one dtype for x, the weights and g (``more``), one CUDA
    device for these and the f32-cast bias vectors (``vecs``),
    contiguous. Returns (r, h, f)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    r, h = x.shape
    f = w1.shape[1]
    if w1.shape != (h, f) or w2.shape != (f, h):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} do not form "
                         f"an MLP")
    for t in (w1, w2, *more):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} kernel: {t.dtype} beside x's {x.dtype} "
                            f"(one dtype for x, the weights and g)")
    for t in (w1, w2, *more, *vecs):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    if not all(t.is_contiguous() for t in (x, w1, w2, *more)):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    return r, h, f


def _gelu_check(name, x, w1, b1, w2, more=()):
    r, h, f = _mlp_check(name, x, w1, w2, more, vecs=(b1,))
    if b1.shape != (f,):
        raise ValueError(f"{name}: b1 {tuple(b1.shape)} must be ({f},)")
    return r, h, f


# the wgmma routes' geometry (csrc/gemm_core.cuh, csrc/fused_mlp.cu's
# namespaces sw, ge and fw): the core's output tile and k step, each
# backward P1's tile width and its clusters' blocks (side by side along
# N), the row tiles of a raster group
SW_BM, SW_BN, SW_BK, SW_GROUP_M = 128, 256, 64, 8
SW_DACT_BN, SW_DACT_CLUSTER = 64, 2
GE_DACT_BN, GE_DACT_CLUSTER = 128, 2
# the GeLU backward's narrower tile for P3 and P4 (``ge::run_dw``), and
# the SMs of the card the route was tuned on (an H100's)
GE_DW_BN, H100_SMS = 192, 132
# the GeLU forward's P1 tile width and its P2's in the last of several
# chunks (``fw::kGeluBN``, ``fw::kLastBN``; the SwiGLU's paired P1 and
# every other P2 take SW_BN)
FW_GELU_BN = FW_LAST_BN = 192


def _tile_of(t: int, num_m: int, num_n: int):
    """gemm_core.cuh's ``tile_of``: the (row, column) tile of the t-th
    tile a persistent block walks, groups of SW_GROUP_M row tiles sweeping
    the column tiles, row tile fastest."""
    per = SW_GROUP_M * num_n
    first = t // per * SW_GROUP_M
    rows = min(num_m - first, SW_GROUP_M)
    rem = t % per
    return first + rem % rows, rem // rows


def gemm_tiles(m: int, n: int, bm: int, bn: int, nsplit: bool = False,
               cluster: int = 1):
    """The output tiles of one product in the order the persistent grid
    walks them: (row0, col0, half), half the N half of an ``nsplit``
    product (else 0); each tile [row0, row0 + bm) x [col0, col0 + bn),
    clipped at (m, n). With ``cluster`` blocks side by side along N (P1)
    the walk is over the clusters' tiles, each listing its blocks' tiles
    in rank order (the last may lie wholly past n: it only shares its
    loads)."""
    halves = 2 if nsplit else 1
    num_m, nh = -(-m // bm), -(-n // (bn * cluster))
    out = []
    for t in range(num_m * nh * halves):
        mt, nt = _tile_of(t, num_m, nh * halves)
        half = nt // nh
        out.extend((mt * bm, ((nt - half * nh) * cluster + rank) * bn, half)
                   for rank in range(cluster))
    return out


# CUDA calls of the GeLU MLP backward by route
mlp_bwd_routes = {"wgmma": 0, "generic": 0}


def mlp_bwd_route(dtype, h: int, f: int, aligned: bool) -> str:
    """The route a CUDA call of the GeLU MLP's (or the SwiGLU's)
    backward takes: ``"wgmma"`` for bfloat16 with H and F multiples of 8
    (TMA's 16-byte row strides) and every tensor 16-byte aligned and
    contiguous (``aligned``), else ``"generic"``."""
    if dtype == torch.bfloat16 and h % 8 == 0 and f % 8 == 0 and aligned:
        return "wgmma"
    return "generic"


def dw_tile(m: int, n: int, sms: int = H100_SMS) -> int:
    """``ge::run_dw``'s tile width for P3 or P4, an [m, n] output on
    ``sms`` SMs: GE_DW_BN where its waves times its width fall below
    SW_BN's (the last wave less empty), else SW_BN."""
    def cost(bn):
        return -(-(-(-m // SW_BM) * -(-n // bn)) // sms) * bn
    return GE_DW_BN if cost(GE_DW_BN) < cost(SW_BN) else SW_BN


def mlp_bwd_plan(r: int, h: int, f: int, fc: int, sms: int = H100_SMS):
    """The GeLU backward's wgmma launches, chunk by chunk (csrc/fused_mlp.cu
    ``ge::launch``; before them the column-sum pass, after them
    ``sum_parts``): a list of (f0, nc, products), products mapping P1..P4
    to (M, N, K, halves, (tile rows, tile columns, cluster)): P1 [R, nc]
    over H (two products, a = x·W1_c and dact = gm·W2_cᵀ, on one tile;
    clusters of GE_DACT_CLUSTER blocks along N; db1's partials by 128-row
    block); P2 dX [R, H] over K = nc; P3 dW1_c [H, nc] over R; P4 dW2_c
    [nc, H] over R, each at ``dw_tile``'s width on ``sms`` SMs.
    ``halves`` counts the products a launch runs per output tile
    element."""
    if min(r, h, f, fc) < 1:
        raise ValueError(f"mlp_bwd_plan: r, h, f, fc must be positive, "
                         f"got {r}, {h}, {f}, {fc}")
    plan = []
    for f0 in range(0, f, fc):
        nc = min(fc, f - f0)
        plan.append((f0, nc, {
            "P1": (r, nc, h, 2, (SW_BM, GE_DACT_BN, GE_DACT_CLUSTER)),
            "P2": (r, h, nc, 1, (SW_BM, SW_BN, 1)),
            "P3": (h, nc, r, 1, (SW_BM, dw_tile(h, nc, sms), 1)),
            "P4": (nc, h, r, 1, (SW_BM, dw_tile(nc, h, sms), 1))}))
    return plan


# CUDA calls of the GeLU and SwiGLU forwards by route; both forwards take
# the backwards' rule
mlp_fwd_routes = {"wgmma": 0, "generic": 0}
swiglu_fwd_routes = {"wgmma": 0, "generic": 0}
mlp_fwd_route = swiglu_fwd_route = mlp_bwd_route


def _fwd_plan(name, r, h, f, fc, p1, last_bn=SW_BN):
    """The forwards' wgmma launches, chunk by chunk: a list of (f0, nc,
    products, epilogue), products mapping P1, P2 to (M, N, K, halves,
    (tile rows, tile columns, cluster)) and epilogue naming P2's: "one"
    (a single chunk writes y: round(C [+ b2])), "sum_store" (the first of
    several stores the f32 sum), "sum_add" (a middle one reduce-adds to
    it), "sum_last" (the last loads it before its k loop and writes
    round(sum + C [+ b2]); the dropout mask where y is written; its tile
    ``last_bn`` wide)."""
    if min(r, h, f, fc) < 1:
        raise ValueError(f"{name}: r, h, f, fc must be positive, got {r}, "
                         f"{h}, {f}, {fc}")
    starts = range(0, f, fc)
    plan = []
    for c, f0 in enumerate(starts):
        nc = min(fc, f - f0)
        epi = ("one" if len(starts) == 1 else "sum_store" if c == 0
               else "sum_last" if c == len(starts) - 1 else "sum_add")
        bn = last_bn if epi == "sum_last" else SW_BN
        plan.append((f0, nc, {"P1": p1(nc),
                              "P2": (r, h, nc, 1, (SW_BM, bn, 1))}, epi))
    return plan


def mlp_fwd_plan(r: int, h: int, f: int, fc: int):
    """The GeLU forward's wgmma launches (csrc/fused_mlp.cu
    ``fw::gelu_launch``; ``_fwd_plan``'s form): P1 act_c [R, nc] over H
    on the core's [128, FW_GELU_BN] tiles; P2 y [R, H] over K = nc (the
    last of several chunks on [128, FW_LAST_BN] tiles)."""
    return _fwd_plan("mlp_fwd_plan", r, h, f, fc, lambda nc: (
        r, nc, h, 1, (SW_BM, FW_GELU_BN, 1)), FW_LAST_BN)


def swiglu_fwd_plan(r: int, h: int, f: int, fc: int):
    """The SwiGLU forward's wgmma launches (``fw::swiglu_launch``;
    ``_fwd_plan``'s form): P1 act_c [R, nc] over H on the core's paired B,
    two products (x·Wg_c, x·Wu_c) side by side in one [128, 256]
    accumulator over output tiles SW_BN / 2 wide; P2 y [R, H] over K =
    nc."""
    return _fwd_plan("swiglu_fwd_plan", r, h, f, fc, lambda nc: (
        r, nc, h, 2, (SW_BM, SW_BN // 2, 1)))


def _route(name, route, natural, dtype, h, f):
    """The route a call takes: ``natural`` (the rule's), or ``route``
    where the caller names one the shapes allow."""
    if route is None:
        return natural
    if route not in ("wgmma", "generic"):
        raise ValueError(f"{name}: route {route!r} is 'wgmma' or 'generic'")
    if route == "wgmma" and natural != "wgmma":
        raise ValueError(
            f"{name}: the wgmma route takes bfloat16 with H and F "
            f"multiples of 8 and 16-byte aligned tensors, got {dtype}, "
            f"H={h}, F={f}")
    return route


def _bwd_cuda(x, w1, b1, w2, g, approximate, drop=None, route=None):
    """dX and dW through the kernels, in one call, on the route
    ``mlp_bwd_route`` picks (``route`` names one instead: a measurement
    holds the two on the same inputs). Returns (dx, dw1, db1, dw2, db2):
    dx, dw1 and dw2 in x's dtype, db1 and db2 f32. With ``drop`` the
    kernels write the masked g, rounded, into a [R, H] workspace and read
    it in place of g."""
    r, h, f = _gelu_check("fused_mlp_bwd", x, w1, b1, w2, more=(g,))
    if g.shape != x.shape:
        raise ValueError(f"fused_mlp_bwd: g {tuple(g.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    route = _route("fused_mlp_bwd", route, mlp_bwd_route(x.dtype, h, f, all(
        t.data_ptr() % 16 == 0 for t in (x, w1, w2, g))), x.dtype, h, f)
    fc = min(f, _MLP_BWD_CHUNK_F if route == "wgmma" else _CHUNK_F)
    parts = -(-r // _ROW_BLOCK)
    dev, dt = x.device, x.dtype

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    dx, dw1, dw2 = empty(r, h), empty(h, f), empty(f, h)
    db1, db2 = empty(f, dtype=f32), empty(h, dtype=f32)
    da, act = empty(r, fc), empty(r, fc)
    acc = empty(r, h, dtype=f32) if f > fc else None
    part = empty(parts, f + h, dtype=f32)  # column sums per row block
    gm = None if drop is None else empty(r, h)
    b1f = _vec32(b1)
    ptr = [x.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(),
           g.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
           dw2.data_ptr(), db2.data_ptr()]
    ws = [da.data_ptr(), act.data_ptr(),
          None if acc is None else acc.data_ptr(), part.data_ptr(),
          None if gm is None else gm.data_ptr()]
    tail = (parts, r, h, f, fc, int(approximate), *_drop_args(drop))
    if route == "wgmma":   # a stays in the registers
        _build.call(_mlp_lib(), "fused_mlp_bwd_wgmma", dt, dev, *ptr, *ws,
                    *tail)
    else:                  # the f32 pre-activation chunk
        a = empty(r, fc, dtype=f32)
        _build.call(_mlp_lib(), "fused_mlp_bwd", dt, dev, *ptr, a.data_ptr(),
                    *ws, *tail)
    counts = launches if drop is None else dropout_launches
    counts["fused_mlp_dx"] += 1
    counts["fused_mlp_dw"] += 1
    mlp_bwd_routes[route] += 1
    return dx, dw1, db1, dw2, db2


def _fwd_cuda(x, w1, b1, w2, b2, approximate, drop=None, route=None):
    """y through the kernels on the route ``mlp_fwd_route`` picks
    (``route`` names one instead: a measurement holds the two on the same
    inputs); with ``drop`` the last chunk's epilogue masks y."""
    r, h, f = _gelu_check("fused_mlp_fwd", x, w1, b1, w2)
    if b2.shape != (h,) or b2.device != x.device:
        raise ValueError(f"fused_mlp_fwd: b2 {tuple(b2.shape)} on "
                         f"{b2.device} must be ({h},) on {x.device}")
    b1f, b2f = _vec32(b1), _vec32(b2)
    route = _route("fused_mlp_fwd", route, mlp_fwd_route(x.dtype, h, f, all(
        t.data_ptr() % 16 == 0 for t in (x, w1, w2, b1f, b2f))), x.dtype, h,
        f)
    fc = min(f, _MLP_FWD_CHUNK_F if route == "wgmma" else _CHUNK_F)
    y = torch.empty_like(x)
    act = torch.empty((r, fc), dtype=x.dtype, device=x.device)
    acc = (torch.empty((r, h), dtype=torch.float32, device=x.device)
           if f > fc else None)
    _build.call(_mlp_lib(), "fused_mlp_fwd_wgmma" if route == "wgmma"
                else "fused_mlp_fwd", x.dtype, x.device, x.data_ptr(),
                w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
                y.data_ptr(), act.data_ptr(),
                None if acc is None else acc.data_ptr(), r, h, f, fc,
                int(approximate), *_drop_args(drop))
    (launches if drop is None else dropout_launches)["fused_mlp_fwd"] += 1
    mlp_fwd_routes[route] += 1
    return y


# the row kernels' dropout arguments (the fused MLP's and the
# projection-LN's): the rate, the seed pair and the reference's row tile
_ROW_DROP_SCHEMA = ("float dropout_p=0.0, int seed0=0, int seed1=0, "
                    "int block_r=0")


@torch.library.custom_op(
    "paddle_tpu_torch::fused_mlp_fwd", mutates_args=(),
    schema="(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
           f"bool approximate, {_ROW_DROP_SCHEMA}) -> Tensor")
def fused_mlp_fwd(x, w1, b1, w2, b2, approximate, dropout_p=0.0, seed0=0,
                  seed1=0, block_r=0):
    """Fused MLP forward on [R, H] → y [R, H] in x's dtype; with
    ``dropout_p > 0`` the output mask keyed (seed0, seed1) by the row tile
    block_r."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, x.shape[1],
                    "fused MLP dropout")
    if _on(x.device, "fused_mlp_fwd"):
        return _fwd_cuda(x, w1, b1, w2, b2, approximate, drop)
    return fused_mlp_fwd_ref(x, w1, b1, w2, b2, approximate, drop)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_mlp_bwd", mutates_args=(),
    schema="(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
           f"Tensor g, bool approximate, {_ROW_DROP_SCHEMA}) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def fused_mlp_bwd(x, w1, b1, w2, b2, g, approximate, dropout_p=0.0, seed0=0,
                  seed1=0, block_r=0):
    """Fused MLP backward → (dx, dw1, db1, dw2, db2), each in its
    primal's dtype (the f32 weight and bias gradients cast as the
    reference's bwd does, :464-466); the forward's dropout mask
    regenerated from its key and applied to g."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, x.shape[1],
                    "fused MLP dropout")
    if _on(x.device, "fused_mlp_bwd"):
        dx, dw1, db1, dw2, db2 = _bwd_cuda(x, w1, b1, w2, g, approximate,
                                           drop)
    else:
        dx = fused_mlp_dx_ref(x, w1, b1, w2, g, approximate, drop)
        dw1, db1, dw2, db2 = fused_mlp_dw_ref(x, w1, b1, w2, g, approximate,
                                              drop)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _mlp_setup_context(ctx, inputs, output):
    x, w1, b1, w2, b2, approximate, *drop = inputs
    # the primal inputs and the dropout key's numbers only: the [R, F]
    # activation and the mask are recomputed
    ctx.save_for_backward(x, w1, b1, w2, b2)
    ctx.approximate = approximate
    ctx.drop = drop


def _mlp_backward(ctx, g):
    x, w1, b1, w2, b2 = ctx.saved_tensors
    return (*fused_mlp_bwd(x, w1, b1, w2, b2, g.contiguous(),
                           ctx.approximate, *ctx.drop),
            None) + (None,) * len(ctx.drop)


fused_mlp_fwd.register_autograd(_mlp_backward,
                                setup_context=_mlp_setup_context)


def fused_mlp_2d(x, w1, b1, w2, b2, *, approximate=False, dropout_p=0.0,
                 dropout_seed=None):
    """One-pass transformer MLP over a [R, H] view (mlp_fusion.py:472).

    y = dropout(gelu(x @ w1 + b1) @ w2 + b2); weight layout matches
    nn.Linear ([in, out]); w1 and w2 are cast to x's dtype. The
    reference's checks and messages. ``dropout_p > 0``: the mask keyed by
    ``dropout_seed`` (two uint32 or int32 words, one generator split) and
    the reference's row tile (``mlp_blocks``'s, at x's dtype)."""
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_2d expects a 2D [R, H] view, got "
                         f"{tuple(x.shape)}")
    r, h = x.shape
    w1 = w1.to(x.dtype)
    w2 = w2.to(x.dtype)
    if w1.ndim != 2 or w1.shape[0] != h:
        raise ValueError(f"fc1 weight {tuple(w1.shape)} does not match "
                         f"input [{r}, {h}] (expect [H, F])")
    f = w1.shape[1]
    if tuple(w2.shape) != (f, h):
        raise ValueError(f"fc2 weight {tuple(w2.shape)} must be [{f}, {h}]")
    if tuple(b1.shape) != (f,) or tuple(b2.shape) != (h,):
        raise ValueError(f"bias shapes {tuple(b1.shape)}/{tuple(b2.shape)} "
                         f"must be ({f},)/({h},)")
    if not mlp_eligible(r, h, f):
        raise NotImplementedError(
            f"fused_mlp: ffn dim {f} has no legal tile (needs a divisor "
            f"that is a multiple of 128, or f <= 512)")
    drop = ()
    if float(dropout_p) > 0.0:
        if dropout_seed is None:
            raise ValueError("fused_mlp: dropout_p > 0 requires "
                             "dropout_seed (2,) key data")
        drop = (float(dropout_p), *_seed_pair(dropout_seed),
                mlp_blocks(r, h, f, dtype=x.dtype)[0])
    return fused_mlp_fwd(x.contiguous(), w1.contiguous(), b1.contiguous(),
                         w2.contiguous(), b2.contiguous(), bool(approximate),
                         *drop)


# ---------------------------------------------------------------------------
# fused SwiGLU MLP: (silu(x·Wg)·(x·Wu))·Wd, no biases (LLaMA)
# ---------------------------------------------------------------------------

def _swiglu_check(name, x, wg, wu, wd, more=()):
    r, h, f = _mlp_check(name, x, wg, wd, more=(wu, *more))
    if wu.shape != wg.shape:
        raise ValueError(f"{name}: gate/up weights {tuple(wg.shape)}/"
                         f"{tuple(wu.shape)} differ")
    return r, h, f


def _swiglu_fwd_cuda(x, wg, wu, wd, route=None):
    """y through the kernels on the route ``swiglu_fwd_route`` picks
    (``route`` names one instead)."""
    r, h, f = _swiglu_check("fused_swiglu_fwd", x, wg, wu, wd)
    route = _route("fused_swiglu_fwd", route, swiglu_fwd_route(
        x.dtype, h, f, all(t.data_ptr() % 16 == 0 for t in (x, wg, wu, wd))),
        x.dtype, h, f)
    fc = min(f, _MLP_FWD_CHUNK_F if route == "wgmma" else _CHUNK_F)
    dev = x.device
    y = torch.empty_like(x)
    act = torch.empty((r, fc), dtype=x.dtype, device=dev)
    acc = (torch.empty((r, h), dtype=torch.float32, device=dev)
           if f > fc else None)
    ptr = [x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
           y.data_ptr()]
    ws = [act.data_ptr(), None if acc is None else acc.data_ptr()]
    if route == "wgmma":   # ag and au stay in the registers
        _build.call(_mlp_lib(), "fused_swiglu_fwd_wgmma", x.dtype, dev, *ptr,
                    *ws, r, h, f, fc)
    else:                  # the f32 gate product's chunk
        ag = torch.empty((r, fc), dtype=torch.float32, device=dev)
        _build.call(_mlp_lib(), "fused_swiglu_fwd", x.dtype, dev, *ptr,
                    ag.data_ptr(), *ws, r, h, f, fc)
    launches["fused_swiglu_fwd"] += 1
    swiglu_fwd_routes[route] += 1
    return y


# CUDA calls of the SwiGLU backward by route
swiglu_bwd_routes = {"wgmma": 0, "generic": 0}
# the SwiGLU backward takes the GeLU backward's rule
swiglu_bwd_route = mlp_bwd_route


def swiglu_bwd_plan(r: int, h: int, f: int, fc: int):
    """The wgmma route's launches, chunk by chunk (csrc/fused_mlp.cu
    ``sw::launch``): a list of (f0, nc, products), products mapping P1..P4
    to (M, N, K, halves, (tile rows, tile columns, cluster)): P1 [R, nc]
    over H (three products, dag, dau, act from one tile; clusters of
    SW_DACT_CLUSTER blocks along N); P2 dX [R, H] over K = 2 nc (two K
    halves); P3 [dWg_c | dWu_c] [H, nc] over R (two N halves); P4 dWd_c
    [nc, H] over R. ``halves`` counts the products a launch runs per
    output tile element (P1: 3 products; P2: its two K halves sum into one
    output; P3: two outputs)."""
    if min(r, h, f, fc) < 1:
        raise ValueError(f"swiglu_bwd_plan: r, h, f, fc must be positive, "
                         f"got {r}, {h}, {f}, {fc}")
    plan = []
    for f0 in range(0, f, fc):
        nc = min(fc, f - f0)
        plan.append((f0, nc, {
            "P1": (r, nc, h, 3, (SW_BM, SW_DACT_BN, SW_DACT_CLUSTER)),
            "P2": (r, h, nc, 2, (SW_BM, SW_BN, 1)),
            "P3": (h, nc, r, 2, (SW_BM, SW_BN, 1)),
            "P4": (nc, h, r, 1, (SW_BM, SW_BN, 1))}))
    return plan


def _swiglu_bwd_cuda(x, wg, wu, wd, g, route=None):
    """dX and dW through the kernels, in one call, on the route
    ``swiglu_bwd_route`` picks (``route`` names one instead: a measurement
    holds the two on the same inputs). Returns (dx, dwg, dwu, dwd), all in
    x's dtype."""
    r, h, f = _swiglu_check("fused_swiglu_bwd", x, wg, wu, wd, more=(g,))
    if g.shape != x.shape:
        raise ValueError(f"fused_swiglu_bwd: g {tuple(g.shape)} must have "
                         f"x's shape {tuple(x.shape)}")
    route = _route("fused_swiglu_bwd", route, swiglu_bwd_route(
        x.dtype, h, f, all(t.data_ptr() % 16 == 0
                           for t in (x, wg, wu, wd, g))), x.dtype, h, f)
    fc = min(f, _SWIGLU_BWD_CHUNK_F if route == "wgmma" else _CHUNK_F)
    dev, dt = x.device, x.dtype

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32 = torch.float32
    dx, dwg, dwu, dwd = empty(r, h), empty(h, f), empty(h, f), empty(f, h)
    dag, dau, act = empty(r, fc), empty(r, fc), empty(r, fc)
    if route == "wgmma":
        # ag and au stay in the registers; dX's f32 sum spans chunks only
        acc = empty(r, h, dtype=f32) if f > fc else None
        _build.call(_mlp_lib(), "fused_swiglu_bwd_wgmma", dt, dev,
                    x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dwg.data_ptr(),
                    dwu.data_ptr(), dwd.data_ptr(), dag.data_ptr(),
                    dau.data_ptr(), act.data_ptr(),
                    None if acc is None else acc.data_ptr(), r, h, f, fc)
    else:
        ag, au = empty(r, fc, dtype=f32), empty(r, fc, dtype=f32)
        acc = empty(r, h, dtype=f32)   # dX sums two products per chunk
        _build.call(_mlp_lib(), "fused_swiglu_bwd", dt, dev, x.data_ptr(),
                    wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
                    dwd.data_ptr(), ag.data_ptr(), au.data_ptr(),
                    dag.data_ptr(), dau.data_ptr(), act.data_ptr(),
                    acc.data_ptr(), r, h, f, fc)
    launches["fused_swiglu_dx"] += 1
    launches["fused_swiglu_dw"] += 1
    swiglu_bwd_routes[route] += 1
    return dx, dwg, dwu, dwd


@torch.library.custom_op(
    "paddle_tpu_torch::fused_swiglu_fwd", mutates_args=(),
    schema="(Tensor x, Tensor gate_w, Tensor up_w, Tensor down_w) -> Tensor")
def fused_swiglu_fwd(x, gate_w, up_w, down_w):
    """Fused SwiGLU forward on [R, H] → y [R, H] in x's dtype."""
    if _on(x.device, "fused_swiglu_fwd"):
        return _swiglu_fwd_cuda(x, gate_w, up_w, down_w)
    return fused_swiglu_fwd_ref(x, gate_w, up_w, down_w)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_swiglu_bwd", mutates_args=(),
    schema="(Tensor x, Tensor gate_w, Tensor up_w, Tensor down_w, Tensor g) "
           "-> (Tensor, Tensor, Tensor, Tensor)")
def fused_swiglu_bwd(x, gate_w, up_w, down_w, g):
    """Fused SwiGLU backward → (dx, dwg, dwu, dwd), each in its primal's
    dtype (the f32 weight gradients cast as the reference's bwd does,
    :667-668)."""
    if _on(x.device, "fused_swiglu_bwd"):
        dx, dwg, dwu, dwd = _swiglu_bwd_cuda(x, gate_w, up_w, down_w, g)
    else:
        dx = fused_swiglu_dx_ref(x, gate_w, up_w, down_w, g)
        dwg, dwu, dwd = fused_swiglu_dw_ref(x, gate_w, up_w, down_w, g)
    return (dx, dwg.to(gate_w.dtype), dwu.to(up_w.dtype),
            dwd.to(down_w.dtype))


def _swiglu_setup_context(ctx, inputs, output):
    # the primal inputs only: ag, au and the activation are recomputed
    ctx.save_for_backward(*inputs)


def _swiglu_backward(ctx, g):
    return fused_swiglu_bwd(*ctx.saved_tensors, g.contiguous())


fused_swiglu_fwd.register_autograd(_swiglu_backward,
                                   setup_context=_swiglu_setup_context)


def fused_swiglu_2d(x, gate_w, up_w, down_w):
    """LLaMA MLP over a [R, H] view (mlp_fusion.py:674):
    down_w(silu(x @ gate_w) * (x @ up_w)). No biases, no dropout; weight
    layout [in, out], cast to x's dtype. The reference's checks and
    messages; the tile rule as ``mlp_eligible``."""
    if x.ndim != 2:
        raise ValueError(f"fused_swiglu_2d expects a 2D [R, H] view, got "
                         f"{tuple(x.shape)}")
    r, h = x.shape
    wg, wu, wd = (w.to(x.dtype) for w in (gate_w, up_w, down_w))
    if wg.ndim != 2 or wg.shape[0] != h or wu.shape != wg.shape:
        raise ValueError(f"gate/up weights {tuple(wg.shape)}/"
                         f"{tuple(wu.shape)} must be [{h}, F]")
    f = wg.shape[1]
    if tuple(wd.shape) != (f, h):
        raise ValueError(f"down weight {tuple(wd.shape)} must be [{f}, {h}]")
    if not mlp_eligible(r, h, f):
        raise NotImplementedError(
            f"fused_swiglu: intermediate dim {f} has no legal tile")
    return fused_swiglu_fwd(x.contiguous(), wg.contiguous(), wu.contiguous(),
                            wd.contiguous())


# ---------------------------------------------------------------------------
# fused projection epilogue: LayerNorm(residual + x·W + b)
# ---------------------------------------------------------------------------

def _proj_z(x, w, b, res, drop=None):
    """dropout(x·W with f32 accumulation + b) + res, in f32 (:726-740)."""
    return _dropped(x.float() @ w.float() + b.float(), drop) + res.float()


def fused_proj_ln_fwd_ref(x, w, b, res, lnw, lnb, eps: float,
                          drop: Optional[DropKey] = None):
    """Plain version of the projection-LN forward kernel (:726-749): x [R,
    Hin], w [Hin, Hout], res [R, Hout] in one dtype, the vectors f32-cast.
    Returns (y in res's dtype, mean [R] f32, rstd [R] f32)."""
    z = _proj_z(x, w, b, res, drop)
    mean = z.mean(-1, keepdim=True)
    zc = z - mean
    rstd = torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)
    y = (zc * rstd) * lnw.float() + lnb.float()
    return y.to(res.dtype), mean[:, 0], rstd[:, 0]


def fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean, rstd, g,
                          drop: Optional[DropKey] = None):
    """Plain version of the projection-LN backward kernel (:771-793):
    returns (dz, dp, dgamma, dbeta), all f32; dp is dz dropped (without
    dropout a copy: an op's outputs may not alias each other)."""
    xhat = (_proj_z(x, w, b, res, drop) - mean[:, None]) * rstd[:, None]
    gf = g.float()
    gw = gf * lnw.float()
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * xhat).mean(-1, keepdim=True)
    dz = (gw - c1 - xhat * c2) * rstd[:, None]
    dp = dz.clone() if drop is None else _dropped(dz, drop)
    return dz, dp, (gf * xhat).sum(0), gf.sum(0)


def fused_proj_ln_bwd_pair_ref(x, w, b, res, lnw, mean, rstd, g,
                               drop: Optional[DropKey] = None):
    """Plain version of the cluster route's backward kernel: returns (dres
    = round(dz) in res's dtype, hi = bf16(dp), lo = bf16(dp − hi), dgamma,
    dbeta, db = Σ dp), the last three f32. hi + lo is dp to ~2^-17
    relative; hi is 0 exactly where the mask drops."""
    dz, dp, dg, dbeta = fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean, rstd,
                                              g, drop)
    hi = dp.to(torch.bfloat16)
    lo = (dp - hi.float()).to(torch.bfloat16)
    return dz.to(res.dtype), hi, lo, dg, dbeta, dp.sum(0)


def _f32_grads(x, w, b, res, lnw, lnb, dz, dp, dg, dbeta):
    """From the f32 kernel's (dz, dp, dgamma, dbeta): dx = dp·Wᵀ, dW =
    xᵀ·dp and db = Σ dp as f32 products outside the kernel, with W and x
    cast to f32, as the reference computes them (:895-904); the six
    gradients each cast to its primal's dtype."""
    dx = dp @ w.float().T
    dw = x.float().T @ dp
    return (dx.to(x.dtype), dw.to(w.dtype), dp.sum(0).to(b.dtype),
            dz.to(res.dtype), dg.to(lnw.dtype), dbeta.to(lnb.dtype))


def fused_proj_ln_grads_ref(x, w, b, res, lnw, lnb, mean, rstd, g,
                            drop: Optional[DropKey] = None):
    """Plain version of the whole backward: the kernel's plain version,
    then the reference's f32 products (``_f32_grads``)."""
    return _f32_grads(x, w, b, res, lnw, lnb,
                      *fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean, rstd,
                                             g, drop))


_PL_ARGTYPES = {"proj_ln_fwd": [_P] * 9 + [_I] * 3 + [ctypes.c_float]
                + _DROP + [_P],
                "proj_ln_bwd": [_P] * 12 + [_I] * 3 + _DROP + [_P]}
# the cluster route's entries, bf16 only (``<name>_bf16``): the forward
# takes proj_ln_fwd's arguments, the backward proj_ln_bwd's with dres and
# the pair in place of dz and dp
_PL_CLUSTER_ARGTYPES = {"proj_ln_fwd_cluster": _PL_ARGTYPES["proj_ln_fwd"],
                        "proj_ln_bwd_cluster": _PL_ARGTYPES["proj_ln_bwd"]}

# the cluster route's geometry (csrc/proj_ln.cu, namespace cl): a cluster
# of PL_CLUSTER_CTAS blocks owns PL_CLUSTER_ROWS rows, each block Hout / 4
# columns; Hout a multiple of PL_CLUSTER_HOUT_STEP up to PL_CLUSTER_MAX_HOUT
PL_CLUSTER_ROWS = 128
PL_CLUSTER_CTAS = 4
PL_CLUSTER_HOUT_STEP = 256
PL_CLUSTER_MAX_HOUT = 768

# CUDA calls of the projection-LN kernels by direction and route
pl_routes = {"fwd_cluster": 0, "fwd_generic": 0, "bwd_cluster": 0,
             "bwd_generic": 0}


@functools.cache
def _pl_lib():
    lib = _build.library(
        "proj_ln.cu", _PL_ARGTYPES,
        ints=("proj_ln_max_hout_f32", "proj_ln_max_hout_bf16",
              "proj_ln_rows_per_block", "proj_ln_cluster_max_hout",
              "proj_ln_cluster_rows"))
    for name, types in _PL_CLUSTER_ARGTYPES.items():
        fn = getattr(lib, f"{name}_bf16")
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def pl_route(dtype, hin: int, hout: int, aligned: bool) -> str:
    """The projection-LN kernels a CUDA call takes: ``"cluster"`` for
    bfloat16 with Hout a multiple of 256 up to 768, Hin a multiple of 8
    (TMA's 16-byte row stride) and every tensor 16-byte aligned and
    contiguous (``aligned``), else ``"generic"``."""
    if (dtype == torch.bfloat16 and hout % PL_CLUSTER_HOUT_STEP == 0
            and 0 < hout <= PL_CLUSTER_MAX_HOUT and hin % 8 == 0
            and aligned):
        return "cluster"
    return "generic"


def pl_cluster_plan(hout: int):
    """The cluster route's column slices: block ``rank`` of a cluster owns
    the columns [start, stop) of every row of its 128-row tile; the four
    slices tile [0, Hout) in rank order, the order in which each row's
    four partial sums are added."""
    if hout % PL_CLUSTER_HOUT_STEP or not 0 < hout <= PL_CLUSTER_MAX_HOUT:
        raise ValueError(f"the cluster route takes Hout a multiple of "
                         f"{PL_CLUSTER_HOUT_STEP} up to "
                         f"{PL_CLUSTER_MAX_HOUT}, got {hout}")
    nw = hout // PL_CLUSTER_CTAS
    return [(rank * nw, (rank + 1) * nw) for rank in range(PL_CLUSTER_CTAS)]


def proj_ln_max_hout(dtype) -> int:
    """The widest Hout the projection-LN kernels take in ``dtype``: the f32
    [32, Hout + 4] row tile beside the operand ring in 232,448 bytes of
    shared memory, reckoned as ``proj_ln.cu``'s ``max_hout`` reckons it
    (its ``Cfg``: BM 32, NC 256, BK 32 / 16 and 3 / 2 stages in bf16 / f32,
    tile rows padded by 16 bytes): 1356 in bf16, 1512 in f32."""
    esize, bk, nstage = (2, 32, 3) if dtype == torch.bfloat16 else (4, 16, 2)
    pad = 16 // esize
    ring = nstage * (32 * (bk + pad) + bk * (256 + pad)) * esize
    return (232448 - ring) // (32 * 4) - 4


def proj_ln_eligible(hout: int, dtype) -> bool:
    """The projection-LN kernels take an even Hout up to
    ``proj_ln_max_hout``."""
    return hout % 2 == 0 and hout <= proj_ln_max_hout(dtype)


def _pl_check(name, x, w, res, more=()):
    """The kernels' contract: x [R, Hin], w [Hin, Hout], res (and g,
    ``more``) [R, Hout], float32 or bfloat16 in one dtype, on one CUDA
    device, contiguous; Hout even and within what shared memory holds
    (``proj_ln_max_hout``: the f32 [32, Hout] row tile beside the operand
    ring). Returns (r, hin, hout)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    r, hin = x.shape
    hout = w.shape[1]
    for t in (w, res, *more):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} kernel: {t.dtype} beside x's {x.dtype} "
                            f"(one dtype for x, w, the residual and g)")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    if not all(t.is_contiguous() for t in (x, w, res, *more)):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    if not proj_ln_eligible(hout, x.dtype):
        limit = proj_ln_max_hout(x.dtype)
        raise ValueError(
            f"{name}: the kernel takes an even Hout of at most {limit} for "
            f"{x.dtype} (its f32 [32, Hout] row tile and operand ring fill "
            f"227 KB of shared memory), got Hout={hout}")
    return r, hin, hout


def _pl_route_for(name, route, x, hin, hout, tensors):
    """The route of a CUDA call: ``pl_route``'s, or ``route`` when named
    (an in-call comparison), which must then be one the shapes allow."""
    natural = pl_route(x.dtype, hin, hout,
                       all(t.data_ptr() % 16 == 0 for t in tensors))
    if route is None:
        return natural
    if route not in ("cluster", "generic"):
        raise ValueError(f"{name}: route {route!r} is 'cluster' or 'generic'")
    if route == "cluster" and natural != "cluster":
        raise ValueError(
            f"{name}: the cluster route takes bfloat16 with Hout a multiple "
            f"of {PL_CLUSTER_HOUT_STEP} up to {PL_CLUSTER_MAX_HOUT}, Hin a "
            f"multiple of 8 and 16-byte aligned tensors, got {x.dtype}, "
            f"Hin={hin}, Hout={hout}")
    return route


def _proj_ln_fwd_cuda(x, w, b, res, lnw, lnb, eps, drop=None, route=None):
    """The forward on the route ``pl_route`` picks (``route`` names one
    instead: a measurement holds the two on the same inputs)."""
    r, hin, hout = _pl_check("fused_proj_ln_fwd", x, w, res)
    route = _pl_route_for("fused_proj_ln_fwd", route, x, hin, hout,
                          (x, w, res))
    b32, g32, be32 = _vec32(b), _vec32(lnw), _vec32(lnb)
    y = torch.empty_like(res)
    mean = torch.empty(r, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    # the cluster route is bf16: _build.call takes its proj_ln_fwd_cluster_bf16
    _build.call(_pl_lib(),
                "proj_ln_fwd_cluster" if route == "cluster" else "proj_ln_fwd",
                x.dtype, x.device, x.data_ptr(), w.data_ptr(), b32.data_ptr(),
                res.data_ptr(), g32.data_ptr(), be32.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), r, hin, hout, float(eps),
                *_drop_args(drop))
    (launches if drop is None else dropout_launches)["fused_proj_ln_fwd"] += 1
    pl_routes[f"fwd_{route}"] += 1
    return y, mean, rstd


def _proj_ln_bwd_cuda(x, w, b, res, lnw, mean, rstd, g, drop=None):
    r, hin, hout = _pl_check("fused_proj_ln_bwd", x, w, res, more=(g,))
    b32, g32 = _vec32(b), _vec32(lnw)
    dev = x.device
    dz = torch.empty((r, hout), dtype=torch.float32, device=dev)
    dp = torch.empty_like(dz)
    rows = _pl_lib().proj_ln_rows_per_block()
    part = torch.empty((-(-r // rows), 2, hout), dtype=torch.float32,
                       device=dev)
    sums = torch.empty((2, hout), dtype=torch.float32, device=dev)
    _build.call(_pl_lib(), "proj_ln_bwd", x.dtype, dev, x.data_ptr(),
                w.data_ptr(), b32.data_ptr(), res.data_ptr(), g32.data_ptr(),
                mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
                g.data_ptr(), dz.data_ptr(), dp.data_ptr(), part.data_ptr(),
                sums.data_ptr(), r, hin, hout, *_drop_args(drop))
    (launches if drop is None else dropout_launches)["fused_proj_ln_bwd"] += 1
    pl_routes["bwd_generic"] += 1
    # copies: rows of one tensor, and an op's outputs may not alias
    return dz, dp, sums[0].clone(), sums[1].clone()


def _pl_pair_kernel(x, w, b, res, lnw, mean, rstd, g, drop=None):
    """The cluster route's backward kernel: (dres [R, Hout] in res's
    dtype, pair [R, 2, Hout] bf16 (hi, lo of dp), sums [3, Hout] f32:
    dgamma, dbeta, db)."""
    r, hin, hout = _pl_check("fused_proj_ln_bwd", x, w, res, more=(g,))
    _pl_route_for("fused_proj_ln_bwd", "cluster", x, hin, hout, (x, w, res, g))
    b32, g32 = _vec32(b), _vec32(lnw)
    dev = x.device
    dres = torch.empty_like(res)
    pair = torch.empty((r, 2, hout), dtype=torch.bfloat16, device=dev)
    part = torch.empty((-(-r // PL_CLUSTER_ROWS), 3, hout),
                       dtype=torch.float32, device=dev)
    sums = torch.empty((3, hout), dtype=torch.float32, device=dev)
    _build.call(_pl_lib(), "proj_ln_bwd_cluster", x.dtype, dev, x.data_ptr(),
                w.data_ptr(), b32.data_ptr(), res.data_ptr(), g32.data_ptr(),
                mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
                g.data_ptr(), dres.data_ptr(), pair.data_ptr(),
                part.data_ptr(), sums.data_ptr(), r, hin, hout,
                *_drop_args(drop))
    (launches if drop is None else dropout_launches)["fused_proj_ln_bwd"] += 1
    pl_routes["bwd_cluster"] += 1
    return dres, pair, sums


def _proj_ln_bwd_pair_cuda(x, w, b, res, lnw, mean, rstd, g, drop=None):
    """The cluster backward kernel's outputs as its plain version
    (``fused_proj_ln_bwd_pair_ref``) returns them: (dres, hi, lo, dgamma,
    dbeta, db), hi and lo views of one [R, 2, Hout] tensor."""
    dres, pair, sums = _pl_pair_kernel(x, w, b, res, lnw, mean, rstd, g, drop)
    return dres, pair[:, 0], pair[:, 1], sums[0], sums[1], sums[2]


def _proj_ln_grads_cuda(x, w, b, res, lnw, lnb, mean, rstd, g, drop=None,
                        route=None):
    """The whole backward on the route ``pl_route`` picks (``route`` names
    one instead). Cluster: the pair kernel, then dx = [hi | lo]·[Wᵀ; Wᵀ]
    (one bf16 product over K = 2 Hout, f32 accumulation, one rounding)
    and dW = xᵀ·[hi | lo] with an f32 output whose two halves are added
    before the one cast; no f32 copy of dp. Generic: the f32 kernel, then
    the reference's f32 products."""
    r, hin, hout = _pl_check("fused_proj_ln_bwd", x, w, res, more=(g,))
    route = _pl_route_for("fused_proj_ln_bwd", route, x, hin, hout,
                          (x, w, res, g))
    if route == "generic":
        return _f32_grads(x, w, b, res, lnw, lnb,
                          *_proj_ln_bwd_cuda(x, w, b, res, lnw, mean, rstd, g,
                                             drop))
    dres, pair, sums = _pl_pair_kernel(x, w, b, res, lnw, mean, rstd, g, drop)
    pair = pair.view(r, 2 * hout)
    dx = torch.mm(pair, torch.cat([w, w], 1).T)
    dwp = torch.mm(x.T, pair, out_dtype=torch.float32)
    dw = (dwp[:, :hout] + dwp[:, hout:]).to(w.dtype)
    # copies: rows of one tensor, and an op's outputs may not alias
    return (dx, dw, sums[2].to(b.dtype, copy=True), dres,
            sums[0].to(lnw.dtype, copy=True), sums[1].to(lnb.dtype, copy=True))


@torch.library.custom_op(
    "paddle_tpu_torch::fused_proj_ln_fwd", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, Tensor res, Tensor lnw, "
           f"Tensor lnb, float eps, {_ROW_DROP_SCHEMA}) "
           "-> (Tensor, Tensor, Tensor)")
def fused_proj_ln_fwd(x, w, b, res, lnw, lnb, eps, dropout_p=0.0, seed0=0,
                      seed1=0, block_r=0):
    """Projection-LN forward on x [R, Hin] → (y [R, Hout] in res's dtype,
    mean [R] f32, rstd [R] f32); with ``dropout_p > 0`` the mask keyed
    (seed0, seed1) by the row tile block_r."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, res.shape[1],
                    "projection-LN dropout")
    if _on(x.device, "fused_proj_ln_fwd"):
        return _proj_ln_fwd_cuda(x, w, b, res, lnw, lnb, eps, drop)
    return fused_proj_ln_fwd_ref(x, w, b, res, lnw, lnb, eps, drop)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_proj_ln_bwd", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, Tensor res, Tensor lnw, "
           f"Tensor mean, Tensor rstd, Tensor g, {_ROW_DROP_SCHEMA}) "
           "-> (Tensor, Tensor, Tensor, Tensor)")
def fused_proj_ln_bwd(x, w, b, res, lnw, mean, rstd, g, dropout_p=0.0,
                      seed0=0, seed1=0, block_r=0):
    """The generic backward kernel's op → (dz, dp, dgamma, dbeta), all
    f32, as the reference's kernel returns them (:857-858); the forward's
    dropout mask regenerated from its key. Autograd takes
    ``fused_proj_ln_grads``."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, res.shape[1],
                    "projection-LN dropout")
    if _on(x.device, "fused_proj_ln_bwd"):
        return _proj_ln_bwd_cuda(x, w, b, res, lnw, mean, rstd, g, drop)
    return fused_proj_ln_bwd_ref(x, w, b, res, lnw, mean, rstd, g, drop)


@torch.library.custom_op(
    "paddle_tpu_torch::fused_proj_ln_grads", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, Tensor res, Tensor lnw, "
           "Tensor lnb, Tensor mean, Tensor rstd, Tensor g, "
           f"{_ROW_DROP_SCHEMA}) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
           "Tensor)")
def fused_proj_ln_grads(x, w, b, res, lnw, lnb, mean, rstd, g, dropout_p=0.0,
                        seed0=0, seed1=0, block_r=0):
    """The projection-LN's whole backward → (dx, dW, db, dres, dgamma,
    dbeta), each in its primal's dtype; on a card the route's kernel and
    products, on the CPU ``fused_proj_ln_grads_ref``."""
    drop = drop_key(dropout_p, seed0, seed1, block_r, res.shape[1],
                    "projection-LN dropout")
    if _on(x.device, "fused_proj_ln_grads"):
        return _proj_ln_grads_cuda(x, w, b, res, lnw, lnb, mean, rstd, g,
                                   drop)
    return fused_proj_ln_grads_ref(x, w, b, res, lnw, lnb, mean, rstd, g,
                                   drop)


def _proj_ln_setup_context(ctx, inputs, output):
    x, w, b, res, lnw, lnb, eps, *drop = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, w, b, res, lnw, lnb, mean, rstd)
    ctx.drop = drop


def _proj_ln_backward(ctx, dy, _dmean, _drstd):
    x, w, b, res, lnw, lnb, mean, rstd = ctx.saved_tensors
    return fused_proj_ln_grads(x, w, b, res, lnw, lnb, mean, rstd,
                               dy.contiguous(), *ctx.drop) + (None,) * 5


fused_proj_ln_fwd.register_autograd(_proj_ln_backward,
                                    setup_context=_proj_ln_setup_context)


def fused_proj_ln_2d(x, w, b, residual, ln_w, ln_b, *, eps=1e-5,
                     dropout_p=0.0, dropout_seed=None):
    """LayerNorm(residual + dropout(x @ w + b)) over [R, Hin] x
    (mlp_fusion.py:913): the attention-output-projection epilogue,
    projection, bias, dropout, residual add and LN in one kernel pass.
    Weight layout [in, out], cast to x's dtype. The reference's checks
    and messages (:920-949); the kernel's own limit on Hout raises
    ValueError on a card. ``dropout_p > 0``: the mask keyed by
    ``dropout_seed`` (two uint32 or int32 words) and the reference's row
    tile (``mlp_blocks``'s)."""
    if x.ndim != 2:
        raise ValueError(f"fused_proj_ln_2d expects a 2D [R, Hin] view, "
                         f"got {tuple(x.shape)}")
    r, hin = x.shape
    w = w.to(x.dtype)
    if w.ndim != 2 or w.shape[0] != hin:
        raise ValueError(f"projection weight {tuple(w.shape)} must be "
                         f"[{hin}, Hout]")
    hout = w.shape[1]
    if b is None:
        raise NotImplementedError(
            "fused_proj_ln: bias-less projection is not fused; take the "
            "dense path")
    if tuple(residual.shape) != (r, hout):
        raise ValueError(f"residual {tuple(residual.shape)} must be "
                         f"[{r}, {hout}]")
    shapes = [tuple(t.shape) for t in (b, ln_w, ln_b)]
    if any(s != (hout,) for s in shapes):
        raise ValueError(f"bias/ln shapes {shapes[0]}/{shapes[1]}/{shapes[2]} "
                         f"must all be ({hout},)")
    drop = ()
    if float(dropout_p) > 0.0:
        if dropout_seed is None:
            raise ValueError("fused_proj_ln: dropout_p > 0 requires "
                             "dropout_seed (2,) key data")
        blocks = mlp_blocks(r, hout, hin, dtype=x.dtype)
        if blocks is None:
            raise NotImplementedError(
                f"fused_proj_ln: contraction dim {hin} has no legal tile")
        drop = (float(dropout_p), *_seed_pair(dropout_seed), blocks[0])
    return fused_proj_ln_fwd(x.contiguous(), w.contiguous(), b.contiguous(),
                             residual.contiguous(), ln_w.contiguous(),
                             ln_b.contiguous(), float(eps), *drop)[0]


def _check(q, k_pool, v_pool, block_size, proj_w):
    """The reference's three validation errors (mlp_fusion.py:1079-1098),
    same messages. Returns (nh, d, kvh, nblocks, ho)."""
    if q.ndim != 2:
        raise ValueError(f"decode_attn_proj expects q [NH, D], got "
                         f"{tuple(q.shape)}")
    nh, d = q.shape
    nslot1, kvh, d2 = k_pool.shape
    if d2 != d or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q head_dim {d}")
    if nh % kvh:
        raise ValueError(f"query heads {nh} not a multiple of kv heads "
                         f"{kvh}")
    nslot = nslot1 - 1
    if nslot % block_size:
        raise ValueError(f"pool slots {nslot} not a multiple of "
                         f"block_size {block_size}")
    if proj_w.ndim != 2 or proj_w.shape[0] != nh * d:
        raise ValueError(f"proj weight {tuple(proj_w.shape)} must be "
                         f"[{nh * d}, HO]")
    return nh, d, kvh, nslot // block_size, proj_w.shape[1]


def decode_attn_proj_ref(q, k_pool, v_pool, position: PositionLike,
                         block_table, proj_w, proj_b, *, block_size: int,
                         scale: float):
    """Plain PyTorch version of the kernel, same arguments as
    ``decode_attn_proj``: q [NH, D]; k_pool/v_pool [NSLOT+1, KVH, D]
    (this layer's pool, trash row last, the token's own K/V already
    appended); position (int or one-element int tensor); block_table
    [MB] int; proj_w [NH*D, HO] (head-major rows, Paddle layout);
    proj_b [HO]. Returns [HO] in q's dtype.

    Numerics of the reference kernel: q scaled in f32 then rounded to
    q's dtype; table entries clipped to [0, nblocks-1]; scores and
    softmax in f32 with masked positions at -1e30; attention rounded to
    the weight dtype (= q's dtype) before the projection; f32
    accumulation starting from the f32 bias."""
    nh, d, kvh, nblocks, ho = _check(q, k_pool, v_pool, block_size, proj_w)
    dt = q.dtype
    qs = (q.float() * float(scale)).to(dt).float()
    bt = torch.as_tensor(block_table, device=q.device).long().clamp(
        0, nblocks - 1)
    ctx = bt.shape[0] * block_size
    offs = torch.arange(block_size, device=q.device)
    slots = (bt[:, None] * block_size + offs[None, :]).reshape(ctx)
    k = k_pool[slots].float()                       # [CTX, KVH, D]
    v = v_pool[slots].float()
    g = nh // kvh
    s = torch.einsum("kgd,jkd->kgj", qs.reshape(kvh, g, d), k)
    pos = torch.as_tensor(position, device=q.device).reshape(())
    valid = torch.arange(ctx, device=q.device) <= pos
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    attn = torch.einsum("kgj,jkd->kgd", p, v) / p.sum(-1)[..., None]
    att = attn.reshape(nh * d).to(dt).float()
    y = proj_b.float() + att @ proj_w.to(dt).float()
    return y.to(dt)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]

# CUDA calls of the decode kernels by route
decode_routes = {"split": 0, "generic": 0}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@functools.cache
def _lib():
    return _build.library("decode_attn_proj.cu",
                          {"decode_attn_proj": _ARGTYPES,
                           "decode_attn_proj_split": _SPLIT_ARGTYPES})


def decode_route(dtype, nh: int, kvh: int, d: int, ho: int, mb: int,
                 aligned: bool) -> str:
    """The decode kernels a CUDA call takes: ``"split"`` for float32 or
    bfloat16 with D 64 or 128, NH · D of 1024 or 2048 (the projection's
    eight row bands of 128 or 256 rows), KVH dividing NH with a group NH /
    KVH of 1, 2, 4 or 8, HO a whole number of 16-byte vectors, a table of
    at most ``DECODE_MAX_PAGES`` pages, and the pools and the weight
    16-byte aligned (``aligned``), else ``"generic"``."""
    if (dtype in (torch.float32, torch.bfloat16) and d in (64, 128)
            and nh * d in tuple(DECODE_CLUSTER * b for b in DECODE_BANDS)
            and 0 < kvh and nh % kvh == 0 and nh // kvh in (1, 2, 4, 8)
            and ho % (16 // _ESIZE[dtype]) == 0
            and 0 < mb <= DECODE_MAX_PAGES and aligned):
        return "split"
    return "generic"


def decode_splits(kvh: int, mb: int) -> int:
    """The split route's attention grid: splits a kv head, so that KVH ·
    splits is about ``DECODE_TARGET_BLOCKS``, at most the table's MB pages
    and ``DECODE_MAX_SPLITS`` (the partials a projection thread merges)."""
    return max(1, min(-(-DECODE_TARGET_BLOCKS // kvh), mb, DECODE_MAX_SPLITS))


def decode_split_plan(pos: int, mb: int, block_size: int, kvh: int):
    """The context positions [start, stop) each live attention split of
    one kv head reads, as the kernels reckon them on the device from pos
    (≥ 0): the live pages min(pos // bs + 1, MB) cut into runs of
    ceil(live / splits) whole pages; the last run stops at pos. Blocks of
    the grid past the returned splits read nothing."""
    nsplit = decode_splits(kvh, mb)
    live = min(pos // block_size + 1, mb)
    pps = -(-live // nsplit)
    return [(s * pps * block_size,
             min(min((s + 1) * pps, live) * block_size, pos + 1))
            for s in range(-(-live // pps))]


def decode_proj_plan(nh: int, d: int, ho: int, dtype):
    """The split route's projection blocks in grid order (a cluster a
    column tile, its blocks by rank): (row0, row1, col0, col1) of proj_w
    [NH·D, HO], each one of ``DECODE_CLUSTER`` row bands by
    ``DECODE_VECS`` 16-byte vectors (fewer in a ragged last tile)."""
    ct = DECODE_VECS * (16 // _ESIZE[dtype])
    rb = nh * d // DECODE_CLUSTER
    return [(r * rb, (r + 1) * rb, c, min(c + ct, ho))
            for c in range(0, ho, ct) for r in range(DECODE_CLUSTER)]


def _launch(q, k_pool, v_pool, position, block_table, proj_w, proj_b,
            block_size, scale, route=None):
    nh, d, kvh, nblocks, ho = _check(q, k_pool, v_pool, block_size, proj_w)
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attn_proj kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("proj_w", proj_w), ("proj_b", proj_b)):
        if t.device != dev:
            raise ValueError(f"decode_attn_proj: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attn_proj kernel: {name} is {t.dtype}, "
                            f"q is {q.dtype} (one dtype for all)")
    if proj_b.shape != (ho,):
        raise ValueError(f"proj bias {tuple(proj_b.shape)} must be ({ho},)")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"decode_attn_proj kernel takes head_dim <= "
                         f"{_MAX_HEAD_DIM}, got {d}")
    if not isinstance(position, torch.Tensor):
        position = torch.tensor([int(position)], dtype=torch.int32,
                                device=dev)
    for name, t in (("position", position), ("block_table", block_table)):
        if t.device != dev or t.dtype != torch.int32:
            raise TypeError(f"decode_attn_proj kernel: {name} must be int32 "
                            f"on {dev}, got {t.dtype} on {t.device}")
    if position.numel() != 1:
        raise ValueError(f"position must hold one element, got "
                         f"{tuple(position.shape)}")
    if block_table.ndim != 1:
        raise ValueError(f"block_table must be [MB], got "
                         f"{tuple(block_table.shape)}")
    tensors = (q, k_pool, v_pool, position, block_table, proj_w, proj_b)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attn_proj kernel needs contiguous tensors")
    mb = block_table.shape[0]
    natural = decode_route(q.dtype, nh, kvh, d, ho, mb, all(
        t.data_ptr() % 16 == 0 for t in (k_pool, v_pool, proj_w)))
    if route is None:
        route = natural
    elif route not in ("split", "generic"):
        raise ValueError(f"decode_attn_proj: route {route!r} is 'split' or "
                         f"'generic'")
    elif route == "split" and natural != "split":
        raise ValueError(
            f"decode_attn_proj: the split route takes float32 or bfloat16 "
            f"with D 64 or 128, NH·D 1024 or 2048, NH / KVH of 1, 2, 4 or 8, "
            f"HO a whole number of 16-byte vectors, at most "
            f"{DECODE_MAX_PAGES} pages and 16-byte aligned pools and weight, "
            f"got {q.dtype}, D={d}, NH={nh}, KVH={kvh}, HO={ho}, MB={mb}")
    y = torch.empty((ho,), dtype=q.dtype, device=dev)
    ptrs = [t.data_ptr() for t in tensors] + [y.data_ptr()]
    if route == "split":
        nsplit = decode_splits(kvh, mb)
        part = torch.empty((nh * nsplit * (2 + d),), dtype=torch.float32,
                           device=dev)
        _build.call(_lib(), "decode_attn_proj_split", q.dtype, dev, *ptrs,
                    part.data_ptr(), nh, kvh, d, int(block_size), nblocks, mb,
                    ho, nsplit, float(scale))
    else:
        pages_per_split = math.ceil(mb / _MAX_SPLITS)
        nsplit = math.ceil(mb / pages_per_split)
        scratch = torch.empty((nh * nsplit * (2 + d) + nh * ho,),
                              dtype=torch.float32, device=dev)
        _build.call(_lib(), "decode_attn_proj", q.dtype, dev, *ptrs,
                    scratch.data_ptr(), nh, kvh, d, int(block_size), nblocks,
                    mb, ho, pages_per_split, nsplit, float(scale))
    decode_attn_proj.launches += 1
    decode_routes[route] += 1
    return y


def decode_attn_proj(q, k_pool, v_pool, position: PositionLike, block_table,
                     proj_w, proj_b, *, block_size: int, scale: float):
    """Single-kernel B=1 decode: paged attention → output projection.

    Arguments as ``decode_attn_proj_ref``. CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernels on the route
    ``decode_route`` picks (float32 or bfloat16, one dtype for q, pools
    and projection; int32 position (≥ 0) and table on the same card,
    contiguous) or raise. Returns [HO] = attention(q, paged context) ·
    proj_w + proj_b in q's dtype."""
    if q.device.type == "cpu":
        return decode_attn_proj_ref(q, k_pool, v_pool, position, block_table,
                                    proj_w, proj_b, block_size=block_size,
                                    scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn_proj runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, position, block_table, proj_w, proj_b,
                   block_size, scale)


decode_attn_proj.launches = 0
