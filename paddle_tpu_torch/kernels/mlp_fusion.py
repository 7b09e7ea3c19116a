"""Single-kernel B=1 serving decode: paged attention + output projection.

Counterpart: ``paddle_tpu/kernels/mlp_fusion.py``, the decode part only
(``_decode_kernel`` :977, ``_decode_call`` :1041, ``decode_attn_proj``
:1067). The fused MLP, SwiGLU and projection-LN kernels of that module
belong to later slices (ROADMAP.md).

``decode_attn_proj`` is the wrapper. For CUDA tensors it launches the
hand-written Hopper kernel ``csrc/decode_attn_proj.cu`` (its header
names the TPU kernel it replaces, its memory bound and what the design
does about it) or raises; for CPU tensors it takes the plain PyTorch
version ``decode_attn_proj_ref``. ``decode_attn_proj.launches`` counts
kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Union

import torch

__all__ = ["decode_attn_proj", "decode_attn_proj_ref"]

_NEG_INF = -1e30   # flash_attention.py:61 — the kernel's mask, never -inf
_MAX_HEAD_DIM = 256
_MAX_SPLITS = 16   # attention splits over the block table (≤ kMaxSplits)

PositionLike = Union[int, torch.Tensor]


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


@functools.cache
def _lib():
    from ._build import load
    lib = load("decode_attn_proj.cu")
    for fn in (lib.decode_attn_proj_f32, lib.decode_attn_proj_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.decode_attn_proj_error_string.argtypes = [ctypes.c_int]
    lib.decode_attn_proj_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pool, v_pool, position, block_table, proj_w, proj_b,
            block_size, scale):
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
    pages_per_split = math.ceil(mb / _MAX_SPLITS)
    nsplit = math.ceil(mb / pages_per_split)
    y = torch.empty((ho,), dtype=q.dtype, device=dev)
    scratch = torch.empty((nh * nsplit * (2 + d) + nh * ho,),
                          dtype=torch.float32, device=dev)
    lib = _lib()
    fn = (lib.decode_attn_proj_bf16 if q.dtype == torch.bfloat16
          else lib.decode_attn_proj_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), y.data_ptr(),
                scratch.data_ptr(), nh, kvh, d, int(block_size), nblocks, mb,
                ho, pages_per_split, nsplit, float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attn_proj kernel launch failed: CUDA error {rc} "
            f"({lib.decode_attn_proj_error_string(rc).decode()})")
    decode_attn_proj.launches += 1
    return y


def decode_attn_proj(q, k_pool, v_pool, position: PositionLike, block_table,
                     proj_w, proj_b, *, block_size: int, scale: float):
    """Single-kernel B=1 decode: paged attention → output projection.

    Arguments as ``decode_attn_proj_ref``. CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernel (float32 or bfloat16,
    one dtype for q, pools and projection; int32 position and table on
    the same card, contiguous) or raise. Returns [HO] = attention(q,
    paged context) · proj_w + proj_b in q's dtype."""
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
