"""GPT — the decoder-only LM: the Layer model, training and serving.

Counterpart: ``paddle_tpu/models/gpt.py``: ``GPTConfig`` / ``CONFIGS``
(:39, :100), the Layer ``GPTForCausalLM`` (:116-205), the functional
train step on one device (``init_hybrid_params`` :216 through
``make_train_step`` :645) and the serving functions (:686-932, the
fast path's ``serving_chunk_step`` included). The pipeline,
sequence-parallel, tensor-parallel and MoE branches belong to a later
slice (ROADMAP A10).

``GPTForCausalLM`` is an ``nn.Module`` holding the parameters under the
reference Layer model's names (``gpt.wte.weight``,
``gpt.blocks.<i>.qkv.weight``, ...) with Paddle's ``[in, out]`` Linear
weights, initialised at random from a seed with a ``torch.Generator`` on
the model's device (normal(0, 0.02) weights, zero biases, unit LayerNorm
gains). ``serving_params(model)`` gives the serving parameter tree: the
reference's top-level keys, with ``blocks`` a list of one dict per layer
(views of the module's parameters, no copy) where the reference stacks
the layer axis. ``serving_params_from_numpy`` / ``load_numpy`` take the
reference's tree (as numpy arrays) so both packages compute the same
function.

Training: ``init_hybrid_params`` gives the reference's parameter tree
on one device (``blocks`` leaves stacked ``[L, ...]``; the reference's
size-1 ``pp`` axis is dropped; ``train_params_from_numpy`` /
``train_params_to_numpy`` convert to and from the reference's tree).
``make_train_step`` runs ``loss_fn`` → autograd → ``adamw_update`` and
updates parameters and moments IN PLACE, where the reference donates
them. Attention in ``_block_apply`` goes through ``flash_attention_bshd``
(the Hopper kernels on a card) when ``_attn_mode`` allows; the MLP goes
through ``fused_mlp_2d`` (the fused MLP kernels on a card, their plain
versions on the CPU) when ``_mlp_mode`` allows, as the reference's does
with ``FLAGS_fused_mlp`` at its default (on), else the dense chain. The
Layer block takes ``nn.functional.fused_mlp``, and the Layer model's
norms are the port's ``nn.LayerNorm`` (the fused LayerNorm kernels with
``FLAGS_fused_norm`` on, as the reference's ``nn.LayerNorm`` takes its
fused kernel). The remat policies of
``_stage_fn`` are torch activation checkpointing; the selective ones find
the reference's ``checkpoint_name`` sites through ``_named`` and save
the flash forward's ``(out, lse)``, and the fused MLP forward's output
where the reference saves ``fc2_out``.

The serving functions share ``paged_attention_math`` as in the
reference. ``serving_decode_step`` updates the pools IN PLACE and
returns them; with ``FLAGS_serving_decode_kernel`` on and a B=1 bucket,
each layer's attention + output projection is one ``decode_attn_proj``
call (the hand-written CUDA kernel on a card).
"""
from __future__ import annotations

import functools
import math
import threading
import warnings
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from .._device import DeviceLike, resolve_device
from ..core.flags import get_flag
from ..core.tensor import unwrap_args
from ..inference.kv_cache import context_slots, kv_append, kv_gather
from ..kernels._build import KERNEL_DTYPES
from ..kernels.chunked_xent import chunked_softmax_xent
from ..kernels.flash_attention import _MAX_HEAD_DIM, flash_attention_bshd
from ..kernels.mlp_fusion import decode_attn_proj, fused_mlp_2d, mlp_eligible
from ..nn.functional import mlp as _mlp_introspect
from ..nn.functional.attention import (paged_attention_math,
                                       scaled_dot_product_attention)
from ..nn.functional.common import linear
from ..nn.functional.mlp import _fused_mode, fused_mlp
from ..nn.layer.norm import LayerNorm

__all__ = ["GPTConfig", "CONFIGS", "GPTForCausalLM", "init_hybrid_params",
           "train_params_from_numpy", "train_params_to_numpy", "loss_fn",
           "adamw_update", "init_opt_state", "make_train_step",
           "serving_params", "serving_params_from_numpy",
           "serving_forward_logits", "serving_prefill",
           "serving_decode_step", "serving_chunk_step",
           "last_decode_kernel_path"]

_BLOCK_PARAMS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


class GPTConfig(NamedTuple):
    """The reference's config (gpt.py:39-96), same fields, order and
    defaults. On one device ``moe_*`` and ``vpp_chunks`` must keep their
    defaults (ROADMAP A10); ``dropout`` is carried but, as in the
    reference's functional step, not applied."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: Optional[int] = None
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    vpp_chunks: int = 1
    # pack each head to this many lanes (0 = off); pad lanes of qkv_w and
    # proj_w are zero and stay zero under training (reference :57-67)
    head_pack: int = 0
    # 'dots_saveable' | 'save_small' | 'save_qkv' | 'save_ffn' |
    # 'save_except_big' | 'full' | 'none' (see _stage_fn)
    remat_policy: str = "dots_saveable"
    opt_dtype: Any = torch.float32        # AdamW moment storage
    lm_head: str = "auto"                 # 'plain' | 'chunked' | 'auto'

    @property
    def ffn(self):
        return self.intermediate_size or 4 * self.hidden_size


# canonical configs (PaddleNLP naming), as in the reference
CONFIGS = {
    "gpt2-small": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                           max_seq_len=2048),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                           max_seq_len=2048),
    "tiny": GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                      num_heads=4, max_seq_len=128),
}


# ---------------------------------------------------------------------------
# parameter-holding modules (Paddle layout)
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """Paddle-layout linear: weight [in, out], bias [out]."""

    def __init__(self, n_in: int, n_out: int, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device, dtype):
        super().__init__()
        H = cfg.hidden_size
        self.nh = cfg.num_heads
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(H, **kw)
        self.qkv = Linear(H, 3 * H, **kw)
        self.proj = Linear(H, H, **kw)
        self.ln2 = LayerNorm(H, **kw)
        self.fc1 = Linear(H, cfg.ffn, **kw)
        self.fc2 = Linear(cfg.ffn, H, **kw)

    def named_serving(self):
        """(serving name, parameter) pairs in ``_BLOCK_PARAMS`` order."""
        return (("ln1_g", self.ln1.weight), ("ln1_b", self.ln1.bias),
                ("qkv_w", self.qkv.weight), ("qkv_b", self.qkv.bias),
                ("proj_w", self.proj.weight), ("proj_b", self.proj.bias),
                ("ln2_g", self.ln2.weight), ("ln2_b", self.ln2.bias),
                ("fc1_w", self.fc1.weight), ("fc1_b", self.fc1.bias),
                ("fc2_w", self.fc2.weight), ("fc2_b", self.fc2.bias))

    def forward(self, x):
        """The reference block (gpt.py:138-160): LN → qkv → causal
        attention → proj, then LN → ``fused_mlp`` (tanh GeLU)."""
        B, S, H = x.shape
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(B, S, self.nh, H // self.nh)

        attn = scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                            is_causal=True)
        x = x + self.proj(attn.reshape(B, S, H))
        h = self.ln2(x)
        return x + fused_mlp(h, self.fc1.weight, self.fc1.bias,
                             self.fc2.weight, self.fc2.bias, approximate=True)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList([GPTBlock(cfg, device, dtype)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, **kw)

    @unwrap_args
    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = self.wte(input_ids.long()) + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """Parameters of the reference ``GPTForCausalLM`` (tied-embedding
    head), on ``device`` (None → the CUDA card) in ``cfg.dtype``,
    initialised from ``seed``."""

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gpt = GPTModel(cfg, self.device, cfg.dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if p.ndim == 2:                     # embeddings, Linear weights
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("weight"):       # LayerNorm gains
                p.fill_(1.0)
            else:                               # biases
                p.zero_()

    @unwrap_args
    def forward(self, input_ids):
        """[B, S] ids → [B, S, V] logits (tied-embedding head)."""
        return self.gpt(input_ids) @ self.gpt.wte.weight.T

    @unwrap_args
    def loss(self, input_ids, labels):
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())

    @torch.no_grad()
    def load_numpy(self, tree: Dict[str, Any]) -> "GPTForCausalLM":
        """Copy the reference's serving tree (``jax.tree.map(np.asarray,
        paddle_tpu.models.gpt.serving_params(model))``: ``blocks.*``
        stacked over the layers) into this module's parameters."""
        g = self.gpt

        def put(p, arr):
            p.copy_(torch.from_numpy(np.array(arr, np.float32)))

        put(g.wte.weight, tree["wte"])
        put(g.wpe.weight, tree["wpe"])
        put(g.ln_f.weight, tree["lnf_g"])
        put(g.ln_f.bias, tree["lnf_b"])
        for i, blk in enumerate(g.blocks):
            for name, p in blk.named_serving():
                put(p, tree["blocks"][name][i])
        return self


def serving_params(model: GPTForCausalLM) -> Dict[str, Any]:
    """The serving parameter tree of ``model`` (views, no copy):
    {"wte", "wpe", "lnf_g", "lnf_b", "blocks": [per-layer dict]}."""
    g = model.gpt
    return {"wte": g.wte.weight.detach(), "wpe": g.wpe.weight.detach(),
            "lnf_g": g.ln_f.weight.detach(), "lnf_b": g.ln_f.bias.detach(),
            "blocks": [{n: p.detach() for n, p in blk.named_serving()}
                       for blk in g.blocks]}


def serving_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                              dtype=torch.float32) -> Dict[str, Any]:
    """The reference's serving tree (numpy, stacked blocks) as the
    port's serving tree on ``device`` in ``dtype``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    blocks = tree["blocks"]
    L = len(blocks["qkv_w"])
    return {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
            "lnf_g": t(tree["lnf_g"]), "lnf_b": t(tree["lnf_b"]),
            "blocks": [{n: t(blocks[n][i]) for n in _BLOCK_PARAMS}
                       for i in range(L)]}


# ---------------------------------------------------------------------------
# serving math
# ---------------------------------------------------------------------------

def _layer_norm(x, g, b, eps=1e-5):
    """Reference order (gpt.py:358): f32 stats with the population
    variance, the normalised value cast back to x's dtype, then ·g+b."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _serving_qkv(bp, x, cfg: GPTConfig):
    """ln1 + qkv projection, split into per-head q, k, v."""
    B, Q, H = x.shape
    NH = cfg.num_heads
    D = H // NH
    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = h @ bp["qkv_w"] + bp["qkv_b"]
    q, k, v = qkv.split(H, dim=-1)
    return (q.reshape(B, Q, NH, D), k.reshape(B, Q, NH, D),
            v.reshape(B, Q, NH, D))


def _serving_mlp(bp, x):
    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    h = F.gelu(h @ bp["fc1_w"] + bp["fc1_b"], approximate="tanh")
    return x + (h @ bp["fc2_w"] + bp["fc2_b"])


def _prefill_hidden(params, input_ids, cfg: GPTConfig):
    """Final-LN hidden states [B, S, H] and per-layer (k, v)."""
    B, S = input_ids.shape
    ar = torch.arange(S, device=input_ids.device)
    pos = ar[None, :].expand(B, S)
    x = params["wte"][input_ids] + params["wpe"][ar][None]
    kvs = []
    for bp in params["blocks"]:
        q, k, v = _serving_qkv(bp, x, cfg)
        attn = paged_attention_math(q, k, v, pos, 1.0 / math.sqrt(q.shape[-1]))
        x = x + (attn.reshape(B, S, -1) @ bp["proj_w"] + bp["proj_b"])
        x = _serving_mlp(bp, x)
        kvs.append((k, v))
    return _layer_norm(x, params["lnf_g"], params["lnf_b"]), kvs


def serving_forward_logits(params, input_ids, cfg: GPTConfig):
    """No-cache reference forward: [B, S] ids → [B, S, V] logits."""
    x, _ = _prefill_hidden(params, input_ids, cfg)
    return x @ params["wte"].T


def serving_prefill(params, input_ids, lengths, cfg: GPTConfig):
    """Prefill a (padded) prompt batch. [B, S] ids + [B] true lengths →
    (last_logits [B, V], k [L, B, S, NH, D], v [L, B, S, NH, D]);
    last_logits is each request's row at length-1."""
    x, kvs = _prefill_hidden(params, input_ids, cfg)
    B = input_ids.shape[0]
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    ks = torch.stack([k for k, _ in kvs])
    vs = torch.stack([v for _, v in kvs])
    return last @ params["wte"].T, ks, vs


_LAST_DECODE_PATH = None
_DECODE_KERNEL_WARNED = False


def last_decode_kernel_path():
    """'kernel/cuda' | 'kernel/plain' | 'composite' — the path the most
    recent serving_decode_step took (None before any step)."""
    return _LAST_DECODE_PATH


def _decode_kernel_mode(B: int, device: torch.device, dtype=torch.float32,
                        head_dim: int = 0):
    """Routing for the single-kernel decode step (FLAGS_serving_decode_
    kernel): the kernel serves the latency-bound B=1 regime in float32 or
    bfloat16 with head_dim <= 256; other steps keep the composite path
    with a once-warn. 'cuda' launches the Hopper kernel, 'plain' (CPU
    tensors) its plain PyTorch version."""
    global _DECODE_KERNEL_WARNED
    if not get_flag("serving_decode_kernel"):
        return None
    if B != 1:
        why = (f"batch bucket B={B} > 1 keeps the composite decode path (the "
               "single-kernel step targets latency-bound B=1 decode)")
    elif dtype not in KERNEL_DTYPES or head_dim > _MAX_HEAD_DIM:
        why = (f"the decode kernel takes float32 or bfloat16 with head_dim "
               f"<= {_MAX_HEAD_DIM}, got {dtype} and {head_dim}; keeping the "
               "composite decode path")
    else:
        return "cuda" if device.type == "cuda" else "plain"
    if not _DECODE_KERNEL_WARNED:
        _DECODE_KERNEL_WARNED = True
        warnings.warn(f"FLAGS_serving_decode_kernel: {why}")
    return None


def serving_decode_step(params, k_pool, v_pool, tokens, positions,
                        block_tables, cfg: GPTConfig, block_size: int):
    """One fixed-shape decode step through the paged cache.

    k_pool/v_pool [L, NSLOT+1, NH, D] (updated in place); tokens [B]
    int (the incoming token per lane); positions [B] int (the position
    it occupies); block_tables [B, MB] int32 (pad rows all num_blocks).
    Appends the new token's K/V at slot(position) and attends the
    MB*block_size context window with mask j <= position. Returns
    (logits [B, V], k_pool, v_pool)."""
    global _LAST_DECODE_PATH
    B = tokens.shape[0]
    dev = tokens.device
    bt = block_tables
    pos = positions.long()
    new_slot = (bt[torch.arange(B, device=dev), pos // block_size].long()
                * block_size + pos % block_size)
    x = (params["wte"][tokens.long()] + params["wpe"][pos])[:, None]
    kmode = _decode_kernel_mode(B, dev, params["wte"].dtype,
                                cfg.hidden_size // cfg.num_heads)
    if kmode is None:
        ctx_slots = context_slots(bt, block_size)
    for layer, bp in enumerate(params["blocks"]):
        kp, vp = k_pool[layer], v_pool[layer]
        q, k, v = _serving_qkv(bp, x, cfg)
        kv_append(kp, k[:, 0], new_slot)
        kv_append(vp, v[:, 0], new_slot)
        scale = 1.0 / math.sqrt(q.shape[-1])
        if kmode is not None:
            y = decode_attn_proj(q[0, 0].contiguous(), kp, vp, positions[:1], bt[0],
                                 bp["proj_w"], bp["proj_b"],
                                 block_size=block_size, scale=scale)
            x = x + y.to(x.dtype)[None, None, :]
        else:
            attn = paged_attention_math(q, kv_gather(kp, ctx_slots),
                                        kv_gather(vp, ctx_slots),
                                        pos[:, None], scale)
            x = x + (attn.reshape(B, 1, -1) @ bp["proj_w"] + bp["proj_b"])
        x = _serving_mlp(bp, x)
    _LAST_DECODE_PATH = "composite" if kmode is None else f"kernel/{kmode}"
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return x[:, 0] @ params["wte"].T, k_pool, v_pool


def serving_chunk_step(params, k_pool, v_pool, ids, positions, slots,
                       block_tables, cfg: GPTConfig, block_size: int):
    """Multi-token paged-cache step: chunked prefill (B=1, Q a chunk
    bucket) and speculative verify (B a batch bucket, Q = k+1).

    ids/positions/slots [B, Q] int; block_tables [B, MB] int32. The
    slots come from the host: pad rows and over-budget rows target the
    trash row explicitly. Pad rows carry the position sentinel ctx,
    clamped for the attention mask and the position table. Each row's
    K/V lands in the pools (in place) before the context gather, so the
    j <= pos mask admits exactly the logical prefix. Returns (logits
    [B, Q, V], k_pool, v_pool)."""
    B, Q = ids.shape
    NH, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    ctx = block_tables.shape[1] * block_size
    pos = positions.long()
    pos_q = pos.clamp(max=ctx - 1)
    flat_slots = slots.reshape(B * Q)
    ctx_slots = context_slots(block_tables, block_size)
    x = (params["wte"][ids.long()]
         + params["wpe"][pos.clamp(max=params["wpe"].shape[0] - 1)])
    for layer, bp in enumerate(params["blocks"]):
        kp, vp = k_pool[layer], v_pool[layer]
        q, k, v = _serving_qkv(bp, x, cfg)
        kv_append(kp, k.reshape(B * Q, NH, D), flat_slots)
        kv_append(vp, v.reshape(B * Q, NH, D), flat_slots)
        attn = paged_attention_math(q, kv_gather(kp, ctx_slots),
                                    kv_gather(vp, ctx_slots), pos_q,
                                    1.0 / math.sqrt(D))
        x = x + (attn.reshape(B, Q, -1) @ bp["proj_w"] + bp["proj_b"])
        x = _serving_mlp(bp, x)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return x @ params["wte"].T, k_pool, v_pool


# ---------------------------------------------------------------------------
# training: the functional step on one device
# ---------------------------------------------------------------------------

_REMAT_POLICIES = ("dots_saveable", "save_small", "save_qkv", "save_ffn",
                   "save_except_big", "full", "none")
# the reference's save_only_these_names lists (gpt.py:453-471); each also
# saves the flash forward's (out, lse), its flash_out/flash_lse names
_SAVED_NAMES = {
    "save_small": ("attn_out", "proj_out", "fc2_out"),
    "save_qkv": ("attn_out", "proj_out", "fc2_out", "qkv_out"),
    "save_ffn": ("attn_out", "proj_out", "fc2_out", "ffn_act"),
}
_BIG_NAMES = ("qkv_out", "ffn_act")     # save_except_big recomputes these

# the reference's checkpoint_name of the op being called, per thread: the
# recompute runs the block again on the autograd engine's thread
_NAMING = threading.local()


def _named(name, fn, *args, **kwargs):
    """Call ``fn`` with ``name`` as the reference's ``checkpoint_name`` of
    its result: the selective-checkpoint policies read it while the op
    runs (in the forward and again in the recompute)."""
    _NAMING.name = name
    try:
        return fn(*args, **kwargs)
    finally:
        _NAMING.name = None


def _one_device(cfg: GPTConfig, n_micro: int = 1):
    for what, bad in (("vpp_chunks > 1", cfg.vpp_chunks > 1),
                      ("moe_experts > 0", cfg.moe_experts > 0),
                      ("n_micro > 1", n_micro > 1)):
        if bad:
            raise NotImplementedError(
                f"GPT training: {what} needs the pipeline / expert-parallel "
                f"mesh, ported with distributed training (ROADMAP A10)")


def _leaves(tree):
    """Tensors of a nested dict in sorted-key order (jax.tree order)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    return [tree]


def _unflatten(tree, flat):
    """The inverse of ``_leaves``: ``flat`` in ``tree``'s structure."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)

    return build(tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def init_hybrid_params(cfg: GPTConfig, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (gpt.py:216-317) on one device:
    {"wte", "wpe", "lnf_g", "lnf_b", "blocks": {name: [L, ...]}}, normal
    (0, 0.02) weights from a ``torch.Generator`` seeded with ``seed``,
    zero biases, unit LayerNorm gains, in ``cfg.dtype``."""
    _one_device(cfg)
    dev = resolve_device(device)
    H, V, L, FF, SM = (cfg.hidden_size, cfg.vocab_size, cfg.num_layers,
                       cfg.ffn, cfg.max_seq_len)
    g = torch.Generator(device=dev).manual_seed(int(seed))

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
            cfg.dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    NH = cfg.num_heads
    d = H // NH
    dp = cfg.head_pack or d
    Hq = NH * dp
    if dp == d:
        qkv_w = rnd(L, H, 3 * H)
        proj_w = rnd(L, H, H)
    else:
        # packed heads: random in the d logical lanes, zero in the pad
        # lanes (gpt.py:240-246)
        qkv_w = rnd(L, H, 3, NH, dp)
        qkv_w[..., d:] = 0
        qkv_w = qkv_w.reshape(L, H, 3 * Hq)
        proj_w = rnd(L, NH, dp, H)
        proj_w[:, :, d:, :] = 0
        proj_w = proj_w.reshape(L, Hq, H)
    blocks = {"qkv_w": qkv_w, "qkv_b": full(0.0, L, 3 * Hq),
              "proj_w": proj_w, "proj_b": full(0.0, L, H),
              "ln1_g": full(1.0, L, H), "ln1_b": full(0.0, L, H),
              "ln2_g": full(1.0, L, H), "ln2_b": full(0.0, L, H),
              "fc1_w": rnd(L, H, FF), "fc1_b": full(0.0, L, FF),
              "fc2_w": rnd(L, FF, H), "fc2_b": full(0.0, L, H)}
    return {"wte": rnd(V, H), "wpe": rnd(SM, H), "lnf_g": full(1.0, H),
            "lnf_b": full(0.0, H), "blocks": blocks}


def train_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                            dtype=torch.float32) -> Dict[str, Any]:
    """The reference's training tree (``jax.tree.map(np.asarray,
    init_hybrid_params(cfg))``, blocks ``[1, L, ...]``) as the port's tree
    (blocks ``[L, ...]``) on ``device`` in ``dtype``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    blocks = {}
    for name, a in tree["blocks"].items():
        if np.shape(a)[0] != 1:
            raise ValueError(f"blocks.{name} has a pp axis of "
                             f"{np.shape(a)[0]}; one device takes pp=1")
        blocks[name] = t(np.asarray(a)[0])
    return {"wte": t(tree["wte"]), "wpe": t(tree["wpe"]),
            "lnf_g": t(tree["lnf_g"]), "lnf_b": t(tree["lnf_b"]),
            "blocks": blocks}


def train_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``train_params_from_numpy``: float32 numpy arrays,
    blocks ``[1, L, ...]`` as in the reference's tree. Takes the
    parameter tree or an AdamW moment tree."""
    def a(t):
        return t.detach().float().cpu().numpy()

    out = {k: a(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: a(v)[None] for k, v in params["blocks"].items()}
    return out


def _attn_mode(seq_len: int, head_dim: int):
    """'flash' | None: the reference's tile guards (gpt.py:320-335). The
    kernels take any S, but the routing follows the reference so that
    both packages compute the same function for every shape."""
    if seq_len % 128 != 0 or head_dim % 8 != 0:
        return None
    return "flash"


def _mlp_mode(rows: int, h: int, f: int, device: torch.device):
    """'cuda' | 'plain' | None: the reference's fused-MLP routing
    (gpt.py:338-355). ``FLAGS_fused_mlp`` on and a legal ffn tile
    (``mlp_eligible``) take the fused route: the kernels for CUDA
    tensors, their plain versions for CPU tensors. One device, so the
    reference's trivial-mp condition always holds."""
    mode = _fused_mode(device)
    if mode is None or not mlp_eligible(rows, h, f):
        return None
    return mode


def _affine(x, w, b):
    """x @ w + b as one addmm: one dispatcher op, so a checkpoint policy
    can save the product it names."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _block_apply(bp, x, cfg: GPTConfig):
    """One transformer block on [B, S, H] (gpt.py:365-440). Returns (x,
    aux) with aux = 0 (no MoE on one device)."""
    n_heads = cfg.num_heads
    B, S, H = x.shape
    d_head = H // n_heads           # logical head dim: sets the scale
    dp = cfg.head_pack or d_head    # physical (possibly packed) lanes
    h = _layer_norm(x, bp["ln1_g"], bp["ln1_b"])
    qkv = _named("qkv_out", _affine, h, bp["qkv_w"], bp["qkv_b"])
    q, k, v = (t.reshape(B, S, n_heads, dp)
               for t in qkv.split(n_heads * dp, dim=-1))
    scale = 1.0 / math.sqrt(d_head)
    if _attn_mode(S, dp) is not None:
        out = flash_attention_bshd(q, k, v, causal=True, scale=scale)
    else:
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        scores = (qh @ kh.transpose(2, 3)).float() * scale
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        scores = scores.masked_fill(~mask, -1e9)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _named("attn_out", torch.matmul, attn, vh).transpose(1, 2)
    out = out.reshape(B, S, n_heads * dp)
    x = x + _named("proj_out", _affine, out, bp["proj_w"], bp["proj_b"])
    h = _layer_norm(x, bp["ln2_g"], bp["ln2_b"])
    zero = x.new_zeros((), dtype=torch.float32)
    ffn = bp["fc1_w"].shape[-1]
    mode = _mlp_mode(B * S, H, ffn, x.device)
    _mlp_introspect._LAST_PATH = \
        "dense" if mode is None else f"fused_mlp/{mode}"
    if mode is not None:
        # the [B*S, ffn] GeLU activation never exists whole in device
        # memory; 'ffn_act' vanishes on this route (save_ffn saves less)
        y = _named("fc2_out", fused_mlp_2d, h.reshape(B * S, H),
                   bp["fc1_w"], bp["fc1_b"], bp["fc2_w"], bp["fc2_b"],
                   approximate=True)
        return x + y.reshape(B, S, H), zero
    h = _named("ffn_act", F.gelu, _affine(h, bp["fc1_w"], bp["fc1_b"]),
               approximate="tanh")
    return x + _named("fc2_out", _affine, h, bp["fc2_w"], bp["fc2_b"]), zero


def _policy(remat: str):
    """The selective-checkpoint policy of a reference remat policy."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    dots = (aten.mm.default, aten.addmm.default, aten.bmm.default)
    flash = torch.ops.paddle_tpu_torch.flash_fwd.default
    # the fused MLP forward's output is the reference's fc2_out: saved by
    # the save_* policies and save_except_big, recomputed under
    # dots_saveable (not a dot) and full
    named_ops = dots + (aten.gelu.default,
                        torch.ops.paddle_tpu_torch.fused_mlp_fwd.default)
    names = _SAVED_NAMES.get(remat, ())

    def policy(ctx, op, *args, **kwargs):
        name = getattr(_NAMING, "name", None)
        if op is flash:
            save = True
        elif remat == "dots_saveable":
            save = op in dots
        elif remat == "save_except_big":
            save = not (name in _BIG_NAMES and op in named_ops)
        else:
            save = name in names and op in named_ops
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _stage_fn(stage_params, x, cfg: GPTConfig, remat: bool = True):
    """Apply the layers (a loop over the stacked layer axis, gpt.py:443-
    496), each under the config's remat policy: ``full`` checkpoints the
    block and recomputes all of it, ``none`` keeps every activation, the
    others save what the reference's policy saves and recompute the
    rest. Returns (h, aux summed over the layers)."""
    body = functools.partial(_block_apply, cfg=cfg)
    if remat and cfg.remat_policy == "none":
        remat = False
    kwargs = dict(use_reentrant=False)
    if remat:
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be 'dots_saveable', 'save_small', "
                f"'save_qkv', 'save_ffn', 'save_except_big', 'full' or "
                f"'none', got {cfg.remat_policy!r}")
        if cfg.remat_policy != "full":
            kwargs["context_fn"] = functools.partial(
                _ckpt.create_selective_checkpoint_contexts,
                _policy(cfg.remat_policy))
    # unbind: one stacked gradient per leaf in the backward, where
    # per-layer indexing would scatter into a full [L, ...] zero tensor
    # for every layer
    layers = {name: t.unbind(0) for name, t in stage_params.items()}
    aux = x.new_zeros((), dtype=torch.float32)
    for i in range(len(layers["qkv_w"])):
        bp = {name: ts[i] for name, ts in layers.items()}
        if remat:
            x, a = _ckpt.checkpoint(body, bp, x, **kwargs)
        else:
            x, a = body(bp, x)
        aux = aux + a
    return x, aux


def _forward_hidden(params, input_ids, cfg: GPTConfig, n_micro: int = 1):
    """Forward to the final-LayerNorm hidden states [B, S, H] (gpt.py:499;
    one device: no pp or sep region)."""
    _one_device(cfg, n_micro)
    S = input_ids.shape[1]
    x = F.embedding(input_ids.long(), params["wte"]) + params["wpe"][:S]
    x, aux = _stage_fn(params["blocks"], x.to(cfg.dtype), cfg)
    return _layer_norm(x, params["lnf_g"], params["lnf_b"]), aux


def _forward(params, input_ids, cfg: GPTConfig, n_micro: int = 1):
    x, aux = _forward_hidden(params, input_ids, cfg, n_micro)
    return x @ params["wte"].T.to(cfg.dtype), aux


def loss_fn(params, input_ids, labels, cfg: GPTConfig, n_micro: int = 1):
    """Mean token cross-entropy (gpt.py:565-590): the plain head, or the
    chunked one (kernels/chunked_xent.py) for lm_head='chunked', or
    'auto' under remat 'full', at vocab >= 8192."""
    x, _ = _forward_hidden(params, input_ids, cfg, n_micro)
    use_chunked = (cfg.lm_head == "chunked" or
                   (cfg.lm_head == "auto" and cfg.remat_policy == "full"))
    if cfg.vocab_size >= 8192 and use_chunked:
        return chunked_softmax_xent(x, params["wte"].to(cfg.dtype), labels)
    logits32 = (x @ params["wte"].T.to(cfg.dtype)).float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.01):
    """AdamW over the whole tree (gpt.py:593-626), IN PLACE: parameters,
    moments and the step count are overwritten (the reference returns new
    arrays and donates the old). The update math is f32; moments are
    stored in their own dtype (``cfg.opt_dtype``), each rounded once after
    the f32 math. Returns (params, opt_state)."""
    step = opt_state["step"] + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(opt_state["m"]), _leaves(opt_state["v"])):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        p32 = p.float()
        p32 = p32 - lr * ((m32 / c1) / (torch.sqrt(v32 / c2) + eps)
                          + wd * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"].copy_(step)
    return params, opt_state


def init_opt_state(params, dtype=torch.float32):
    """AdamW state: step 0 (int32) and zero moments in ``dtype``."""
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=params["wte"].device),
            "m": _tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params),
            "v": _tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)}


def make_train_step(cfg: GPTConfig, n_micro: int = 1, lr=1e-4):
    """One train step: (params, opt_state, input_ids, labels) → (params,
    opt_state, loss). Parameters and moments are updated IN PLACE (the
    returned trees are the ones passed in), where the reference's jitted
    step donates them."""
    _one_device(cfg, n_micro)

    def train_step(params, opt_state, input_ids, labels):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, input_ids, labels, cfg, n_micro)
        grads = torch.autograd.grad(loss, leaves)
        adamw_update(params, _unflatten(params, grads), opt_state, lr=lr)
        return params, opt_state, loss.detach()

    return train_step
