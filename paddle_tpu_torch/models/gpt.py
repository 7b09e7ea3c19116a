"""GPT — the decoder-only LM, serving half.

Counterpart: ``paddle_tpu/models/gpt.py``: ``GPTConfig`` / ``CONFIGS``
(:39, :100), the ``GPTForCausalLM`` parameter layout (:116-200) and the
serving functions (:686-880). The training step (``init_hybrid_params``,
``_block_apply``, ``loss_fn``, ``adamw_update``) and ``serving_chunk_step``
belong to later slices (ROADMAP.md).

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

The three serving functions share ``paged_attention_math`` as in the
reference. ``serving_decode_step`` updates the pools IN PLACE and
returns them; with ``FLAGS_serving_decode_kernel`` on and a B=1 bucket,
each layer's attention + output projection is one ``decode_attn_proj``
call (the hand-written CUDA kernel on a card).
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..core.flags import get_flag
from ..inference.kv_cache import kv_append, kv_gather
from ..kernels.mlp_fusion import decode_attn_proj
from ..nn.functional.attention import paged_attention_math

__all__ = ["GPTConfig", "CONFIGS", "GPTForCausalLM", "serving_params",
           "serving_params_from_numpy", "serving_forward_logits",
           "serving_prefill", "serving_decode_step",
           "last_decode_kernel_path"]

_BLOCK_PARAMS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


class GPTConfig(NamedTuple):
    """The reference's config fields that the serving path reads (the
    training knobs come with the training slice)."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: Optional[int] = None
    dtype: Any = torch.bfloat16

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
    """Paddle-layout linear parameters: weight [in, out], bias [out]."""

    def __init__(self, n_in: int, n_out: int, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out, device=device,
                                             dtype=dtype))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device, dtype):
        super().__init__()
        H = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.ln1 = nn.LayerNorm(H, **kw)
        self.qkv = Linear(H, 3 * H, **kw)
        self.proj = Linear(H, H, **kw)
        self.ln2 = nn.LayerNorm(H, **kw)
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


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList([GPTBlock(cfg, device, dtype)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, **kw)


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

    def forward(self, input_ids):
        raise NotImplementedError(
            "GPTForCausalLM.forward (the Layer forward) uses the flash-"
            "attention and fused-MLP kernels and is ported with the GPT "
            "training step (ROADMAP.md queue A, item A2); "
            "serve through serving_params / inference.gpt_adapter")

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


def _decode_kernel_mode(B: int, device: torch.device):
    """Routing for the single-kernel decode step (FLAGS_serving_decode_
    kernel): the kernel serves the latency-bound B=1 regime; B>1 steps
    keep the composite path with a once-warn. 'cuda' launches the
    Hopper kernel, 'plain' (CPU tensors) its plain PyTorch version."""
    global _DECODE_KERNEL_WARNED
    if not get_flag("serving_decode_kernel"):
        return None
    if B != 1:
        if not _DECODE_KERNEL_WARNED:
            _DECODE_KERNEL_WARNED = True
            warnings.warn(
                "FLAGS_serving_decode_kernel: batch bucket B="
                f"{B} > 1 keeps the composite decode path (the "
                "single-kernel step targets latency-bound B=1 decode)")
        return None
    return "cuda" if device.type == "cuda" else "plain"


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
    MB = block_tables.shape[1]
    dev = tokens.device
    bt = block_tables
    pos = positions.long()
    new_slot = (bt[torch.arange(B, device=dev), pos // block_size].long()
                * block_size + pos % block_size)
    x = (params["wte"][tokens.long()] + params["wpe"][pos])[:, None]
    kmode = _decode_kernel_mode(B, dev)
    if kmode is None:
        ctx_i = torch.arange(MB * block_size, device=dev)
        ctx_slots = bt[:, ctx_i // block_size].long() * block_size \
            + (ctx_i % block_size)[None, :]
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
