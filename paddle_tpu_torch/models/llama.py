"""LLaMA — the Layer model, trained on one device.

Counterpart: ``paddle_tpu/models/llama.py``: ``LlamaConfig`` /
``CONFIGS`` (:21-52), ``_rope`` (:55-59), ``LlamaAttention`` (:62-101),
``LlamaMLP`` (:104-133), ``LlamaDecoderLayer`` (:136-148), ``LlamaModel``
(:151-168), ``LlamaForCausalLM`` with ``forward`` and ``loss``
(:171-186), and the serving functions (:189-432):
``llama_serving_params``, the ``_srv_*`` helpers,
``llama_serving_forward_logits``, ``llama_serving_prefill``,
``llama_serving_decode_step`` and ``llama_serving_chunk_step`` (the
engine's adapter is ``inference.engine.llama_adapter``).
``use_tp=True`` (the tensor-parallel layers) is A10 and raises
NotImplementedError.

The modules are ``nn.Module``s on an explicit ``device`` (None → the
CUDA card) in ``dtype``, initialised from ``seed`` with a
``torch.Generator`` on that device, with the reference's distributions:
Xavier-normal Linear weights (``nn/layer/common.py:19``, std
``sqrt(2 / (in + out))``), normal(0, 1) embeddings (:99) and unit RMSNorm
gains. ``state_dict()`` keys are the reference model's, letter for
letter (``llama.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``),
with Paddle's ``[in, out]`` Linear weights; ``load_numpy`` takes the
reference's state dict as numpy arrays.

Attention runs through ``scaled_dot_product_attention`` (the flash
kernels on a card), after GQA repeats the K/V heads as the reference
does. The MLP runs through ``nn.functional.fused_swiglu`` (the SwiGLU
kernels on a card with ``FLAGS_fused_mlp`` on, the reference's default).
RoPE rounds the rotated q and k back to their dtype, where the
reference's promotes a bf16 model to f32 (ROADMAP C); the loss takes
the cross-entropy of f32 logits, as the reference's bf16 model
effectively does. The labels are compared with the logits as given, not
shifted, as in the reference.

Serving, as in the reference: plain functions over a parameter tree
whose ``blocks`` is a list of per-layer dicts of views of the model's
parameters (the reference stacks the layer axis), with f32 RoPE tables
over ``max_position_embeddings`` (neox layout). The pools hold
``cfg.kv_heads`` heads (GQA: ``paged_attention_math`` folds the query
heads into groups, K/V never repeat) and store post-RoPE keys. The
pools are updated in place. Attention is ``paged_attention_math`` and
the MLP a plain SwiGLU, as in the reference; no kernel runs on this
path. The serving rotation is rounded back to q's dtype as the
training one is, where the reference promotes a bf16 model to f32
(ROADMAP C); in f32 the two agree. Position-table gathers clamp to the
table's edge, as JAX's gathers do, where torch would raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..core.tensor import unwrap_args
from ..incubate.nn.functional import _rotate, fused_rotary_position_embedding
from ..inference.kv_cache import context_slots, kv_append, kv_gather
from ..nn.functional.attention import (paged_attention_math,
                                       scaled_dot_product_attention)
from ..nn.functional.mlp import fused_swiglu
from ..nn.layer.norm import RMSNorm

__all__ = ["LlamaConfig", "CONFIGS", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "llama_serving_params", "llama_serving_params_from_numpy",
           "llama_serving_forward_logits", "llama_serving_prefill",
           "llama_serving_decode_step", "llama_serving_chunk_step"]

_SRV_BLOCK = ("in_ln_g", "q_w", "k_w", "v_w", "o_w", "post_ln_g", "gate_w",
              "up_w", "down_w")


class LlamaConfig(NamedTuple):
    """The reference's config (llama.py:21-33), same fields, order and
    defaults."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None   # GQA; None = MHA
    intermediate_size: int = 11008
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def kv_heads(self):
        return self.num_key_value_heads or self.num_attention_heads


CONFIGS = {
    "llama-7b": LlamaConfig(),
    "llama-13b": LlamaConfig(hidden_size=5120, num_hidden_layers=40,
                             num_attention_heads=40,
                             intermediate_size=13824),
    "llama2-70b": LlamaConfig(hidden_size=8192, num_hidden_layers=80,
                              num_attention_heads=64,
                              num_key_value_heads=8,
                              intermediate_size=28672,
                              max_position_embeddings=4096),
    "tiny": LlamaConfig(vocab_size=512, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, intermediate_size=128,
                        max_position_embeddings=64),
}


def _no_tp(use_tp):
    if use_tp:
        raise NotImplementedError(
            "llama: use_tp (the tensor-parallel layers over the mp mesh "
            "axis) is ported with the distributed slice (ROADMAP A10)")


def _rope(q, k):
    oq, ok, _ = fused_rotary_position_embedding(q, k,
                                                use_neox_rotary_style=True)
    return oq, ok


class _Linear(nn.Module):
    """Paddle-layout linear without bias: weight [in, out]."""

    def __init__(self, n_in: int, n_out: int, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=dtype))

    def forward(self, x):
        return x @ self.weight


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        _no_tp(use_tp)
        H = cfg.hidden_size
        self.nh = cfg.num_attention_heads
        self.nkv = cfg.kv_heads
        self.head_dim = H // self.nh
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.q_proj = _Linear(H, H, **kw)
        self.k_proj = _Linear(H, self.nkv * self.head_dim, **kw)
        self.v_proj = _Linear(H, self.nkv * self.head_dim, **kw)
        self.o_proj = _Linear(H, H, **kw)

    def forward(self, x):
        B, S, H = x.shape
        q = self.q_proj(x).reshape(B, S, self.nh, self.head_dim)
        k = self.k_proj(x).reshape(B, S, self.nkv, self.head_dim)
        v = self.v_proj(x).reshape(B, S, self.nkv, self.head_dim)
        q, k = _rope(q, k)
        if self.nkv != self.nh:  # GQA: repeat KV groups
            rep = self.nh // self.nkv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(B, S, H))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)) through ``fused_swiglu``."""

    def __init__(self, cfg: LlamaConfig, use_tp: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        _no_tp(use_tp)
        H, FF = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.gate_proj = _Linear(H, FF, **kw)
        self.up_proj = _Linear(H, FF, **kw)
        self.down_proj = _Linear(FF, H, **kw)

    def forward(self, x):
        return fused_swiglu(x, self.gate_proj.weight, self.up_proj.weight,
                            self.down_proj.weight)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, use_tp, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                epsilon=cfg.rms_norm_eps,
                                                **kw)
        self.mlp = LlamaMLP(cfg, use_tp, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_tp: bool = False, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        _no_tp(use_tp)
        self.cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, use_tp, **kw)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)

    @unwrap_args
    def forward(self, input_ids):
        x = self.embed_tokens(input_ids.long())
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """The reference's ``LlamaForCausalLM`` (untied head) on ``device``
    (None → the CUDA card) in ``dtype``, initialised from ``seed``."""

    def __init__(self, cfg: LlamaConfig, use_tp: bool = False, *,
                 device: DeviceLike = None, dtype=torch.bfloat16,
                 seed: int = 0):
        super().__init__()
        _no_tp(use_tp)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.llama = LlamaModel(cfg, device=self.device, dtype=dtype)
        self.lm_head = _Linear(cfg.hidden_size, cfg.vocab_size, self.device,
                               dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, _Linear):
                n_in, n_out = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (n_in + n_out)),
                                   generator=g)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=g)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    @unwrap_args
    def forward(self, input_ids):
        """[B, S] ids → [B, S, V] logits in the model's dtype."""
        return self.lm_head(self.llama(input_ids))

    @unwrap_args
    def loss(self, input_ids, labels):
        """Mean token cross-entropy of the f32 logits against ``labels``
        as given (llama.py:180-186)."""
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1).long())

    @torch.no_grad()
    def load_numpy(self, state: Dict[str, Any]) -> "LlamaForCausalLM":
        """Copy the reference's state dict (name → numpy array, the
        reference's names and [in, out] layout) into the parameters."""
        params = dict(self.named_parameters())
        if set(state) != set(params):
            raise KeyError(f"load_numpy: names differ from the model's: "
                           f"missing {sorted(set(params) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(params))}")
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(state[name], np.float32)))
        return self


# ---------------------------------------------------------------------------
# serving: prefill / paged-cache decode / chunk steps (inference/engine.py)
# ---------------------------------------------------------------------------

def _rope_tables(cfg: LlamaConfig, device):
    """sin, cos [max_position_embeddings, D] f32 in the neox layout, the
    reference's arithmetic (llama.py:231-235)."""
    D = cfg.hidden_size // cfg.num_attention_heads
    pos = torch.arange(cfg.max_position_embeddings, device=device,
                       dtype=torch.float32)[:, None]
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, D, 2, device=device, dtype=torch.float32) / D))
    emb = torch.cat([pos * inv[None, :]] * 2, dim=-1)
    return torch.sin(emb), torch.cos(emb)


def llama_serving_params(model: LlamaForCausalLM) -> Dict[str, Any]:
    """The serving parameter tree of ``model`` (views, no copy):
    {"embed", "norm_g", "head_w", "rope_sin", "rope_cos", "blocks":
    [per-layer dict of ``_SRV_BLOCK``]}."""
    m = model.llama
    blocks = []
    for layer in m.layers:
        a, mlp = layer.self_attn, layer.mlp
        blocks.append({n: p.detach() for n, p in zip(_SRV_BLOCK, (
            layer.input_layernorm.weight, a.q_proj.weight, a.k_proj.weight,
            a.v_proj.weight, a.o_proj.weight,
            layer.post_attention_layernorm.weight, mlp.gate_proj.weight,
            mlp.up_proj.weight, mlp.down_proj.weight))})
    sin, cos = _rope_tables(model.cfg, model.device)
    return {"embed": m.embed_tokens.weight.detach(),
            "norm_g": m.norm.weight.detach(),
            "head_w": model.lm_head.weight.detach(),
            "rope_sin": sin, "rope_cos": cos, "blocks": blocks}


def llama_serving_params_from_numpy(tree: Dict[str, Any],
                                    device: DeviceLike = None,
                                    dtype=torch.float32) -> Dict[str, Any]:
    """The reference's serving tree (numpy, stacked blocks) as the port's
    on ``device``: weights in ``dtype``, the RoPE tables in f32."""
    dev = resolve_device(device)

    def t(a, dt=dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    blocks = tree["blocks"]
    return {"embed": t(tree["embed"]), "norm_g": t(tree["norm_g"]),
            "head_w": t(tree["head_w"]),
            "rope_sin": t(tree["rope_sin"], torch.float32),
            "rope_cos": t(tree["rope_cos"], torch.float32),
            "blocks": [{n: t(blocks[n][i]) for n in _SRV_BLOCK}
                       for i in range(len(blocks["q_w"]))]}


def _srv_rms(x, g, eps):
    """The reference's inlined RMSNorm (llama.py:243-247)."""
    ms = x.square().mean(-1, keepdim=True)
    return (x / torch.sqrt(ms + eps)) * g


def _srv_rope(x, sin_t, cos_t, pos_ids):
    """Neox rotation of x [B, S, H, D] at absolute positions pos_ids
    [B, S] (clamped to the table), rounded back to x's dtype."""
    ids = pos_ids.long().clamp(0, sin_t.shape[0] - 1)
    return _rotate(x, sin_t[ids][:, :, None, :], cos_t[ids][:, :, None, :],
                   True)


def _srv_qkv(bp, tables, x, pos_ids, cfg: LlamaConfig):
    """RMSNorm, the Q/K/V projections and RoPE: q [B, S, NH, D] and k, v
    [B, S, KVH, D], the pools' width (no GQA repeat)."""
    B, S, H = x.shape
    NH, KVH = cfg.num_attention_heads, cfg.kv_heads
    D = H // NH
    h = _srv_rms(x, bp["in_ln_g"], cfg.rms_norm_eps)
    q = (h @ bp["q_w"]).reshape(B, S, NH, D)
    k = (h @ bp["k_w"]).reshape(B, S, KVH, D)
    v = (h @ bp["v_w"]).reshape(B, S, KVH, D)
    return _srv_rope(q, *tables, pos_ids), _srv_rope(k, *tables, pos_ids), v


def _srv_mlp(bp, x, cfg: LlamaConfig):
    h = _srv_rms(x, bp["post_ln_g"], cfg.rms_norm_eps)
    return x + (F.silu(h @ bp["gate_w"]) * (h @ bp["up_w"])) @ bp["down_w"]


def _srv_scan(params, input_ids, cfg: LlamaConfig):
    """The no-cache forward over the layers: final-norm hidden states
    [B, S, H] and the per-layer (k, v) — post-RoPE k."""
    B, S = input_ids.shape
    H = cfg.hidden_size
    D = H // cfg.num_attention_heads
    pos = torch.arange(S, device=input_ids.device)[None, :].expand(B, S)
    tables = (params["rope_sin"], params["rope_cos"])
    x = params["embed"][input_ids.long()]
    kvs = []
    for bp in params["blocks"]:
        q, k, v = _srv_qkv(bp, tables, x, pos, cfg)
        attn = paged_attention_math(q, k, v, pos, 1.0 / math.sqrt(D))
        x = x + attn.reshape(B, S, H) @ bp["o_w"]
        x = _srv_mlp(bp, x, cfg)
        kvs.append((k, v))
    return _srv_rms(x, params["norm_g"], cfg.rms_norm_eps), kvs


def llama_serving_forward_logits(params, input_ids, cfg: LlamaConfig):
    """No-cache reference forward: [B, S] ids → [B, S, V] logits."""
    x, _ = _srv_scan(params, input_ids, cfg)
    return x @ params["head_w"]


def llama_serving_prefill(params, input_ids, lengths, cfg: LlamaConfig):
    """[B, S] ids + [B] true lengths → (last_logits [B, V], k [L, B, S,
    KVH, D], v [...]); k is post-RoPE, as the cache stores it."""
    x, kvs = _srv_scan(params, input_ids, cfg)
    B = input_ids.shape[0]
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return (last @ params["head_w"], torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _paged_layers(params, x, k_pool, v_pool, pos_rope, pos_q, slots,
                  ctx_slots, cfg: LlamaConfig):
    """The layers of a paged step: each appends its [B*Q] rows of K/V
    at ``slots`` (in place), then attends the gathered context."""
    B, Q, H = x.shape
    KVH, D = cfg.kv_heads, H // cfg.num_attention_heads
    tables = (params["rope_sin"], params["rope_cos"])
    for layer, bp in enumerate(params["blocks"]):
        kp, vp = k_pool[layer], v_pool[layer]
        q, k, v = _srv_qkv(bp, tables, x, pos_rope, cfg)
        kv_append(kp, k.reshape(B * Q, KVH, D), slots)
        kv_append(vp, v.reshape(B * Q, KVH, D), slots)
        attn = paged_attention_math(q, kv_gather(kp, ctx_slots),
                                    kv_gather(vp, ctx_slots), pos_q,
                                    1.0 / math.sqrt(D))
        x = x + attn.reshape(B, Q, H) @ bp["o_w"]
        x = _srv_mlp(bp, x, cfg)
    return _srv_rms(x, params["norm_g"], cfg.rms_norm_eps)


def llama_serving_decode_step(params, k_pool, v_pool, tokens, positions,
                              block_tables, cfg: LlamaConfig,
                              block_size: int):
    """One fixed-shape decode step through the paged cache, GQA pools
    [L, NSLOT+1, KVH, D] updated in place; the slot arithmetic and the
    pad-lane trash-row contract of ``gpt.serving_decode_step``. Returns
    (logits [B, V], k_pool, v_pool)."""
    B = tokens.shape[0]
    dev = tokens.device
    pos = positions.long()
    new_slot = (block_tables[torch.arange(B, device=dev),
                             pos // block_size].long() * block_size
                + pos % block_size)
    x = params["embed"][tokens.long()][:, None]
    x = _paged_layers(params, x, k_pool, v_pool, pos[:, None], pos[:, None],
                      new_slot, context_slots(block_tables, block_size), cfg)
    return x[:, 0] @ params["head_w"], k_pool, v_pool


def llama_serving_chunk_step(params, k_pool, v_pool, ids, positions, slots,
                             block_tables, cfg: LlamaConfig,
                             block_size: int):
    """Multi-token paged-cache step (chunked prefill, speculative verify),
    the GQA mirror of ``gpt.serving_chunk_step``: host-computed slots
    [B, Q] (pad rows → trash), RoPE at each row's absolute position
    clamped at the table's edge, the mask's position at the context's,
    K stored post-RoPE. Returns (logits [B, Q, V], k_pool, v_pool)."""
    B, Q = ids.shape
    pos = positions.long()
    ctx = block_tables.shape[1] * block_size
    x = _paged_layers(params, params["embed"][ids.long()], k_pool, v_pool,
                      pos.clamp(max=cfg.max_position_embeddings - 1),
                      pos.clamp(max=ctx - 1), slots.reshape(B * Q),
                      context_slots(block_tables, block_size), cfg)
    return x @ params["head_w"], k_pool, v_pool
