"""LLaMA — the Layer model, trained on one device.

Counterpart: ``paddle_tpu/models/llama.py``: ``LlamaConfig`` /
``CONFIGS`` (:21-52), ``_rope`` (:55-59), ``LlamaAttention`` (:62-101),
``LlamaMLP`` (:104-133), ``LlamaDecoderLayer`` (:136-148), ``LlamaModel``
(:151-168) and ``LlamaForCausalLM`` with ``forward`` and ``loss``
(:171-186). The serving functions (:189-) and the engine's adapter are
ROADMAP A4b; ``use_tp=True`` (the tensor-parallel layers) is A10 and
raises NotImplementedError.

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
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..incubate.nn.functional import fused_rotary_position_embedding
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.mlp import fused_swiglu
from ..nn.layer.norm import RMSNorm

__all__ = ["LlamaConfig", "CONFIGS", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM"]


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

    def forward(self, input_ids):
        """[B, S] ids → [B, S, V] logits in the model's dtype."""
        return self.lm_head(self.llama(input_ids))

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
