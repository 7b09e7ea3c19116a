"""Transformer layers.

Counterpart: ``paddle_tpu/nn/layer/transformer.py``:
``_convert_attention_mask`` (:22-29, a bool mask becomes an f32 additive
mask of 0 and -1e9), ``MultiHeadAttention`` with ``Cache`` /
``StaticCache`` and ``gen_cache`` (:32-97), ``TransformerEncoderLayer``
and ``TransformerEncoder`` (:99-178), ``TransformerDecoderLayer`` and
``TransformerDecoder`` (:181-256), pre-norm (``normalize_before``) and
post-norm, ``Transformer`` with ``generate_square_subsequent_mask``
(:258-292) and ``_clone_layer`` (:294-302).

``MultiHeadAttention`` projects q, k and v with four ``Linear`` layers
and attends through ``F.scaled_dot_product_attention`` on Paddle's [b, s,
h, d] layout: no mask and a [B, 1, 1, Sk] key-padding mask take the
flash kernels (TPU kernels 1-3; the dropout variant at ``dropout > 0``
while training, one generator split per call), any other mask (the
decoder's [S, S] causal mask) the reference's dense route with its
once-warning. The LayerNorms take the fused kernels (13, 14) through
``F.layer_norm``. The feed-forward stays ``linear1 → activation →
Dropout → linear2`` as in the reference (:133): the fused MLP kernels
place their dropout elsewhere. So the generator splits in the
reference's order: the attention's, then ``dropout1``, the FFN's
``dropout``, ``dropout2`` (and ``dropout3`` in a decoder layer). The
residual adds are the registered ``add``, as the reference's Tensor
``+`` is.

``_clone_layer`` is the reference's: a deep copy of the layer, the
parameters fresh tensors under the same names. So every layer of a
``TransformerEncoder`` or ``TransformerDecoder`` starts with the first
layer's weights (upstream Paddle builds each layer anew); the port keeps
that (ROADMAP C, "Found in the reference, kept by the port").

Every layer takes ``device=`` (None: the current place).
"""
from __future__ import annotations

import collections
import copy

import torch

from ..._device import DeviceLike, resolve_device
from ...core.tensor import to_plain
from ...ops import add, concat, reshape, zeros
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True keeps) as an additive mask of ``dtype``: 0 where
    kept, -1e9 elsewhere; a float mask as it is."""
    if attn_mask is None:
        return None
    v = to_plain(attn_mask)
    if v.dtype == torch.bool:
        return torch.where(v, 0.0, -1e9).to(dtype)
    return attn_mask


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device: DeviceLike = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        dev = resolve_device(device)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr,
                             device=dev)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=dev)

    def _shape(self, x):
        """[B, S, E] → [B, S, H, D]."""
        return reshape(x, [x.shape[0], x.shape[1], self.num_heads,
                           self.head_dim])

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``StaticCache``: the projected keys and values of ``key`` /
        ``value`` (cross-attention's memory); otherwise an empty ``Cache``
        that each call extends along the sequence axis."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        k = zeros([key.shape[0], 0, self.num_heads, self.head_dim],
                  dtype="float32").to(to_plain(key).device)
        return self.Cache(k, k)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, torch.float32)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training)
        out = reshape(out, [out.shape[0], out.shape[1], self.embed_dim])
        out = self.out_proj(out)
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device: DeviceLike = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = resolve_device(device)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device: DeviceLike = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        dev = resolve_device(device)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=dev)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=dev)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=dev)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory,
                                               type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 device: DeviceLike = None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        dev = resolve_device(device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev)
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=dev)
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] f32: 0 on and below the diagonal, -inf above,
        on the model's device."""
        dev = next(iter(self.parameters()), torch.empty(0)).device
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=dev).tril()
        return torch.where(keep, 0.0, float("-inf")).float()


def _clone_layer(layer):
    """A deep copy of ``layer``: fresh parameter tensors under the same
    names, holding the same values (the reference's ``_clone_layer``,
    whose docstring promises re-initialised parameters)."""
    return copy.deepcopy(layer)
