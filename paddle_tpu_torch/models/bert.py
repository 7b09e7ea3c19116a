"""BERT — the encoder-only model family, pretrained on one device.

Counterpart: ``paddle_tpu/models/bert.py``: ``BertConfig`` / ``CONFIGS``
(:22-43), ``BertEmbeddings`` (:46-66), ``BertLayer`` (:69-113),
``BertPooler`` (:116-122), ``BertModel`` with its [B, S] → additive
[B, 1, 1, S] mask (:125-143), ``BertPretrainingHeads`` with the tied
decoder weight and ``per_token_mlm_loss`` (:146-180),
``BertForPretraining.forward`` / ``.loss`` (:183-204) and
``BertForSequenceClassification`` (:207-217), its pooled output's
dropout included.

The modules are ``nn.Layer``s on an explicit ``device`` (None → the
current place: the CUDA card unless ``set_device`` says otherwise) in ``dtype``, initialised from ``seed`` with a
``torch.Generator`` on that device, with the reference's distributions:
Xavier-normal Linear weights (``nn/layer/common.py:19``, std
``sqrt(2 / (in + out))``), normal(0, 1) embeddings (:99), zero biases,
unit LayerNorm gains. ``state_dict()`` keys are the reference model's,
letter for letter (``bert.encoder.0.qkv.weight``, ``cls.decoder_bias``),
with Paddle's ``[in, out]`` Linear weights. The MLM decoder weight is
the word-embedding table itself, held by the heads unregistered (it is
not a key of either state dict): one tensor, which ``load_numpy`` and the
optimizer update in place and whose gradient sums both uses.

Every op the reference dispatches goes through the port's registered
op of the same name, as many times (``embedding``, ``add``, ``linear``,
``tanh``, ``gelu``, ``matmul``, ``chunked_mlm_xent``, ``cross_entropy``,
the fused ops below, and the arithmetic of ``ops/``: ``split_even`` and
``reshape`` of the heads, ``getitem`` of the pooled token, ``cast``,
``subtract``, ``multiply`` and ``unsqueeze`` of the padding mask,
``not_equal``, ``where``, ``zeros_like``, ``multiply``, ``sum`` and
``divide`` of the loss), so the model runs under ``amp.auto_cast`` and
``amp.decorate`` with the reference's casts (at O2 the loss arithmetic is
bf16, as the reference's is) and its operator table is the reference's;
every parameter carries the reference's unique name (``p.name``,
``nn.layer.layers.name_parameters``). The entry points (``forward``,
``loss``) take facade tensors (``core/tensor.py``) as plain ones.

The block runs the reference's fused route at the default flags:
attention through ``scaled_dot_product_attention`` (the flash kernels,
with the padding mask as their key-padding bias), the attention output
projection folded into the sublayer close by
``fused_attn_proj_residual_layer_norm`` (the projection-LN kernels), the
erf-GeLU MLP by ``fused_mlp`` and the FFN close by
``fused_bias_dropout_residual_layer_norm`` (the LayerNorm kernels); the
embeddings' and the MLM transform's ``LayerNorm`` through
``nn.functional.layer_norm``. A bf16 model keeps bf16 I/O through the
fused kernels (f32 statistics inside them); the losses are taken in f32.

Dropout runs at the config's rates (0.1 and 0.1 by default) wherever
the reference applies it, each site taking one split of the framework
generator (``paddle_tpu_torch.seed``, ``core/generator.py``) in the
reference's order, 1 + 3·L splits a forward in training mode: the
embeddings' ``nn.Dropout`` (a dense mask), then per layer the attention
probabilities (the flash kernels' in-kernel mask), the attention close
(the projection-LN kernels') and the FFN close (the LayerNorm kernels');
the dense routes draw the reference's dense masks. ``eval()`` takes no
split.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..nn.functional.activation import gelu, tanh
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.loss import chunked_mlm_xent, cross_entropy
from ..nn.functional.mlp import (fused_attn_proj_residual_layer_norm,
                                 fused_mlp)
from ..nn.functional.norm import fused_bias_dropout_residual_layer_norm
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.layers import Layer, LayerList, name_parameters
from ..nn.layer.norm import LayerNorm
from ..core.tensor import unwrap_args
from ..ops import manipulation as M
from ..ops.creation import zeros_like
from ..ops.logic import not_equal
from ..ops.math import add, divide, matmul, multiply, subtract
from ..ops.reduction import sum as _sum
from .gpt import Linear    # Paddle layout: weight [in, out], bias [out]

__all__ = ["BertConfig", "CONFIGS", "BertEmbeddings", "BertLayer",
           "BertPooler", "BertModel", "BertPretrainingHeads",
           "BertForPretraining", "BertForSequenceClassification"]


class BertConfig(NamedTuple):
    """The reference's config (bert.py:22-32), same fields, order and
    defaults."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


CONFIGS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(hidden_size=1024, num_hidden_layers=24,
                             num_attention_heads=16, intermediate_size=4096),
    "tiny": BertConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=64),
}


def _kw(device, dtype):
    return dict(device=resolve_device(device), dtype=dtype)


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = _kw(device, dtype)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        x = add(self.word_embeddings(input_ids), self.position_embeddings(pos))
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = add(x, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertLayer(Layer):
    """Post-LN encoder block (original BERT ordering)."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        H = cfg.hidden_size
        kw = _kw(device, dtype)
        self.nh = cfg.num_attention_heads
        self.qkv = Linear(H, 3 * H, **kw)
        self.attn_out = Linear(H, H, **kw)
        self.attn_ln = LayerNorm(H, epsilon=cfg.layer_norm_eps, **kw)
        self.fc1 = Linear(H, cfg.intermediate_size, **kw)
        self.fc2 = Linear(cfg.intermediate_size, H, **kw)
        self.ffn_ln = LayerNorm(H, epsilon=cfg.layer_norm_eps, **kw)
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        """The reference block (bert.py:84-113): attention, the output
        projection folded into the add → LN close, the erf-GeLU MLP, the
        add → LN close."""
        B, S, H = x.shape
        q, k, v = M.split(self.qkv(x), 3, axis=-1)

        def heads(t):
            return M.reshape(t, [B, S, self.nh, H // self.nh])

        out = scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=attn_mask,
            dropout_p=self.attn_dropout if self.training else 0.0)
        x = fused_attn_proj_residual_layer_norm(
            M.reshape(out, [B, S, H]), self.attn_out.weight,
            self.attn_out.bias,
            x, self.attn_ln.weight, self.attn_ln.bias,
            dropout_rate=self.dropout.p, ln_epsilon=self.attn_ln._epsilon,
            training=self.training)
        h = fused_mlp(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                      self.fc2.bias, approximate=False)
        return fused_bias_dropout_residual_layer_norm(
            h, x, ln_scale=self.ffn_ln.weight, ln_bias=self.ffn_ln.bias,
            dropout_rate=self.dropout.p, ln_epsilon=self.ffn_ln._epsilon,
            training=self.training)


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            **_kw(device, dtype))

    def forward(self, hidden):
        return tanh(self.dense(M._getitem(hidden, (slice(None), 0))))


class _Init(Layer):
    """Seeded initialisation and loading of the reference's weights, shared
    by the entry points."""

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        """The reference's initialisers, drawn from a generator seeded with
        ``seed`` on the model's device."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, Linear):
                n_in, n_out = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (n_in + n_out)),
                                   generator=g)
                mod.bias.zero_()
            elif isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 1.0, generator=g)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, BertPretrainingHeads):
                mod.decoder_bias.zero_()

    @torch.no_grad()
    def load_numpy(self, state: Dict[str, Any]):
        """Copy the reference's state dict (name → numpy array, the
        reference's names and [in, out] layout) into the parameters, in
        place: the tied decoder weight follows the word embeddings."""
        params = dict(self.named_parameters())
        if set(state) != set(params):
            raise KeyError(f"load_numpy: names differ from the model's: "
                           f"missing {sorted(set(params) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(params))}")
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(state[name], np.float32)))
        return self


class BertModel(_Init):
    """The encoder on ``device`` (None → the CUDA card) in ``dtype``,
    initialised from ``seed`` (None: left to the model that holds it)."""

    def __init__(self, cfg: BertConfig, *, device: DeviceLike = None,
                 dtype=torch.bfloat16, seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        kw = dict(device=self.device, dtype=dtype)
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.encoder = LayerList([BertLayer(cfg, **kw)
                                  for _ in range(cfg.num_hidden_layers)])
        self.pooler = BertPooler(cfg, **kw)
        if seed is not None:
            self.reset_parameters(seed)
        name_parameters(self)

    @unwrap_args
    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """[B, S] ids (and a [B, S] 1/0 ``attention_mask``, 0 at padding)
        → (sequence output [B, S, H], pooled output [B, H])."""
        if attention_mask is not None:
            am = multiply(subtract(1.0, M.cast(attention_mask, "float32")),
                          -1e9)
            # additive [B, 1, 1, S]
            attention_mask = M.unsqueeze(M.unsqueeze(am, 1), 1)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertPretrainingHeads(Layer):
    """The MLM transform and tied decoder, and the NSP classifier.
    ``embedding_weights`` is the word-embedding table (the decoder
    weight), held unregistered."""

    def __init__(self, cfg: BertConfig, embedding_weights=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = _kw(device, dtype)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps, **kw)
        self._tied = (embedding_weights,)   # a tuple: not a registered leaf
        self.seq_relationship = Linear(cfg.hidden_size, 2, **kw)

    @property
    def decoder_weight(self):
        return self._tied[0]

    def _mlm_transform(self, sequence_output):
        return self.transform_ln(gelu(self.transform(sequence_output)))

    def forward(self, sequence_output, pooled_output):
        """(MLM logits [B, S, V], NSP logits [B, 2])."""
        h = self._mlm_transform(sequence_output)
        logits = add(matmul(h, self.decoder_weight, transpose_y=True),
                     self.decoder_bias)
        return logits, self.seq_relationship(pooled_output)

    def per_token_mlm_loss(self, sequence_output, labels):
        """[B, S] f32 cross-entropy per position without the [B, S, V]
        logits: the chunked-vocabulary head."""
        return chunked_mlm_xent(self._mlm_transform(sequence_output),
                                self.decoder_weight, self.decoder_bias,
                                labels)


class BertForPretraining(_Init):
    """The reference's ``BertForPretraining`` on ``device`` (None → the
    CUDA card) in ``dtype``, initialised from ``seed``."""

    def __init__(self, cfg: BertConfig, *, device: DeviceLike = None,
                 dtype=torch.bfloat16, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bert = BertModel(cfg, device=self.device, dtype=dtype, seed=None)
        self.cls = BertPretrainingHeads(
            cfg, self.bert.embeddings.word_embeddings.weight,
            device=self.device, dtype=dtype)
        self.reset_parameters(seed)
        name_parameters(self)

    @unwrap_args
    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls(seq, pooled)

    @unwrap_args
    def loss(self, input_ids, mlm_labels, nsp_labels, token_type_ids=None,
             attention_mask=None):
        """MLM (labels -100 ignored) + NSP joint pretraining loss
        (bert.py:193-204), the reference's ops one for one: f32, or bf16
        arithmetic at O2. The MLM term runs through the chunked head."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        valid = M.cast(not_equal(mlm_labels, -100), "float32")
        safe_labels = M.where(not_equal(mlm_labels, -100), mlm_labels,
                              zeros_like(mlm_labels))
        per_tok = self.cls.per_token_mlm_loss(seq, safe_labels)
        mlm = divide(_sum(multiply(per_tok, valid)), add(_sum(valid), 1e-6))
        nsp = cross_entropy(self.cls.seq_relationship(pooled), nsp_labels)
        return add(mlm, nsp)


class BertForSequenceClassification(_Init):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, *,
                 device: DeviceLike = None, dtype=torch.bfloat16,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bert = BertModel(cfg, device=self.device, dtype=dtype, seed=None)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes, self.device,
                                 dtype)
        self.reset_parameters(seed)
        name_parameters(self)

    @unwrap_args
    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))
