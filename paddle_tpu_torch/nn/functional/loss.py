"""Loss functionals.

Counterpart: ``paddle_tpu/nn/functional/loss.py``: ``_reduce`` (:10),
``cross_entropy`` (:19-64), the vision path's loss,
``binary_cross_entropy`` (:102), PP-YOLOE's classification loss, and
``chunked_mlm_xent`` (:238-251), BERT's tied MLM head, registered ops under the reference's names and
AMP categories (``cross_entropy`` and ``binary_cross_entropy`` black,
``chunked_mlm_xent`` promote), and the other losses of that module
(:66-236) under theirs: ``nll_loss``, ``mse_loss``, ``l1_loss``,
``smooth_l1_loss``, ``binary_cross_entropy_with_logits``, ``kl_div``,
``margin_ranking_loss``, ``hinge_embedding_loss``,
``cosine_embedding_loss``, ``triplet_margin_loss``,
``sigmoid_focal_loss``, ``square_error_cost``, ``log_loss`` and
``ctc_loss``; ``softmax_with_cross_entropy`` is ``cross_entropy``.

``ctc_loss`` takes Paddle's [T, B, C] activations, log-softmaxes them
as the reference does (its optax loss expects logits) and runs torch's
CTC per sequence; ``reduction="mean"`` divides each sequence's loss by
its label length before the mean, as the reference's does.

``binary_cross_entropy`` is the reference's formula, each log's argument
floored at 1e-12 (a saturated probability costs 27.63). It is not
``torch.nn.functional.binary_cross_entropy``, which clamps each log at
-100 instead (100.0 at a saturated probability) and whose backward
differs there too: a detector's scores do saturate.
"""
from __future__ import annotations

import torch

from ...core.dispatch import register_op
from ...kernels.chunked_xent import chunked_softmax_xent_per_token

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "chunked_mlm_xent", "cosine_embedding_loss", "cross_entropy",
           "ctc_loss", "hinge_embedding_loss", "kl_div", "l1_loss",
           "log_loss", "margin_ranking_loss", "mse_loss", "nll_loss",
           "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@register_op("cross_entropy", amp="black")
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Paddle's cross_entropy: by default ``input`` holds raw logits
    (``use_softmax``; else probabilities, logged with a 1e-30 floor) and
    ``label`` class indices, [B] or with a trailing 1 ([B, 1]); soft labels
    (``soft_label``, or a label of input's shape) take the soft path.
    Hard labels: ``ignore_index`` rows count 0 and leave the mean's
    denominator; ``weight`` [classes] scales each row by its class's
    weight and, with ``reduction="mean"``, the mean divides by the sum of
    the weights of the rows kept; ``label_smoothing`` mixes in the mean of
    the log-probabilities (a uniform target). The math runs in f32 (f64
    for f64 input), as the reference's ("black") op does; the loss is
    f32."""
    x = input.to(torch.promote_types(input.dtype, torch.float32))
    axis = axis % x.ndim
    logp = (torch.log_softmax(x, axis) if use_softmax
            else torch.log(x.clamp_min(1e-30)))
    nclass = x.shape[axis]
    soft = soft_label or tuple(label.shape) == tuple(x.shape)
    if soft:
        target = label.to(x.dtype)
        if label_smoothing > 0:
            target = target * (1 - label_smoothing) + label_smoothing / nclass
        loss = -(target * logp).sum(axis)
        valid = torch.ones_like(loss, dtype=torch.bool)
    else:
        y = label.long()
        if y.ndim == x.ndim:            # a trailing 1
            y = y.squeeze(axis)
        valid = y != ignore_index
        y_safe = torch.where(valid, y, 0)
        picked = logp.gather(axis, y_safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            loss = (-(1 - label_smoothing) * picked
                    - label_smoothing * logp.mean(axis))
        else:
            loss = -picked
        if weight is not None:
            loss = loss * weight.to(x.dtype)[y_safe]
        loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if weight is not None and not soft:
            w = torch.where(valid, weight.to(x.dtype)[y_safe], 0.0)
            return loss.sum() / w.sum().clamp_min(1e-12)
        return loss.sum() / valid.to(x.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


softmax_with_cross_entropy = cross_entropy


@register_op("nll_loss", amp="black")
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """-logp[label] of [N, C] log-probabilities; ``ignore_index`` rows
    count 0; the weighted mean divides by the kept rows' weights."""
    y = label.long()
    valid = y != ignore_index
    y_safe = torch.where(valid, y, 0)
    loss = -input.gather(1, y_safe[:, None])[:, 0]
    if weight is not None:
        loss = loss * weight[y_safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = (torch.where(valid, weight[y_safe], 0.0).sum()
                 if weight is not None else valid.to(loss.dtype).sum())
        return loss.sum() / denom.clamp_min(1e-12)
    return _reduce(loss, reduction)


@register_op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@register_op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((input - label).abs(), reduction)


@register_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


@register_op("binary_cross_entropy", amp="black")
def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    """-(y·log(max(x, 1e-12)) + (1 − y)·log(max(1 − x, 1e-12))) of the
    probabilities ``input`` against ``label``, times ``weight`` when given,
    then reduced ('mean', 'sum' or 'none')."""
    eps = torch.tensor(1e-12, dtype=input.dtype, device=input.device)
    y = label.to(input.dtype)
    loss = -(y * torch.log(torch.maximum(input, eps))
             + (1 - y) * torch.log(torch.maximum(1 - input, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_op("binary_cross_entropy_with_logits", amp="black")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """max(x, 0) − x·y + log(1 + exp(−|x|)), times (pos_weight − 1)·y + 1
    and ``weight`` when given."""
    x, y = logit, label
    loss = torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * y + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_op("kl_div", amp="black")
def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@register_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0),
                   reduction)


@register_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0)),
                   reduction)


@register_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0))
    return _reduce(loss, reduction)


@register_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return ((u - v).abs() + epsilon).pow(p).sum(-1).pow(1 / p)

    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


@register_op("sigmoid_focal_loss", amp="black")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x, y = logit, label
    p = torch.sigmoid(x)
    ce = torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * y + (1 - alpha) * (1 - y)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@register_op("square_error_cost")
def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


@register_op("log_loss", amp="black")
def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


@register_op("ctc_loss", amp="black")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC of [max_time, batch, classes] activations against [batch,
    max_label] labels (see the module docstring)."""
    if log_probs.ndim != 3:
        raise ValueError("log_probs must be [max_time, batch, num_classes]")
    lp = torch.log_softmax(log_probs, -1)
    il = torch.as_tensor(input_lengths, device=lp.device).long()
    ll = torch.as_tensor(label_lengths, device=lp.device).long()
    per_seq = torch.nn.functional.ctc_loss(
        lp, labels.long(), il, ll, blank=blank, reduction="none")
    if reduction == "mean":
        return (per_seq / ll.to(per_seq.dtype).clamp_min(1)).mean()
    return _reduce(per_seq, reduction)


@register_op("chunked_mlm_xent")
def chunked_mlm_xent(h, w, bias, labels):
    """Per-position cross-entropy of the tied head ``h @ wᵀ + bias`` with
    the vocabulary streamed in chunks: [B, S, V] logits never exist at
    once. h [B, S, H]; w [V, H]; bias [V] or None; labels [B, S] int.
    Returns f32 [B, S]."""
    return chunked_softmax_xent_per_token(h, w, bias, labels)
