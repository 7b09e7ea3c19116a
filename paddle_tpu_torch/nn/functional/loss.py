"""Loss functionals.

Counterpart: ``paddle_tpu/nn/functional/loss.py``: ``_reduce`` (:10),
``cross_entropy`` (:19-64), the vision path's loss,
``binary_cross_entropy`` (:102), PP-YOLOE's classification loss, and
``chunked_mlm_xent`` (:238-251), BERT's tied MLM head, registered ops under the reference's names and
AMP categories (``cross_entropy`` and ``binary_cross_entropy`` black,
``chunked_mlm_xent`` promote). The other losses of that module come with
later slices.

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

__all__ = ["binary_cross_entropy", "chunked_mlm_xent", "cross_entropy"]


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


@register_op("chunked_mlm_xent")
def chunked_mlm_xent(h, w, bias, labels):
    """Per-position cross-entropy of the tied head ``h @ wᵀ + bias`` with
    the vocabulary streamed in chunks: [B, S, V] logits never exist at
    once. h [B, S, H]; w [V, H]; bias [V] or None; labels [B, S] int.
    Returns f32 [B, S]."""
    return chunked_softmax_xent_per_token(h, w, bias, labels)
