"""Detection ops.

Counterpart: ``paddle_tpu/vision/ops.py``: ``_matrix_nms`` (:437-481) and
``matrix_nms`` (:484-493), PP-YOLOE's post-processing. The other
functions of that module are ROADMAP A11.

Matrix NMS (SOLOv2) on one image, static in shape: the boxes' best class
scores, floored to -1 at or below ``score_threshold``, are sorted (the top
``nms_top_k``), each box's score decays by its IoU with every
higher-scored box of its class, compensated by that box's own largest
such IoU, and the decayed scores above ``post_threshold`` are sorted
again (the top ``keep_top_k``). Both sorts are stable, as ``jnp.argsort``
is, so equal scores keep the boxes' order on every device. The [k, k] IoU
and decay matrices are materialised: at k = 8400 (a 640² image) each f32
[k, k] tensor holds 282 MB and each [k, k, 2] one 564 MB.
"""
from __future__ import annotations

import torch

__all__ = ["matrix_nms"]


def _matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
                keep_top_k, use_gaussian, gaussian_sigma):
    """bboxes [M, 4] (x1, y1, x2, y2), scores [C, M] → (rows [n, 6]: class,
    decayed score, box; rows past the kept count are zero, the kept count
    as an int32 0-d tensor), n = min(keep_top_k or k, k)."""
    boxes, sc = bboxes, scores
    C, M = sc.shape
    cls_best = sc.max(0).values
    cls_idx = sc.argmax(0)                 # the first best class
    cls_best = torch.where(cls_best > score_threshold, cls_best,
                           torch.full_like(cls_best, -1.0))
    k = min(nms_top_k if nms_top_k > 0 else M, M)
    order = torch.argsort(-cls_best, stable=True)[:k]
    b = boxes[order]
    s = cls_best[order]
    c = cls_idx[order]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    area = torch.maximum(b[:, 2] - b[:, 0], zero) * torch.maximum(
        b[:, 3] - b[:, 1], zero)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = torch.maximum(rb - lt, zero)
    del lt, rb
    inter = wh[..., 0] * wh[..., 1]
    del wh
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-9)
    del inter
    same = c[:, None] == c[None, :]
    lower = torch.ones((k, k), dtype=torch.bool, device=b.device).tril(-1)
    sup = lower & same                     # j < r: a higher-scored box
    del same, lower
    ious = torch.where(sup, iou, zero)     # iou with suppressors
    del iou
    max_iou = ious.max(1).values           # per-box own compensation
    if use_gaussian:
        ratio = torch.exp(-(ious ** 2 - max_iou[None, :] ** 2)
                          / gaussian_sigma)
    else:
        # decay by each suppressor j, compensated by j's own overlap with
        # its suppressors (SOLOv2 eq. (4))
        ratio = (1 - ious) / torch.clamp_min(1 - max_iou[None, :], 1e-9)
    del ious
    decay = torch.where(sup, ratio, torch.ones_like(ratio)).min(1).values
    del ratio, sup
    new_s = s * decay
    keep = (new_s > post_threshold) & (s > 0)   # score_threshold filter
    out_n = min(keep_top_k if keep_top_k > 0 else k, k)
    final = torch.argsort(-torch.where(keep, new_s,
                                       torch.full_like(new_s, -1.0)),
                          stable=True)[:out_n]
    rows = torch.cat([c[final][:, None].to(torch.float32),
                      new_s[final][:, None], b[final]], dim=1)
    valid = keep[final]
    rows = rows * valid[:, None]
    return rows, valid.sum().to(torch.int32)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=-1, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Paddle's matrix_nms on one image: bboxes [M, 4], scores [C, M] →
    (rows, count) with ``return_rois_num`` (the default), else rows.
    ``background_label``, ``normalized`` and ``return_index`` are accepted
    and change nothing, as in the reference."""
    out, n = _matrix_nms(bboxes, scores, score_threshold, post_threshold,
                         nms_top_k, keep_top_k, use_gaussian,
                         gaussian_sigma)
    if return_rois_num:
        return out, n
    return out
