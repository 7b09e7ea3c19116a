"""PP-YOLOE-style anchor-free detector.

Counterpart: ``paddle_tpu/models/ppyoloe.py``, all of it:
``PPYOLOEConfig`` and ``CONFIGS`` (:28-46), ``ConvBNLayer`` (:49),
``CSPBlock`` (:60), ``CSPBackbone`` (:81), ``FPNNeck`` (:106),
``PPYOLOEHead`` (:130), ``PPYOLOE`` (:155) with ``forward`` (:164),
``post_process`` (:194), ``loss`` (:204) and ``_anchor_centers`` (:239),
and ``_giou`` (:253). A CSP backbone of Conv-BN-SiLU layers, a top-down
FPN neck with a nearest 2x upsample, a decoupled anchor-free head with
softplus (l, t, r, b) distances, a static-shape decode over all pyramid
levels and matrix NMS (``vision/ops.py``); training assigns every grid
cell whose centre lies inside a gt box to the first such box (a
centre-prior assigner), with a BCE classification loss and a GIoU box
loss.

The modules are ``nn.Layer``s on an explicit ``device`` (None → the
current place: the CUDA card unless ``set_device`` says otherwise) in ``dtype``, initialised from ``seed`` with a
``torch.Generator`` on that device, with the reference's distributions
(KaimingUniform(fan_in) conv weights, Uniform(±1/sqrt(fan_in)) biases of
the prediction convolutions, unit BatchNorm gains and zero shifts).
``state_dict()`` keys are the reference model's, letter for letter
(``backbone.stem.0.conv.weight``, ``backbone.stages.0.1.blocks.0.bn._mean``,
``head.cls_preds.2.bias``), the BatchNorm running statistics among them;
``load_numpy`` fills the parameters and those buffers from the
reference's state dict.

Every ConvBNLayer's BatchNorm is a plain ``batch_norm``: in training,
with ``FLAGS_fused_norm`` on (the default), the fused BatchNorm kernels
without a residual and without the ReLU epilogue (35 calls a ppyoloe-l
forward: 2 stem, 3 × (1 + 6) in the CSP stages, 6 in the neck, 6 in the
head), then a SiLU; in eval mode the dense ``_bn_infer``. Eval runs
eagerly (``jit.to_static`` is ROADMAP A9).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..core.tensor import unwrap_args
from ..nn import functional as F
from ..nn.layer import BatchNorm2D, Conv2D
from ..nn.layer.layers import (Layer, LayerList, Sequential, load_numpy,
                               name_parameters, reset_conv_bn)

__all__ = ["CONFIGS", "CSPBackbone", "CSPBlock", "ConvBNLayer", "FPNNeck",
           "PPYOLOE", "PPYOLOEConfig", "PPYOLOEHead"]


class PPYOLOEConfig(NamedTuple):
    num_classes: int = 80
    width_mult: float = 1.0
    depth_mult: float = 1.0
    strides: Sequence[int] = (8, 16, 32)

    def ch(self, c):
        return max(8, int(c * self.width_mult))

    def depth(self, d):
        return max(1, int(round(d * self.depth_mult)))


CONFIGS = {
    "ppyoloe-s": PPYOLOEConfig(width_mult=0.50, depth_mult=0.33),
    "ppyoloe-m": PPYOLOEConfig(width_mult=0.75, depth_mult=0.67),
    "ppyoloe-l": PPYOLOEConfig(width_mult=1.0, depth_mult=1.0),
    "tiny": PPYOLOEConfig(num_classes=4, width_mult=0.125, depth_mult=0.33),
}


class ConvBNLayer(Layer):
    def __init__(self, cin, cout, k=3, stride=1, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                           bias_attr=False, **kw)
        self.bn = BatchNorm2D(cout, **kw)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class CSPBlock(Layer):
    """Split → residual conv path + shortcut path → merge (CSP)."""

    def __init__(self, ch, n_blocks, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        half = ch // 2
        self.left = ConvBNLayer(ch, half, k=1, **kw)
        self.right = ConvBNLayer(ch, half, k=1, **kw)
        self.blocks = LayerList(
            [ConvBNLayer(half, half, k=3, **kw) for _ in range(n_blocks)])
        self.merge = ConvBNLayer(half * 2, ch, k=1, **kw)

    def forward(self, x):
        left = self.left(x)
        h = self.right(x)
        for blk in self.blocks:
            h = h + blk(h)
        return self.merge(torch.cat([left, h], dim=1))


class CSPBackbone(Layer):
    """Stem + 3 downsampling CSP stages → features at strides 8/16/32."""

    def __init__(self, cfg: PPYOLOEConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg.ch
        self.stem = Sequential(ConvBNLayer(3, c(32), stride=2, **kw),
                               ConvBNLayer(c(32), c(64), stride=2, **kw))
        self.stages = LayerList()
        chans = [c(64), c(128), c(256), c(512)]
        for i in range(3):
            self.stages.append(Sequential(
                ConvBNLayer(chans[i], chans[i + 1], stride=2, **kw),
                CSPBlock(chans[i + 1], cfg.depth(3), **kw)))
        self.out_channels = chans[1:]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs  # strides 8, 16, 32


class FPNNeck(Layer):
    """Top-down feature pyramid (simplified CustomCSPPAN)."""

    def __init__(self, in_channels: List[int], *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.lateral = LayerList(
            [ConvBNLayer(c, in_channels[0], k=1, **kw) for c in in_channels])
        self.fuse = LayerList(
            [ConvBNLayer(in_channels[0], in_channels[0], k=3, **kw)
             for _ in in_channels])
        self.out_channel = in_channels[0]

    def forward(self, feats):
        lats = [lat(f) for lat, f in zip(self.lateral, feats)]
        outs = [None] * len(lats)
        prev = lats[-1]
        outs[-1] = self.fuse[-1](prev)
        for i in range(len(lats) - 2, -1, -1):
            up = F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = lats[i] + up
            outs[i] = self.fuse[i](prev)
        return outs


class PPYOLOEHead(Layer):
    """Decoupled anchor-free head: per level cls logits [B, nc, H, W] and
    distances [B, 4, H, W] (l, t, r, b in stride units)."""

    def __init__(self, ch, num_classes, n_levels, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes = num_classes
        self.cls_convs = LayerList(
            [ConvBNLayer(ch, ch, k=3, **kw) for _ in range(n_levels)])
        self.reg_convs = LayerList(
            [ConvBNLayer(ch, ch, k=3, **kw) for _ in range(n_levels)])
        self.cls_preds = LayerList(
            [Conv2D(ch, num_classes, 1, **kw) for _ in range(n_levels)])
        self.reg_preds = LayerList(
            [Conv2D(ch, 4, 1, **kw) for _ in range(n_levels)])

    def forward(self, feats):
        cls_out, reg_out = [], []
        for i, f in enumerate(feats):
            cls_out.append(self.cls_preds[i](self.cls_convs[i](f)))
            # distances must be positive: softplus keeps them smooth
            reg_out.append(F.softplus(self.reg_preds[i](self.reg_convs[i](f))))
        return cls_out, reg_out


class PPYOLOE(Layer):
    """The detector on ``device`` (None → the CUDA card) in ``dtype``,
    initialised from ``seed``."""

    def __init__(self, cfg: PPYOLOEConfig, seed: int = 0, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        kw = dict(device=self.device, dtype=dtype)
        self.backbone = CSPBackbone(cfg, **kw)
        self.neck = FPNNeck(self.backbone.out_channels, **kw)
        self.head = PPYOLOEHead(self.neck.out_channel, cfg.num_classes,
                                len(cfg.strides), **kw)
        self.reset_parameters(seed)
        name_parameters(self)

    @unwrap_args
    def forward(self, images):
        """images [B, 3, H, W], H and W divisible by the largest stride
        (32) → (scores [B, P, nc], boxes [B, P, 4]) with
        P = Σ_l H_l * W_l (static)."""
        _, _, H, W = images.shape
        smax = max(self.cfg.strides)
        if H % smax or W % smax:
            raise ValueError(
                f"input H, W must be divisible by {smax}; got {H}x{W}")
        feats = self.neck(self.backbone(images))
        cls_out, reg_out = self.head(feats)
        all_scores, all_boxes = [], []
        for cls, reg, stride in zip(cls_out, reg_out, self.cfg.strides):
            B, nc, H, W = cls.shape
            cy = (torch.arange(H, dtype=torch.float32, device=cls.device)
                  + 0.5) * stride
            cx = (torch.arange(W, dtype=torch.float32, device=cls.device)
                  + 0.5) * stride
            # [B, H, W, 4] distances in pixels
            d = reg.permute(0, 2, 3, 1) * stride
            x1 = cx.reshape(1, 1, W) - d[..., 0]
            y1 = cy.reshape(1, H, 1) - d[..., 1]
            x2 = cx.reshape(1, 1, W) + d[..., 2]
            y2 = cy.reshape(1, H, 1) + d[..., 3]
            boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(B, H * W, 4)
            scores = F.sigmoid(cls).permute(0, 2, 3, 1).reshape(B, H * W, nc)
            all_scores.append(scores)
            all_boxes.append(boxes)
        return torch.cat(all_scores, dim=1), torch.cat(all_boxes, dim=1)

    def post_process(self, images, score_threshold=0.3, keep_top_k=100):
        """Decode + matrix NMS (single image)."""
        from ..vision.ops import matrix_nms
        scores, boxes = self(images)
        out, n = matrix_nms(boxes[0], scores[0].transpose(0, 1),
                            score_threshold=score_threshold,
                            post_threshold=score_threshold,
                            keep_top_k=keep_top_k)
        return out, n

    @unwrap_args
    def loss(self, images, gt_boxes, gt_labels):
        """Center-prior assignment + BCE cls + GIoU box loss.

        gt_boxes [B, G, 4] (x1 y1 x2 y2, pixels), gt_labels [B, G] int
        (-1 = padding).
        """
        scores, boxes = self(images)                      # [B,P,nc],[B,P,4]
        B, P, nc = scores.shape
        centers = self._anchor_centers(images)            # [P, 2]

        cx, cy = centers[:, 0], centers[:, 1]
        inside = ((cx[None, None, :] >= gt_boxes[:, :, None, 0])
                  & (cx[None, None, :] < gt_boxes[:, :, None, 2])
                  & (cy[None, None, :] >= gt_boxes[:, :, None, 1])
                  & (cy[None, None, :] < gt_boxes[:, :, None, 3])
                  & (gt_labels[:, :, None] >= 0))         # [B,G,P]
        assigned = inside.any(dim=1)                      # [B,P]
        # first matching gt per cell
        gt_idx = torch.argmax(inside.to(torch.int32), dim=1)  # [B,P]

        onehot = F.one_hot(torch.gather(gt_labels, 1, gt_idx).clamp(
            0, nc - 1), nc).to(scores.dtype)
        cls_tgt = onehot * assigned.to(scores.dtype).unsqueeze(-1)
        cls_loss = F.binary_cross_entropy(scores, cls_tgt,
                                          reduction="none").sum(-1)
        cls_loss = cls_loss.mean()

        tgt_boxes = torch.gather(
            gt_boxes, 1, gt_idx.unsqueeze(-1).expand(B, P, 4))
        giou = _giou(boxes, tgt_boxes)                    # [B,P]
        w = assigned.to(scores.dtype)
        box_loss = ((1.0 - giou) * w).sum() / (w.sum() + 1.0)
        return cls_loss + 2.0 * box_loss

    def _anchor_centers(self, images):
        """[P, 2] (x, y) grid-cell centres of every level, on the model's
        device."""
        _, _, H, W = images.shape
        cs = []
        for stride in self.cfg.strides:
            h, w = H // stride, W // stride
            cy = (torch.arange(h, dtype=torch.float32, device=self.device)
                  + 0.5) * stride
            cx = (torch.arange(w, dtype=torch.float32, device=self.device)
                  + 0.5) * stride
            gx = cx.reshape(1, w).expand(h, w).reshape(-1)
            gy = cy.reshape(h, 1).expand(h, w).reshape(-1)
            cs.append(torch.stack([gx, gy], dim=1))
        return torch.cat(cs, dim=0)

    def reset_parameters(self, seed: int = 0):
        """The reference's initialisers, drawn in module order from a
        generator seeded with ``seed`` on the model's device; the
        BatchNorm gains 1, shifts 0 and running statistics 0 and 1."""
        reset_conv_bn(self, self.device, seed)

    def load_numpy(self, state: Dict[str, Any]):
        """Copy the reference's state dict (name → numpy array: every
        parameter and the BatchNorm buffers, in the reference's names and
        layouts) into the model, in place."""
        return load_numpy(self, state)


def _clip(x, lo, hi):
    """The reference's ``jnp.clip``: max then min, a tie splitting the
    gradient as ``jnp.maximum`` / ``jnp.minimum`` split it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _giou(a, b):
    """Generalized IoU of aligned box tensors [..., 4]."""
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    inter_w = _clip(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                    0.0, 1e9)
    inter_h = _clip(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                    0.0, 1e9)
    inter = inter_w * inter_h
    area_a = _clip(ax2 - ax1, 0.0, 1e9) * _clip(ay2 - ay1, 0.0, 1e9)
    area_b = _clip(bx2 - bx1, 0.0, 1e9) * _clip(by2 - by1, 0.0, 1e9)
    union = area_a + area_b - inter
    iou = inter / (union + 1e-9)
    hull_w = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    hull_h = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    hull = hull_w * hull_h
    return iou - (hull - union) / (hull + 1e-9)
