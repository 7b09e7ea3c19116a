"""Counterpart: ``paddle_tpu/vision/models/__init__.py`` (the ResNet
family so far; the other vision models are ROADMAP A11; the PP-YOLOE
detector is ``paddle_tpu_torch.models.ppyoloe``, as in the reference)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "wide_resnet50_2", "wide_resnet101_2"]
