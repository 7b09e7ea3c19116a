"""The ResNet family.

Counterpart: ``paddle_tpu/vision/models/resnet.py``, all of it:
``_bn_act`` (:12), ``BasicBlock`` (:29), ``BottleneckBlock`` (:54),
``ResNet`` (:82), ``_resnet`` with the ``pretrained`` check (:140-146)
and the factories ``resnet18`` ... ``resnext50_32x4d`` (:149-183).

The modules are ``nn.Module``s on an explicit ``device`` (None → the
CUDA card) in ``dtype``, initialised from ``seed`` with a
``torch.Generator`` on that device, with the reference's distributions:
KaimingUniform(fan_in) conv weights, XavierNormal fc weight ``[in, out]``
and zero bias, unit BatchNorm gains and zero shifts. ``state_dict()``
keys are the reference model's, letter for letter (``conv1.weight``,
``bn1._mean``, ``layer1.0.downsample.1._variance``, ``fc.weight``),
the BatchNorm running statistics among them; ``load_numpy`` fills the
parameters and those buffers from the reference's state dict. Every
parameter carries the reference's unique name (``p.name``:
``conv2d_0.w_0`` ..., ``nn.layer.layers.name_parameters``).

Every BatchNorm goes through ``_bn_act`` → ``forward_act`` →
``nn.functional.batch_norm_act``: in training, with ``FLAGS_fused_norm``
on (the default), the fused BatchNorm kernels with the residual add and
the ReLU in their epilogue (53 calls a resnet50 forward: the stem, 16
blocks × 3 and 4 downsample BatchNorms). A bf16 model is bf16 throughout
(the batch statistics and running buffers f32). Under ``amp.auto_cast``
(the reference bench's O2) an f32 model's parameters are cast per op as
the reference casts them: the convolutions and the fused BatchNorm white,
the dense BatchNorm black, the pools, ReLU, the residual add
(``ops.add``) and the flatten before the classifier (``ops.flatten``)
promote. Take the loss in f32. ``forward`` takes facade tensors
(``core/tensor.py``) as plain ones.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ...nn.functional.activation import relu
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU)
from ...nn.layer.layers import load_numpy, name_parameters, reset_conv_bn
from ...core.tensor import unwrap_args
from ...ops.manipulation import flatten
from ...ops.math import add

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


def _bn_act(bn, x, activation=None, residual=None):
    """bn → (+ residual) → activation through the layer's fused epilogue
    when it has one (``forward_act``: one kernel pass per direction on the
    fused route); a norm layer without ``forward_act`` composes the same
    ops."""
    fwd = getattr(bn, "forward_act", None)
    if fwd is not None:
        return fwd(x, activation=activation, residual=residual)
    out = bn(x)
    if residual is not None:
        out = add(out, residual)
    if activation == "relu":
        out = relu(out)
    return out


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = _bn_act(self.bn1, self.conv1(x), activation="relu")
        out = self.conv2(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        return _bn_act(self.bn2, out, activation="relu", residual=identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = _bn_act(self.bn1, self.conv1(x), activation="relu")
        out = _bn_act(self.bn2, self.conv2(out), activation="relu")
        out = self.conv3(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        return _bn_act(self.bn3, out, activation="relu", residual=identity)


class ResNet(nn.Module):
    """Paddle's ResNet on ``device`` (None → the CUDA card) in ``dtype``,
    initialised from ``seed``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device: DeviceLike = None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.device = resolve_device(device)
        self._kw = dict(device=self.device, dtype=dtype)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = self._norm_layer(self.inplanes, **self._kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._kw)
        self.reset_parameters(seed)
        name_parameters(self)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                norm_layer(planes * block.expansion, **self._kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, norm_layer=norm_layer,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **self._kw))
        return nn.Sequential(*layers)

    @unwrap_args
    def forward(self, x):
        x = self.maxpool(_bn_act(self.bn1, self.conv1(x), activation="relu"))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x

    def reset_parameters(self, seed: int = 0):
        """The reference's initialisers, drawn in module order from a
        generator seeded with ``seed`` on the model's device; the
        BatchNorm gains 1, shifts 0 and running statistics 0 and 1."""
        reset_conv_bn(self, self.device, seed)

    def load_numpy(self, state: Dict[str, Any]):
        """Copy the reference's state dict (name → numpy array: every
        parameter and the BatchNorm buffers ``_mean`` / ``_variance``, in
        the reference's names and layouts) into the model, in place."""
        return load_numpy(self, state)


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict via "
            "paddle.load + model.set_state_dict")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)
