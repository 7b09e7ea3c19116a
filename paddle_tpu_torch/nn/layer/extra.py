"""Long-tail nn layers.

Counterpart: ``paddle_tpu/nn/layer/extra.py``: the loss layers
(:15-157), the pools (:160-263), ``Softmax2D``, ``Unflatten``,
``FeatureAlphaDropout``, ``ZeroPad1D`` / ``ZeroPad3D`` and the layer
form of ``SpectralNorm`` (:266-356), ``RNNCellBase`` (``Layer``, as in
the reference), ``BiRNN`` (:361-393), ``BeamSearchDecoder`` and
``dynamic_decode`` (:396-431, the greedy loop). Each layer keeps its
constructor's arguments and calls its functional
(``nn/functional/extra.py``).
"""
from __future__ import annotations

import math

import torch

from ..._device import DeviceLike, resolve_device
from ... import ops
from ..functional import extra as FE
from .layers import Layer

__all__ = ["AdaptiveAvgPool3D", "AdaptiveLogSoftmaxWithLoss",
           "AdaptiveMaxPool3D", "BeamSearchDecoder", "BiRNN",
           "FeatureAlphaDropout", "FractionalMaxPool2D",
           "FractionalMaxPool3D", "GaussianNLLLoss", "HSigmoidLoss",
           "LPPool1D", "LPPool2D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "PairwiseDistance", "PoissonNLLLoss", "RNNCellBase", "RNNTLoss",
           "SoftMarginLoss", "Softmax2D", "SpectralNorm",
           "TripletMarginWithDistanceLoss", "Unflatten", "ZeroPad1D",
           "ZeroPad3D", "dynamic_decode"]


# -- losses ------------------------------------------------------------------

class _LossBase(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        if reduction not in ("mean", "sum", "none"):
            raise ValueError(f"bad reduction {reduction!r}")
        self.reduction = reduction


class GaussianNLLLoss(_LossBase):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.full, self.epsilon = full, epsilon

    def forward(self, input, label, variance):  # noqa: A002
        return FE.gaussian_nll_loss(input, label, variance, self.full,
                                    self.epsilon, self.reduction)


class PoissonNLLLoss(_LossBase):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.log_input, self.full, self.epsilon = log_input, full, epsilon

    def forward(self, input, label):  # noqa: A002
        return FE.poisson_nll_loss(input, label, self.log_input, self.full,
                                   self.epsilon, self.reduction)


class SoftMarginLoss(_LossBase):
    def forward(self, input, label):  # noqa: A002
        return FE.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(_LossBase):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):  # noqa: A002
        return FE.multi_label_soft_margin_loss(input, label, self.weight,
                                               self.reduction)


class MultiMarginLoss(_LossBase):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.p, self.margin, self.weight = p, margin, weight

    def forward(self, input, label):  # noqa: A002
        return FE.multi_margin_loss(input, label, self.p, self.margin,
                                    self.weight, self.reduction)


class TripletMarginWithDistanceLoss(_LossBase):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.distance_function = distance_function
        self.margin, self.swap = margin, swap

    def forward(self, input, positive, negative):  # noqa: A002
        return FE.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class RNNTLoss(_LossBase):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda

    def forward(self, input, label, input_lengths, label_lengths):  # noqa: A002
        return FE.rnnt_loss(input, label, input_lengths, label_lengths,
                            self.blank, self.fastemit_lambda,
                            self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device: DeviceLike = None):
        super().__init__()
        self.num_classes = num_classes
        dev = resolve_device(device)
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr, device=dev)
        self.bias = (self.create_parameter([num_classes - 1], is_bias=True,
                                           device=dev)
                     if bias_attr is not False else None)

    def forward(self, input, label):  # noqa: A002
        return FE.hsigmoid_loss(input, label, self.num_classes,
                                self.weight, self.bias)


class AdaptiveLogSoftmaxWithLoss(Layer):
    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.head_weight = self.create_parameter([in_features, n_classes],
                                                 device=dev)
        self.head_bias = (self.create_parameter([n_classes], is_bias=True,
                                                device=dev)
                          if head_bias else None)
        self.cutoffs = list(cutoffs)

    def forward(self, input, label):  # noqa: A002
        return FE.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.head_bias, None,
            self.cutoffs)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return FE.pairwise_distance(x, y, self.p, self.epsilon,
                                    self.keepdim)


# -- pooling -----------------------------------------------------------------

class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return FE.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return FE.adaptive_max_pool3d(x, self.output_size)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return FE.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return FE.lp_pool2d(x, *self.args)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return FE.fractional_max_pool2d(x, self.output_size)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return FE.fractional_max_pool3d(x, self.output_size)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self.args
        return FE.max_unpool1d(x, indices, k, s, p, df, osz)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self.args
        return FE.max_unpool2d(x, indices, k, s, p, df, osz)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self.args
        return FE.max_unpool3d(x, indices, k, s, p, df, osz)


# -- misc layers -------------------------------------------------------------

class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW inputs."""

    def forward(self, x):
        from .. import functional as F
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.out_shape = axis, shape

    def forward(self, x):
        return ops.unflatten(x, self.axis, self.out_shape)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return FE.feature_alpha_dropout(x, self.p, self.training)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = ([padding, padding] if isinstance(padding, int)
                        else list(padding))

    def forward(self, x):
        return ops.pad(x, self.padding, mode="constant", value=0.0,
                       data_format="NCL")


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = ([padding] * 6 if isinstance(padding, int)
                        else list(padding))

    def forward(self, x):
        return ops.pad(x, self.padding, mode="constant", value=0.0,
                       data_format="NCDHW")


class SpectralNorm(Layer):
    """A weight divided by its largest singular value, estimated by power
    iteration on the kept vectors ``weight_u`` [h] and ``weight_v`` [w]
    (not trained; updated on every call)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device: DeviceLike = None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        dev = resolve_device(device)
        self.weight_u = self.create_parameter([h], device=dev)
        self.weight_v = self.create_parameter([w], device=dev)
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        from .. import functional as F
        perm = [self.dim] + [i for i in range(weight.ndim) if i != self.dim]
        w = weight.permute(perm)
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = F.normalize(mat.t() @ u, axis=0, epsilon=self.epsilon)
            u = F.normalize(mat @ v, axis=0, epsilon=self.epsilon)
        sigma = u @ mat @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        out = (mat / sigma).reshape(w.shape)
        inv = list(range(1, self.dim + 1)) + [0] + \
            list(range(self.dim + 1, weight.ndim))
        return out.permute(inv)


# -- recurrent ---------------------------------------------------------------

RNNCellBase = Layer


class BiRNN(Layer):
    """A forward and a backward cell over the sequence, their outputs
    concatenated (``paddle.nn.BiRNN``)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            x = ops.transpose(x, [1, 0, 2])
        steps = x.shape[1]

        def run(cell, seq):
            states = None
            outs = []
            for t in range(steps):
                out, states = cell(seq[:, t], states)
                outs.append(out)
            return ops.stack(outs, axis=1)

        fw = run(self.cell_fw, x)
        bw = ops.flip(run(self.cell_bw, ops.flip(x, axis=[1])), axis=[1])
        out = ops.concat([fw, bw], axis=-1)
        if self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        return out, None


# -- decoding ----------------------------------------------------------------

class BeamSearchDecoder:
    """A cell with its embedding and output projection, for
    ``dynamic_decode`` (``paddle.nn.BeamSearchDecoder``'s interface)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=20, **kwargs):
    """Greedy decoding: the arg-max token each step, stopping when the
    first lane's token is ``end_token`` (one host read a step, as in the
    reference); returns (the tokens [..., steps], the final states)."""
    token = decoder.start_token
    states = inits
    out_tokens = []
    for _ in range(max_step_num):
        emb = decoder.embedding_fn(token) if decoder.embedding_fn else token
        out, states = decoder.cell(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        token = ops.argmax(logits, axis=-1)
        out_tokens.append(token)
        if int(token.reshape(-1)[0]) == decoder.end_token:
            break
    return ops.stack(out_tokens, axis=-1), states
