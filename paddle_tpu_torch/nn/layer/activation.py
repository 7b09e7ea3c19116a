"""Activation layers.

Counterpart: ``paddle_tpu/nn/layer/activation.py``: the layer classes
``_mk`` makes over the functionals (:10-56), each passing its
constructor's arguments to its functional, and ``PReLU`` (:57-75), its
``weight`` [num_parameters] from Constant(init).
"""
from __future__ import annotations

from ..._device import DeviceLike, resolve_device
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


def _mk(name, fname):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            self._args = args
            self._kwargs = kwargs

        def forward(self, x):
            return getattr(F, fname)(x, *self._args, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _mk("ReLU", "relu")
ReLU6 = _mk("ReLU6", "relu6")
Sigmoid = _mk("Sigmoid", "sigmoid")
LogSigmoid = _mk("LogSigmoid", "log_sigmoid")
Tanh = _mk("Tanh", "tanh_act")
Tanhshrink = _mk("Tanhshrink", "tanhshrink")
Hardshrink = _mk("Hardshrink", "hardshrink")
Hardsigmoid = _mk("Hardsigmoid", "hardsigmoid")
Hardswish = _mk("Hardswish", "hardswish")
Hardtanh = _mk("Hardtanh", "hardtanh")
ELU = _mk("ELU", "elu")
CELU = _mk("CELU", "celu")
SELU = _mk("SELU", "selu")
GELU = _mk("GELU", "gelu")
Silu = _mk("Silu", "silu")
Mish = _mk("Mish", "mish")
Swish = _mk("Swish", "silu")
LeakyReLU = _mk("LeakyReLU", "leaky_relu")
Softplus = _mk("Softplus", "softplus")
Softshrink = _mk("Softshrink", "softshrink")
Softsign = _mk("Softsign", "softsign")
ThresholdedReLU = _mk("ThresholdedReLU", "thresholded_relu")
Softmax = _mk("Softmax", "softmax")
LogSoftmax = _mk("LogSoftmax", "log_softmax")
Maxout = _mk("Maxout", "maxout")
GLU = _mk("GLU", "glu")
RReLU = _mk("RReLU", "rrelu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device: DeviceLike = None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init), device=resolve_device(device))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)
