"""Weight initialisers.

Counterpart: ``paddle_tpu/nn/initializer/__init__.py``: the classes
``Constant`` … ``Dirac`` (:41-193), ``calculate_gain``,
``_resolve_initializer`` and ``set_global_initializer`` (:194-226).
Each class is a callable ``(shape, dtype) -> tensor`` that draws from the
framework generator (``core/generator.py``, one ``split_key`` a call, as
the reference's) through the port's random transforms (``ops/random.py``),
on the current place's device unless ``device=`` names one. So from the
same seed a parameter gets the reference's values: ``Uniform``,
``XavierUniform`` and ``KaimingUniform`` bit for bit, the normal draws
(``Normal``, ``XavierNormal``, ``KaimingNormal``) within the two ulps of
``ops/random.py``'s ``normal`` (torch's and XLA's float32 ``log1p``
differ), ``TruncatedNormal`` within 2e-4 of its std (the bounds of its
uniform are each library's float32 ``erf``, an ulp apart near ±1, where
``erfinv`` magnifies them), ``Orthogonal`` within the rounding of the
two libraries' QR.

The plain functions ``constant``, ``uniform``, ``xavier_normal`` and
``kaiming_uniform`` fill a tensor in place from an explicit
``torch.Generator``: the seeded resets of the built-in models
(``reset_conv_bn``, the models' ``reset_parameters``) use them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import dtype as dtypes
from ...core import generator as gen_mod
from ...core.place import default_device
from ...core.tensor import to_plain

__all__ = ["Assign", "Constant", "Dirac", "Initializer", "KaimingNormal",
           "KaimingUniform", "Normal", "Orthogonal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "calculate_gain",
           "constant", "kaiming_uniform", "set_global_initializer",
           "uniform", "xavier_normal"]


def _fan_in_out(shape):
    """(fan_in, fan_out): [in, out] for a Linear weight; in·receptive and
    out·receptive for a conv weight [out, in, *kernel]."""
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _key():
    return gen_mod.default_generator.split_key()


def _dt(dtype):
    return dtypes.convert_dtype(dtype) or torch.float32


def _f(value, like):
    """A Python number as a 0-d tensor of like's dtype (the reference's
    weak-typed constants)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError

    def apply(self, param):
        """Draw into an existing parameter in place."""
        with torch.no_grad():
            t = to_plain(param)
            t.copy_(self(list(t.shape), t.dtype, t.device))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=device or default_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean = mean
        self.std = std

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import normal_bits
        z = normal_bits(_key(), tuple(shape), _dt(dtype),
                        device or default_device())
        return _affine(z, self.mean, self.std)


def _affine(z, mean, std):
    """mean + std·z in z's dtype; for float32 rounded once, as XLA's fused
    multiply-add rounds the reference's."""
    if z.dtype == torch.float32:
        m = float(torch.tensor(mean, dtype=torch.float32))
        s = float(torch.tensor(std, dtype=torch.float32))
        return (z.double() * s + m).float()
    return _f(mean, z) + _f(std, z) * z


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean = mean
        self.std = std
        self.a = a
        self.b = b

    def __call__(self, shape, dtype, device=None):
        """``jax.random.truncated_normal``: sqrt(2)·erfinv(u), u uniform
        between erf(lo / sqrt 2) and erf(hi / sqrt 2), clamped inside (lo,
        hi)."""
        from ...ops.random import _draw_dtype, erfinv32, uniform_bits
        dt = _dt(dtype)
        draw = _draw_dtype(dt)
        dev = device or default_device()
        lo = torch.tensor((self.a - self.mean) / self.std, dtype=draw)
        hi = torch.tensor((self.b - self.mean) / self.std, dtype=draw)
        root2 = torch.tensor(math.sqrt(2), dtype=draw)
        a = float(torch.special.erf(lo / root2))
        b = float(torch.special.erf(hi / root2))
        u = uniform_bits(_key(), tuple(shape), draw, a, b, dev)
        out = root2.to(dev) * erfinv32(u)
        out = out.clamp(float(torch.nextafter(lo, torch.tensor(math.inf,
                                                                 dtype=draw))),
                        float(torch.nextafter(hi, torch.tensor(-math.inf,
                                                                 dtype=draw))))
        return _affine(out.to(dt), self.mean, self.std)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low = low
        self.high = high

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import uniform_bits
        return uniform_bits(_key(), tuple(shape), _dt(dtype), self.low,
                            self.high, device or default_device())


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import normal_bits
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        z = normal_bits(_key(), tuple(shape), _dt(dtype),
                        device or default_device())
        return _f(std, z) * z


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import uniform_bits
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return uniform_bits(_key(), tuple(shape), _dt(dtype), -limit, limit,
                            device or default_device())


def _kaiming_gain(nonlinearity, negative_slope):
    return (math.sqrt(2.0 / (1 + negative_slope ** 2))
            if nonlinearity in ("relu", "leaky_relu") else 1.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import normal_bits
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        std = _kaiming_gain(self.nonlinearity,
                            self.negative_slope) / math.sqrt(fi)
        z = normal_bits(_key(), tuple(shape), _dt(dtype),
                        device or default_device())
        return _f(std, z) * z


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        from ...ops.random import uniform_bits
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        limit = _kaiming_gain(self.nonlinearity,
                              self.negative_slope) * math.sqrt(3.0 / fi)
        return uniform_bits(_key(), tuple(shape), _dt(dtype), -limit, limit,
                            device or default_device())


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        """The QR of a normal [max(r, c), min(r, c)] draw, its columns'
        signs fixed by R's diagonal, transposed when rows < cols."""
        from ...ops.random import normal_bits
        shape = tuple(shape)
        rows = shape[0]
        cols = math.prod(shape[1:])
        flat = normal_bits(_key(), (max(rows, cols), min(rows, cols)),
                           torch.float32, device or default_device())
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(_dt(dtype))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        v = self.value
        v = (to_plain(v).detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v)))
        return v.to(device=device or default_device(),
                    dtype=_dt(dtype)).reshape(tuple(shape)).clone()


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, device=None):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                idx = (g * (oc // self.groups) + i, i) + tuple(centers)
                out[idx] = 1.0
        return torch.from_numpy(out).to(device=device or default_device(),
                                        dtype=_dt(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


def _resolve_initializer(init):
    """Accept an Initializer instance, a class, or a callable."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, type) and issubclass(init, Initializer):
        return init()
    if callable(init):
        return init
    raise TypeError(f"cannot use {init!r} as initializer")


def set_global_initializer(weight_init, bias_init=None):
    """Record the global initialisers, as the reference's simplified hook
    does (nothing reads them there either)."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


# -- in-place fills from an explicit torch.Generator (the models' resets) --

@torch.no_grad()
def constant(t, value=0.0):
    return t.fill_(value)


@torch.no_grad()
def uniform(t, low=-1.0, high=1.0, generator=None):
    return t.uniform_(low, high, generator=generator)


@torch.no_grad()
def xavier_normal(t, fan_in=None, fan_out=None, gain=1.0, generator=None):
    """normal(0, gain·sqrt(2 / (fan_in + fan_out)))."""
    fi, fo = _fan_in_out(t.shape)
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    return t.normal_(0.0, gain * math.sqrt(2.0 / (fi + fo)),
                     generator=generator)


@torch.no_grad()
def kaiming_uniform(t, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                    generator=None):
    """uniform(±gain·sqrt(3 / fan_in)), gain sqrt(2 / (1 + slope²)) for
    relu and leaky_relu, else 1."""
    fi = _fan_in_out(t.shape)[0] if fan_in is None else fan_in
    limit = _kaiming_gain(nonlinearity, negative_slope) * math.sqrt(3.0 / fi)
    return t.uniform_(-limit, limit, generator=generator)
