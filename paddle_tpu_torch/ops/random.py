"""Random ops over the framework generator.

Counterpart: ``paddle_tpu/ops/random.py``: the 8 registered ``*_raw``
ops and the public ``uniform``, ``rand``, ``normal``, ``gaussian``,
``randn``, ``standard_normal``, ``randint``, ``randint_like``,
``randperm``, ``bernoulli``, ``poisson``, ``multinomial`` and the
in-place ``exponential_``, ``uniform_``, ``normal_`` and the ``*_like``
forms.

Every draw takes one split of the framework generator
(``core/generator.py``, ``default_generator.split_key()``: the
reference's threefry key sequence) and turns the threefry-2x32 bits of
that key into values by ``jax.random``'s transforms, computed here on the
tensor's device from the key's two words (no host-to-device copy, and no
``torch.Generator``):

- ``uniform``: the top mantissa bits of each element's 32 random bits
  (8 for bfloat16, 16 for float16) under the exponent of 1.0, minus 1,
  scaled to [min, max); ``randint``: two 32-bit draws reduced modulo the
  span; ``randperm``: a stable sort by 32-bit random keys (one round
  below ~1600 elements); ``bernoulli``: ``uniform < p``; ``multinomial``:
  Gumbel noise (``-log(-log(u))``) added to the log-probabilities,
  arg-max (with replacement) or top-k (without). These are the
  reference's draws bit for bit (``uniform``'s ``floats * span + lo``
  rounded once, as XLA's fused multiply-add rounds it).
- ``exponential``: ``-log1p(-u)``, and ``normal``: ``sqrt(2) *
  erfinv(u)`` with ``u`` uniform on (-1, 1) through XLA's erfinv
  polynomial (Giles). The float32 log1p of torch and of XLA differ, so
  these are within one and two ulps of the reference's.
- ``poisson``: Knuth's algorithm below a rate of 10 and Hormann's
  transformed rejection above, as ``jax.random.poisson`` runs them.

A 64-bit request (``float64``, ``int64``) draws what the reference draws
(which computes at 32 bits on the TPU) and widens it.
"""
from __future__ import annotations

import math

import torch

from ..core import dtype as dtypes
from ..core import generator as gen_mod
from ..core.dispatch import register_op
from ..core.place import default_device
from ..core.tensor import to_plain, wrap
from ..nn.functional.sampling import threefry2x32
from ._helpers import shape_arg, tensor
from .math import add, multiply

_M32 = 0xFFFFFFFF


def _key():
    return gen_mod.default_generator.split_key()


def split(key, num=2):
    """``jax.random.split(key, num)``: key i is the hash of the counter
    pair (0, i). ``key`` is two ints (or two tensors of words)."""
    k1, k2 = key
    return [threefry2x32(k1, k2, 0, i) for i in range(num)]


def bits32(key, shape, device):
    """``jax.random.bits(key, shape)`` (uint32 values in int64): each
    element hashes its flat index as the counter pair (hi, lo); the two
    output words are xor-ed."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (y1 ^ y2).reshape(shape)


_ONE_BITS = {torch.float32: (9, 0x3F800000, torch.int32),
             torch.float16: (6, 0x3C00, torch.int16),
             torch.bfloat16: (1, 0x3F80, torch.int16)}


def _draw_dtype(dtype):
    """The dtype the reference draws in: 64-bit requests narrowed."""
    return {torch.float64: torch.float32,
            torch.int64: torch.int32}.get(dtype, dtype)


def _unit_floats(bits, dtype):
    """Random bits → floats in [0, 1) of ``dtype`` (jax's ``_uniform``)."""
    shift, one, itype = _ONE_BITS[dtype]
    if dtype == torch.float16:
        bits = bits & 0xFFFF
    elif dtype == torch.bfloat16:
        bits = bits & 0xFF
    fb = ((bits >> shift) | one).to(torch.int64)
    if itype == torch.int16:
        fb = torch.where(fb >= 1 << 15, fb - (1 << 16), fb)
    return fb.to(itype).view(dtype) - 1.0


def uniform_bits(key, shape, dtype, lo, hi, device):
    """``jax.random.uniform(key, shape, dtype, lo, hi)``."""
    draw = _draw_dtype(dtype)
    floats = _unit_floats(bits32(key, shape, device), draw)
    lo_t = torch.full((), lo, dtype=draw, device=device)
    span = torch.full((), hi, dtype=draw, device=device) - lo_t
    # floats * span + lo rounded once, as XLA's fused multiply-add does:
    # the float64 product of two float32 values is exact
    out = (floats.double() * span.double() + lo_t.double()).to(draw)
    return torch.maximum(lo_t, out).to(dtype)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x):
    """XLA's float32 erfinv: M. Giles' polynomial in ``w = -log1p(-x^2)``
    (degree 9, one set of coefficients below w = 5 and one above)."""
    x32 = x.float()
    w = -torch.log1p(-x32 * x32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    out = torch.where(x32.abs() == 1, x32 * torch.finfo(torch.float32).max,
                      p * x32)
    return out.to(x.dtype)


def normal_bits(key, shape, dtype, device):
    """``jax.random.normal(key, shape, dtype)``."""
    draw = _draw_dtype(dtype)
    lo = torch.nextafter(torch.tensor(-1.0, dtype=draw),
                         torch.tensor(0.0, dtype=draw)).item()
    u = uniform_bits(key, shape, draw, lo, 1.0, device)
    root2 = torch.full((), math.sqrt(2), dtype=draw, device=device)
    return (root2 * erfinv32(u)).to(dtype)


@register_op("uniform_raw", differentiable=False)
def _uniform(key, shape, dtype, lo, hi, device=None):
    return uniform_bits(key, shape_arg(shape), dtypes.convert_dtype(dtype),
                        lo, hi, device or default_device())


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    dtype = dtypes.convert_dtype(dtype) if dtype else \
        dtypes.get_default_dtype()
    return wrap(_uniform(_key(), shape_arg(shape), dtype,
                         float(to_plain(min)), float(to_plain(max))))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


@register_op("normal_raw", differentiable=False)
def _normal(key, shape, dtype, mean, std, device=None):
    z = normal_bits(key, shape_arg(shape), dtypes.convert_dtype(dtype),
                    device or default_device())
    return mean + std * z


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m, s = to_plain(mean), to_plain(std)
        shp = torch.broadcast_shapes(getattr(m, "shape", ()),
                                     getattr(s, "shape", ()))
        base = wrap(_normal(_key(), shp, dtypes.get_default_dtype(), 0.0,
                            1.0, device=getattr(m, "device", None)
                            or getattr(s, "device", None)))
        return add(multiply(base, std), mean)
    return wrap(_normal(_key(), shape_arg(shape if shape is not None else [1]),
                        dtypes.get_default_dtype(), float(mean), float(std)))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dtype = dtypes.convert_dtype(dtype) if dtype else \
        dtypes.get_default_dtype()
    return wrap(_normal(_key(), shape_arg(shape), dtype, float(mean),
                        float(std)))


def randn(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype=dtype)


def standard_normal(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype=dtype)


def randint_bits(key, shape, low, high, dtype, device):
    """``jax.random.randint``: two 32-bit draws, the high one times
    (2^32 mod span) plus the low one, modulo the span (uint32
    arithmetic)."""
    info = torch.iinfo(_draw_dtype(dtype))
    lo = max(min(int(low), info.max), info.min)
    hi_raw = int(high)
    hi = max(min(hi_raw, info.max), info.min)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif hi_raw > info.max:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    higher, lower = bits32(k1, shape, device), bits32(k2, shape, device)
    if span == 0:       # a span of 2^32 wraps to 0: the low draw as it is
        off = lower
    else:
        mult = (1 << 16) % span
        mult = (mult * mult) % span
        off = (((higher % span) * mult) & _M32)
        off = ((off + lower % span) & _M32) % span
    return (off + lo).to(dtype)


@register_op("randint_raw", differentiable=False)
def _randint(key, shape, low, high, dtype):
    return randint_bits(key, shape_arg(shape), low, high,
                        dtypes.convert_dtype(dtype), default_device())


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dtype = dtypes.convert_dtype(dtype) if dtype else dtypes.int64
    return wrap(_randint(_key(), shape_arg(shape), int(to_plain(low)),
                         int(to_plain(high)), dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = to_plain(x)
    return randint(low, high, shape=x.shape, dtype=dtype or x.dtype)


def permutation_bits(key, n, device):
    """``jax.random.permutation(key, n)``: arange(n) stably sorted by
    32-bit random keys, ceil(3 ln n / ln(2^32 - 1)) rounds."""
    x = torch.arange(n, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits32(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


@register_op("randperm_raw", differentiable=False)
def _randperm(key, n, dtype):
    return permutation_bits(key, n, default_device()).to(
        dtypes.convert_dtype(dtype))


def randperm(n, dtype="int64", name=None):
    return wrap(_randperm(_key(), int(to_plain(n)),
                          dtypes.convert_dtype(dtype)))


@register_op("bernoulli_raw", differentiable=False)
def _bernoulli(key, p):
    p = tensor(p)
    u = uniform_bits(key, p.shape, p.dtype, 0.0, 1.0, p.device)
    return (u < p).to(p.dtype)


def bernoulli(x, name=None):
    return _bernoulli(_key(), x)


def _poisson_knuth(key, lam):
    k = torch.zeros_like(lam, dtype=torch.int32)
    log_prod = torch.zeros_like(lam)
    while bool((log_prod > -lam).any()):
        key, sub = split(key)
        k = torch.where(log_prod > -lam, k + 1, k)
        u = uniform_bits(sub, lam.shape, torch.float32, 0.0, 1.0, lam.device)
        log_prod = log_prod + torch.log(u)
    return k - 1


def _poisson_rejection(key, lam):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros_like(lam, dtype=torch.bool)
    while not bool(accepted.all()):
        key, s0, s1 = split(key, 3)
        u = uniform_bits(s0, lam.shape, lam.dtype, 0.0, 1.0, lam.device) - 0.5
        v = uniform_bits(s1, lam.shape, lam.dtype, 0.0, 1.0, lam.device)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / us + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int32)


def poisson_bits(key, lam):
    """``jax.random.poisson(key, lam)`` (int32 counts)."""
    lam = lam.float()
    knuth = torch.isnan(lam) | (lam < 10)
    res = torch.where(
        knuth,
        _poisson_knuth(key, torch.where(knuth, lam, torch.zeros_like(lam))),
        _poisson_rejection(key, torch.where(knuth, torch.full_like(lam, 1e5),
                                            lam)))
    return torch.where(lam == 0, torch.zeros_like(res), res)


@register_op("poisson_raw", differentiable=False)
def _poisson(key, lam):
    lam = tensor(lam)
    return poisson_bits(key, lam).to(lam.dtype)


def poisson(x, name=None):
    return _poisson(_key(), x)


def gumbel_bits(key, shape, dtype, device):
    """``jax.random.gumbel`` (low mode): ``-log(-log(u))``, u uniform on
    [tiny, 1)."""
    tiny = torch.finfo(_draw_dtype(dtype)).tiny
    u = uniform_bits(key, shape, dtype, tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical_bits(key, logits, shape=None):
    """``jax.random.categorical(key, logits, axis=-1, shape)``: arg-max of
    the logits plus Gumbel noise over (*prefix, *batch, V)."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch)]
    g = gumbel_bits(key, prefix + shape[len(prefix):] + logits.shape[-1:],
                    logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=-1)


@register_op("multinomial_raw", differentiable=False)
def _multinomial(key, probs, num_samples, replacement):
    probs = tensor(probs)
    logits = torch.log(torch.clamp_min(probs, 1e-30))
    if replacement:
        return categorical_bits(key, logits, probs.shape[:-1] + (
            num_samples,)).to(torch.int64)
    g = gumbel_bits(key, logits.shape, logits.dtype, logits.device)
    idx = torch.sort(logits + g, dim=-1, descending=True, stable=True).indices
    return idx[..., :num_samples].to(torch.int64)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return _multinomial(_key(), x, int(num_samples), bool(replacement))


@register_op("exponential_raw", differentiable=False)
def _exponential(key, shape, lam, dtype, device=None):
    u = uniform_bits(key, shape_arg(shape), dtypes.convert_dtype(dtype), 0.0,
                     1.0, device or default_device())
    return -torch.log1p(-u) / lam


def _fill(x, values):
    with torch.no_grad():
        to_plain(x).copy_(to_plain(values))
    return x


def exponential_(x, lam=1.0, name=None):
    xv = to_plain(x)
    return _fill(x, _exponential(_key(), tuple(xv.shape), float(lam),
                                 xv.dtype, device=xv.device))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    xv = to_plain(x)
    return _fill(x, _uniform(_key(), tuple(xv.shape), xv.dtype, float(min),
                             float(max), device=xv.device))


def normal_(x, mean=0.0, std=1.0, shape=None, name=None):
    xv = to_plain(x)
    return _fill(x, _normal(_key(), tuple(xv.shape), xv.dtype, float(mean),
                            float(std), device=xv.device))


def rand_like(x, dtype=None, name=None):
    x = to_plain(x)
    return uniform(x.shape, dtype=dtype or x.dtype, min=0.0, max=1.0)


def randn_like(x, dtype=None, name=None):
    x = to_plain(x)
    return gaussian(x.shape, dtype=dtype or x.dtype)


__all__ = ["bernoulli", "exponential_", "gaussian", "multinomial", "normal",
           "normal_", "poisson", "rand", "rand_like", "randint",
           "randint_like", "randn", "randn_like", "randperm",
           "standard_normal", "uniform", "uniform_"]
