"""The operator surface: every op module, and the Tensor facade's methods.

Counterpart: ``paddle_tpu/ops/__init__.py``: the op modules' public
functions, the in-place variants (``add_`` ... ``fill_``, :68-93),
``increment``, and the Tensor methods and operators (:109-303), set here
on the facade class of ``core/tensor.py``. Paddle's names win over
torch's on the facade (``x.sum(axis=1)``, ``x.transpose([1, 0])``,
``x.gather(idx)``, ``x.numel()`` a tensor); the facade's own attributes
(``numpy``, ``detach``, ``to``, ``cpu``, ``backward`` ...) stay.

An in-place variant runs the registered op out of place and writes the
result into ``x`` with torch's own in-place ``copy_`` (autograd records
it; a leaf that requires a gradient refuses it, as Paddle's does). Where
the op changes the shape or dtype (``reshape_``, ``cast_`` ...) the
tensor's data is replaced instead, which a tensor that requires a
gradient refuses. ``x[idx] = v`` is the registered ``setitem`` written
back so. The reflected operators with a Python number on the left
(``1 - x``, ``2 / x``, ``2 ** x``) make the number a 0-d tensor first,
as the reference's ``to_tensor`` does.
"""
from __future__ import annotations

import types

import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor, to_plain
from . import extras as _ex
from ._helpers import tensor as _as_tensor
from .array_ops import array_length, array_read, array_write, create_array
from .creation import (arange, assign, clone, diag, diagflat, empty,
                       empty_like, eye, full, full_like, linspace, logspace,
                       meshgrid, ones, ones_like, to_tensor, tril,
                       tril_indices, triu, triu_indices, zeros, zeros_like)
from .extras import (add_n, angle, atleast_1d, atleast_2d, atleast_3d,
                     bernoulli_, block_diag, broadcast_shape, cartesian_prod,
                     cauchy_, cdist, cholesky_inverse, column_stack,
                     combinations, complex, cond, create_parameter,
                     create_tensor,
                     cumulative_trapezoid, diagonal_scatter, dsplit, dstack,
                     finfo, frexp, gammainc, gammaincc, gammaln, geometric_,
                     histogram_bin_edges, householder_product, hsplit, i0,
                     i0e, i1, i1e, iinfo, index_fill, is_complex,
                     is_floating_point, is_integer, isneginf, isposinf,
                     isreal, log_normal, log_normal_, logcumsumexp, logit,
                     lu_unpack, masked_scatter, multigammaln, nanquantile,
                     nextafter, ormqr, pca_lowrank, pdist, polar, polygamma,
                     rank, reduce_as, renorm, reverse, row_stack,
                     select_scatter, sgn, shard_index, signbit, sinc,
                     slice_scatter, standard_gamma, svd_lowrank, take,
                     tensor_split, tolist, top_p_sampling, trapezoid,
                     unflatten, unstack, vander, view_as, vsplit)
from .extras import unfold as tensor_unfold
from .linalg import (cholesky, cholesky_solve, corrcoef, cov, cross, det,
                     diag_embed, diagonal, dist, eig, eigh, eigvals,
                     eigvalsh, einsum, histogramdd, inverse, lstsq, lu,
                     matrix_exp, matrix_norm, matrix_power, matrix_rank,
                     multi_dot, norm, pinv, qr, slogdet, solve, svd, trace,
                     triangular_solve, vector_norm)
from .logic import (allclose, bitwise_and, bitwise_left_shift, bitwise_not,
                    bitwise_or, bitwise_right_shift, bitwise_xor, equal,
                    equal_all, greater_equal, greater_than, is_empty,
                    isclose, isin, less_equal, less_than, logical_and,
                    logical_not, logical_or, logical_xor, not_equal)
from .manipulation import (_getitem, _setitem, as_complex, as_real,
                           as_strided, bincount, broadcast_tensors,
                           broadcast_to, bucketize, cast, chunk, concat,
                           conj, crop, expand, expand_as, flatten, flip,
                           gather, gather_nd, hstack, histogram, imag,
                           index_add, index_put, index_sample, index_select,
                           kthvalue, masked_fill, masked_select, mode,
                           moveaxis, nonzero, numel, one_hot, pad,
                           put_along_axis, real, repeat_interleave, reshape,
                           roll, rot90, scatter, scatter_nd, scatter_nd_add,
                           searchsorted, shape, slice, sort, split, squeeze,
                           stack, strided_slice, swapaxes, t, take_along_axis,
                           tensordot, tile, topk, transpose, transpose_,
                           unbind, unique,
                           unique_consecutive, unsqueeze, view, vstack, where,
                           argsort)
from .math import (abs, acos, acosh, add, addmm, asin, asinh, atan, atan2,
                   atanh, bmm, ceil, clip, copysign, cos, cosh, cummax,
                   cummin, cumprod, cumsum, deg2rad, diff, digamma, divide,
                   dot, erf, erfinv, exp, expm1, floor, floor_divide,
                   floor_mod, fmax, fmin, frac, gcd, heaviside, hypot, inner,
                   isfinite, isinf, isnan, kron, lcm, ldexp, lerp, lgamma,
                   log, log1p, log2, log10, logaddexp, matmul, maximum,
                   minimum, mod, multiplex, multiply, mv, nan_to_num, neg,
                   outer, pow, rad2deg, reciprocal, remainder, round, rsqrt,
                   scale, sign, sin, sinh, sqrt, square, stanh, subtract,
                   tan, tanh, trunc)
from .random import (bernoulli, exponential_, gaussian, multinomial, normal,
                     normal_, poisson, rand, rand_like, randint, randint_like,
                     randn, randn_like, randperm, standard_normal, uniform,
                     uniform_)
from .reduction import (all, amax, amin, any, argmax, argmin,
                        count_nonzero, logsumexp, max, mean, median, min,
                        nanmean, nanmedian, nansum, prod, quantile, std, sum,
                        var)

# ---------------------------------------------------------------------------
# in-place variants
# ---------------------------------------------------------------------------


def _make_inplace(fn):
    def inplace(x, *args, **kwargs):
        out = to_plain(fn(x, *args, **kwargs))
        if tuple(out.shape) == tuple(x.shape) and out.dtype == x.dtype:
            torch.Tensor.copy_(x, out)
        else:
            if x.requires_grad:
                raise RuntimeError(
                    f"{fn.__name__}_: a tensor that requires a gradient "
                    "cannot change its shape or dtype in place")
            x.data = out
        return x

    inplace.__name__ = fn.__name__ + "_"
    return inplace


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
multiply_ = _make_inplace(multiply)
divide_ = _make_inplace(divide)
scale_ = _make_inplace(scale)
clip_ = _make_inplace(clip)
floor_ = _make_inplace(floor)
ceil_ = _make_inplace(ceil)
exp_ = _make_inplace(exp)
sqrt_ = _make_inplace(sqrt)
reciprocal_ = _make_inplace(reciprocal)
tanh_ = _make_inplace(tanh)
cast_ = _make_inplace(cast)
reshape_ = _make_inplace(reshape)
squeeze_ = _make_inplace(squeeze)
unsqueeze_ = _make_inplace(unsqueeze)
flatten_ = _make_inplace(flatten)
zero_ = _make_inplace(lambda x: zeros_like(x))
fill_ = _make_inplace(lambda x, v: full_like(x, v))


def increment(x, value=1.0, name=None):
    return add_(x, value)


# ---------------------------------------------------------------------------
# the facade's operators and methods
# ---------------------------------------------------------------------------


def _lhs(o, s):
    """A Python number on the left of a reflected operator, as the
    reference's ``to_tensor(o)``: a 0-d tensor of its default dtype."""
    return o if isinstance(o, torch.Tensor) else _as_tensor(o, to_plain(s))


def _index(idx):
    if isinstance(idx, tuple):
        return tuple(to_plain(i) for i in idx)
    return to_plain(idx)


def _getitem_method(s, idx):
    return apply(_getitem.opdef, s, _index(idx))


def _setitem_method(s, idx, value):
    out = to_plain(apply(_setitem.opdef, s, _index(idx), value))
    torch.Tensor.copy_(s, out)


def apply_sigmoid(x, name=None):
    from ..nn.functional.activation import sigmoid
    return sigmoid(x)


_OPERATORS = {
    "__add__": lambda s, o: add(s, o),
    "__radd__": lambda s, o: add(s, o),
    "__sub__": lambda s, o: subtract(s, o),
    "__rsub__": lambda s, o: subtract(_lhs(o, s), s),
    "__mul__": lambda s, o: multiply(s, o),
    "__rmul__": lambda s, o: multiply(s, o),
    "__truediv__": lambda s, o: divide(s, o),
    "__rtruediv__": lambda s, o: divide(_lhs(o, s), s),
    "__floordiv__": lambda s, o: floor_divide(s, o),
    "__rfloordiv__": lambda s, o: floor_divide(_lhs(o, s), s),
    "__mod__": lambda s, o: remainder(s, o),
    "__rmod__": lambda s, o: remainder(_lhs(o, s), s),
    "__pow__": lambda s, o: pow(s, o),
    "__rpow__": lambda s, o: pow(_lhs(o, s), s),
    "__matmul__": lambda s, o: matmul(s, o),
    "__rmatmul__": lambda s, o: matmul(o, s),
    "__iadd__": lambda s, o: add(s, o),
    "__isub__": lambda s, o: subtract(s, o),
    "__imul__": lambda s, o: multiply(s, o),
    "__itruediv__": lambda s, o: divide(s, o),
    "__neg__": lambda s: neg(s),
    "__abs__": lambda s: abs(s),
    "__eq__": lambda s, o: equal(s, o) if o is not None else False,
    "__ne__": lambda s, o: not_equal(s, o) if o is not None else True,
    "__lt__": lambda s, o: less_than(s, o),
    "__le__": lambda s, o: less_equal(s, o),
    "__gt__": lambda s, o: greater_than(s, o),
    "__ge__": lambda s, o: greater_equal(s, o),
    "__invert__": lambda s: logical_not(s),
    "__and__": lambda s, o: (logical_and if s.dtype == torch.bool
                             else bitwise_and)(s, o),
    "__or__": lambda s, o: (logical_or if s.dtype == torch.bool
                            else bitwise_or)(s, o),
    "__xor__": lambda s, o: (logical_xor if s.dtype == torch.bool
                             else bitwise_xor)(s, o),
    "__getitem__": _getitem_method,
    "__setitem__": _setitem_method,
}

_METHODS = dict(
    add=add, add_=add_, subtract=subtract, subtract_=subtract_,
    multiply=multiply, multiply_=multiply_, divide=divide, divide_=divide_,
    matmul=matmul, mm=matmul, bmm=bmm, dot=dot, pow=pow, abs=abs, neg=neg,
    exp=exp, exp_=exp_, log=log, sqrt=sqrt, sqrt_=sqrt_, rsqrt=rsqrt,
    square=square, sin=sin, cos=cos, tan=tan, tanh=tanh, tanh_=tanh_,
    sigmoid=apply_sigmoid, floor=floor, floor_=floor_, ceil=ceil, ceil_=ceil_,
    round=round, sign=sign, clip=clip, clip_=clip_, scale=scale,
    scale_=scale_, maximum=maximum, minimum=minimum, remainder=remainder,
    mod=remainder, reciprocal=reciprocal, reciprocal_=reciprocal_, erf=erf,
    lerp=lerp, cumsum=cumsum, cumprod=cumprod, isnan=isnan, isinf=isinf,
    isfinite=isfinite, nan_to_num=nan_to_num,
    sum=sum, mean=mean, max=max, min=min, prod=prod, all=all, any=any,
    argmax=argmax, argmin=argmin, logsumexp=logsumexp, std=std, var=var,
    median=median, quantile=quantile,
    reshape=reshape, reshape_=reshape_, transpose=transpose, t=t,
    squeeze=squeeze, squeeze_=squeeze_, unsqueeze=unsqueeze,
    unsqueeze_=unsqueeze_, flatten=flatten, flatten_=flatten_,
    expand=expand, expand_as=expand_as, broadcast_to=broadcast_to,
    tile=tile, flip=flip, roll=roll, cast=cast, astype=cast, cast_=cast_,
    gather=gather, gather_nd=gather_nd, scatter=scatter,
    scatter_nd_add=scatter_nd_add, index_select=index_select,
    index_add=index_add, index_put=index_put, index_sample=index_sample,
    masked_select=masked_select, masked_fill=masked_fill,
    take_along_axis=take_along_axis, put_along_axis=put_along_axis,
    where=where, nonzero=nonzero, sort=sort, argsort=argsort, topk=topk,
    unique=unique, split=split, chunk=chunk, unbind=unbind,
    tril=tril, triu=triu, diagonal=diagonal, trace=trace, norm=norm,
    dist=dist, cross=cross, cholesky=cholesky, inverse=inverse,
    matrix_power=matrix_power, det=det, numel=numel, equal=equal,
    equal_all=equal_all, not_equal=not_equal, greater_than=greater_than,
    greater_equal=greater_equal, less_than=less_than, less_equal=less_equal,
    allclose=allclose, isclose=isclose, logical_and=logical_and,
    logical_or=logical_or, logical_not=logical_not, logical_xor=logical_xor,
    bitwise_and=bitwise_and, bitwise_or=bitwise_or, bitwise_xor=bitwise_xor,
    bitwise_not=bitwise_not, kron=kron, outer=outer, inner=inner,
    repeat_interleave=repeat_interleave, one_hot=one_hot,
    bincount=bincount, histogram=histogram, real=real, imag=imag, conj=conj,
    zero_=zero_, fill_=fill_, uniform_=uniform_, normal_=normal_,
    exponential_=exponential_, frac=frac, trunc=trunc, diff=diff,
    heaviside=heaviside, rot90=rot90, moveaxis=moveaxis, swapaxes=swapaxes,
    as_strided=as_strided, view=view, mv=mv, addmm=addmm,
    kthvalue=kthvalue, mode=mode, searchsorted=searchsorted,
    bucketize=bucketize, log1p=log1p, log2=log2, log10=log10,
    expm1=expm1, logaddexp=logaddexp, atan2=atan2, amax=amax, amin=amin,
    nansum=nansum, nanmean=nanmean, count_nonzero=count_nonzero,
    increment=increment, slogdet=slogdet, qr=qr, svd=svd, eigh=eigh,
    pinv=pinv, solve=solve, lu=lu, diag=diag, diag_embed=diag_embed,
    diagflat=diagflat, clone=assign,
)
for _name in (
        "gammaln", "gammainc", "gammaincc", "multigammaln", "polygamma",
        "i0", "i0e", "i1", "i1e", "logit", "sinc", "nextafter",
        "logcumsumexp", "angle", "sgn", "signbit", "frexp", "atleast_1d",
        "atleast_2d", "atleast_3d", "reverse", "unstack", "unflatten",
        "vander", "view_as", "diagonal_scatter", "select_scatter",
        "slice_scatter", "masked_scatter", "index_fill", "take",
        "nanquantile", "trapezoid", "cumulative_trapezoid", "renorm",
        "reduce_as", "cdist", "histogram_bin_edges", "cond",
        "cholesky_inverse", "svd_lowrank", "pca_lowrank", "is_complex",
        "is_floating_point", "is_integer", "isneginf", "isposinf",
        "isreal", "top_p_sampling", "shard_index", "tensor_split",
        "hsplit", "vsplit", "dsplit", "rank", "block_diag", "add_n",
        "polar", "broadcast_shape", "householder_product", "lu_unpack",
        "ormqr", "cauchy_", "geometric_", "log_normal_", "bernoulli_"):
    _METHODS.setdefault(_name, getattr(_ex, _name))
_METHODS["unfold"] = tensor_unfold
for _name in ("acos", "acosh", "asin", "asinh", "atan", "atanh", "cosh",
              "sinh", "digamma", "erfinv", "gcd", "lcm", "hypot", "ldexp",
              "copysign", "bitwise_left_shift", "bitwise_right_shift",
              "deg2rad", "rad2deg", "fmax", "fmin", "lgamma"):
    _METHODS.setdefault(_name, globals()[_name])
_METHODS.setdefault("floor_mod", remainder)
_METHODS.setdefault("floor_divide", floor_divide)

# Paddle defines x.op_() for most elementwise and manipulation ops.
_INPLACE_BASES = {
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "cos",
    "cosh", "sin", "sinh", "tan", "cumsum", "cumprod", "digamma",
    "erfinv", "floor_divide", "frac", "gcd", "lcm", "hypot", "ldexp",
    "lerp", "lgamma", "log", "log10", "log1p", "log2", "logical_and",
    "logical_not", "logical_or", "logical_xor", "bitwise_and",
    "bitwise_not", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "greater_equal", "greater_than",
    "less_equal", "less_than", "equal", "not_equal", "masked_fill",
    "mod", "nan_to_num", "neg", "pow", "put_along_axis", "remainder",
    "erf", "expm1", "square",
    "round", "rsqrt", "scatter", "sigmoid", "t", "tril", "triu",
    "trunc", "where", "copysign", "index_put", "index_fill",
    "gammainc", "gammaincc", "gammaln", "multigammaln", "polygamma",
    "i0", "sinc", "logit", "addmm", "renorm", "masked_scatter",
    "floor_mod",
}
for _base in sorted(_INPLACE_BASES):
    if _base + "_" not in _METHODS:
        _METHODS[_base + "_"] = _make_inplace(_METHODS[_base])
    # and as functions, paddle.abs_(x) ... (reference __init__.py:151-170)
    globals().setdefault(_base + "_", _METHODS[_base + "_"])


def _patch_tensor():
    own = set(Tensor.__dict__)
    for name, fn in {**_OPERATORS, **_METHODS}.items():
        if name not in own:
            setattr(Tensor, name, fn)


_patch_tensor()


__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and not isinstance(v, types.ModuleType)
    and getattr(v, "__module__", "").startswith(__name__))
