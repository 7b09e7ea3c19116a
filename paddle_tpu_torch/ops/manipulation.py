"""Shape, layout, indexing, gather / scatter and sort ops.

Counterpart: ``paddle_tpu/ops/manipulation.py``: the same 62 registered
ops, and the unregistered ``split`` (dispatching ``split_even`` or
``split_sections``, :86-111), ``chunk``, ``unbind``, ``pad``,
``broadcast_tensors``, ``scatter_nd``, ``unique``,
``unique_consecutive``, ``shape``, ``slice`` and ``strided_slice``
(both dispatching ``getitem``).

The reference's semantics where torch's differ:
- ``gather`` and ``index_select`` are ``jnp.take`` (any index shape,
  negative indices counted from the end), not ``torch.gather``;
- ``sort`` sorts stably and a descending sort is the ascending one
  reversed; ``argsort`` and ``topk`` keep the lower index first among
  equal values; ``kthvalue`` is read off a stable sort, ``mode`` returns
  the smallest most frequent value and its last index;
- ``unique`` returns (values, first indices, inverse, counts) as
  ``np.unique`` does; ``one_hot`` of an out-of-range id is a zero row;
- ``getitem`` takes negative slice steps (a flip) as numpy does;
- ``scatter`` with ``overwrite`` writes each row once, so only distinct
  indices have a defined result; without it the updates are summed.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.dispatch import apply, register_op
from ..core.tensor import to_plain, wrap
from ._helpers import operands, shape_arg, tensor


@register_op("reshape")
def reshape(x, shape, name=None):
    return torch.reshape(tensor(x), shape_arg(shape))


@register_op("transpose")
def transpose(x, perm=None, name=None):
    x = tensor(x)
    if perm is None:
        perm = list(range(x.ndim))[::-1]
    return x.permute(*[int(p) for p in perm])


@register_op("t")
def t(x, name=None):
    x = tensor(x)
    if x.ndim > 2:
        raise ValueError("paddle.t only supports tensors with ndim <= 2")
    return x.t() if x.ndim == 2 else x


@register_op("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(tensor(x), source, destination)


@register_op("swapaxes")
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(tensor(x), int(axis0), int(axis1))


transpose_ = transpose


@register_op("concat")
def concat(x, axis=0, name=None):
    dev = next((v.device for v in x if isinstance(v, torch.Tensor)), None)
    return torch.cat([tensor(v, dev) for v in x], dim=int(to_plain(axis)))


@register_op("stack")
def stack(x, axis=0, name=None):
    return torch.stack([tensor(v) for v in x], dim=int(axis))


@register_op("vstack")
def vstack(x, name=None):
    return torch.vstack([tensor(v) for v in x])


@register_op("hstack")
def hstack(x, name=None):
    return torch.hstack([tensor(v) for v in x])


def split(x, num_or_sections, axis=0, name=None):
    axis = int(to_plain(axis))
    if isinstance(num_or_sections, int):
        outs = apply(_split_even.opdef, x, num_or_sections, axis)
    else:
        secs = [int(to_plain(s)) for s in num_or_sections]
        if -1 in secs:
            total = to_plain(x).shape[axis]
            known = builtins.sum(s for s in secs if s != -1)
            secs = [s if s != -1 else total - known for s in secs]
        outs = apply(_split_secs.opdef, x, tuple(secs), axis)
    return list(outs)


@register_op("split_even", multi_out=True)
def _split_even(x, num, axis):
    x = tensor(x)
    n = x.shape[axis]
    if n % num:
        raise ValueError("array split does not result in an equal division: "
                         f"rest is {n % num}")
    return tuple(torch.split(x, n // num, dim=axis))


@register_op("split_sections", multi_out=True)
def _split_secs(x, secs, axis):
    return tuple(torch.split(tensor(x), list(secs), dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0):
    n = to_plain(x).shape[int(axis)]
    return [squeeze(o, axis=[int(axis)]) for o in split(x, n, axis=axis)]


@register_op("squeeze")
def squeeze(x, axis=None, name=None):
    x = tensor(x)
    if axis is None:
        return torch.squeeze(x)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = [a % x.ndim for a in axes]
    axes = [a for a in axes if x.shape[a] == 1]
    return torch.squeeze(x, dim=tuple(axes)) if axes else x


@register_op("unsqueeze")
def unsqueeze(x, axis, name=None):
    x = tensor(x)
    axes = [axis] if isinstance(axis, int) else [int(to_plain(a))
                                                 for a in axis]
    nd = x.ndim + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


@register_op("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = tensor(x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.ndim, stop_axis % x.ndim)


@register_op("expand")
def expand(x, shape, name=None):
    x = tensor(x)
    shape = shape_arg(shape)
    offset = len(shape) - x.ndim
    full = [(x.shape[i - offset] if i >= offset else 1) if s == -1 else s
            for i, s in enumerate(shape)]
    return torch.broadcast_to(x, tuple(full))


broadcast_to = expand


@register_op("expand_as")
def expand_as(x, y, name=None):
    return torch.broadcast_to(tensor(x), tuple(tensor(y).shape))


def broadcast_tensors(inputs, name=None):
    return [wrap(a) for a in torch.broadcast_tensors(
        *[tensor(to_plain(i)) for i in inputs])]


@register_op("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(tensor(x), shape_arg(repeat_times))


@register_op("flip")
def flip(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(tensor(x), dims=axes)


@register_op("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(tensor(x), k, dims=list(axes))


@register_op("roll")
def roll(x, shifts, axis=None, name=None):
    x = tensor(x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


@register_op("cast")
def cast(x, dtype):
    return tensor(x).to(dtypes.convert_dtype(dtype))


@register_op("clone_op")
def _clone_op(x):
    x = tensor(x)
    if x.dtype == torch.bool:
        return x.to(torch.int64)     # jnp: bool + 0 is an int
    return x.clone()


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        period = 2 * (n - 1)
        i = torch.remainder(i, period) if period else torch.zeros_like(i)
        return torch.where(i >= n, period - i, i)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    return torch.remainder(i, n)           # circular


@register_op("pad_nd")
def _pad_nd(x, pad_width, mode="constant", value=0.0):
    x = tensor(x)
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(mode)
    if mode == "constant":
        flat = []
        for b, a in reversed(list(pad_width)):
            flat += [int(b), int(a)]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (b, a) in enumerate(pad_width):
        if b or a:
            x = x.index_select(d, _pad_index(x.shape[d], int(b), int(a),
                                             mode, x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        pad_from_left_axis=True, name=None):
    """``paddle.nn.functional.pad``: a full-rank list pads every axis
    (from the first, or from the last with ``pad_from_left_axis`` False);
    a shorter one pads the spatial axes, innermost pair first."""
    nd = to_plain(x).ndim
    pad = [int(p) for p in (to_plain(pad).tolist()
                            if isinstance(pad, torch.Tensor) else pad)]
    if len(pad) == 2 * nd:
        order = range(nd) if pad_from_left_axis else reversed(range(nd))
        width = [(pad[2 * i], pad[2 * i + 1]) for i in order]
    else:
        n_spatial = len(pad) // 2
        width = [(0, 0)] * nd
        if data_format.endswith("C"):
            spatial = list(range(1, 1 + n_spatial))
        else:
            spatial = list(range(nd - n_spatial, nd))
        for i in range(n_spatial):
            width[spatial[n_spatial - 1 - i]] = (pad[2 * i], pad[2 * i + 1])
    return apply(_pad_nd.opdef, x, tuple(width), mode, value)


# --- gather / scatter ------------------------------------------------------


def _index(index, x, n=None):
    """An index array as a long tensor on ``x``'s device, negative entries
    counted from ``n``."""
    idx = tensor(index, x).long()
    if n is not None:
        idx = torch.where(idx < 0, idx + n, idx)
    return idx


@register_op("gather")
def gather(x, index, axis=0, name=None):
    x = tensor(x)
    axis = int(to_plain(axis)) % x.ndim
    idx = _index(index, x, x.shape[axis])
    if idx.ndim == 0:
        idx = idx[None]
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@register_op("gather_nd")
def gather_nd(x, index, name=None):
    x = tensor(x)
    idx = _index(index, x)
    return x[tuple(idx.unbind(-1))]


@register_op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    a = tensor(arr)
    idx = _index(indices, a, a.shape[axis])
    if broadcast:
        shape = list(a.shape)
        shape[axis] = idx.shape[axis]
        idx = torch.broadcast_to(idx, shape)
    return torch.gather(a, axis, idx)


@register_op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    a = tensor(arr)
    idx = _index(indices, a, a.shape[axis])
    v = torch.broadcast_to(tensor(values, a, a.dtype), idx.shape)
    if reduce == "assign":
        return a.scatter(axis, idx, v)
    if reduce in ("add", "sum"):
        return a.scatter_add(axis, idx, v)
    red = {"mul": "prod", "multiply": "prod", "amax": "amax",
           "amin": "amin"}.get(reduce)
    if red is None:
        raise ValueError(f"unknown reduce {reduce}")
    return a.scatter_reduce(axis, idx, v, red, include_self=True)


@register_op("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    x = tensor(x)
    idx = _index(index, x, x.shape[0]).reshape(-1)
    upd = tensor(updates, x, x.dtype)
    if overwrite:
        return x.index_put((idx,), upd)
    return x.index_add(0, idx, upd)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    x = tensor(x)
    idx = _index(index, x)
    return x.index_put(tuple(idx.unbind(-1)), tensor(updates, x, x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = to_plain(updates)
    zero = torch.zeros(shape_arg(shape), dtype=u.dtype, device=u.device)
    if updates is not u:
        zero = wrap(zero)
    return scatter_nd_add(zero, index, updates)


@register_op("index_select")
def index_select(x, index, axis=0, name=None):
    x = tensor(x)
    return torch.index_select(x, axis, _index(index, x, x.shape[axis])
                              .reshape(-1))


@register_op("index_sample")
def index_sample(x, index):
    x = tensor(x)
    return torch.gather(x, 1, _index(index, x, x.shape[1]))


@register_op("index_add")
def index_add(x, index, axis, value, name=None):
    x = tensor(x)
    idx = _index(index, x, x.shape[axis]).reshape(-1)
    return x.index_add(axis, idx, tensor(value, x, x.dtype))


def _index_tensor(i, x):
    i = tensor(i, x)
    return i if i.dtype == torch.bool else i.long()


@register_op("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    x = tensor(x)
    loc = tuple(_index_tensor(i, x) for i in indices)
    return x.index_put(loc, tensor(value, x, x.dtype), accumulate=accumulate)


@register_op("masked_fill")
def masked_fill(x, mask, value, name=None):
    x = tensor(x)
    return torch.where(tensor(mask, x).bool(), tensor(value, x, x.dtype), x)


@register_op("masked_select", differentiable=False)
def masked_select(x, mask, name=None):
    x = tensor(x)
    return x[tensor(mask, x).bool()]


@register_op("where")
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        raise ValueError("use paddle.nonzero for one-arg where")
    cond = tensor(condition)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = tensor(x, cond)
    return torch.where(cond.bool(), *operands(x, y))


@register_op("nonzero", differentiable=False)
def nonzero(x, as_tuple=False):
    x = tensor(x)
    res = torch.nonzero(x)
    if as_tuple:
        return tuple(res.unbind(-1))
    return res


def _norm_index(idx, x):
    """A numpy-style index for torch: (x, index, flipped dims). Lists and
    arrays become tensors on ``x``'s device; a slice with a negative step
    becomes a positive one over ``x`` flipped along that dim."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    conv, neg = [], False
    for i in items:
        if isinstance(i, (list, np.ndarray)) or (
                isinstance(i, torch.Tensor) and i.device != x.device):
            i = _index_tensor(i, x)
        elif isinstance(i, torch.Tensor) and i.dtype != torch.bool:
            i = i.long()
        elif isinstance(i, builtins.slice) and i.step is not None \
                and int(i.step) < 0:
            neg = True
        conv.append(i)
    flipped = []
    if neg:
        x, conv, flipped = _flip_negative_steps(x, conv)
    return x, (tuple(conv) if isinstance(idx, tuple) else conv[0]), flipped


def _consumed(i):
    return i.ndim if isinstance(i, torch.Tensor) and i.dtype == torch.bool \
        else 1


def _flip_negative_steps(x, items):
    used = builtins.sum(_consumed(i) for i in items
                        if i is not None and i is not Ellipsis)
    dim, out, flipped = 0, [], []
    for i in items:
        if i is None:
            out.append(i)
            continue
        if i is Ellipsis:
            dim += x.ndim - used
            out.append(i)
            continue
        if isinstance(i, builtins.slice) and i.step is not None \
                and int(i.step) < 0:
            n = x.shape[dim]
            r = range(*i.indices(n))
            x = x.flip(dim)
            flipped.append(dim)
            i = builtins.slice(0, 0) if len(r) == 0 else builtins.slice(
                n - 1 - r[0], n - r[-1], -i.step)
        dim += _consumed(i)
        out.append(i)
    return x, out, flipped


@register_op("getitem")
def _getitem(x, idx):
    x, idx, _ = _norm_index(idx, tensor(x))
    return x[idx]


@register_op("setitem")
def _setitem(x, idx, value):
    x = tensor(x)
    xf, idx, flipped = _norm_index(idx, x)
    out = xf.clone()
    out[idx] = tensor(value, x, x.dtype) if isinstance(
        value, torch.Tensor) or not np.isscalar(value) else value
    return out.flip(flipped) if flipped else out


# --- sort / search ---------------------------------------------------------


@register_op("sort")
def sort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.sort(tensor(x), dim=axis, stable=True).values
    return torch.flip(out, dims=[axis]) if descending else out


@register_op("argsort", differentiable=False)
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(tensor(x), dim=axis, descending=descending,
                      stable=True).indices.to(torch.int64)


@register_op("topk", multi_out=True)
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    x = tensor(x)
    k = int(to_plain(k))
    v, i = torch.sort(x, dim=int(axis), descending=largest, stable=True)
    return v.narrow(int(axis), 0, k), \
        i.narrow(int(axis), 0, k).to(torch.int64)


@register_op("kthvalue", multi_out=True)
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = tensor(x)
    v, i = torch.sort(x, dim=axis, stable=True)
    v, i = v.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i.to(torch.int64)


@register_op("mode", multi_out=True, differentiable=False)
def mode(x, axis=-1, keepdim=False, name=None):
    x = tensor(x)
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    flat = xm.reshape(-1, n)
    srt = torch.sort(flat, dim=-1).values
    change = torch.zeros_like(srt, dtype=torch.long)
    change[:, 1:] = (srt[:, 1:] != srt[:, :-1]).long()
    run_id = torch.cumsum(change, dim=-1)
    counts = torch.zeros_like(run_id).scatter_add_(1, run_id,
                                                   torch.ones_like(run_id))
    best = torch.argmax(counts, dim=-1, keepdim=True)
    first = torch.argmax((run_id == best).long(), dim=-1, keepdim=True)
    val = torch.gather(srt, 1, first)
    last = (n - 1) - torch.argmax((flat == val).flip(-1).long(), dim=-1)
    vals, idxs = val[:, 0].reshape(xm.shape[:-1]), last.reshape(xm.shape[:-1])
    if keepdim:
        vals, idxs = vals.unsqueeze(axis), idxs.unsqueeze(axis)
    return vals, idxs.to(torch.int64)


@register_op("searchsorted", differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss = tensor(sorted_sequence)
    v = tensor(values, ss)
    ss, v = operands(ss, v)
    if ss.ndim > 1:
        v = torch.broadcast_to(v, ss.shape[:-1] + v.shape[-1:]).contiguous()
    out = torch.searchsorted(ss.contiguous(), v, right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


@register_op("bucketize", differentiable=False)
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    x, ss = operands(tensor(x), tensor(sorted_sequence))
    out = torch.searchsorted(ss.contiguous(), x.contiguous(), right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


@register_op("unique", differentiable=False, multi_out=True)
def _unique_all(x, axis=None):
    """(sorted unique values, the index of each one's first occurrence,
    the inverse, the counts), as ``np.unique`` returns them."""
    x = tensor(x)
    vals, inv, counts = torch.unique(x if axis is not None else x.reshape(-1),
                                     sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    n = inv.shape[0]
    pos = torch.arange(n, device=x.device)
    first = torch.full((counts.shape[0],), n, dtype=torch.long,
                       device=x.device).scatter_reduce(
        0, inv, pos, "amin", include_self=True)
    if axis is None:
        inv = inv.reshape(x.shape)
    return vals, first, inv, counts


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    vals, idx, inv, counts = _unique_all(x, axis)
    outs = [vals]
    if return_index:
        outs.append(idx)
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


@register_op("unique_consecutive", differentiable=False, multi_out=True)
def _unique_consecutive_all(x, axis=None):
    if axis is not None:
        raise NotImplementedError("axis!=None unique_consecutive")
    return tuple(torch.unique_consecutive(tensor(x).reshape(-1),
                                          return_inverse=True,
                                          return_counts=True))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    vals, inv, counts = _unique_consecutive_all(x, axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


@register_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    x = tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if not isinstance(repeats, int):
        repeats = tensor(repeats, x).long()
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("as_real")
def as_real(x, name=None):
    x = tensor(x)
    return torch.stack([real.__wrapped__(x), imag.__wrapped__(x)], dim=-1)


@register_op("as_complex")
def as_complex(x, name=None):
    x = tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


@register_op("real")
def real(x, name=None):
    x = tensor(x)
    return torch.real(x) if x.is_complex() else x


@register_op("imag")
def imag(x, name=None):
    x = tensor(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@register_op("conj")
def conj(x, name=None):
    x = tensor(x)
    return torch.conj_physical(x) if x.is_complex() else x


@register_op("numel", differentiable=False)
def numel(x, name=None):
    x = tensor(x)
    return torch.full((), x.numel(), dtype=torch.int64,
                      device=x.device)


def shape(x):
    """``paddle.shape``: the runtime shape as a 1-D int32 tensor."""
    x = to_plain(x)
    return wrap(torch.tensor(list(x.shape), dtype=torch.int32,
                             device=x.device))


@register_op("one_hot", differentiable=False)
def one_hot(x, num_classes, name=None):
    x = tensor(x)
    n = int(to_plain(num_classes))
    return (x[..., None] == torch.arange(n, device=x.device)).to(
        torch.float32)


@register_op("bincount", differentiable=False)
def bincount(x, weights=None, minlength=0, name=None):
    x = tensor(x)
    return torch.bincount(x.long(), weights=None if weights is None else
                          tensor(weights, x), minlength=minlength)


def _bin_edges(x, bins, lo, hi):
    """``jnp.histogram_bin_edges``: ``bins + 1`` edges over [lo, hi] (an
    empty range widened by 0.5 on each side)."""
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, bins + 1, dtype=x.dtype, device=x.device)


@register_op("histogram", differentiable=False)
def histogram(input, bins=100, min=0, max=0, weight=None,  # noqa: A002
              density=False, name=None):
    x = tensor(input).reshape(-1)
    if not x.is_floating_point():
        x = x.to(dtypes.get_default_dtype())
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    edges = _bin_edges(x, int(bins), lo, hi)
    w = torch.ones_like(x) if weight is None else \
        tensor(weight, x, x.dtype).reshape(-1)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    inside = idx <= bins
    counts = torch.zeros(bins + 1, dtype=x.dtype, device=x.device).index_add(
        0, torch.where(inside, idx, torch.zeros_like(idx)),
        torch.where(inside, w, torch.zeros_like(w)))[1:]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts


@register_op("crop")
def crop(x, shape=None, offsets=None, name=None):
    x = tensor(x)
    shp = shape_arg(shape)
    offs = [0] * x.ndim if offsets is None else [int(to_plain(o))
                                                 for o in offsets]
    return x[tuple(builtins.slice(o, o + (s if s != -1 else x.shape[i] - o))
                   for i, (o, s) in enumerate(zip(offs, shp)))]


def slice(input, axes, starts, ends):  # noqa: A001
    """``paddle.slice``: the registered ``getitem`` of basic slices."""
    slices = [builtins.slice(None)] * to_plain(input).ndim
    for ax, s, e in zip(axes, starts, ends):
        slices[int(ax)] = builtins.slice(int(to_plain(s)), int(to_plain(e)))
    return apply(_getitem.opdef, input, tuple(slices))


def strided_slice(x, axes, starts, ends, strides, name=None):
    slices = [builtins.slice(None)] * to_plain(x).ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        slices[int(ax)] = builtins.slice(int(to_plain(s)), int(to_plain(e)),
                                         int(to_plain(st)))
    return apply(_getitem.opdef, x, tuple(slices))


@register_op("tensordot", amp="white")
def tensordot(x, y, axes=2, name=None):
    x, y = operands(x, y)
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and all(
            isinstance(a, int) for a in axes):
        axes = ([axes[0]], [axes[1]])
    return torch.tensordot(x, y, dims=axes)


@register_op("view")
def view(x, shape_or_dtype, name=None):
    x = tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(shape_arg(shape_or_dtype))
    return x.view(dtypes.convert_dtype(shape_or_dtype))


@register_op("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    flat = tensor(x).reshape(-1)
    return torch.as_strided(flat, shape_arg(shape), tuple(stride),
                            offset).clone()


__all__ = [n for n, v in list(globals().items())
           if (hasattr(v, "opdef") or n in (
               "split", "chunk", "unbind", "pad", "broadcast_tensors",
               "broadcast_to", "scatter_nd", "unique", "unique_consecutive",
               "shape", "slice", "strided_slice", "transpose_"))
           and not n.startswith("_")]
