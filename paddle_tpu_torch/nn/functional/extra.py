"""Long-tail nn functionals.

Counterpart: ``paddle_tpu/nn/functional/extra.py`` (49 functions): the
losses ``gaussian_nll_loss`` … ``adaptive_log_softmax_with_loss``
(:35-290), the 3-D adaptive, LP, fractional and un-pools (:293-439),
``affine_grid``, ``grid_sample`` and ``temporal_shift`` (:442-536),
``sequence_mask``, ``gather_tree`` and ``feature_alpha_dropout``
(:539-582), the attention wrappers (:585-629) and the in-place
activations ``relu_`` … ``thresholded_relu_`` (:632-674). The registered
ops keep the reference's names (``lp_pool_nd``, ``max_unpool_nd``,
``feature_alpha_dropout_raw``, ``margin_cross_entropy`` multi-output,
``sequence_mask`` and ``gather_tree`` not differentiable ...) and each
body is the reference's formula in torch: the fractional pools are the
adaptive bins, ``hsigmoid_loss`` the default complete binary tree (the
labels read on the host, as the reference reads them),
``adaptive_log_softmax_with_loss`` the full softmax over the head,
``class_center_sample`` the deterministic positives-then-lowest-negatives
pick. Two entries wait for later items: ``class_center_sample`` with a
``group`` (ROADMAP A10) and ``sparse_attention`` (the ``sparse``
package, A11).

The in-place activations compute through the registered functional and
copy the result into ``x``'s storage: autograd records the copy, so
gradients flow through the functional as they do through the reference's
rebinding of ``x`` to its output.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import dtype as dtypes
from ...core import generator as gen_mod
from ...core.dispatch import register_op
from ...core.tensor import to_plain
from .sampling import bernoulli

__all__ = [
    "adaptive_avg_pool3d", "adaptive_max_pool3d", "affine_grid",
    "class_center_sample", "dice_loss", "feature_alpha_dropout",
    "fractional_max_pool2d", "fractional_max_pool3d", "gather_tree",
    "gaussian_nll_loss", "grid_sample", "hsigmoid_loss", "lp_pool1d",
    "lp_pool2d", "margin_cross_entropy", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "multi_label_soft_margin_loss", "multi_margin_loss",
    "npair_loss", "pairwise_distance", "poisson_nll_loss", "rnnt_loss",
    "sequence_mask", "soft_margin_loss", "temporal_shift",
    "thresholded_relu_", "triplet_margin_with_distance_loss",
    "adaptive_log_softmax_with_loss", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked", "flashmask_attention",
    "sparse_attention", "relu_", "tanh_", "softmax_", "elu_", "hardtanh_",
    "leaky_relu_",
]

_F = torch.nn.functional


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _one_hot(y, n, dtype):
    return (y[..., None] == torch.arange(n, device=y.device)).to(dtype)


# -- losses ------------------------------------------------------------------

@register_op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,  # noqa: A002
                      reduction="mean", name=None):
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@register_op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    x, y = input, label
    loss = torch.exp(x) - y * x if log_input else x - y * torch.log(
        x + epsilon)
    if full:
        stirling = y * torch.log(y + epsilon) - y + 0.5 * torch.log(
            2 * math.pi * (y + epsilon))
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@register_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    y = label.to(input.dtype)
    return _reduce(torch.log1p(torch.exp(-y * input)), reduction)


@register_op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    y = label.to(input.dtype)
    loss = -(y * _F.logsigmoid(input) + (1 - y) * _F.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


@register_op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    y = label.long()
    n, c = input.shape
    correct = input.gather(1, y[:, None])
    m = torch.clamp_min(margin - correct + input, 0.0) ** p
    if weight is not None:
        m = m * weight[y][:, None]
    mask = _one_hot(y, c, input.dtype) == 0
    return _reduce(torch.where(mask, m, 0.0).sum(-1) / c, reduction)


def _l2_dist(u, v):
    return torch.sqrt(((u - v) ** 2).sum(-1) + 1e-12)


@register_op("triplet_margin_with_distance_loss")
def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or _l2_dist
    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)


@register_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = x - y + epsilon
    return (d.abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


@register_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    y = labels.reshape(-1, 1)
    sim = anchor @ positive.T
    same = (y == y.T).to(anchor.dtype)
    same = same / same.sum(-1, keepdim=True)
    xent = (torch.logsumexp(sim, -1) - (sim * same).sum(-1)).mean()
    reg = l2_reg * ((anchor * anchor).sum(-1)
                    + (positive * positive).sum(-1)).mean() * 0.25
    return xent + reg


@register_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    y = _one_hot(label.squeeze(-1).long(), input.shape[-1], input.dtype)
    red = tuple(range(1, input.ndim))
    inter = (input * y).sum(red)
    union = input.sum(red) + y.sum(red)
    return (1.0 - (2 * inter + epsilon) / (union + epsilon)).mean()


@register_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: leaf
    c sits at node c + num_classes; each step to the root adds the
    logistic loss of the parent's code bit."""
    y = np.asarray(to_plain(label).detach().cpu()).reshape(-1)
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    codes, paths = [], []
    for lbl in y:
        node = int(lbl) + num_classes
        cs, ps = [], []
        while node > 1:
            ps.append(node // 2 - 1)
            cs.append(node % 2)
            node //= 2
        ps, cs = ps[:depth], cs[:depth]
        while len(ps) < depth:
            ps.append(0)
            cs.append(-1)
        paths.append(ps)
        codes.append(cs)
    paths = torch.tensor(paths, device=input.device)
    codes = torch.tensor(codes, device=input.device)
    logits = torch.einsum("nd,nkd->nk", input, weight[paths])
    if bias is not None:
        logits = logits + bias.reshape(-1)[paths]
    target = torch.where(codes > 0, 1.0, 0.0)
    bce = (torch.clamp_min(logits, 0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    return torch.where(codes >= 0, bce, 0.0).sum(-1).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-style margin softmax, the single-group form."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy over a process group is not ported yet "
            "(ROADMAP A10)")
    loss, softmax = _margin_ce(logits, label, margin1, margin2, margin3,
                               scale, return_softmax, reduction)
    return (loss, softmax) if return_softmax else loss


@register_op("margin_cross_entropy", multi_out=True)
def _margin_ce(logits, label, m1, m2, m3, s, return_softmax, reduction):
    theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    target_logit = torch.cos(m1 * theta + m2) - m3
    onehot = _one_hot(label.long(), logits.shape[-1], logits.dtype)
    out = torch.where(onehot > 0, target_logit, logits) * s
    loss = -(torch.log_softmax(out, -1) * onehot).sum(-1)
    return _reduce(loss, reduction), torch.softmax(out, -1)


def class_center_sample(label, num_classes, num_samples, group=None):
    """(the labels remapped to the sampled centers, the sampled centers):
    the batch's classes, then the lowest other classes up to
    ``num_samples``."""
    if group is not None:
        raise NotImplementedError(
            "class_center_sample over a process group is not ported yet "
            "(ROADMAP A10)")
    lab = to_plain(label)
    y = np.asarray(lab.detach().cpu()).reshape(-1)
    pos = np.unique(y)
    need = max(0, num_samples - len(pos))
    neg = np.setdiff1d(np.arange(num_classes), pos)[:need]
    sampled = np.concatenate([pos, neg]).astype(y.dtype)
    remap = {c: i for i, c in enumerate(sampled)}
    y2 = np.asarray([remap[c] for c in y], y.dtype)
    return (torch.from_numpy(y2).to(lab.device),
            torch.from_numpy(sampled).to(lab.device))


@register_op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,  # noqa: A002
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss: the forward variables in log space over [B, T,
    U+1, V] activations (log-softmaxed here) and [B, U] labels."""
    x = torch.log_softmax(input, -1)
    y = label.long()
    b, t_max, u1, _ = x.shape
    blank_lp = x[..., blank]                                # [B, T, U+1]
    lab_lp = x[:, :, :u1 - 1, :].gather(
        -1, y[:, None, :, None].expand(b, t_max, u1 - 1, 1))[..., 0]
    neg_inf = torch.full((b,), -1e30, dtype=x.dtype, device=x.device)
    a = [[None] * u1 for _ in range(t_max)]
    for t in range(t_max):
        for u in range(u1):
            if t == 0 and u == 0:
                a[t][u] = torch.zeros((b,), dtype=x.dtype, device=x.device)
                continue
            below = (a[t - 1][u] + blank_lp[:, t - 1, u] if t > 0
                     else neg_inf)
            left = a[t][u - 1] + lab_lp[:, t, u - 1] if u > 0 else neg_inf
            a[t][u] = torch.logaddexp(below, left)
    alpha = torch.stack([torch.stack(row, -1) for row in a], 1)  # [B,T,U+1]
    bi = torch.arange(b, device=x.device)
    tl = torch.as_tensor(input_lengths, device=x.device).long() - 1
    ul = torch.as_tensor(label_lengths, device=x.device).long()
    loss = -(alpha[bi, tl, ul] + blank_lp[bi, tl, ul])
    return _reduce(loss, reduction)


@register_op("adaptive_log_softmax_with_loss", multi_out=True)
def adaptive_log_softmax_with_loss(input, label, head_weight, head_bias,  # noqa: A002
                                   tail_weights, cutoffs, name=None):
    """(log-probability of each label, its negative mean) from the full
    softmax over the head's logits."""
    logits = input @ head_weight
    if head_bias is not None:
        logits = logits + head_bias
    out = torch.log_softmax(logits, -1).gather(-1, label.long()[:, None])
    out = out[..., 0]
    return out, -out.mean()


# -- pooling -----------------------------------------------------------------

def _adaptive_pool_nd(x, output_size, nd, reduce):
    """Paddle's adaptive bins [floor(i·L/O), ceil((i+1)·L/O)) over the
    last ``nd`` axes."""
    sizes = ([output_size] * nd if isinstance(output_size, int)
             else list(output_size))
    for i, osz in enumerate(sizes):
        axis = 2 + i
        n = x.shape[axis]
        if n % osz == 0:
            x = x.movedim(axis, -1)
            x = reduce(x.reshape(x.shape[:-1] + (osz, n // osz)), -1)
            x = x.movedim(-1, axis)
        else:
            starts = (np.arange(osz) * n) // osz
            ends = ((np.arange(osz) + 1) * n + osz - 1) // osz
            x = torch.stack([reduce(x.narrow(axis, int(s), int(e - s)),
                                    axis)
                             for s, e in zip(starts, ends)], axis)
    return x


def _mean(v, axis):
    return v.mean(axis)


def _max(v, axis):
    return v.amax(axis)


@register_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool_nd(x, output_size, 3, _mean)


@register_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "return_mask for adaptive_max_pool3d is not supported yet")
    return _adaptive_pool_nd(x, output_size, 3, _max)


@register_op("lp_pool_nd")
def _lp_pool(x, norm_type, kernel, stride, pads, channel_last):
    """(Σ over each window of |x|^p)^(1/p), zero-padded."""
    p = float(norm_type)
    nd = len(kernel)
    if channel_last:
        x = x.movedim(-1, 1)
    flat = [q for pp in reversed(pads) for q in (pp, pp)]
    v = _F.pad(x.abs() ** p, flat)
    pool = _F.avg_pool1d if nd == 1 else _F.avg_pool2d
    win = pool(v, tuple(kernel), tuple(stride)) * math.prod(kernel)
    out = win ** (1.0 / p)
    return out.movedim(1, -1) if channel_last else out


def _lp_args(kernel_size, stride, padding, nd):
    k = (kernel_size,) * nd if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    s = stride if stride is not None else k
    s = (s,) * nd if isinstance(s, int) else tuple(s)
    pads = (padding,) * nd if isinstance(padding, int) else tuple(padding)
    return k, s, pads


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    if ceil_mode:
        raise NotImplementedError("ceil_mode is not supported yet")
    k, s, pads = _lp_args(kernel_size, stride, padding, 1)
    return _lp_pool(x, norm_type, k, s, pads, data_format == "NLC")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    if ceil_mode:
        raise NotImplementedError("ceil_mode is not supported yet")
    k, s, pads = _lp_args(kernel_size, stride, padding, 2)
    return _lp_pool(x, norm_type, k, s, pads, data_format == "NHWC")


def fractional_max_pool2d(x, output_size, kernel_size=None,
                          random_u=None, return_mask=False, name=None):
    """Fractional max pooling as adaptive bins (the deterministic limit of
    Graham's random sequences), as the reference computes it."""
    if return_mask:
        raise NotImplementedError("return_mask is not supported yet")
    return _adaptive_pool_nd(x, output_size, 2, _max)


def fractional_max_pool3d(x, output_size, kernel_size=None,
                          random_u=None, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError("return_mask is not supported yet")
    return _adaptive_pool_nd(x, output_size, 3, _max)


@register_op("max_unpool_nd")
def _max_unpool(x, indices, kernel, stride, out_spatial):
    """Each value written at its flat index of the output's spatial
    axes, zeros elsewhere."""
    lead = tuple(x.shape[:2])
    out = torch.zeros(lead + (math.prod(out_spatial),), dtype=x.dtype,
                      device=x.device)
    out = out.scatter(-1, indices.long().reshape(lead + (-1,)),
                      x.reshape(lead + (-1,)))
    return out.reshape(lead + tuple(out_spatial))


def _unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    k = [kernel_size] * nd if isinstance(kernel_size, int) \
        else list(kernel_size)
    s = list(k) if stride is None else (
        [stride] * nd if isinstance(stride, int) else list(stride))
    pads = [padding] * nd if isinstance(padding, int) else list(padding)
    if output_size is None:
        output_size = [(x.shape[2 + i] - 1) * s[i] - 2 * pads[i] + k[i]
                       for i in range(nd)]
    else:
        output_size = list(output_size)[-nd:]
    return _max_unpool(x, indices, tuple(k), tuple(s), tuple(output_size))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3)


# -- spatial transforms ------------------------------------------------------

@register_op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, H, W, 2] sampling grid of the [N, 2, 3] affine maps over
    [-1, 1]² (pixel centres without ``align_corners``)."""
    _, _, h, w = [int(s) for s in out_shape]

    def axis_coords(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=theta.device)
        step = 2.0 / n
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                              device=theta.device)

    gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return torch.einsum("hwk,nck->nhwc", base, theta)


@register_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at ``grid`` [N, Ho, Wo, 2] (x, y in [-1, 1]):
    bilinear or nearest, zeros / border / reflection padding."""
    n, _, h, w = x.shape

    def unnorm(c, size):
        if align_corners:
            return (c + 1.0) / 2.0 * (size - 1)
        return ((c + 1.0) * size - 1.0) / 2.0

    fx = unnorm(grid[..., 0], w)
    fy = unnorm(grid[..., 1], h)
    if padding_mode == "reflection":
        def refl(c, size):
            if align_corners:
                span = max(size - 1, 1)
                c = torch.remainder(c, 2 * span).abs()
                return torch.minimum(c, 2 * span - c)
            c = torch.remainder(c + 0.5, 2 * size).abs()
            return torch.minimum(c, 2 * size - c) - 0.5

        fx, fy = refl(fx, w), refl(fy, h)
    elif padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        out = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            out = out * inb[..., None]
        return out                                    # [N, Ho, Wo, C]

    if mode == "nearest":
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0 = torch.floor(fx).long()
        y0 = torch.floor(fy).long()
        wx, wy = fx - x0, fy - y0
        out = (sample(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + sample(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + sample(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + sample(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.movedim(-1, 1)


@register_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    v = x.movedim(-1, 1) if data_format == "NHWC" else x
    nt, c, h, w = v.shape
    v = v.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.roll(v[:, :, :fold], -1, 1).clone()
    left[:, -1] = 0.0
    right = torch.roll(v[:, :, fold:2 * fold], 1, 1).clone()
    right[:, 0] = 0.0
    out = torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(nt, c, h,
                                                                  w)
    return out.movedim(1, -1) if data_format == "NHWC" else out


# -- seq2seq utilities -------------------------------------------------------

@register_op("sequence_mask", differentiable=False)
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    m = int(maxlen) if maxlen is not None else int(x.max())
    return (torch.arange(m, device=x.device)[None, :] < x[..., None]).to(
        dtypes.convert_dtype(dtype))


@register_op("gather_tree", differentiable=False)
def gather_tree(ids, parents, name=None):
    """Back-trace beam-search parents; ids / parents [T, B, beam]."""
    t_max, b, k = ids.shape
    out = torch.zeros_like(ids)
    beam = torch.arange(k, device=ids.device).expand(b, k)
    out[t_max - 1] = ids[t_max - 1]
    for t in range(t_max - 2, -1, -1):
        beam = parents[t + 1].gather(-1, beam)
        out[t] = ids[t].gather(-1, beam)
    return out


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channels (SELU-preserving statistics)."""
    if not training or p == 0.0:
        return x
    return _feature_alpha(x, p, gen_mod.default_generator.split_key())


@register_op("feature_alpha_dropout_raw")
def _feature_alpha(x, p, key):
    alpha = -1.7580993408473766
    keep = 1.0 - p
    shape = tuple(x.shape[:2]) + (1,) * (x.ndim - 2)
    mask = bernoulli(torch.tensor(key, dtype=torch.int64, device=x.device),
                     keep, shape)
    a = (keep + alpha ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha * (1 - keep)
    return a * torch.where(mask, x, torch.full_like(x, alpha)) + b


# -- attention wrappers ------------------------------------------------------

def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         name=None):
    """qkv packed [B, S, 3, H, D] → (attention out, None)."""
    from .attention import scaled_dot_product_attention
    out = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                       qkv[:, :, 2], dropout_p=dropout,
                                       is_causal=causal)
    return out, None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q=None, cu_seqlens_k=None,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                name=None, **kw):
    raise NotImplementedError(
        "varlen packed attention is not supported: pad to the dense "
        "[B, S, 3, H, D] layout and call flash_attn_qkvpacked")


def flashmask_attention(query, key, value, startend_row_indices=None,
                        causal=False, name=None, **kw):
    if startend_row_indices is not None:
        raise NotImplementedError(
            "flashmask startend_row_indices is not supported yet; build an "
            "additive attn_mask and use scaled_dot_product_attention")
    from .attention import scaled_dot_product_attention
    return scaled_dot_product_attention(query, key, value, is_causal=causal)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    raise NotImplementedError(
        "sparse_attention runs on the sparse package, not ported yet "
        "(ROADMAP A11)")


# -- in-place activations ----------------------------------------------------

def _inplace(x, out):
    """Copy ``out`` into ``x``'s storage; returns ``x``."""
    xp, op = to_plain(x), to_plain(out)
    if xp.requires_grad or op.requires_grad:
        xp.copy_(op)
    else:
        with torch.no_grad():
            xp.copy_(op)
    return x


def relu_(x, name=None):
    from .activation import relu
    return _inplace(x, relu(x))


def tanh_(x, name=None):
    from ...ops import tanh
    return _inplace(x, tanh(x))


def softmax_(x, axis=-1, dtype=None, name=None):
    from .activation import softmax
    return _inplace(x, softmax(x, axis=axis))


def elu_(x, alpha=1.0, name=None):
    from .activation import elu
    return _inplace(x, elu(x, alpha))


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    from .activation import hardtanh
    return _inplace(x, hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    from .activation import leaky_relu
    return _inplace(x, leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, name=None):
    from .activation import thresholded_relu
    return _inplace(x, thresholded_relu(x, threshold))
