"""The port's ``nn.functional`` (the rest of ``nn/``) against the JAX
reference, from one table of cases.

Each entry of ``CASES`` names a functional of ``paddle.nn.functional``,
its seeded numpy arguments, its keyword arguments and which arguments to
differentiate. Both packages run it on the same arguments (the
reference eagerly through its registered ops, the port on the CPU); every
output must have the reference's shape and be within ``atol`` (integer
and bool outputs equal). Then ``sum(out · w)`` with one seeded cotangent
``w`` per float output is back-propagated through both and the
gradients of the marked arguments compared within the same tolerance,
scaled by the largest reference gradient (not for ``label_smooth`` and
the fractional pools, whose reference returns an array off its autograd
tape). The random functionals
(``alpha_dropout``, ``dropout2d`` / ``3d``, ``feature_alpha_dropout``,
``gumbel_softmax``) run with both framework generators seeded alike and
draw the reference's masks and noise.

Tolerances (fp32): 1e-5 by default (the same formula, one f32 rounding
order or another); 1e-4 where a reduction over a window or a
transcendental chain adds up (``ctc_loss``, ``rnnt_loss``, the LP pools,
``poisson_nll_loss``, ``gumbel_softmax``'s log-log noise, whose float32
``log`` differs between the libraries by an ulp).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle

import paddle_tpu_torch as pt

@pytest.fixture(autouse=True)
def _cpu():
    """The port's layers and ops on the CPU; both places put back."""
    yield from cpu_place()



def R(*shape, seed=0, lo=None, hi=None):
    g = np.random.default_rng(seed)
    if lo is not None:
        return g.uniform(lo, hi, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


def L(*shape, high, seed=0, dtype=np.int64):
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


def _unpool_idx(n, c, inp, out):
    g = np.random.default_rng(5)
    return np.stack([np.stack([np.sort(g.choice(out, inp, replace=False))
                               for _ in range(c)]) for _ in range(n)])


def _tree():
    ids = np.array([[[1, 2]], [[3, 4]], [[5, 6]]], np.int64)       # [T,B,k]
    parents = np.array([[[0, 0]], [[1, 0]], [[0, 1]]], np.int64)
    return ids, parents


X = R(2, 4, 5, seed=1)
X4 = R(2, 8, 4, 4, seed=2)
P01 = R(4, 3, seed=3, lo=0.05, hi=0.95)


def _c(name, args, kw=None, grad=(0,), atol=1e-5, seeded=False, fn=None):
    return pytest.param(name, args, kw or {}, grad, atol, seeded,
                        id=fn or name)


CASES = [
    # activations
    _c("relu6", [X * 4]), _c("log_sigmoid", [X]), _c("mish", [X]),
    _c("leaky_relu", [X], {"negative_slope": 0.2}),
    _c("prelu", [X4, R(8, seed=4, lo=0.1, hi=0.3)], grad=(0, 1)),
    _c("elu", [X], {"alpha": 0.5}), _c("celu", [X], {"alpha": 1.5}),
    _c("selu", [X]), _c("hardswish", [X * 3]), _c("hardsigmoid", [X * 3]),
    _c("hardtanh", [X * 2], {"min": -0.5, "max": 0.7}),
    _c("hardshrink", [X]), _c("softshrink", [X], {"threshold": 0.3}),
    _c("tanhshrink", [X]), _c("softsign", [X]),
    _c("thresholded_relu", [X], {"threshold": 0.2}),
    _c("softmax", [X], {"axis": 1}), _c("log_softmax", [X], {"axis": -1}),
    _c("maxout", [X4], {"groups": 2}), _c("glu", [X4], {"axis": 1}),
    _c("rrelu", [X]), _c("swish", [X]), _c("tanh_act", [X]),
    _c("gumbel_softmax", [X], {"temperature": 0.7}, grad=(), atol=1e-4,
       seeded=True),
    _c("gumbel_softmax", [X], {"hard": True}, grad=(), seeded=True,
       fn="gumbel_softmax_hard"),
    # losses
    _c("mse_loss", [X, R(2, 4, 5, seed=5)], grad=(0, 1)),
    _c("l1_loss", [X, R(2, 4, 5, seed=5)], {"reduction": "sum"}),
    _c("smooth_l1_loss", [X, R(2, 4, 5, seed=5)], {"delta": 0.5}),
    _c("nll_loss", [np.log(P01), np.array([0, 2, -100, 1])],
       {"weight": np.array([0.3, 1.0, 2.0], np.float32)}),
    _c("binary_cross_entropy_with_logits",
       [X, (R(2, 4, 5, seed=6) > 0).astype(np.float32)],
       {"pos_weight": R(5, seed=7, lo=0.5, hi=2.0)}),
    _c("kl_div", [np.log(P01), R(4, 3, seed=8, lo=0.1, hi=0.9)],
       {"reduction": "batchmean"}, grad=(0, 1)),
    _c("kl_div", [np.log(P01), np.log(R(4, 3, seed=8, lo=0.1, hi=0.9))],
       {"log_target": True}, grad=(0, 1), fn="kl_div_log_target"),
    _c("margin_ranking_loss", [R(6, seed=1), R(6, seed=2),
                               np.sign(R(6, seed=3))], {"margin": 0.1},
       grad=(0, 1)),
    _c("hinge_embedding_loss", [R(6, seed=1), np.sign(R(6, seed=3))]),
    _c("cosine_embedding_loss", [R(4, 5, seed=1), R(4, 5, seed=2),
                                 np.array([1, -1, 1, -1])],
       {"margin": 0.2}, grad=(0, 1)),
    _c("triplet_margin_loss", [R(4, 5, seed=1), R(4, 5, seed=2),
                               R(4, 5, seed=3)], {"swap": True},
       grad=(0, 1, 2)),
    _c("sigmoid_focal_loss", [X, (R(2, 4, 5, seed=6) > 0).astype(
        np.float32)]),
    _c("square_error_cost", [X, R(2, 4, 5, seed=5)], grad=(0, 1)),
    _c("log_loss", [P01, (R(4, 3, seed=6) > 0).astype(np.float32)]),
    _c("softmax_with_cross_entropy", [R(4, 5, seed=2),
                                      np.array([1, 0, 4, 2])]),
    _c("ctc_loss", [R(6, 2, 5, seed=9), np.array([[1, 2, 2], [3, 1, 0]]),
                    np.array([6, 5]), np.array([3, 2])], atol=1e-4),
    _c("ctc_loss", [R(6, 2, 5, seed=9), np.array([[1, 2, 2], [3, 1, 0]]),
                    np.array([6, 5]), np.array([3, 2])],
       {"reduction": "sum"}, atol=1e-4, fn="ctc_loss_sum"),
    _c("gaussian_nll_loss", [X, R(2, 4, 5, seed=5),
                             R(2, 4, 5, seed=6, lo=0.1, hi=2.0)],
       {"full": True}, grad=(0, 2)),
    _c("poisson_nll_loss", [X, R(2, 4, 5, seed=6, lo=0.0, hi=4.0)],
       {"full": True}, atol=1e-4),
    _c("poisson_nll_loss", [P01, R(4, 3, seed=6, lo=0.0, hi=4.0)],
       {"log_input": False}, atol=1e-4, fn="poisson_nll_loss_linear"),
    _c("soft_margin_loss", [X, np.sign(R(2, 4, 5, seed=3))]),
    _c("multi_label_soft_margin_loss",
       [R(4, 3, seed=2), (R(4, 3, seed=6) > 0).astype(np.float32)],
       {"weight": R(3, seed=7, lo=0.5, hi=1.5)}),
    _c("multi_margin_loss", [R(4, 5, seed=2), np.array([1, 0, 4, 2])],
       {"p": 2, "weight": R(5, seed=8, lo=0.5, hi=1.5)}),
    _c("triplet_margin_with_distance_loss",
       [R(4, 5, seed=1), R(4, 5, seed=2), R(4, 5, seed=3)],
       {"swap": True}, grad=(0, 1, 2)),
    _c("pairwise_distance", [R(4, 5, seed=1), R(4, 5, seed=2)],
       {"p": 3.0, "keepdim": True}, grad=(0, 1)),
    _c("npair_loss", [R(4, 5, seed=1), R(4, 5, seed=2),
                      np.array([0, 1, 0, 2])], grad=(0, 1)),
    _c("dice_loss", [np.exp(R(3, 4, 5, seed=1)) / 3,
                     L(3, 4, 1, high=5, seed=3)]),
    _c("hsigmoid_loss", [R(4, 6, seed=1), np.array([0, 3, 5, 2]), 6,
                         R(5, 6, seed=2), R(5, seed=3)], grad=(0, 3, 4)),
    _c("margin_cross_entropy", [R(4, 5, seed=1, lo=-0.9, hi=0.9),
                                np.array([1, 0, 4, 2])],
       {"return_softmax": True, "scale": 8.0}),
    _c("rnnt_loss", [R(2, 4, 3, 5, seed=1), np.array([[1, 2], [3, 0]]),
                     np.array([4, 3]), np.array([2, 1])], atol=1e-4),
    _c("adaptive_log_softmax_with_loss",
       [R(4, 6, seed=1), np.array([1, 0, 4, 2]), R(6, 5, seed=2),
        R(5, seed=3), None, [2, 4]], grad=(0, 2, 3)),
    # common
    _c("dropout2d", [X4], {"p": 0.4}, seeded=True),
    _c("dropout3d", [R(2, 4, 2, 3, 3, seed=3)], {"p": 0.4}, seeded=True),
    _c("alpha_dropout", [X], {"p": 0.3}, seeded=True),
    _c("feature_alpha_dropout", [X4], {"p": 0.3}, seeded=True),
    _c("interpolate", [X4], {"size": [6, 7]}),
    _c("interpolate", [X4], {"scale_factor": 0.5}, fn="interpolate_down"),
    _c("unfold", [X4, [2, 3]], {"strides": [1, 2], "paddings": [1, 0, 0, 1],
                                "dilations": [1, 1]}),
    _c("fold", [R(2, 8, 9, seed=4), [4, 4], 2], {"strides": 1}),
    _c("bilinear", [R(3, 4, seed=1), R(3, 5, seed=2), R(6, 4, 5, seed=3),
                    R(6, seed=4)], grad=(0, 1, 2, 3)),
    _c("cosine_similarity", [R(4, 5, seed=1), R(4, 5, seed=2)],
       grad=(0, 1)),
    _c("pixel_shuffle", [X4, 2]),
    _c("pixel_shuffle", [R(2, 4, 4, 8, seed=3), 2],
       {"data_format": "NHWC"}, fn="pixel_shuffle_nhwc"),
    _c("pixel_unshuffle", [X4, 2]), _c("channel_shuffle", [X4, 4]),
    _c("label_smooth", [np.eye(4, dtype=np.float32)[[0, 2, 1]]],
       {"epsilon": 0.2}, grad=()),
    _c("normalize", [X], {"p": 3, "axis": 2}),
    _c("zeropad2d", [X4, [1, 0, 2, 1]]),
    _c("pad", [X4, [1, 2, 0, 1]], {"mode": "reflect"}),
    # norms
    _c("instance_norm", [X4], {"weight": R(8, seed=5), "bias": R(8, seed=6)}),
    _c("group_norm", [X4, 4], {"weight": R(8, seed=5),
                               "bias": R(8, seed=6)}),
    _c("group_norm", [R(2, 4, 4, 8, seed=3), 2],
       {"data_format": "NHWC"}, fn="group_norm_nhwc"),
    _c("local_response_norm", [X4, 3]),
    _c("rms_norm", [X, R(5, seed=3)], grad=(0, 1)),
    # pools
    _c("adaptive_avg_pool3d", [R(1, 2, 5, 6, 4, seed=1), [2, 3, 3]]),
    _c("adaptive_max_pool3d", [R(1, 2, 5, 6, 4, seed=1), 2]),
    _c("lp_pool1d", [R(2, 3, 9, seed=1), 2, 3], {"stride": 2,
                                                 "padding": 1}, atol=1e-4),
    _c("lp_pool2d", [X4, 3, 2], atol=1e-4),
    _c("fractional_max_pool2d", [R(1, 2, 7, 7, seed=1), 3], grad=()),
    _c("fractional_max_pool3d", [R(1, 2, 5, 5, 5, seed=1), 2], grad=()),
    _c("max_unpool1d", [R(1, 2, 4, seed=1), _unpool_idx(1, 2, 4, 8), 2]),
    _c("max_unpool2d", [R(1, 2, 3, 3, seed=1), _unpool_idx(1, 2, 9, 36)
                        .reshape(1, 2, 3, 3), 2]),
    _c("max_unpool3d", [R(1, 1, 2, 2, 2, seed=1),
                        _unpool_idx(1, 1, 8, 64).reshape(1, 1, 2, 2, 2), 2]),
    # spatial transforms, sequences
    _c("affine_grid", [R(2, 2, 3, seed=1), [2, 3, 4, 5]], grad=(0,)),
    _c("affine_grid", [R(2, 2, 3, seed=1), [2, 3, 4, 5]],
       {"align_corners": False}, fn="affine_grid_centres"),
    _c("grid_sample", [X4, R(2, 3, 5, 2, seed=2, lo=-1.2, hi=1.2)],
       grad=(0, 1)),
    _c("grid_sample", [X4, R(2, 3, 5, 2, seed=2, lo=-1.2, hi=1.2)],
       {"mode": "nearest", "padding_mode": "border",
        "align_corners": False}, fn="grid_sample_nearest_border"),
    _c("grid_sample", [X4, R(2, 3, 5, 2, seed=2, lo=-1.5, hi=1.5)],
       {"padding_mode": "reflection"}, fn="grid_sample_reflection"),
    _c("temporal_shift", [R(4, 8, 2, 2, seed=1), 2]),
    _c("sequence_mask", [np.array([1, 3, 2])], {"maxlen": 4}, grad=()),
    _c("gather_tree", list(_tree()), grad=()),
    _c("flash_attn_qkvpacked", [R(2, 6, 3, 2, 8, seed=1)]),
    _c("flashmask_attention", [R(2, 6, 2, 8, seed=1), R(2, 6, 2, 8, seed=2),
                               R(2, 6, 2, 8, seed=3)], {"causal": True},
       grad=(0, 1, 2)),
    _c("flash_attention", [R(2, 6, 2, 8, seed=1), R(2, 6, 2, 8, seed=2),
                           R(2, 6, 2, 8, seed=3)], grad=(0, 1, 2)),
]


def _to(pkg, a, grad):
    if not isinstance(a, np.ndarray):
        return a
    if pkg is paddle:
        return paddle.to_tensor(a, stop_gradient=not grad)
    t = torch.from_numpy(a.copy())
    return t.requires_grad_(True) if grad else t


def _outs(o):
    if isinstance(o, (tuple, list)):
        return [y for x in o for y in _outs(x)]
    return [] if o is None else [o]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@pytest.mark.parametrize("name, args, kw, grad, atol, seeded", CASES)
def test_functional(name, args, kw, grad, atol, seeded):
    jargs = [_to(paddle, a, i in grad) for i, a in enumerate(args)]
    pargs = [_to(pt, a, i in grad) for i, a in enumerate(args)]
    jkw = {k: _to(paddle, v, False) for k, v in kw.items()}
    pkw = {k: _to(pt, v, False) for k, v in kw.items()}
    if seeded:
        paddle.seed(17)
        pt.seed(17)
    jout = _outs(getattr(paddle.nn.functional, name)(*jargs, **jkw))
    pout = _outs(getattr(pt.nn.functional, name)(*pargs, **pkw))
    assert len(jout) == len(pout)
    for j, p in zip(jout, pout):
        jv, pv = _np(j), _np(p)
        assert pv.shape == jv.shape
        if np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(pv, jv, atol=atol, rtol=atol)
        else:
            np.testing.assert_array_equal(pv, jv)
    if not grad:
        return
    jl = pl = 0
    for k, (j, p) in enumerate(zip(jout, pout)):
        if not torch.is_floating_point(p) or not p.requires_grad:
            continue
        w = R(*p.shape, seed=50 + k) if p.ndim else np.float32(1.5)
        jl = jl + (j * paddle.to_tensor(w)).sum()
        pl = pl + (p * torch.from_numpy(np.asarray(w))).sum()
    jl.backward()
    pl.backward()
    for i in grad:
        jg, pg = np.asarray(jargs[i].grad.numpy()), pargs[i].grad.numpy()
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(pg, jg, atol=atol * scale, rtol=0,
                                   err_msg=f"gradient of argument {i}")


@pytest.mark.parametrize("name", ["relu_", "tanh_", "softmax_", "elu_",
                                  "hardtanh_", "leaky_relu_",
                                  "thresholded_relu_"])
def test_inplace_activations(name):
    """The in-place form writes the functional's output into x, and
    gradients reach the tensor x was computed from."""
    base = R(3, 4, seed=9)
    jx = paddle.to_tensor(base, stop_gradient=False) * 1.0
    px = torch.from_numpy(base).requires_grad_(True)
    pxc = px * 1.0
    jy = getattr(paddle.nn.functional, name)(jx)
    py = getattr(pt.nn.functional, name)(pxc)
    assert py is pxc
    np.testing.assert_allclose(_np(py), _np(jy), atol=1e-6)
    w = R(3, 4, seed=10)
    (py * torch.from_numpy(w)).sum().backward()
    fn = getattr(pt.nn.functional, name[:-1] if name != "tanh_"
                 else "tanh_act")
    x2 = torch.from_numpy(base).requires_grad_(True)
    (fn(x2) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), x2.grad.numpy(), atol=1e-6)


def test_class_center_sample():
    label = np.array([4, 1, 4, 7])
    jy, jc = paddle.nn.functional.class_center_sample(
        paddle.to_tensor(label), 10, 6)
    py, pc = pt.nn.functional.class_center_sample(torch.from_numpy(label),
                                                  10, 6)
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy.numpy()))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc.numpy()))
    with pytest.raises(NotImplementedError, match="A10"):
        pt.nn.functional.class_center_sample(torch.from_numpy(label), 10,
                                             6, group=object())


def test_flash_attention_entry_points():
    q = torch.from_numpy(R(1, 4, 2, 8, seed=1))
    out, lse = pt.nn.functional.flash_attention(q, q, q)
    assert lse is None and tuple(out.shape) == (1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="unpadded flash"):
        pt.nn.functional.flash_attn_unpadded(q, q, q, None, None, 4, 4)
    with pytest.raises(NotImplementedError, match="sparse-mask"):
        pt.nn.functional.flash_attention.__globals__[
            "flash_attention_with_sparse_mask"]()
    with pytest.raises(NotImplementedError, match="varlen packed"):
        pt.nn.functional.flash_attn_varlen_qkvpacked(q)
    with pytest.raises(NotImplementedError, match="A11"):
        pt.nn.functional.sparse_attention(q, q, q, None, None)
