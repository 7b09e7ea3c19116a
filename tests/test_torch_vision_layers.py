"""The port's vision functionals and layers against the JAX reference:
``conv2d``, ``max_pool2d``, ``adaptive_avg_pool2d``, ``linear``,
``relu``, ``cross_entropy`` and the layers and initialisers over them.

The same numpy inputs go through both packages in fp32. Tolerances:
conv2d and linear atol 1e-5 / rtol 1e-5 (the same products summed in
other orders); the pools and relu exactly (a max and a mean of the same
values: rtol 1e-6 for the mean); cross_entropy atol 1e-6 / rtol 1e-5 (f32
log-softmax). The initialisers' distributions are checked by their
moments: their values differ from the reference's by design (another
generator).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn import initializer as pinit


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _both(fn_j, fn_p, *arrays, **kw):
    jout = fn_j(*[paddle.to_tensor(a) for a in arrays], **kw)
    pout = fn_p(*[torch.from_numpy(a) for a in arrays], **kw)
    return np.asarray(pout.detach().numpy()), np.asarray(jout.numpy())


CONV_CASES = [
    # x shape, w shape, stride, padding, dilation, groups
    ((2, 3, 17, 15), (8, 3, 7, 7), 2, 3, 1, 1),        # the stem
    ((2, 8, 9, 9), (8, 8, 3, 3), 1, 1, 1, 1),
    ((2, 8, 9, 9), (16, 8, 1, 1), 2, 0, 1, 1),         # a downsample
    ((2, 8, 10, 11), (8, 2, 3, 3), 1, 1, 1, 4),        # grouped (ResNeXt)
    ((2, 4, 12, 12), (6, 4, 3, 3), 2, "SAME", 1, 1),
    ((2, 4, 12, 13), (6, 4, 4, 2), 3, "same", 1, 1),
    ((2, 4, 12, 12), (6, 4, 3, 3), 1, "VALID", 2, 1),
    ((2, 4, 10, 10), (6, 4, 3, 3), 1, [1, 2], 1, 1),
    ((2, 4, 10, 10), (6, 4, 3, 3), 1, [0, 1, 2, 1], 1, 1),   # asymmetric
    ((2, 4, 10, 10), (6, 4, 3, 3), (2, 1), [[1, 0], [2, 1]], (1, 2), 1),
    ((2, 4, 10, 10), (6, 4, 3, 3), 1, [-1, 1, 1, 1], 1, 1),  # a crop
]


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"c{i}" for i in range(len(CONV_CASES))])
def test_conv2d_matches_reference(case, with_bias):
    xs, ws, stride, padding, dilation, groups = case
    x, w = _rand(xs, 1), _rand(ws, 2, 0.2)
    args = (x, w) + ((_rand(ws[:1], 3),) if with_bias else ())
    got, ref = _both(JF.conv2d, PF.conv2d, *args, stride=stride,
                     padding=padding, dilation=dilation, groups=groups)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_conv2d_gradients_match_reference():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.dispatch import unwrap
    x, w, g = _rand((2, 4, 9, 9), 4), _rand((6, 4, 3, 3), 5, 0.3), None

    def jfn(x, w):
        return unwrap(JF.conv2d(x, w, stride=2, padding=[0, 1, 1, 0]))

    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    g = _rand(jout.shape, 6)
    jdx, jdw = vjp(jnp.asarray(g))
    px, pw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    PF.conv2d(px, pw, stride=2, padding=[0, 1, 1, 0]).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)


def test_conv2d_channels_last_raises_naming_a11():
    with pytest.raises(NotImplementedError, match="A11"):
        PF.conv2d(torch.zeros(1, 4, 4, 3), torch.zeros(2, 3, 1, 1),
                  data_format="NHWC")


POOL_CASES = [
    ((2, 4, 16, 16), 3, 2, 1),              # resnet's stem pool
    ((2, 4, 15, 13), 3, 2, 1),
    ((2, 4, 9, 9), 2, None, 0),
    ((2, 4, 9, 10), (3, 2), (2, 1), [1, 0]),
    ((2, 4, 9, 10), 3, 2, [0, 1, 1, 2]),     # asymmetric
    ((2, 4, 8, 8), 2, 2, 2),                 # wider than half the window
]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[f"p{i}" for i in range(len(POOL_CASES))])
def test_max_pool2d_matches_reference(case):
    xs, k, s, p = case
    got, ref = _both(JF.max_pool2d, PF.max_pool2d, _rand(xs, 7),
                     kernel_size=k, stride=s, padding=p)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,pads", [("SAME", [1, 1, 0, 1]),
                                       ("valid", 0)])
def test_max_pool2d_string_padding_is_xla_s(name, pads):
    """'SAME' / 'VALID' as XLA's reduce_window reckons them (the
    reference's own max_pool2d fails on a string padding): k=3, s=2 over
    9 x 10 pads (1, 1) and (0, 1), or nothing."""
    x = _rand((2, 4, 9, 10), 15)
    got = PF.max_pool2d(torch.from_numpy(x), 3, 2, name).numpy()
    ref = np.asarray(JF.max_pool2d(paddle.to_tensor(x), 3, 2, pads).numpy())
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw,match", [
    (dict(return_mask=True), "A11"), (dict(data_format="NHWC"), "A11"),
    (dict(ceil_mode=True), "A11")])
def test_max_pool2d_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        PF.max_pool2d(torch.zeros(1, 2, 4, 4), 2, **kw)


@pytest.mark.parametrize("xs,out,fmt", [
    ((2, 8, 7, 7), (1, 1), "NCHW"), ((2, 8, 7, 7), 1, "NCHW"),
    ((2, 8, 14, 14), 7, "NCHW"), ((2, 8, 7, 9), (3, 4), "NCHW"),
    ((2, 8, 7, 9), (None, 4), "NCHW"), ((2, 7, 9, 8), (3, 2), "NHWC")])
def test_adaptive_avg_pool2d_matches_reference(xs, out, fmt):
    got, ref = _both(JF.adaptive_avg_pool2d, PF.adaptive_avg_pool2d,
                     _rand(xs, 8), output_size=out, data_format=fmt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_linear_and_relu_match_reference(with_bias):
    x, w = _rand((3, 5, 16), 9), _rand((16, 7), 10)
    args = (x, w) + ((_rand((7,), 11),) if with_bias else ())
    got, ref = _both(JF.linear, PF.linear, *args)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    got, ref = _both(JF.relu, PF.relu, x)
    np.testing.assert_array_equal(got, ref)


XENT_CASES = {
    "hard_B": dict(label=(6,)),
    "hard_B1": dict(label=(6, 1)),
    "ignore": dict(label=(6,), ignore_index=2),
    "weight": dict(label=(6,), weight=True),
    "weight_ignore": dict(label=(6, 1), weight=True, ignore_index=1),
    "sum": dict(label=(6,), reduction="sum"),
    "none": dict(label=(6,), reduction="none"),
    "smooth": dict(label=(6,), label_smoothing=0.1),
    "smooth_weight": dict(label=(6,), label_smoothing=0.2, weight=True),
    "soft": dict(soft=True),
    "soft_smooth": dict(soft=True, label_smoothing=0.1),
    "soft_by_shape": dict(soft=True, by_shape=True),
    "probs": dict(label=(6,), use_softmax=False),
    "axis0": dict(label=(5,), axis=0),
}


@pytest.mark.parametrize("name", list(XENT_CASES))
def test_cross_entropy_matches_reference(name):
    case = dict(XENT_CASES[name])
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    kw = {k: case.pop(k) for k in ("ignore_index", "reduction",
                                   "label_smoothing", "use_softmax", "axis")
          if k in case}
    if not kw.get("use_softmax", True):
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    if case.get("soft"):
        soft = rng.random((6, 5)).astype(np.float32)
        label = soft / soft.sum(-1, keepdims=True)
        if not case.get("by_shape"):
            kw["soft_label"] = True
    else:
        label = rng.integers(0, 5, case["label"]).astype(np.int64)
        if kw.get("axis") == 0:
            label = rng.integers(0, 6, case["label"]).astype(np.int64)
        label.reshape(-1)[0] = kw.get("ignore_index", label.reshape(-1)[0])
    jw = pw = None
    if case.get("weight"):
        w = rng.random(5).astype(np.float32) + 0.5
        jw, pw = paddle.to_tensor(w), torch.from_numpy(w)
    ref = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(label),
                           weight=jw, **kw)
    got = PF.cross_entropy(torch.from_numpy(logits).requires_grad_(True),
                           torch.from_numpy(label), weight=pw, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref.numpy()),
                               atol=1e-6, rtol=1e-5)


def test_cross_entropy_of_bf16_logits_runs_in_f32():
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 10, (4, 1)))
    lo = PF.cross_entropy(logits.bfloat16(), label)
    assert lo.dtype == torch.float32
    np.testing.assert_allclose(
        lo.item(), PF.cross_entropy(logits.bfloat16().float(), label).item(),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the layers and initialisers
# ---------------------------------------------------------------------------

def test_layers_keep_the_reference_shapes_and_names():
    pairs = [(jnn.Conv2D(4, 8, 3, padding=1), pnn.Conv2D(4, 8, 3, padding=1,
                                                          device="cpu")),
             (jnn.Conv2D(4, 8, 3, bias_attr=False, groups=2),
              pnn.Conv2D(4, 8, 3, bias_attr=False, groups=2, device="cpu")),
             (jnn.Linear(6, 3), pnn.Linear(6, 3, device="cpu")),
             (jnn.Linear(6, 3, bias_attr=False),
              pnn.Linear(6, 3, bias_attr=False, device="cpu"))]
    for jl, pl in pairs:
        want = {k: tuple(v.shape) for k, v in jl.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in pl.state_dict().items()} == want


def test_layers_compute_their_functionals():
    x = _rand((2, 4, 9, 9), 14)
    conv = pnn.Conv2D(4, 6, 3, stride=2, padding=[1, 0, 0, 1], device="cpu")
    jconv = jnn.Conv2D(4, 6, 3, stride=2, padding=[1, 0, 0, 1])
    jconv.weight._set_value(conv.weight.detach().numpy())
    jconv.bias._set_value(conv.bias.detach().numpy())
    np.testing.assert_allclose(
        conv(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jconv(paddle.to_tensor(x)).numpy()), atol=1e-5, rtol=1e-5)
    for jl, pl in ((jnn.MaxPool2D(3, 2, 1), pnn.MaxPool2D(3, 2, 1)),
                   (jnn.AdaptiveAvgPool2D((1, 1)),
                    pnn.AdaptiveAvgPool2D((1, 1))),
                   (jnn.ReLU(), pnn.ReLU())):
        np.testing.assert_allclose(pl(torch.from_numpy(x)).numpy(),
                                   np.asarray(jl(paddle.to_tensor(x)).numpy()),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fan_in", [None, 27])
def test_initialisers_draw_the_reference_distributions(fan_in):
    g = torch.Generator().manual_seed(0)
    w = torch.empty(256, 64, 3, 3)
    fi = 64 * 9 if fan_in is None else fan_in
    limit = (2.0 ** 0.5) * (3.0 / fi) ** 0.5
    pinit.kaiming_uniform(w, fan_in=fan_in, generator=g)
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / 3 ** 0.5) < 0.01 * limit
    lin = torch.empty(512, 256)
    pinit.xavier_normal(lin, generator=g)
    std = (2.0 / (512 + 256)) ** 0.5
    assert abs(float(lin.std()) - std) < 0.01 * std
    assert abs(float(lin.mean())) < 0.01 * std
    u = pinit.uniform(torch.empty(10000), -0.25, 0.25, generator=g)
    assert float(u.min()) >= -0.25 and float(u.max()) <= 0.25
    assert float(pinit.constant(torch.empty(3), 2.5).sum()) == 7.5
    conv = pnn.Conv2D(16, 8, 3, device="cpu", generator=g)
    bound = 1.0 / (16 * 9) ** 0.5
    assert float(conv.bias.abs().max()) <= bound
    lin = pnn.Linear(8, 4, device="cpu", generator=g)
    assert float(lin.bias.abs().max()) == 0.0
