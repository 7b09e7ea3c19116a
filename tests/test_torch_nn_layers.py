"""The port's layer classes of ``nn`` (the rest of ``nn/``) against the
JAX reference, from one table of cases.

Each entry of ``CASES`` names a layer of ``paddle.nn``, its constructor
arguments and its seeded numpy inputs. The reference's layer is built
after ``paddle.seed`` and, where it has parameters or buffers, they are
carried to the port's (``state_dict`` → ``load_numpy``; the keys must be
the reference's). Both run the inputs (the port on the CPU): the outputs
must have the reference's shapes and be within 1e-5 (fp32; integer
outputs equal), and where the layer has parameters the gradients of
``sum(out · w)`` with a seeded ``w`` must be within 1e-5 of the largest
reference gradient. The layers with dropout run in eval mode here (their
masks are held in ``test_torch_nn_functionals.py``). The last tests hold
the names of the reference's namespace that wait for a later item: each
raises naming it.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layer.layers import load_numpy

@pytest.fixture(autouse=True)
def _cpu():
    """The port's layers and ops on the CPU; both places put back."""
    yield from cpu_place()



def R(*shape, seed=0, lo=None, hi=None):
    g = np.random.default_rng(seed)
    if lo is not None:
        return g.uniform(lo, hi, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


X = R(2, 4, 5, seed=1)
X4 = R(2, 8, 4, 4, seed=2)
LAB = np.array([1, 0, 4, 2])


def _c(name, ctor=(), kw=None, inputs=(X,), fn=None):
    return pytest.param(name, list(ctor), kw or {}, list(inputs),
                        id=fn or name)


_ACTS = ["ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
         "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh", "ELU", "CELU",
         "SELU", "GELU", "Silu", "Mish", "Swish", "LeakyReLU", "Softplus",
         "Softshrink", "Softsign", "ThresholdedReLU", "Softmax",
         "LogSoftmax", "RReLU"]

CASES = [_c(n) for n in _ACTS] + [
    _c("GELU", [True], fn="GELU_tanh"), _c("LeakyReLU", [0.3],
                                           fn="LeakyReLU_slope"),
    _c("Maxout", [2], inputs=[X4]), _c("GLU", [1], inputs=[X4]),
    _c("PReLU", [8, 0.1], inputs=[X4]), _c("Softmax2D", inputs=[X4]),
    # losses
    _c("CrossEntropyLoss", kw={"label_smoothing": 0.1},
       inputs=[R(4, 5, seed=3), LAB]),
    _c("MSELoss", inputs=[X, R(2, 4, 5, seed=4)]),
    _c("L1Loss", inputs=[X, R(2, 4, 5, seed=4)]),
    _c("SmoothL1Loss", kw={"delta": 0.5}, inputs=[X, R(2, 4, 5, seed=4)]),
    _c("BCELoss", inputs=[R(4, 3, seed=5, lo=0.1, hi=0.9),
                          (R(4, 3, seed=6) > 0).astype(np.float32)]),
    _c("BCEWithLogitsLoss", inputs=[X, (R(2, 4, 5, seed=6) > 0).astype(
        np.float32)]),
    _c("NLLLoss", inputs=[np.log(R(4, 5, seed=5, lo=0.1, hi=0.9)), LAB]),
    _c("KLDivLoss", ["batchmean"], inputs=[
        np.log(R(4, 3, seed=5, lo=0.1, hi=0.9)), R(4, 3, seed=6, lo=0.1,
                                                  hi=0.9)]),
    _c("MarginRankingLoss", [0.2], inputs=[R(6, seed=1), R(6, seed=2),
                                           np.sign(R(6, seed=3))]),
    _c("CTCLoss", inputs=[R(6, 2, 5, seed=9), np.array([[1, 2, 2],
                                                       [3, 1, 0]]),
                          np.array([6, 5]), np.array([3, 2])]),
    _c("TripletMarginLoss", inputs=[R(4, 5, seed=1), R(4, 5, seed=2),
                                    R(4, 5, seed=3)]),
    _c("CosineEmbeddingLoss", inputs=[R(4, 5, seed=1), R(4, 5, seed=2),
                                      np.array([1, -1, 1, -1])]),
    _c("HingeEmbeddingLoss", inputs=[R(6, seed=1), np.sign(R(6, seed=3))]),
    _c("GaussianNLLLoss", inputs=[X, R(2, 4, 5, seed=5),
                                  R(2, 4, 5, seed=6, lo=0.1, hi=2.0)]),
    _c("PoissonNLLLoss", inputs=[X, R(2, 4, 5, seed=6, lo=0, hi=3)]),
    _c("SoftMarginLoss", inputs=[X, np.sign(R(2, 4, 5, seed=3))]),
    _c("MultiLabelSoftMarginLoss", inputs=[
        R(4, 3, seed=2), (R(4, 3, seed=6) > 0).astype(np.float32)]),
    _c("MultiMarginLoss", inputs=[R(4, 5, seed=2), LAB]),
    _c("TripletMarginWithDistanceLoss", inputs=[
        R(4, 5, seed=1), R(4, 5, seed=2), R(4, 5, seed=3)]),
    _c("RNNTLoss", inputs=[R(2, 4, 3, 5, seed=1), np.array([[1, 2], [3, 0]]),
                           np.array([4, 3]), np.array([2, 1])]),
    _c("HSigmoidLoss", [6, 6], inputs=[R(4, 6, seed=1),
                                       np.array([0, 3, 5, 2])]),
    _c("AdaptiveLogSoftmaxWithLoss", [6, 5, [2, 4]],
       kw={"head_bias": True}, inputs=[R(4, 6, seed=1), LAB]),
    _c("PairwiseDistance", inputs=[R(4, 5, seed=1), R(4, 5, seed=2)]),
    # common
    _c("Identity", inputs=[X]), _c("Flatten", inputs=[X4]),
    _c("Dropout2D", inputs=[X4]), _c("Dropout3D", inputs=[X4[:, None]]),
    _c("AlphaDropout", inputs=[X]), _c("FeatureAlphaDropout", inputs=[X4]),
    _c("Upsample", kw={"scale_factor": 2}, inputs=[X4]),
    _c("UpsamplingNearest2D", kw={"size": [6, 5]}, inputs=[X4]),
    _c("Bilinear", [4, 5, 6], inputs=[R(3, 4, seed=1), R(3, 5, seed=2)]),
    _c("PixelShuffle", [2], inputs=[X4]), _c("PixelUnshuffle", [2],
                                             inputs=[X4]),
    _c("ChannelShuffle", [4], inputs=[X4]),
    _c("Pad1D", [[1, 2]], kw={"mode": "replicate"}, inputs=[X]),
    _c("Pad2D", [[1, 0, 2, 1]], inputs=[X4]),
    _c("Pad3D", [[1, 0, 1, 1, 0, 1]], inputs=[X4[:, None]]),
    _c("ZeroPad1D", [2], inputs=[X]), _c("ZeroPad2D", [[0, 1, 1, 0]],
                                         inputs=[X4]),
    _c("ZeroPad3D", [1], inputs=[X4[:, None]]),
    _c("CosineSimilarity", inputs=[R(4, 5, seed=1), R(4, 5, seed=2)]),
    _c("Unfold", [2], inputs=[X4]), _c("Fold", [[4, 4], 2],
                                       inputs=[R(2, 8, 9, seed=4)]),
    _c("Unflatten", [1, [2, 4]], inputs=[X4]),
    # norms
    _c("InstanceNorm1D", [4], inputs=[X]), _c("InstanceNorm2D", [8],
                                              inputs=[X4]),
    _c("InstanceNorm3D", [1], inputs=[X4[:, None]]),
    _c("GroupNorm", [4, 8], inputs=[X4]),
    _c("LocalResponseNorm", [3], inputs=[X4]),
    _c("RMSNorm", [5], inputs=[X]),
    # pools
    _c("AdaptiveAvgPool3D", [2], inputs=[R(1, 2, 5, 6, 4, seed=1)]),
    _c("AdaptiveMaxPool3D", [[2, 3, 2]], inputs=[R(1, 2, 5, 6, 4, seed=1)]),
    _c("LPPool1D", [2, 3], inputs=[R(2, 3, 9, seed=1)]),
    _c("LPPool2D", [3, 2], inputs=[X4]),
    _c("FractionalMaxPool2D", [3], inputs=[R(1, 2, 7, 7, seed=1)]),
    _c("FractionalMaxPool3D", [2], inputs=[R(1, 2, 5, 5, 5, seed=1)]),
]


def _to(pkg, a):
    if not isinstance(a, np.ndarray):
        return a
    return paddle.to_tensor(a) if pkg is paddle else torch.from_numpy(a)


def _outs(o):
    if isinstance(o, (tuple, list)):
        return [y for x in o for y in _outs(x)]
    return [] if o is None else [o]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@pytest.mark.parametrize("name, ctor, kw, inputs", CASES)
def test_layer(name, ctor, kw, inputs):
    paddle.seed(0)
    jl = getattr(paddle.nn, name)(*ctor, **kw)
    pl = getattr(pt.nn, name)(*ctor, **kw)
    state = {k: _np(v) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(pl.state_dict())
    if state:
        load_numpy(pl, state)
    jl.eval()
    pl.eval()
    jout = _outs(jl(*[_to(paddle, a) for a in inputs]))
    pout = _outs(pl(*[_to(pt, a) for a in inputs]))
    assert len(jout) == len(pout)
    for j, p in zip(jout, pout):
        jv, pv = _np(j), _np(p)
        assert pv.shape == jv.shape
        if np.issubdtype(jv.dtype, np.floating):
            np.testing.assert_allclose(pv, jv, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(pv, jv)
    params = [n for n, _ in pl.named_parameters()]
    if not params:
        return
    jloss = ploss = 0
    for k, (j, p) in enumerate(zip(jout, pout)):
        w = R(*p.shape, seed=60 + k) if p.ndim else np.float32(1.5)
        jloss = jloss + (j * paddle.to_tensor(w)).sum()
        ploss = ploss + (p * torch.from_numpy(np.asarray(w))).sum()
    jloss.backward()
    ploss.backward()
    jp = dict(jl.named_parameters())
    for n, p in pl.named_parameters():
        ref = _np(jp[n].grad)
        tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0,
                                   err_msg=n)


def test_spectral_norm_layer():
    """The layer form divides the weight by its power-iteration estimate
    of the largest singular value. The reference's forward raises
    (``F.normalize`` over axis 1 of a vector); the port normalises the
    vectors over their one axis, and is held to numpy's SVD."""
    w = R(6, 4, seed=3)
    sn = pt.nn.SpectralNorm([6, 4], power_iters=50)
    out = sn(torch.from_numpy(w)).detach().numpy()
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(out, w / sigma, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="out of bounds"):
        paddle.nn.SpectralNorm([6, 4])(paddle.to_tensor(w))


A11_LAYERS = ["AdaptiveAvgPool1D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
              "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool3D",
              "Conv1D", "Conv1DTranspose", "Conv2DTranspose", "Conv3D",
              "Conv3DTranspose"]
A11_FUNCTIONALS = ["adaptive_avg_pool1d", "adaptive_max_pool1d",
                   "adaptive_max_pool2d", "avg_pool1d", "avg_pool2d",
                   "avg_pool3d", "max_pool1d", "max_pool3d", "conv1d",
                   "conv1d_transpose", "conv2d_transpose", "conv3d",
                   "conv3d_transpose"]


@pytest.mark.parametrize("name", A11_LAYERS + ["SyncBatchNorm"])
def test_later_layers_raise_naming_their_item(name):
    item = "A10" if name == "SyncBatchNorm" else "A11"
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        getattr(pt.nn, name)(4, 4, 3)


@pytest.mark.parametrize("name", A11_FUNCTIONALS)
def test_later_functionals_raise_naming_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        getattr(pt.nn.functional, name)(torch.zeros(1, 1, 4))
