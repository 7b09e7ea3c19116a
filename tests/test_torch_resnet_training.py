"""The port's ResNet (vision/models/resnet.py) and Momentum against the
JAX reference.

The reference's ``resnet50(num_classes=10)`` is carried across through
numpy (``state_dict`` → ``load_numpy``: every parameter and the BatchNorm
buffers), and one seeded batch (B=4, 3×64×64, labels [B, 1]) goes through
both packages in fp32 with ``FLAGS_fused_norm`` off (the dense BatchNorm
in both) and on (the reference's BN kernels in interpret mode,
``FLAGS_fused_norm_interpret``; the port's fused route, the kernels' plain
versions on the CPU). All flags are restored afterwards. The reference's
whole model takes ~12 s to build and, on one worker, ~13 s (dense) and
~22 s (interpret mode) for a forward and backward at this size, so the
whole model is held on both routes; one BottleneckBlock with a downsample
and one without are held as well, at the tight tolerances.

Tolerances:
- one BottleneckBlock (fp32): output atol 1e-5 / rtol 1e-4; every
  gradient leaf, and the input's gradient, within 1e-4 of its largest
  entry; running statistics rtol 1e-5 / atol 1e-6;
- the whole model: at initialisation and this batch the network amplifies
  rounding many times over. The two packages' dense routes agree to
  3.5e-7 after the stem and drift to 1.8e-4 after layer 4; the port in
  f32 lies up to 0.2 from itself in f64 on a gradient leaf (relative to
  the leaf's largest entry). So no two f32 implementations agree leaf by
  leaf to 1e-4 here, and each reading against the reference is held to
  at most 3x the port's own f32-against-f64 reading on the same weights
  and batch (the dense route in f64): the logits (largest difference),
  the loss, the gradients of all leaves as one vector (relative L2), and
  the running statistics (largest relative difference per buffer);
- eval-mode logits: atol 1e-5 / rtol 1e-4 of each other;
- three Momentum steps fed the same gradients: atol 1e-7 / rtol 1e-6.
"""
import copy
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels
from paddle_tpu_torch.vision.models import resnet as presnet

B, HW, CLASSES = 4, 64, 10
FACTOR = 3.0


def _set_fused(on):
    paddle.set_flags({"FLAGS_fused_norm": on,
                      "FLAGS_fused_norm_interpret": on})
    pt_set_flags({"FLAGS_fused_norm": on})


@pytest.fixture(scope="module", autouse=True)
def flags():
    old = (jax_get_flag("fused_norm"), jax_get_flag("fused_norm_interpret"),
           pt_get_flag("fused_norm"))
    try:
        yield
    finally:
        paddle.set_flags({"FLAGS_fused_norm": old[0],
                          "FLAGS_fused_norm_interpret": old[1]})
        pt_set_flags({"FLAGS_fused_norm": old[2]})


def _numpy(t):
    return np.asarray(t.numpy(), np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 3, HW, HW)).astype(np.float32),
            rng.integers(0, CLASSES, (B, 1)).astype(np.int64))


@pytest.fixture(scope="module")
def reference():
    """The reference's resnet50(num_classes=10), built once, and its
    initial state dict as numpy."""
    paddle.seed(0)
    jnet = jresnet.resnet50(num_classes=CLASSES)
    return jnet, {k: _numpy(v) for k, v in jnet.state_dict().items()}


def _reset(jnet, state):
    jnet.set_state_dict(state)
    jnet.clear_gradients()
    jnet.train()


def _port(state, dtype=torch.float32):
    return pmodels.resnet50(num_classes=CLASSES, device="cpu",
                            dtype=dtype).load_numpy(state)


def _port_run(state, x, y, dtype=torch.float32):
    """The port's logits, loss, gradients (name → array) and buffers after
    one train-mode forward and backward."""
    net = _port(state, dtype)
    logits = net(torch.from_numpy(x).to(dtype))
    loss = PF.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return (logits.detach().double().numpy(), loss.item(),
            {n: p.grad.double().numpy() for n, p in net.named_parameters()},
            {n: b.double().numpy() for n, b in net.named_buffers()})


def _rel_l2(a, b, names):
    fa = np.concatenate([a[n].ravel() for n in names])
    fb = np.concatenate([b[n].ravel() for n in names])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def _worst_stat(a, b):
    return max(float(np.abs(a[n] - b[n]).max() / np.abs(b[n]).max())
               for n in b)


# ---------------------------------------------------------------------------
# the model's parameters
# ---------------------------------------------------------------------------

def test_state_dict_keys_equal_the_reference(reference):
    jnet, state = reference
    net = _port(state)
    want = {k: v.shape for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    assert len(got) == 267
    for key in ("conv1.weight", "bn1._mean", "layer1.0.downsample.1._variance",
                "layer4.2.bn3.bias"):
        assert key in got
    assert got["fc.weight"] == (2048, CLASSES)


def test_load_numpy_carries_every_parameter_and_buffer(reference):
    _, state = reference
    moved = {k: v + 0.5 for k, v in state.items()}
    net = _port(moved)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), moved[k])
    with pytest.raises(KeyError, match="missing"):
        net.load_numpy({k: v for k, v in state.items() if k != "bn1._mean"})


def test_init_follows_the_reference_distributions():
    """Conv weights KaimingUniform(fan_in), fc XavierNormal with a zero
    bias, BN gains 1 and shifts 0, buffers 0 and 1; one seed, one model."""
    net = pmodels.resnet50(device="cpu", seed=3)
    again = pmodels.resnet50(device="cpu", seed=3)
    for (n, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    w = net.layer2[0].conv2.weight.detach()     # [128, 128, 3, 3]
    limit = (2.0 ** 0.5) * (3.0 / (128 * 9)) ** 0.5
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / 3 ** 0.5) < 0.02 * limit
    fc_std = (2.0 / (2048 + 1000)) ** 0.5    # fc.weight [2048, 1000]
    assert abs(float(net.fc.weight.std()) - fc_std) < 0.01 * fc_std
    assert float(net.fc.bias.abs().max()) == 0.0
    bn = net.layer1[0].bn1
    assert bool((bn.weight == 1).all()) and bool((bn.bias == 0).all())
    assert bool((bn._mean == 0).all()) and bool((bn._variance == 1).all())


# ---------------------------------------------------------------------------
# one BottleneckBlock, tight
# ---------------------------------------------------------------------------

def _blocks(stride, inplanes, seed):
    paddle.seed(seed)
    jds = pds = None
    if stride != 1 or inplanes != 64:
        jds = jnn.Sequential(jnn.Conv2D(inplanes, 64, 1, stride=stride,
                                        bias_attr=False), jnn.BatchNorm2D(64))
        pds = torch.nn.Sequential(
            pnn.Conv2D(inplanes, 64, 1, stride=stride, bias_attr=False,
                       device="cpu"), pnn.BatchNorm2D(64, device="cpu"))
    jblk = jresnet.BottleneckBlock(inplanes, 16, stride, jds)
    pblk = presnet.BottleneckBlock(inplanes, 16, stride, pds, device="cpu")
    state = {k: _numpy(v) for k, v in jblk.state_dict().items()}
    mine = {**dict(pblk.named_parameters()), **dict(pblk.named_buffers())}
    assert set(mine) == set(state)
    with torch.no_grad():
        for k, t in mine.items():
            t.copy_(torch.from_numpy(state[k]))
    return jblk, pblk


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("stride,inplanes", [(2, 32), (1, 64)],
                         ids=["downsample", "identity"])
def test_bottleneck_block_matches_reference(stride, inplanes, fused):
    _set_fused(fused)
    try:
        jblk, pblk = _blocks(stride, inplanes, 7)
        rng = np.random.default_rng(8)
        x = rng.normal(size=(4, inplanes, 8, 8)).astype(np.float32)
        gy = rng.normal(size=(4, 64, 8 // stride, 8 // stride)).astype(
            np.float32)
        jx = paddle.to_tensor(x)
        jx.stop_gradient = False
        jy = jblk(jx)
        (jy * paddle.to_tensor(gy)).sum().backward()
        px = torch.from_numpy(x).requires_grad_(True)
        py = pblk(px)
        (py * torch.from_numpy(gy)).sum().backward()
        assert (jnorm.last_norm_path(), PF.last_norm_path()) == (
            ("fused_bn/interpret", "fused_bn/plain") if fused
            else ("dense", "dense"))
    finally:
        _set_fused(False)
    np.testing.assert_allclose(py.detach().numpy(), _numpy(jy), rtol=1e-4,
                               atol=1e-5)
    jgrads = {n: _numpy(p.grad) for n, p in jblk.named_parameters()}
    jgrads["input"] = _numpy(jx.grad)
    pgrads = {n: p.grad.numpy() for n, p in pblk.named_parameters()}
    pgrads["input"] = px.grad.numpy()
    assert set(pgrads) == set(jgrads)
    for name, ref in jgrads.items():
        err = float(np.abs(pgrads[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (name, err)
    for name, buf in pblk.named_buffers():
        np.testing.assert_allclose(buf.numpy(), _numpy(
            dict(jblk.named_buffers())[name]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_f64(reference):
    """The port's dense route in f64 on the reference's weights: the yard
    against which each f32 reading is measured."""
    _, state = reference
    x, y = _batch(1)
    pt_set_flags({"FLAGS_fused_norm": False})
    return _port_run(state, x, y, torch.float64)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_whole_model_matches_reference(fused, reference, port_f64):
    jnet, state = reference
    x, y = _batch(1)
    _reset(jnet, state)
    _set_fused(fused)
    try:
        jlogits = jnet(paddle.to_tensor(x))
        jloss = JF.cross_entropy(jlogits, paddle.to_tensor(y))
        jloss.backward()
        jpath = jnorm.last_norm_path()
        before = dict(pnf.launches)
        logits, loss, grads, bufs = _port_run(state, x, y)
        ppath = PF.last_norm_path()
        assert pnf.launches == before       # CPU: no kernel launches
        pt_set_flags({"FLAGS_fused_norm": False})
        logits32, loss32, grads32, bufs32 = _port_run(state, x, y)
    finally:
        _set_fused(False)
    assert (jpath, ppath) == (("fused_bn/interpret", "fused_bn/plain")
                              if fused else ("dense", "dense"))
    logits64, loss64, grads64, bufs64 = port_f64
    np.testing.assert_allclose(loss, float(jloss.numpy()), atol=1e-5,
                               rtol=1e-4)
    jgrads = {n: _numpy(p.grad) for n, p in jnet.named_parameters()}
    jbufs = {n: _numpy(b) for n, b in jnet.named_buffers()}
    assert set(jgrads) == set(grads) and set(jbufs) == set(bufs)
    names = sorted(grads)
    readings = {
        "logits": (float(np.abs(logits - _numpy(jlogits)).max()),
                   float(np.abs(logits32 - logits64).max())),
        "grads": (_rel_l2(grads, jgrads, names),
                  _rel_l2(grads32, grads64, names)),
        "running_stats": (_worst_stat(bufs, jbufs),
                          _worst_stat(bufs32, bufs64)),
    }
    for key, (got, floor) in readings.items():
        assert got <= FACTOR * floor + 1e-6, (key, got, floor)
    for n in names:
        assert np.isfinite(grads[n]).all(), n


def test_eval_logits_match_reference(reference):
    jnet, state = reference
    x, _ = _batch(2)
    _reset(jnet, state)
    jnet.eval()
    jlogits = _numpy(jnet(paddle.to_tensor(x)))
    net = _port(state).eval()
    before = dict(pnf.launches)
    logits = net(torch.from_numpy(x)).detach().numpy()
    assert pnf.launches == before and PF.last_norm_path() == "dense"
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(use_nesterov=True),
                                dict(weight_decay=1e-4, rescale_grad=0.5)],
                         ids=["plain", "nesterov", "l2_rescale"])
def test_three_momentum_steps_match_reference(kw, reference):
    """The same weights and the same three gradients into both packages'
    Momentum(0.1, momentum=0.9): the parameters after each step."""
    jnet, state = reference
    _reset(jnet, state)
    net = _port(state)
    jparams = list(jnet.parameters())
    pparams = list(net.parameters())
    jopt = paddle.optimizer.Momentum(0.1, momentum=0.9, parameters=jparams,
                                     **kw)
    popt_ = popt.Momentum(0.1, momentum=0.9, parameters=pparams, **kw)
    rng = np.random.default_rng(9)
    import jax.numpy as jnp
    for _ in range(3):
        for jp, pp in zip(jparams, pparams):
            g = rng.normal(size=tuple(pp.shape)).astype(np.float32) * 1e-2
            jp.grad = jnp.asarray(g)
            pp.grad = torch.from_numpy(g)
        jopt.step()
        popt_.step()
        jopt.clear_grad()
        popt_.clear_grad()
        for jp, pp in zip(jparams, pparams):
            np.testing.assert_allclose(pp.detach().numpy(), _numpy(jp),
                                       rtol=1e-6, atol=1e-7)
    _reset(jnet, state)


def test_sgd_matches_reference():
    rng = np.random.default_rng(10)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    jp = paddle.create_parameter(
        [5, 3], "float32", default_initializer=jnn.initializer.Assign(w0))
    pp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jopt = paddle.optimizer.SGD(0.05, parameters=[jp], weight_decay=0.01)
    popt_ = popt.SGD(0.05, parameters=[pp], weight_decay=0.01)
    import jax.numpy as jnp
    for _ in range(3):
        g = rng.normal(size=(5, 3)).astype(np.float32)
        jp.grad = jnp.asarray(g)
        pp.grad = torch.from_numpy(g)
        jopt.step()
        popt_.step()
    np.testing.assert_allclose(pp.detach().numpy(), _numpy(jp), rtol=1e-6,
                               atol=1e-7)


def test_momentum_loop_trains_the_port():
    """The user's loop on the port (tests/test_vision_hapi.py:32-42):
    resnet18 on one fixed batch, Momentum(0.1, momentum=0.9), three steps;
    the fused route (the flag's default); the loss falls."""
    pt_set_flags({"FLAGS_fused_norm": True})
    net = pmodels.resnet18(num_classes=CLASSES, device="cpu", seed=0)
    opt = popt.Momentum(0.01, parameters=net.parameters(), momentum=0.9)
    x, y = (torch.from_numpy(a) for a in _batch(3))
    losses = []
    for _ in range(3):
        loss = PF.cross_entropy(net(x).float(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert PF.last_norm_path() == "fused_bn/plain"
    assert all(p.grad is None for p in net.parameters())
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------

def test_pretrained_raises_the_reference_error():
    with pytest.raises(NotImplementedError) as jerr:
        jresnet.resnet18(pretrained=True)
    with pytest.raises(NotImplementedError) as perr:
        pmodels.resnet18(pretrained=True, device="cpu")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("factory,params", [
    ("resnet18", 11_689_512), ("resnet34", 21_797_672),
    ("resnet50", 25_557_032), ("resnext50_32x4d", 25_028_904),
    ("wide_resnet50_2", 68_883_240)])
def test_factories_build_the_reference_shapes(factory, params):
    """Parameter counts of the factories (torchvision's and Paddle's
    published counts for these architectures)."""
    net = getattr(pmodels, factory)(device="cpu")
    assert sum(p.numel() for p in net.parameters()) == params


def test_bf16_model_stays_bf16():
    net = pmodels.resnet18(num_classes=CLASSES, device="cpu",
                           dtype=torch.bfloat16)
    x, y = (torch.from_numpy(a) for a in _batch(4))
    out = net(x.bfloat16())
    assert out.dtype == torch.bfloat16
    PF.cross_entropy(out.float(), y).backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pmodels.resnet18()
