"""The port's PP-YOLOE (models/ppyoloe.py) against the JAX reference.

The reference's ``tiny`` detector, built after ``paddle.seed(0)`` as
``tests/test_ppyoloe.py`` builds it, is carried across through numpy
(``state_dict`` → ``load_numpy``: every parameter and the BatchNorm
buffers). One seeded image (1×3×64×64) and three gt boxes (two that
overlap with other labels, then a padding row labelled -1) go through
both packages in fp32: the train-mode loss and every gradient, a
Momentum(0.01, momentum=0.9) step and the running statistics, then the
eval-mode scores and boxes and ``post_process``. The reference runs its
default route (``FLAGS_fused_norm`` on, no interpret mode on the CPU: the
dense BatchNorm); the port runs its default route on the CPU, the fused
BatchNorm's plain versions (``fused_bn/plain``, no kernel launch).
``test_detector_learns_synthetic_box``'s Adam sequence is replayed for
three steps. The reference's runs are made once per module (its eager
tiny model takes ~15 s to build and ~20 s for its first training step on
one worker).

Tolerances: the model amplifies rounding (BatchNorm over 4 values a
channel at stride 32, at initialisation): the port's f32 gradients lie
~1e-4 (relative L2) from its own f64 ones, a leaf's worst entry ~2e-4 of
the leaf's largest. So each reading against the reference is held to at
most 3x the port's own f32-against-f64 reading on the same weights and
inputs (the dense route in f64), plus a floor of 1e-6 of the reading's
scale: the loss, the gradients of all leaves as one vector (relative L2),
the parameters and running statistics after the step (largest relative
difference per tensor), the eval scores and boxes (largest difference),
and ``post_process``'s rows (its count and classes exactly). The Adam
losses: rtol 1e-4 (Adam normalises each gradient entry, so the f32
differences above move the second and third losses by ~1e-5).
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import paddle_tpu as paddle
from paddle_tpu.models import ppyoloe as jppyoloe
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.kernels import norm_fusion as pnf
from paddle_tpu_torch.models import ppyoloe as pppyoloe
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import norm as pnorm

FACTOR = 3.0
LR, MOMENTUM = 0.01, 0.9
GT_BOXES = np.array([[[8.0, 8.0, 40.0, 40.0], [20.0, 12.0, 60.0, 44.0],
                      [0.0, 0.0, 64.0, 64.0]]], np.float32)
GT_LABELS = np.array([[2, 1, -1]], np.int64)
# the same boxes with the overlapping pair swapped, and with the padding
# row labelled: both must change the loss
VARIANTS = {"swapped": (GT_BOXES[:, [1, 0, 2]], GT_LABELS[:, [1, 0, 2]]),
            "pad_labelled": (GT_BOXES, np.array([[2, 1, 3]], np.int64))}
ADAM_BOX = np.array([[[8.0, 8.0, 40.0, 40.0]]], np.float32)
ADAM_LABEL = np.array([[2]], np.int64)


def _numpy(t):
    return np.asarray(t.numpy(), np.float32)


def _image():
    rng = np.random.default_rng(0)
    return rng.normal(size=(1, 3, 64, 64)).astype(np.float32)


def _state(net):
    return {k: _numpy(v) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's tiny model after ``paddle.seed(0)`` and everything
    the tests hold the port against, computed once."""
    paddle.seed(0)
    jnet = jppyoloe.PPYOLOE(jppyoloe.CONFIGS["tiny"])
    state0 = _state(jnet)
    img = paddle.to_tensor(_image())
    out = {"state0": state0}
    jnet.train()
    for key, (boxes, labels) in VARIANTS.items():
        jnet.set_state_dict(state0)
        out[key] = float(jnet.loss(img, paddle.to_tensor(boxes),
                                   paddle.to_tensor(labels)).numpy())
    jnet.set_state_dict(state0)
    loss = jnet.loss(img, paddle.to_tensor(GT_BOXES),
                     paddle.to_tensor(GT_LABELS))
    loss.backward()
    out["loss"] = float(loss.numpy())
    out["grads"] = {n: _numpy(p.grad) for n, p in jnet.named_parameters()}
    out["stats"] = {n: _numpy(b) for n, b in jnet.named_buffers()}
    opt = paddle.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM,
                                    parameters=jnet.parameters())
    opt.step()
    opt.clear_grad()
    out["state1"] = _state(jnet)
    jnet.eval()
    scores, boxes = jnet(img)
    out["scores"], out["boxes"] = _numpy(scores), _numpy(boxes)
    rows, n = jnet.post_process(img)
    out["rows"], out["count"] = _numpy(rows), int(n.numpy())
    # test_detector_learns_synthetic_box's sequence: Adam(5e-3), one box
    jnet.set_state_dict(state0)
    jnet.train()
    adam = paddle.optimizer.Adam(learning_rate=5e-3,
                                 parameters=jnet.parameters())
    out["adam"] = []
    for _ in range(3):
        loss = jnet.loss(img, paddle.to_tensor(ADAM_BOX),
                         paddle.to_tensor(ADAM_LABEL))
        loss.backward()
        adam.step()
        adam.clear_grad()
        out["adam"].append(float(loss.numpy()))
    return out


def _port_chain(state, dtype):
    """The port's readings on the reference's weights: the variants'
    losses, the loss, gradients and running statistics of one train-mode
    step, the state after Momentum, eval scores and boxes, post_process."""
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS["tiny"], device="cpu",
                           dtype=dtype).load_numpy(state)
    img = torch.from_numpy(_image()).to(dtype)
    out = {}
    for key, (boxes, labels) in VARIANTS.items():
        net.load_numpy(state)
        with torch.no_grad():
            out[key] = net.loss(img, torch.from_numpy(boxes).to(dtype),
                                torch.from_numpy(labels)).item()
    net.load_numpy(state)
    before = dict(pnf.launches)
    loss = net.loss(img, torch.from_numpy(GT_BOXES).to(dtype),
                    torch.from_numpy(GT_LABELS))
    loss.backward()
    out["path"] = PF.last_norm_path()
    out["launched"] = {k: v - before[k] for k, v in pnf.launches.items()}
    out["loss"] = loss.item()
    out["grads"] = {n: p.grad.double().numpy()
                    for n, p in net.named_parameters()}
    out["stats"] = {n: b.double().numpy() for n, b in net.named_buffers()}
    opt = popt.Momentum(LR, momentum=MOMENTUM, parameters=net.parameters())
    opt.step()
    opt.clear_grad()
    out["state1"] = {k: v.detach().double().numpy()
                     for k, v in net.state_dict().items()}
    net.eval()
    with torch.no_grad():
        scores, boxes = net(img)
        out["eval_path"] = PF.last_norm_path()
        rows, n = net.post_process(img)
    out["scores"], out["boxes"] = (scores.double().numpy(),
                                   boxes.double().numpy())
    out["rows"], out["count"] = rows.double().numpy(), int(n)
    return out


@pytest.fixture(scope="module")
def port(reference):
    return _port_chain(reference["state0"], torch.float32)


@pytest.fixture(scope="module")
def port_f64(reference):
    """The port in f64 (the dense BatchNorm: the kernels take f32 and
    bf16) on the reference's weights: the yard against which each f32
    reading is measured."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _port_chain(reference["state0"], torch.float64)


def _rel_l2(a, b):
    names = sorted(b)
    fa = np.concatenate([a[n].ravel() for n in names])
    fb = np.concatenate([b[n].ravel() for n in names])
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def _worst(a, b):
    return max(float(np.abs(a[n] - b[n]).max())
               / max(float(np.abs(b[n]).max()), 1e-30) for n in b)


def _held(got, floor, scale=1.0):
    assert got <= FACTOR * floor + 1e-6 * scale, (got, floor)


# ---------------------------------------------------------------------------
# the model's parameters and checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "ppyoloe-s", "ppyoloe-l"])
def test_state_dict_names_and_shapes_equal_the_reference(name, reference):
    if name == "tiny":
        want = {k: v.shape for k, v in reference["state0"].items()}
    else:
        jnet = jppyoloe.PPYOLOE(jppyoloe.CONFIGS[name])
        want = {k: tuple(v.shape) for k, v in jnet.state_dict().items()}
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS[name], device="cpu")
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == want
    for key in ("backbone.stem.0.conv.weight",
                "backbone.stages.0.1.blocks.0.bn._mean",
                "head.cls_preds.2.bias", "neck.fuse.0.bn._variance"):
        assert key in got
    assert pppyoloe.CONFIGS[name] == tuple(jppyoloe.CONFIGS[name])


def test_configs_equal_the_reference():
    assert set(pppyoloe.CONFIGS) == set(jppyoloe.CONFIGS)
    for name, cfg in jppyoloe.CONFIGS.items():
        mine = pppyoloe.CONFIGS[name]
        assert tuple(mine) == tuple(cfg)
        assert [mine.ch(c) for c in (32, 64, 512)] == [cfg.ch(c) for c in
                                                        (32, 64, 512)]
        assert mine.depth(3) == cfg.depth(3)
    assert pmodels.ppyoloe is pppyoloe


def test_load_numpy_carries_every_parameter_and_buffer(reference):
    state = reference["state0"]
    moved = {k: v + 0.5 for k, v in state.items()}
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS["tiny"], device="cpu")
    net.load_numpy(moved)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), moved[k])
    with pytest.raises(KeyError, match="missing"):
        net.load_numpy({k: v for k, v in state.items()
                        if k != "head.reg_convs.2.bn._mean"})
    bad = dict(state)
    bad["head.cls_preds.0.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="head.cls_preds.0.bias"):
        net.load_numpy(bad)


def test_default_device_is_the_card():
    cfg = pppyoloe.CONFIGS["tiny"]
    if torch.cuda.is_available():
        assert pppyoloe.PPYOLOE(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pppyoloe.PPYOLOE(cfg)


def test_input_size_check_matches_reference():
    paddle.seed(0)
    jnet = jppyoloe.PPYOLOE(jppyoloe.CONFIGS["tiny"])
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS["tiny"], device="cpu")
    x = np.zeros((1, 3, 48, 64), np.float32)
    with pytest.raises(ValueError) as jerr:
        jnet(paddle.to_tensor(x))
    with pytest.raises(ValueError) as perr:
        net(torch.from_numpy(x))
    assert str(perr.value) == str(jerr.value)
    assert str(perr.value) == "input H, W must be divisible by 32; got 48x64"


@pytest.mark.parametrize("name,calls", [("tiny", 29), ("ppyoloe-s", 29),
                                        ("ppyoloe-l", 35)])
def test_train_forward_makes_one_fused_bn_call_per_conv_bn_layer(
        name, calls, monkeypatch):
    """Every ConvBNLayer's BatchNorm takes the fused route with no residual
    and no ReLU (35 calls a ppyoloe-l forward, as chip_smoke.py checks on
    the card); eval mode takes none."""
    seen = []
    real = pnorm.fused_batch_norm_train

    def spy(x, w, b, residual=None, eps=1e-5, fuse_relu=False):
        seen.append((residual, fuse_relu))
        return real(x, w, b, residual=residual, eps=eps, fuse_relu=fuse_relu)

    monkeypatch.setattr(pnorm, "fused_batch_norm_train", spy)
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS[name], device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        net(x)
        assert PF.last_norm_path() == "fused_bn/plain"
        assert len(seen) == calls
        assert all(r is None and not relu for r, relu in seen)
        net.eval()
        net(x)
    assert len(seen) == calls and PF.last_norm_path() == "dense"


# ---------------------------------------------------------------------------
# the tiny model against the reference
# ---------------------------------------------------------------------------

def test_train_loss_and_gradients_match_reference(reference, port,
                                                  port_f64):
    assert port["path"] == "fused_bn/plain"
    assert not any(port["launched"].values())   # CPU: no kernel launches
    assert set(port["grads"]) == set(reference["grads"])
    _held(abs(port["loss"] - reference["loss"]),
          abs(port["loss"] - port_f64["loss"]), abs(reference["loss"]))
    _held(_rel_l2(port["grads"], reference["grads"]),
          _rel_l2(port["grads"], port_f64["grads"]))
    for n, g in port["grads"].items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, n


def test_padding_rows_and_first_matching_gt_match_reference(
        reference, port, port_f64):
    """Swapping two overlapping gts of different labels changes which gt a
    cell takes (the first), and labelling the padding row brings it into
    the assignment: each loss as the reference's, all three different."""
    for key in VARIANTS:
        _held(abs(port[key] - reference[key]),
              abs(port[key] - port_f64[key]), abs(reference[key]))
    losses = [reference["loss"], reference["swapped"],
              reference["pad_labelled"]]
    assert min(abs(a - b) for a, b in ((losses[0], losses[1]),
                                       (losses[0], losses[2]),
                                       (losses[1], losses[2]))) > 1e-3


def test_running_stats_and_momentum_step_match_reference(reference, port,
                                                         port_f64):
    stats = {n: reference["stats"][n] for n in port["stats"]}
    assert set(stats) == set(reference["stats"])
    assert all(np.abs(v - (0.0 if n.endswith("_mean") else 1.0)).max() > 0
               for n, v in stats.items())      # they moved
    _held(_worst(port["stats"], stats),
          _worst(port["stats"], port_f64["stats"]))
    assert set(port["state1"]) == set(reference["state1"])
    _held(_worst(port["state1"], reference["state1"]),
          _worst(port["state1"], port_f64["state1"]))


def test_eval_forward_after_a_step_matches_reference(reference, port,
                                                     port_f64):
    assert port["eval_path"] == "dense"
    for key in ("scores", "boxes"):
        got = float(np.abs(port[key] - reference[key]).max())
        floor = float(np.abs(port[key] - port_f64[key]).max())
        _held(got, floor, float(np.abs(reference[key]).max()))
    assert port["scores"].shape == (1, 8 * 8 + 4 * 4 + 2 * 2, 4)


def test_post_process_matches_reference(reference, port, port_f64):
    rows, ref = port["rows"], reference["rows"]
    assert rows.shape == ref.shape == (8 * 8 + 4 * 4 + 2 * 2, 6)  # k < 100
    assert port["count"] == reference["count"] == port_f64["count"] > 0
    assert np.array_equal(rows[:, 0], ref[:, 0])
    got = float(np.abs(rows - ref).max())
    floor = float(np.abs(rows - port_f64["rows"]).max())
    _held(got, floor, float(np.abs(ref).max()))


def test_adam_steps_match_the_reference_sequence(reference):
    net = pppyoloe.PPYOLOE(pppyoloe.CONFIGS["tiny"],
                           device="cpu").load_numpy(reference["state0"])
    img = torch.from_numpy(_image())
    adam = popt.Adam(learning_rate=5e-3, parameters=net.parameters())
    losses = []
    for _ in range(3):
        loss = net.loss(img, torch.from_numpy(ADAM_BOX),
                        torch.from_numpy(ADAM_LABEL))
        loss.backward()
        adam.step()
        adam.clear_grad()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, reference["adam"], rtol=1e-4)
    assert losses[-1] < losses[0]
