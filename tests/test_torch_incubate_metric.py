"""The port's ``nn.utils``, ``metric`` and ``incubate.optimizer`` against
the JAX reference.

- ``nn.utils``: ``parameters_to_vector`` / ``vector_to_parameters``,
  ``weight_norm`` and ``spectral_norm`` (their pre-hooks), exact to 1e-6
  on the same weights;
- ``metric``: ``Accuracy`` (top-1 and top-2), ``Precision``, ``Recall``,
  ``Auc`` and ``accuracy`` over the same seeded predictions, equal (both
  compute on the host in numpy);
- ``GradientMergeOptimizer``: k micro-steps of gradient g_i give the
  parameters one step on the mean (or sum) of the g_i gives, in both
  packages, within 1e-6; the parameters do not move between boundaries;
- ``LookAhead``: after k inner steps the slow weights move ``alpha`` of
  the way and the fast weights take them, as the reference's, within
  1e-6 over 7 steps of SGD and Adam; it forwards ``state_dict`` and
  works under ``GradScaler.step``.

The reference's optimizers get the port's gradients by setting ``.grad``
on its parameters (as ``test_torch_llama_training.py`` does).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle
from paddle_tpu.incubate import optimizer as jinc

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate import optimizer as pinc
from paddle_tpu_torch.nn.layer.layers import load_numpy


@pytest.fixture(autouse=True)
def _cpu():
    """The port's layers on the CPU; both places put back."""
    yield from cpu_place()


def R(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _linear_pair():
    paddle.seed(0)
    jl = paddle.nn.Linear(5, 3)
    pl = load_numpy(pt.nn.Linear(5, 3),
                    {k: np.asarray(v.numpy())
                     for k, v in jl.state_dict().items()})
    return jl, pl


def test_parameter_vectors():
    jl, pl = _linear_pair()
    jv = paddle.nn.utils.parameters_to_vector(jl.parameters())
    pv = pt.nn.utils.parameters_to_vector(pl.parameters())
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv.numpy()))
    new = R(18, seed=1)
    paddle.nn.utils.vector_to_parameters(paddle.to_tensor(new),
                                         jl.parameters())
    pt.nn.utils.vector_to_parameters(torch.from_numpy(new), pl.parameters())
    np.testing.assert_array_equal(pl.weight.detach().numpy(),
                                  np.asarray(jl.weight.numpy()))


@pytest.mark.parametrize("which", ["weight_norm", "spectral_norm"])
def test_weight_reparameterisations(which):
    jl, pl = _linear_pair()
    getattr(paddle.nn.utils, which)(jl)
    getattr(pt.nn.utils, which)(pl)
    assert sorted(n for n, _ in pl.named_parameters()) == \
        sorted(n for n, _ in jl.named_parameters())
    x = R(4, 5, seed=2)
    for _ in range(2):
        jo = jl(paddle.to_tensor(x))
        po = pl(torch.from_numpy(x))
        np.testing.assert_allclose(po.detach().numpy(),
                                   np.asarray(jo.numpy()), atol=1e-6)
    assert pt.nn.utils.remove_weight_norm(pl) is pl


def test_metrics():
    rng = np.random.default_rng(3)
    pred = rng.random((32, 5)).astype(np.float32)
    lab = rng.integers(0, 5, (32, 1))
    prob = rng.random(32).astype(np.float32)
    binl = (rng.random(32) > 0.5).astype(np.int64)
    for topk in (1, (1, 2)):
        jm, pm = paddle.metric.Accuracy(topk), pt.metric.Accuracy(topk)
        for lo, hi in ((0, 16), (16, 32)):
            jc = jm.compute(paddle.to_tensor(pred[lo:hi]),
                            paddle.to_tensor(lab[lo:hi]))
            pc = pm.compute(torch.from_numpy(pred[lo:hi]),
                            torch.from_numpy(lab[lo:hi]))
            assert np.allclose(pm.update(pc), jm.update(jc))
        assert np.allclose(pm.accumulate(), jm.accumulate())
        assert pm.name() == jm.name() == "acc"
    for cls in ("Precision", "Recall", "Auc"):
        jm, pm = getattr(paddle.metric, cls)(), getattr(pt.metric, cls)()
        jm.update(paddle.to_tensor(prob), paddle.to_tensor(binl))
        pm.update(torch.from_numpy(prob), torch.from_numpy(binl))
        assert pm.accumulate() == pytest.approx(jm.accumulate(), abs=1e-12)
        pm.reset()
        assert pm.name() == jm.name()
    ja = paddle.metric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(lab),
                                k=2)
    pa = pt.metric.accuracy(torch.from_numpy(pred), torch.from_numpy(lab),
                            k=2)
    assert float(pa) == pytest.approx(float(np.asarray(ja.numpy())))
    assert issubclass(pt.metric.Accuracy, pt.metric.Metric)


def _set_grads(jl, pl, seed):
    for (jn, jp), (pn, pp) in zip(jl.named_parameters(),
                                  pl.named_parameters()):
        g = R(*pp.shape, seed=seed + len(jn))
        jp.grad = paddle.to_tensor(g)
        pp.grad = torch.from_numpy(g.copy())


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge(avg):
    """k micro-steps against one step on the merged gradient."""
    k = 3
    jl, pl = _linear_pair()
    _, ref = _linear_pair()
    jopt = jinc.GradientMergeOptimizer(
        paddle.optimizer.SGD(0.1, parameters=jl.parameters()), k, avg)
    popt = pinc.GradientMergeOptimizer(
        pt.optimizer.SGD(0.1, parameters=pl.parameters()), k, avg)
    merged = {n: 0 for n, _ in ref.named_parameters()}
    before = pl.weight.detach().clone()
    for step in range(k):
        _set_grads(jl, pl, 10 * step)
        for n, p in pl.named_parameters():
            merged[n] = merged[n] + p.grad.clone()
        jopt.step()
        popt.step()
        if step < k - 1:
            assert torch.equal(pl.weight.detach(), before)
            assert pl.weight.grad is None
    one = pt.optimizer.SGD(0.1, parameters=ref.parameters())
    for n, p in ref.named_parameters():
        p.grad = merged[n] / k if avg else merged[n]
    one.step()
    for (n, p), (_, q) in zip(pl.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6)
    np.testing.assert_allclose(pl.weight.detach().numpy(),
                               np.asarray(jl.weight.numpy()), atol=1e-6)
    assert popt.get_lr() == 0.1 and popt.k_steps == k


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_lookahead(inner):
    jl, pl = _linear_pair()
    kw = dict(learning_rate=0.05)
    jopt = jinc.LookAhead(getattr(paddle.optimizer, inner)(
        parameters=jl.parameters(), **kw), alpha=0.5, k=3)
    popt = pinc.LookAhead(getattr(pt.optimizer, inner)(
        parameters=pl.parameters(), **kw), alpha=0.5, k=3)
    slow = pl.weight.detach().clone()
    for step in range(7):
        _set_grads(jl, pl, 100 + step)
        fast_before = pl.weight.detach().clone()
        popt.step()
        jopt.step()
        popt.clear_grad()
        jopt.clear_grad()
        np.testing.assert_allclose(pl.weight.detach().numpy(),
                                   np.asarray(jl.weight.numpy()), atol=1e-6)
        if step in (2, 5):     # a sync: fast = slow + alpha (fast' - slow)
            assert not torch.equal(pl.weight.detach(), fast_before)
            np.testing.assert_allclose(
                pl.weight.detach().numpy(),
                popt._slow[id(pl.weight)].numpy(), atol=0)
            slow = pl.weight.detach().clone()
    assert set(popt.state_dict()) == set(popt._inner.state_dict())
    with pytest.raises(ValueError, match="alpha"):
        pinc.LookAhead(popt._inner, alpha=1.5)
    with pytest.raises(ValueError, match="k_steps"):
        pinc.GradientMergeOptimizer(popt._inner, k_steps=0)
    assert slow.shape == pl.weight.shape


def test_lookahead_under_grad_scaler():
    _, pl = _linear_pair()
    opt = pinc.LookAhead(pt.optimizer.SGD(0.1, parameters=pl.parameters()),
                         k=2)
    scaler = pt.amp.GradScaler(init_loss_scaling=4.0)
    for _ in range(2):
        loss = pl(torch.from_numpy(R(4, 5, seed=9))).square().mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
    assert opt._step_id == 2 and torch.isfinite(pl.weight).all()
