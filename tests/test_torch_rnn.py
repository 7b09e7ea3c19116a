"""The port's recurrent layers against the JAX reference.

``SimpleRNN``, ``LSTM`` and ``GRU`` (one and two layers, forward and
bidirectional, batch-first and time-major, with and without initial
states; each mode at least once bidirectional or time-major), the cells ``LSTMCell``, ``GRUCell`` and ``SimpleRNNCell``, the
driver ``RNN`` (reversed too) and ``BiRNN`` (``nn/layer/rnn.py``,
``nn/layer/extra.py``) at tiny sizes (input 6, hidden 8, T 5, B 3,
f32, on the CPU). The reference's layer is built after ``paddle.seed``
and its weights carried across (``state_dict`` → ``load_numpy``): the
names and layouts are the reference's. The reference scans with
``lax.scan``; the port loops over the steps, with the input projection
of all steps as one matmul.

Tolerances (fp32): outputs and states atol 1e-5; gradients atol 1e-5
plus 1e-5 of the leaf's largest entry (the same f32 arithmetic in
another order over at most 10 steps).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layer.layers import load_numpy

I, HID, T, B = 6, 8, 5, 3


@pytest.fixture(autouse=True)
def _cpu():
    """The port's layers on the CPU; both places put back."""
    yield from cpu_place()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [y for o in out for y in _flat(o)]
    return [] if out is None else [out]


def _check(jl, pl, jouts, pouts, seed=40):
    jf, pf = _flat(jouts), _flat(pouts)
    assert len(jf) == len(pf)
    for j, p in zip(jf, pf):
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(p), _np(j), atol=1e-5, rtol=0)
    jloss = ploss = 0
    for k, (j, p) in enumerate(zip(jf, pf)):
        w = _rand(tuple(p.shape), seed + k)
        jloss = jloss + (j * paddle.to_tensor(w)).sum()
        ploss = ploss + (p * torch.from_numpy(w)).sum()
    jloss.backward()
    ploss.backward()
    jg = dict(jl.named_parameters())
    for n, p in pl.named_parameters():
        ref = np.asarray(jg[n].grad.numpy())
        tol = 1e-5 + 1e-5 * float(np.abs(ref).max())
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0,
                                   err_msg=n)


def _pair(name, *args, **kw):
    paddle.seed(0)
    jl = getattr(paddle.nn, name)(*args, **kw)
    pl = getattr(pt.nn, name)(*args, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(pl.state_dict())
    return jl, load_numpy(pl, state)


@pytest.mark.parametrize("name, layers, direction, time_major", [
    ("SimpleRNN", 1, "forward", True), ("LSTM", 2, "bidirect", False),
    ("LSTM", 1, "forward", True), ("GRU", 2, "bidirect", True)])
def test_rnn_layers(name, layers, direction, time_major):
    jl, pl = _pair(name, I, HID, num_layers=layers, direction=direction,
                   time_major=time_major)
    x = _rand((T, B, I) if time_major else (B, T, I), 1)
    _check(jl, pl, jl(paddle.to_tensor(x)), pl(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_rnn_initial_states(name):
    jl, pl = _pair(name, I, HID, num_layers=2, direction="bidirect")
    x = _rand((B, T, I), 2)
    h0, c0 = _rand((4, B, HID), 3), _rand((4, B, HID), 4)
    if name == "LSTM":
        jout = jl(paddle.to_tensor(x), (paddle.to_tensor(h0),
                                        paddle.to_tensor(c0)))
        pout = pl(torch.from_numpy(x), (torch.from_numpy(h0),
                                        torch.from_numpy(c0)))
    else:
        jout = jl(paddle.to_tensor(x), paddle.to_tensor(h0))
        pout = pl(torch.from_numpy(x), torch.from_numpy(h0))
    _check(jl, pl, jout, pout)


@pytest.mark.parametrize("name", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_and_the_rnn_driver(name):
    jc, pc = _pair(name, I, HID)
    x = _rand((B, I), 5)
    _check(jc, pc, jc(paddle.to_tensor(x)), pc(torch.from_numpy(x)))
    for reverse in (False, True):
        jr = paddle.nn.RNN(jc, is_reverse=reverse)
        pr = pt.nn.RNN(pc, is_reverse=reverse)
        xs = _rand((B, T, I), 6)
        jc.clear_gradients()
        pc.clear_gradients()
        _check(jc, pc, jr(paddle.to_tensor(xs))[0],
               pr(torch.from_numpy(xs))[0])


def test_birnn():
    paddle.seed(0)
    jf, jb = paddle.nn.GRUCell(I, HID), paddle.nn.GRUCell(I, HID)
    jbi = paddle.nn.BiRNN(jf, jb)
    pbi = pt.nn.BiRNN(pt.nn.GRUCell(I, HID), pt.nn.GRUCell(I, HID))
    load_numpy(pbi, {k: np.asarray(v.numpy())
                     for k, v in jbi.state_dict().items()})
    x = _rand((B, T, I), 7)
    _check(jbi, pbi, jbi(paddle.to_tensor(x))[0],
           pbi(torch.from_numpy(x))[0])


def test_rnn_weights_from_one_seed():
    """Uniform(±1/sqrt(hidden)) draws are the reference's bit for bit."""
    paddle.seed(4)
    jl = paddle.nn.LSTM(I, HID, direction="bidirect")
    pt.seed(4)
    pl = pt.nn.LSTM(I, HID, direction="bidirect")
    for (jn, jp), (pn, pp) in zip(jl.named_parameters(),
                                  pl.named_parameters()):
        assert jn == pn
        np.testing.assert_array_equal(pp.detach().numpy(),
                                      np.asarray(jp.numpy()))
