"""The port's learning-rate schedulers, gradient clipping, optimizer knobs
and GradScaler against the JAX reference.

The same inputs, made from a numpy seed, go through both packages: the
sixteen schedulers of ``optimizer/lr.py`` stepped 60 times; the three
clip classes and ``clip_grad_norm_`` / ``clip_grad_value_`` on the same
gradients; SGD / Momentum / Adam / AdamW with param groups, ``L1Decay``,
``lr_ratio``, ``apply_decay_param_fun`` (PaddleNLP's idiom on the tiny
BERT of both packages, its weights carried across with ``load_numpy``),
``amsgrad``, ``grad_clip`` and a scheduler as the rate, each fed the same
three gradients; and ``GradScaler``'s dynamic scale over a run of steps
with an inf planted in one gradient.

Tolerances:
- scheduler rates: equal to 1 ulp (both are the same Python float
  arithmetic);
- clipped gradients and the clipped global norm: rtol 1e-6 (f32 sums in
  other orders);
- parameters after three steps: atol 1e-7 / rtol 1e-6, as the existing
  AdamW and Momentum tests hold them (AdamW with the tiny BERT: atol
  1e-6, its Adam step divides each gradient by its own root-mean-square);
- the scaler's scale and step counts: exact; the parameters and Adam
  moments across a skipped step: bitwise unchanged.
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import bert as jbert
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn.layer.layers import Parameter
from paddle_tpu_torch.optimizer import lr as plr

STEPS = 60


def _numpy(t):
    return np.asarray(t.numpy(), np.float32)


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------

def _poly(mod):
    return mod.PolynomialDecay(0.1, decay_steps=30, end_lr=0.001, power=2.0)


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 25, 40],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.07),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "PolynomialDecay": _poly,
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=15, end_lr=0.0, power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=8,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup-Polynomial": lambda m: m.LinearWarmup(
        _poly(m), warmup_steps=8, start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [5, 17, 33],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.97 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=3, cooldown=2, min_lr=1e-4),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=25, eta_min=0.001),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=7, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=50),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        0.1, total_steps=50, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, step_size_down=9, mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.98),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=40),
}

# the plateau scheduler's metric: falls, stalls, falls again
_METRICS = [1.0 / (1 + i) if i < 15 or i > 40 else 0.0625 for i in
            range(STEPS)]


def _advance(sched, i):
    if isinstance(sched, (plr.ReduceOnPlateau, jlr.ReduceOnPlateau)):
        sched.step(_METRICS[i] if isinstance(sched, jlr.ReduceOnPlateau)
                   else torch.tensor(_METRICS[i]))
    else:
        sched.step()


def _same(a, b):
    return a == b or abs(a - b) <= abs(math.ulp(b))


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_rates_equal_the_reference(name):
    """Sixty steps of each scheduler: the rate after every step, and after
    a state_dict round trip at step 30 into a fresh scheduler."""
    j, p = SCHEDULERS[name](jlr), SCHEDULERS[name](plr)
    assert _same(p(), j())
    for i in range(STEPS):
        if i == 30:
            fresh = SCHEDULERS[name](plr)
            fresh.set_state_dict(p.state_dict())
            assert fresh.state_dict() == p.state_dict()
            if not name.startswith("LinearWarmup-"):
                p = fresh   # a wrapped scheduler's state is not its own
        _advance(j, i)
        _advance(p, i)
        assert _same(p(), j()), (i, p(), j())
        assert p.last_epoch == j.last_epoch


def test_sixteen_schedulers_are_ported():
    names = [n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)
             and n != "LRScheduler"]
    assert len(names) == 16
    assert all(issubclass(getattr(plr, n), plr.LRScheduler) for n in names)
    assert {n.split("-")[0] for n in SCHEDULERS} == set(names)


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------

SHAPES = [(6, 4), (4,), (3, 3)]


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * scale
            for s in SHAPES]


def _pairs(grads):
    """(reference pairs, port pairs): parameters with these gradients,
    the second one excluded from clipping (need_clip False)."""
    jpairs, ppairs = [], []
    for i, g in enumerate(grads):
        jp = JParameter(jnp.zeros(g.shape))
        pp = torch.nn.Parameter(torch.zeros(g.shape))
        if i == 1:
            jp.need_clip = False
            pp.need_clip = False
        jpairs.append((jp, JTensor(jnp.asarray(g))))
        ppairs.append((pp, torch.from_numpy(g)))
    return jpairs, ppairs


@pytest.mark.parametrize("cls,args", [("ClipGradByValue", (0.5,)),
                                      ("ClipGradByValue", (0.3, -0.8)),
                                      ("ClipGradByNorm", (1.0,)),
                                      ("ClipGradByGlobalNorm", (1.0,)),
                                      ("ClipGradByGlobalNorm", (100.0,))])
def test_clip_classes_match_the_reference(cls, args):
    jpairs, ppairs = _pairs(_grads(1, 2.0))
    jout = getattr(jnn, cls)(*args)(jpairs)
    pout = getattr(pnn, cls)(*args)(ppairs)
    for (_, jg), (_, pg), (_, g0) in zip(jout, pout, ppairs):
        np.testing.assert_allclose(pg.numpy(), _numpy(jg), rtol=1e-6,
                                   atol=1e-7)
    # the excluded parameter's gradient is the one it came with
    assert pout[1][1] is ppairs[1][1]


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_the_reference(norm_type):
    grads = _grads(2, 3.0)
    jps = [JParameter(jnp.zeros(g.shape)) for g in grads]
    pps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for jp, pp, g in zip(jps, pps, grads):
        jp.grad = jnp.asarray(g)
        pp.grad = torch.from_numpy(g.copy())
    jt = jclip.clip_grad_norm_(jps, 2.5, norm_type=norm_type)
    pt = pnn.clip_grad_norm_(pps, 2.5, norm_type=norm_type)
    np.testing.assert_allclose(float(pt), float(_numpy(jt)), rtol=1e-6)
    for jp, pp in zip(jps, pps):
        np.testing.assert_allclose(pp.grad.numpy(), _numpy(jp.grad),
                                   rtol=1e-6, atol=1e-7)
    jclip.clip_grad_value_(jps, 0.1)
    pnn.clip_grad_value_(pps, 0.1)
    for jp, pp in zip(jps, pps):
        np.testing.assert_array_equal(pp.grad.numpy(), _numpy(jp.grad))


def test_clip_grad_norm_inf_keeps_bf16_gradients_bitwise():
    """At norm_type=inf with bf16 gradients the reference keeps each max,
    the total and the scale in bf16: the total and every clipped gradient
    are the reference's bit for bit, bf16 dtype included."""
    grads = [g.astype(jnp.bfloat16) for g in _grads(3, 3.0)]
    jps = [JParameter(jnp.zeros(g.shape, jnp.bfloat16)) for g in grads]
    pps = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.bfloat16))
           for g in grads]
    for jp, pp, g in zip(jps, pps, grads):
        jp.grad = jnp.asarray(g)
        pp.grad = torch.from_numpy(g.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    jt = jclip.clip_grad_norm_(jps, 2.5, norm_type=float("inf"))
    pt = pnn.clip_grad_norm_(pps, 2.5, norm_type=float("inf"))

    def bits(t):
        return t.detach().view(torch.int16).numpy()

    assert pt.dtype == torch.bfloat16 and str(jt.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        bits(pt), np.asarray(jt._value).view(np.int16))
    clipped = 0
    for jp, pp, g in zip(jps, pps, grads):
        assert pp.grad.dtype == torch.bfloat16
        want = np.asarray(jp.grad._value).view(np.int16)
        np.testing.assert_array_equal(bits(pp.grad), want)
        clipped += int((want != g.view(np.int16)).sum())
    assert clipped > 0


# ---------------------------------------------------------------------------
# the optimizer's knobs: three steps against the reference
# ---------------------------------------------------------------------------

def _sched(mod):
    return mod.LinearWarmup(mod.StepDecay(0.05, step_size=2, gamma=0.5),
                            warmup_steps=2, start_lr=0.0, end_lr=0.05)


KNOBS = {
    "momentum-param-groups": ("Momentum", lambda m, ps: dict(
        learning_rate=0.05, momentum=0.9,
        parameters=[{"params": ps[:2]},
                    {"params": ps[2:], "learning_rate": 0.5}])),
    "momentum-l1": ("Momentum", lambda m, ps: dict(
        learning_rate=0.05, momentum=0.9, parameters=ps,
        weight_decay=m.L1Decay(0.01))),
    "sgd-l1": ("SGD", lambda m, ps: dict(
        learning_rate=0.05, parameters=ps, weight_decay=m.L1Decay(0.02))),
    "momentum-scheduler": ("Momentum", lambda m, ps: dict(
        learning_rate=_sched(m.lr), momentum=0.9, parameters=ps,
        weight_decay=m.L2Decay(1e-3))),
    "momentum-clip-by-norm": ("Momentum", lambda m, ps: dict(
        learning_rate=0.05, momentum=0.9, parameters=ps,
        grad_clip=(jnn if m is paddle.optimizer else pnn)
        .ClipGradByNorm(0.5))),
    "adamw-scheduler-global-clip": ("AdamW", lambda m, ps: dict(
        learning_rate=_sched(m.lr), parameters=ps,
        grad_clip=(jnn if m is paddle.optimizer else pnn)
        .ClipGradByGlobalNorm(1.0))),
    "adamw-lr-ratio": ("AdamW", lambda m, ps: dict(
        learning_rate=0.01, parameters=ps,
        lr_ratio=lambda p: 0.5 if len(p.shape) == 1 else 1.0)),
    "adamw-amsgrad": ("AdamW", lambda m, ps: dict(
        learning_rate=0.01, parameters=ps, amsgrad=True)),
    "adam-amsgrad-l2": ("Adam", lambda m, ps: dict(
        learning_rate=0.01, parameters=ps, amsgrad=True,
        weight_decay=0.01)),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_optimizer_knobs_match_the_reference(knob):
    """The same parameters and three gradients into both packages'
    optimizer with the knob; a scheduler is stepped after each step, as
    a user's loop does. Then a state_dict round trip into a fresh port
    optimizer, which steps as the original does."""
    cls, kw = KNOBS[knob]
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(a)) for a in init]
    pps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = getattr(paddle.optimizer, cls)(**kw(paddle.optimizer, jps))
    popt_ = getattr(popt, cls)(**kw(popt, pps))
    grads = [[rng.standard_normal(s).astype(np.float32) * 2 for s in SHAPES]
             for _ in range(4)]
    for step in range(3):
        for jp, pp, g in zip(jps, pps, grads[step]):
            jp.grad = jnp.asarray(g)
            pp.grad = torch.from_numpy(g.copy())
        jopt.step()
        popt_.step()
        assert popt_.get_lr() == jopt.get_lr()
        for o in (jopt, popt_):
            if isinstance(o._learning_rate, (jlr.LRScheduler,
                                             plr.LRScheduler)):
                o._learning_rate.step()
            o.clear_grad()
        for jp, pp in zip(jps, pps):
            np.testing.assert_allclose(pp.detach().numpy(), _numpy(jp),
                                       atol=1e-7, rtol=1e-6)
    # the state dict: a fresh optimizer on copies steps as this one does
    copies = [Parameter(p.detach().clone()) for p in pps]
    for c, p in zip(copies, pps):
        c.name = p.name
    fresh = getattr(popt, cls)(**kw(popt, copies))
    fresh.set_state_dict(popt_.state_dict())
    assert fresh._global_step == popt_._global_step == 3
    for o, ps in ((popt_, pps), (fresh, copies)):
        for p, g in zip(ps, grads[3]):
            p.grad = torch.from_numpy(g.copy())
        o.step()
    for c, p in zip(copies, pps):
        torch.testing.assert_close(c.detach(), p.detach(), rtol=0, atol=0)


def test_apply_decay_param_fun_with_paddlenlp_idiom():
    """PaddleNLP's recipe on the tiny BERT of both packages: no decay on
    biases and norms, picked by each package's own parameter names; the
    same gradients, three AdamW steps."""
    cfg = jbert.CONFIGS["tiny"]
    paddle.seed(0)
    jmodel = jbert.BertForPretraining(cfg)
    state = {k: _numpy(v) for k, v in jmodel.state_dict().items()}
    model = pbert.BertForPretraining(pbert.CONFIGS["tiny"], device="cpu",
                                     dtype=torch.float32).load_numpy(state)

    def decay_names(m):
        return [p.name for n, p in m.named_parameters()
                if not any(nd in n for nd in ["bias", "norm"])]

    jdecay, pdecay = decay_names(jmodel), decay_names(model)
    assert len(pdecay) == len(jdecay) and len(set(pdecay)) == len(pdecay)
    assert len({p.name for p in model.parameters()}) == len(
        list(model.parameters()))
    jnamed = dict(jmodel.named_parameters())
    pnamed = dict(model.named_parameters())
    assert set(jnamed) == set(pnamed)
    jopt = paddle.optimizer.AdamW(1e-2, parameters=list(jnamed.values()),
                                  weight_decay=0.1,
                                  apply_decay_param_fun=lambda n: n in jdecay)
    popt_ = popt.AdamW(1e-2, parameters=list(pnamed.values()),
                       weight_decay=0.1,
                       apply_decay_param_fun=lambda n: n in pdecay)
    rng = np.random.default_rng(4)
    for _ in range(3):
        for k in jnamed:
            g = rng.standard_normal(tuple(pnamed[k].shape)).astype(
                np.float32)
            jnamed[k].grad = jnp.asarray(g)
            pnamed[k].grad = torch.from_numpy(g)
        jopt.step()
        popt_.step()
        jopt.clear_grad()
        popt_.clear_grad()
    for k in jnamed:
        np.testing.assert_allclose(pnamed[k].detach().numpy(),
                                   _numpy(jnamed[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

def test_grad_scaler_skips_updates_and_scales_as_the_reference():
    """Adam under both packages' GradScaler(init 1024, x2 every 2 good
    steps, /2 on a bad one) over six steps, an inf planted in one gradient
    at steps 2 and 3: the update is skipped (parameters and moments
    bitwise unchanged), the scale and counters follow the reference's, and
    state_dict / load_state_dict round-trip."""
    rng = np.random.default_rng(5)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(a)) for a in init]
    pps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = paddle.optimizer.Adam(0.01, parameters=jps)
    popt_ = popt.Adam(0.01, parameters=pps)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jsc, psc = jamp.GradScaler(**kw), pamp.GradScaler(**kw)
    for step in range(6):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        scale = psc.get_init_loss_scaling()
        assert scale == jsc.get_init_loss_scaling()
        if step in (2, 3):
            grads[0][1, 2] = np.inf
        for jp, pp, g in zip(jps, pps, grads):
            jp.grad = jnp.asarray(g * scale)
            pp.grad = torch.from_numpy(g * scale)
        before = ([p.detach().clone() for p in pps],
                  {k: {i: t.clone() for i, t in v.items()}
                   for k, v in popt_._accumulators.items()})
        if step == 4:
            jsc.unscale_(jopt)   # the clipping pattern: unscale, then step
            psc.unscale_(popt_)
        jsc.step(jopt)
        psc.step(popt_)
        jsc.update()
        psc.update()
        jopt.clear_grad()
        popt_.clear_grad()
        if step in (2, 3):
            for p, b in zip(pps, before[0]):
                assert torch.equal(p.detach(), b)
            for k, v in popt_._accumulators.items():
                for i, t in v.items():
                    assert torch.equal(t, before[1][k][i])
        for jp, pp in zip(jps, pps):
            np.testing.assert_allclose(pp.detach().numpy(), _numpy(jp),
                                       atol=1e-7, rtol=1e-6)
        jsd, psd = jsc.state_dict(), psc.state_dict()
        assert float(psd.pop("scale")) == float(jsd.pop("scale"))
        assert psd == jsd
    # 1024: x 2 after steps 0-1, / 2 at 2 and 3, x 2 after 4-5
    assert psc.get_init_loss_scaling() == 1024.0
    fresh = pamp.GradScaler()
    fresh.load_state_dict(psc.state_dict())
    assert fresh.state_dict()["good_steps"] == psd["good_steps"]
    assert fresh.get_init_loss_scaling() == psc.get_init_loss_scaling()
    off = pamp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss
