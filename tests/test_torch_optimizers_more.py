"""The ten optimizers ported in A5b-2 (``Adamax`` … ``Rprop``,
``paddle_tpu_torch/optimizer/optimizers.py``) against the JAX reference.

Each optimizer gets the same parameters and the same gradients (a numpy
seed) in both packages, with a knob of its own on (decay, a clip,
``centered``, the Lamb exclusion, ...), and takes six steps (RAdam's
rectified branch starts at the sixth); the parameters must agree to rtol
1e-5 / atol 1e-6 after every step (f32, the same formulas, other kernels
and orders of the reductions). Then its state dict goes through
``paddle.save`` / ``paddle.load`` into a fresh port optimizer on copies
of the parameters, and the fresh one's next step equals the original's
bit for bit (LBFGS keeps its history outside the state dict, in both
packages, so its fresh copy steps from an empty history, as the
reference's does). The original's next step is held to the reference's
too.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as ppaddle
import torch_ops_audit as A
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu_torch.nn.layer.layers import Parameter

SHAPE = (4, 3)
STEPS = 6


@pytest.fixture(autouse=True)
def cpu_place():
    yield from A.cpu_place()


def _kw(paddle, name):
    """The optimizer's constructor arguments but the parameters."""
    return {
        "Adamax": dict(learning_rate=0.01, beta2=0.99),
        "Adagrad": dict(learning_rate=0.1, weight_decay=0.01,
                        initial_accumulator_value=0.1),
        "Adadelta": dict(learning_rate=1.0, rho=0.9),
        "RMSProp": dict(learning_rate=0.01, momentum=0.9, centered=True,
                        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
        "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.02,
                     exclude_from_weight_decay_fn=lambda p: p.name.endswith(
                         "b")),
        "LBFGS": dict(learning_rate=0.5, history_size=3),
        "NAdam": dict(learning_rate=0.01, weight_decay=0.01),
        "RAdam": dict(learning_rate=0.01),
        "ASGD": dict(learning_rate=0.05, batch_num=3),
        "Rprop": dict(learning_rate=0.01, etas=(0.4, 1.3),
                      learning_rate_range=(1e-4, 0.05)),
    }[name]


NAMES = ["Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS",
         "NAdam", "RAdam", "ASGD", "Rprop"]


def _step(opt, params, grads, setter):
    for p, g in zip(params, grads):
        setter(p, g)
    if isinstance(opt, (ppaddle.optimizer.LBFGS,
                        jpaddle.optimizer.LBFGS)):
        opt.step(lambda: None)
    else:
        opt.step()
    opt.clear_grad()


def _jset(p, g):
    p.grad = jnp.asarray(g)


def _pset(p, g):
    p.grad = torch.from_numpy(g.copy())


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_the_reference_and_resumes(name, tmp_path):
    rng = np.random.default_rng(NAMES.index(name))
    init = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]
    grads = [[rng.standard_normal(SHAPE).astype(np.float32)
              * (1 if s % 3 else -0.5) for _ in init]
             for s in range(STEPS + 1)]
    names = ["w_a", "w_b"]
    jps = [JParameter(jnp.asarray(a), name=n) for a, n in zip(init, names)]
    pps = [Parameter(torch.from_numpy(a.copy())) for a in init]
    for p, n in zip(pps, names):
        p.name = n
    jopt = getattr(jpaddle.optimizer, name)(parameters=jps,
                                            **_kw(jpaddle, name))
    popt = getattr(ppaddle.optimizer, name)(parameters=pps,
                                            **_kw(ppaddle, name))
    for s in range(STEPS):
        _step(jopt, jps, grads[s], _jset)
        _step(popt, pps, grads[s], _pset)
        for jp, pp in zip(jps, pps):
            np.testing.assert_allclose(pp.detach().numpy(),
                                       np.asarray(jp.numpy()), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {s}")
    sd = popt.state_dict()
    if name != "LBFGS":
        want = {f"{n}_{acc}" for n in names for acc in jopt._accumulators}
        assert set(sd) - {"global_step"} == want
        assert set(sd) == set(jopt.state_dict())
    path = str(tmp_path / f"{name}.pdopt")
    ppaddle.save(sd, path)
    copies = [Parameter(p.detach().clone()) for p in pps]
    for c, n in zip(copies, names):
        c.name = n
    fresh = getattr(ppaddle.optimizer, name)(parameters=copies,
                                             **_kw(ppaddle, name))
    fresh.set_state_dict(ppaddle.load(path))
    # LBFGS's own step counts no global step, in either package
    assert fresh._global_step == popt._global_step == jopt._global_step == \
        (0 if name == "LBFGS" else STEPS)
    for k, v in sd.items():
        if k != "global_step":
            got = fresh.state_dict()[k]
            assert torch.equal(got, v) and got is not v, k
    _step(fresh, copies, grads[STEPS], _pset)
    _step(popt, pps, grads[STEPS], _pset)
    _step(jopt, jps, grads[STEPS], _jset)
    for c, p, jp in zip(copies, pps, jps):
        if name != "LBFGS":
            assert torch.equal(c, p)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp.numpy()),
                                   rtol=1e-5, atol=1e-6)


def test_the_stubs_are_gone():
    """Every optimizer of the reference's package has a port with the
    reference's accumulator names, and constructs."""
    import paddle_tpu.optimizer as jopt
    for name in NAMES + ["SGD", "Momentum", "Adam", "AdamW"]:
        cls = getattr(ppaddle.optimizer, name)
        assert cls.DEFAULT_ACCS == getattr(jopt, name).DEFAULT_ACCS, name
        kw = dict(learning_rate=0.1) if name in ("Adagrad", "RMSProp") else {}
        cls(parameters=[Parameter(torch.ones(2))], **kw)
