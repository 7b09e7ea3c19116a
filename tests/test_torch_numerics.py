"""The port's tensor checker and ``check_numerics`` (``amp/debugging.py``)
against the JAX reference.

The same op sequence (registered functionals of both packages) runs
under both checkers armed alike; the checker's statistics (ops checked,
device reads, windows, alarms, underflow counts), the ops an alarm names
and the FloatingPointError of ``CHECK_NAN_INF_AND_ABORT`` are the
reference's. The window rule: a clean run of n checked ops costs
ceil(n / FLAGS_check_nan_inf_flush) reads, however many outputs. Every
``TensorCheckerConfig`` field acts: the op lists filter, ``debug_step``
filters on the step count ``GradScaler.update`` advances (in both
packages), ``output_dir`` receives one JSON record an alarm, a bad field
raises. ``check_numerics`` returns the reference's counts from one read.
Flags and the armed config are restored after each test.
"""
import json
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)
from torch_ops_audit import cpu_place

import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.core.flags import get_flag as jget
from paddle_tpu.core.flags import set_flags as jset

import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import debugging as pdbg
from paddle_tpu_torch.core import dispatch as pdispatch

FLAGS = ("check_nan_inf", "check_nan_inf_level", "check_nan_inf_flush")


@pytest.fixture(autouse=True)
def _restore():
    jold = {f: jget(f) for f in FLAGS}
    pold = {f: pt.get_flag(f) for f in FLAGS}
    jstep, pstep = jdbg._STEP[0], pdbg._STEP[0]
    yield from cpu_place()
    jdbg.disable_tensor_checker()
    pdbg.disable_tensor_checker()
    jset(jold)
    pt.set_flags(pold)
    jdbg._STEP[0], pdbg._STEP[0] = jstep, pstep


def _run(pkg, x, poison=False):
    """relu → softmax → add → log → tanh over a [4, 6] input; ``poison``
    puts an inf into the input, so relu is the first op whose output
    holds one (and softmax the first to make NaNs of it)."""
    F = pkg.nn.functional
    v = x.copy()
    if poison:
        v[1, 2] = np.inf
    t = pkg.to_tensor(v)         # a facade: its + is the registered add
    h = F.relu(t)
    h = F.softmax(h, axis=-1)
    h = pkg.log(h + 1.0)
    return pkg.tanh(h)


X = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)


def _arm(dbg, **kw):
    mode = getattr(dbg.DebugMode, kw.pop("mode", "CHECK_NAN_INF"))
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        enable=True, debug_mode=mode, **kw))


@pytest.mark.parametrize("flush", [1, 2, 64])
def test_clean_windows(flush):
    for pkg, dbg, setf in ((paddle, jdbg, jset), (pt, pdbg, pt.set_flags)):
        setf({"check_nan_inf_flush": flush})
        _arm(dbg)
        _run(pkg, X)
        dbg.flush_eager_checks()
    ps, js = pdbg.eager_checker_stats(), jdbg.eager_checker_stats()
    assert ps == js
    n = ps["ops_checked"]
    assert n >= 4 and ps["syncs"] == ps["windows"] == math.ceil(n / flush)
    assert ps["alarms"] == 0


def test_alarm_names_the_first_op(capsys):
    recs = []
    for pkg, dbg, setf in ((paddle, jdbg, jset), (pt, pdbg, pt.set_flags)):
        setf({"check_nan_inf_flush": 64})
        _arm(dbg)
        _run(pkg, X, poison=True)
        dbg.flush_eager_checks()
        recs.append(dbg.eager_checker_stats())
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].replace("paddle_tpu", "") == out[1].replace(
        "paddle_tpu", "")
    assert "culprit ops: relu (1), softmax (6)" in out[1]
    assert recs[0] == recs[1] and recs[1]["alarms"] == 1
    from paddle_tpu_torch.profiler import flightrec
    rec = flightrec.records(kind="numerics_alarm")[-1]
    assert rec["ops"][0] == "relu" and rec["source"] == "eager_checker"


def test_abort_raises():
    for pkg, dbg in ((paddle, jdbg), (pt, pdbg)):
        _arm(dbg, mode="CHECK_NAN_INF_AND_ABORT")
        pkg.set_flags({"check_nan_inf_flush": 1})
        with pytest.raises(FloatingPointError,
                           match=r"culprit ops: relu \(1\)"):
            _run(pkg, X, poison=True)


def test_op_lists_output_dir_and_underflow(tmp_path):
    stats = []
    for pkg, dbg, d in ((paddle, jdbg, "j"), (pt, pdbg, "p")):
        _arm(dbg, mode="CHECK_ALL", checked_op_list=["softmax", "tanh"],
             skipped_op_list=["tanh"], output_dir=str(tmp_path / d),
             stack_height_limit=2)
        pkg.set_flags({"check_nan_inf_flush": 64})
        _run(pkg, X, poison=True)
        F = pkg.nn.functional
        tiny = np.full((3,), 1e-40, np.float32)
        F.softmax(pkg.to_tensor(tiny).astype("bfloat16") * 1e-30)
        dbg.flush_eager_checks()
        stats.append(dbg.eager_checker_stats())
        dumps = sorted((tmp_path / d).iterdir())
        assert len(dumps) == 1
        rec = json.loads(dumps[0].read_text())
        assert rec["ops"] == ["softmax"] and len(rec["stack"]) == 2
    assert stats[0] == stats[1] and stats[1]["ops_checked"] == 2
    with pytest.raises(TypeError, match="checked_op_list"):
        pdbg.TensorCheckerConfig(enable=True, checked_op_list="softmax")
    with pytest.raises(ValueError, match="debug_step"):
        pdbg.TensorCheckerConfig(enable=True, debug_step=(3, 1))
    with pytest.raises(ValueError, match="stack_height_limit"):
        pdbg.TensorCheckerConfig(enable=True, stack_height_limit=100)
    with pytest.raises(ValueError, match="enable is False"):
        pdbg.enable_tensor_checker(pdbg.TensorCheckerConfig(enable=False))


def test_debug_step_follows_the_scaler():
    """``debug_step=(1, 2)``: checking is on only between the first and
    the second ``GradScaler.update()``, in both packages."""
    counts = []
    for pkg, dbg in ((paddle, jdbg), (pt, pdbg)):
        dbg._STEP[0] = 0
        _arm(dbg, debug_step=(1, 2))
        scaler = pkg.amp.GradScaler(init_loss_scaling=2.0)
        seen = []
        for _ in range(3):
            _run(pkg, X)
            dbg.flush_eager_checks()
            seen.append(dbg.eager_checker_stats()["ops_checked"])
            scaler.update()
        counts.append(seen)
        assert dbg._STEP[0] == 3
    assert counts[0] == counts[1]
    assert counts[1][0] == 0 and counts[1][1] > 0 and \
        counts[1][2] == counts[1][1]


def test_per_tensor_check_without_the_hook():
    """With no checker installed, FLAGS_check_nan_inf reads each output
    and raises at the first bad one (the reference's inline path)."""
    hook = pdispatch._nan_check_hook
    pdispatch.set_nan_check_hook(None)
    try:
        pt.set_flags({"check_nan_inf": True})
        with pytest.raises(FloatingPointError, match="Operator relu"):
            _run(pt, X, poison=True)
    finally:
        pdispatch.set_nan_check_hook(hook)


def test_check_numerics(capsys):
    v = np.array([1.0, np.nan, -np.inf, 3.0, np.inf], np.float32)
    jn, ji = jdbg.check_numerics(paddle.to_tensor(v), "op", "var",
                                 jdbg.DebugMode.CHECK_NAN_INF)
    pn, pi = pdbg.check_numerics(torch.from_numpy(v), "op", "var",
                                 pdbg.DebugMode.CHECK_NAN_INF)
    assert (int(pn), int(pi)) == (int(np.asarray(jn.numpy())),
                                  int(np.asarray(ji.numpy()))) == (1, 2)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == out[1]
    with pytest.raises(FloatingPointError, match="has 1 NaN and 2 Inf"):
        pdbg.check_numerics(torch.from_numpy(v), "op", "var",
                            pdbg.DebugMode.CHECK_NAN_INF_AND_ABORT)
    clean = pdbg.check_numerics(torch.ones(3))
    assert (int(clean[0]), int(clean[1])) == (0, 0)
    vec = pt.profiler.numerics.health_vector(torch.from_numpy(v))
    assert vec.tolist()[:3] == [1.0, 2.0, 3.0]
    assert vec.tolist()[3] == pytest.approx(math.sqrt(10.0), rel=1e-7)
    with pytest.raises(NotImplementedError, match="compare_accuracy"):
        pdbg.compare_accuracy("a", "b", "c")
