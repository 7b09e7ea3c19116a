"""The port's op registry and AMP (core/dispatch.py, amp/) against the JAX
reference.

- The cast decision: for every AMP category (white, black, promote, and
  promote ops named in the reference's white and black lists) x level
  (O0, O1, O2) x custom list (none, white, black, both) x low dtype
  (bfloat16, float16), a float32, bfloat16, float16 and int64 argument
  through the port's hook comes out in the dtype the reference's
  ``_amp_hook`` gives it. Exact.
- The dispatch path: calls counted, arguments cast inside lists, tuples,
  namedtuples and dicts, the output hook, ``differentiable=False``, the
  registry's categories against the reference's for every op the port
  registers.
- ``collect_operator_stats`` on the models: resnet50 (B=2, 3x32x32, 10
  classes) forward and loss under O2, and the tiny BERT (2 layers, H 64,
  4 heads, dropout 0.1 / 0.1) pretraining loss under O1 and O2, each on the
  dense and the fused routes (the reference's kernels in interpret mode),
  weights carried across with ``load_numpy``. The two tables are equal:
  the same op names, each with the same calls in the same dtype buckets
  (the reference's attention takes its flash route there, under
  ``FLAGS_flash_attention_interpret``, so no op is excepted). At O2 the
  BERT loss arithmetic (``multiply``, ``sum``, ``divide``, ``subtract``)
  is bf16 in both. Exact.
- ``decorate(level="O2")``: the parameters the reference casts, cast;
  BatchNorm and LayerNorm kept f32; the optimizer's master weights.
"""
import ast
import importlib
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdebug
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import ops as pops
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.amp import debugging as pdebug
from paddle_tpu_torch.core import dispatch as pdispatch
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import resnet as presnet

jac = importlib.import_module("paddle_tpu.amp.auto_cast")
pac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

ROOT = Path(__file__).resolve().parents[1]
_FLAGS = ("flash_attention_interpret", "fused_norm", "fused_norm_interpret",
          "fused_mlp", "fused_mlp_interpret")


@pytest.fixture(scope="module", autouse=True)
def restore_flags():
    old = {n: jax_get_flag(n) for n in _FLAGS}
    old_pt = {n: pt_get_flag(n) for n in ("fused_norm", "fused_mlp")}
    try:
        paddle.set_flags({"FLAGS_flash_attention_interpret": True})
        yield
    finally:
        paddle.set_flags({f"FLAGS_{n}": v for n, v in old.items()})
        pt_set_flags({f"FLAGS_{n}": v for n, v in old_pt.items()})


def _set_fused(on):
    paddle.set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_norm_interpret": on,
                      "FLAGS_fused_mlp": on, "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_norm": on, "FLAGS_fused_mlp": on})


# ---------------------------------------------------------------------------
# the cast decision
# ---------------------------------------------------------------------------

OPS = [("t_white", "white"), ("t_black", "black"), ("t_promote", "promote"),
       ("matmul", "promote"), ("exp", "promote")]
DTYPES = ["float32", "bfloat16", "float16", "int64"]


def _custom(kind, name):
    return {"none": (None, None), "white": ([name], None),
            "black": (None, [name]), "both": ([name], [name])}[kind]


@pytest.mark.parametrize("low", ["bfloat16", "float16"])
@pytest.mark.parametrize("custom", ["none", "white", "black", "both"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2"])
@pytest.mark.parametrize("op", OPS, ids=[o[0] for o in OPS])
def test_hook_gives_the_reference_cast_decision(op, level, custom, low):
    name, cat = op
    white, black = _custom(custom, name)
    jop = jdispatch.OpDef(name, lambda *a: a, amp=cat)
    pop = pdispatch.OpDef(name, lambda *a: a, amp=cat)
    for dt in DTYPES:
        # "kept", or the dtype the argument is cast to (the reference holds
        # int64 as int32 with x64 off: an integer is kept either way)
        with jac.auto_cast(level=level, dtype=low, custom_white_list=white,
                           custom_black_list=black):
            jin = jnp.zeros(2, dt)
            jout = jac._amp_hook(jop, [jin], [0])[0]
        want = "kept" if jout.dtype == jin.dtype else str(jout.dtype)
        pin = torch.zeros(2, dtype=getattr(torch, dt))
        with pac.auto_cast(level=level, dtype=low, custom_white_list=white,
                           custom_black_list=black):
            args, _ = pac._amp_hook(pop, (pin,), {})
            eff, = pdispatch.amp_dtypes(pop, pin)
        for out in (args[0].dtype, eff):
            got = "kept" if out == pin.dtype else str(out)[len("torch."):]
            assert got == want, (dt, got, want)
    assert not pamp.is_auto_cast_enabled()
    assert pamp.get_amp_dtype() == "float32"


def test_state_is_thread_local_and_restored():
    import threading
    seen = {}
    with pamp.auto_cast(level="O2", dtype="float16"):
        assert pamp.is_auto_cast_enabled()
        assert pamp.get_amp_dtype() == "float16"
        t = threading.Thread(
            target=lambda: seen.update(on=pamp.is_auto_cast_enabled()))
        t.start()
        t.join()
        with pamp.auto_cast(enable=False):
            assert not pamp.is_auto_cast_enabled()
        assert pamp.get_amp_dtype() == "float16"
    assert seen == {"on": False}
    assert not pamp.is_auto_cast_enabled()
    assert pamp.amp_guard is pamp.auto_cast
    assert pamp.amp_decorate is pamp.decorate
    assert pamp.is_bfloat16_supported() and pamp.is_float16_supported()
    assert pamp.white_list() == paddle.amp.white_list()
    assert pamp.black_list() == paddle.amp.black_list()


# ---------------------------------------------------------------------------
# the dispatch path
# ---------------------------------------------------------------------------

Pair = namedtuple("Pair", "a b")


def test_apply_counts_casts_every_argument_and_shows_outputs():
    seen = []
    op = pdispatch.OpDef("t_apply", lambda xs, pair, d, k=None, s=1.0:
                         (xs[0], xs[1], pair.a, pair.b, d["w"], k, s),
                         amp="white", multi_out=True)
    f32 = torch.ones(2)
    args = ([f32, torch.ones(2, dtype=torch.int64)],
            Pair(f32, torch.ones(2, dtype=torch.float16)), {"w": f32})
    pdispatch.reset_dispatch_stats()
    prev = pdispatch._output_hook
    pdispatch.set_output_hook(lambda n, outs: seen.append((n, len(outs))))
    try:
        with pamp.auto_cast(level="O1"):
            out = pdispatch.apply(op, *args, k=f32, s=2.0, name="cosmetic")
    finally:
        pdispatch.set_output_hook(prev)
    assert [o.dtype for o in out[:6]] == [torch.bfloat16, torch.int64,
                                          torch.bfloat16, torch.bfloat16,
                                          torch.bfloat16, torch.bfloat16]
    assert out[6] == 2.0
    assert seen == [("t_apply", 7)]
    assert pdispatch.dispatch_stats() == {"ops_dispatched": 1, "per_op": {
        "t_apply": {"calls": 1}}}
    # outside auto_cast nothing is cast; the gradient flows back through a
    # cast into the argument's own dtype
    x = torch.ones(3, requires_grad=True)
    lin = pdispatch.OpDef("t_lin", lambda a: a * 3.0, amp="white")
    assert pdispatch.apply(lin, x).dtype == torch.float32
    with pamp.auto_cast(level="O1"):
        y = pdispatch.apply(lin, x)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.float32 and x.grad.tolist() == [3.0] * 3
    nd = pdispatch.OpDef("t_nd", lambda a: a * 2.0, differentiable=False)
    assert not pdispatch.apply(nd, x).requires_grad


def test_registered_ops_carry_the_reference_categories():
    """Every op the port registers is registered by the reference under
    the same name and category (the models' functionals included)."""
    import paddle_tpu_torch.models.bert  # noqa: F401  (registers its ops)
    import paddle_tpu_torch.vision.models  # noqa: F401
    assert {"conv2d", "batch_norm_train", "batch_norm_infer",
            "fused_bn_train", "layer_norm", "fused_layer_norm",
            "fused_bias_dropout_residual_ln", "linear", "dropout_raw",
            "embedding", "relu", "gelu", "tanh", "sigmoid", "silu",
            "softplus", "max_pool2d", "adaptive_avg_pool2d", "cross_entropy",
            "chunked_mlm_xent", "flash_attention", "flash_attention_masked",
            "sdpa_ref", "fused_mlp", "fused_attn_proj_ln", "add",
            "matmul"} <= set(pdispatch.OP_REGISTRY)
    for name, op in pdispatch.OP_REGISTRY.items():
        if name.startswith("t_"):
            continue
        assert name in jdispatch.OP_REGISTRY, name
        assert op.amp == jdispatch.OP_REGISTRY[name].amp, name
        assert op.multi_out == jdispatch.OP_REGISTRY[name].multi_out, name


def test_no_module_of_the_port_calls_torch_autocast():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr != "autocast", path
            if isinstance(node, ast.Name):
                assert node.id != "autocast", path


# ---------------------------------------------------------------------------
# collect_operator_stats on the models
# ---------------------------------------------------------------------------

def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _agree(jstats, pstats):
    """The two operator tables are equal: the same op names, each with the
    same calls in the same dtype buckets."""
    for name in sorted(set(jstats) | set(pstats)):
        assert pstats.get(name) == jstats.get(name), (name, pstats.get(name),
                                                      jstats.get(name))
    assert pstats == jstats


@pytest.fixture(scope="module")
def resnet():
    paddle.seed(0)
    jnet = jresnet.resnet50(num_classes=10)
    state = {k: _np(v) for k, v in jnet.state_dict().items()}
    net = presnet.resnet50(num_classes=10, device="cpu").load_numpy(state)
    rng = np.random.default_rng(0)
    return (jnet, net, rng.normal(size=(2, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, (2, 1)).astype(np.int64))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_resnet50_o2_operator_stats_match_the_reference(resnet, fused):
    jnet, net, x, y = resnet
    _set_fused(fused)
    try:
        with jdebug.collect_operator_stats() as jstats:
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = jnet(paddle.to_tensor(x))
            JF.cross_entropy(logits.astype("float32"), paddle.to_tensor(y))
        with pdebug.collect_operator_stats() as pstats:
            with pamp.auto_cast(level="O2", dtype="bfloat16"):
                plogits = net(torch.from_numpy(x))
            PF.cross_entropy(pops.cast(plogits, "float32"),
                             torch.from_numpy(y))
    finally:
        _set_fused(False)
    assert pstats["conv2d"]["bf16"] == 53
    bn = "fused_bn_train" if fused else "batch_norm_train"
    assert pstats[bn]["calls"] == 53
    _agree(jstats, pstats)
    assert plogits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())


@pytest.fixture(scope="module")
def berts():
    cfg = jbert.CONFIGS["tiny"]
    paddle.seed(0)
    jmodel = jbert.BertForPretraining(cfg)
    state = {k: _np(v) for k, v in jmodel.state_dict().items()}
    model = pbert.BertForPretraining(pbert.CONFIGS["tiny"], device="cpu",
                                     dtype=torch.float32).load_numpy(state)
    rng = np.random.default_rng(1)
    B, S, V = 2, 16, cfg.vocab_size
    ids = rng.integers(0, V, (B, S)).astype(np.int64)
    lab = rng.integers(0, V, (B, S)).astype(np.int64)
    lab[rng.random((B, S)) > 0.3] = -100
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 11:] = 0
    return jmodel, model, (ids, lab, nsp, mask)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_bert_operator_stats_match_the_reference(berts, level, fused):
    jmodel, model, batch = berts
    _set_fused(fused)
    try:
        paddle.seed(3)
        with jdebug.collect_operator_stats() as jstats:
            with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
                jloss = jmodel.loss(*(paddle.to_tensor(a) for a in batch[:3]),
                                    attention_mask=paddle.to_tensor(batch[3]))
        with pdebug.collect_operator_stats() as pstats:
            with pamp.auto_cast(level=level, dtype="bfloat16"):
                ploss = model.loss(*(torch.from_numpy(a) for a in batch[:3]),
                                   attention_mask=torch.from_numpy(batch[3]))
    finally:
        _set_fused(False)
    _agree(jstats, pstats)
    assert pstats["linear"]["bf16"] == pstats["linear"]["calls"] > 0
    assert pstats["cross_entropy"]["fp32"] == 1
    assert str(ploss.dtype).replace("torch.", "") == str(jloss.dtype)
    if fused:
        assert pstats["flash_attention_masked"]["bf16"] == 2
    # the loss arithmetic: f32 at O1, bf16 at O2, as the reference's
    bucket = "bf16" if level == "O2" else "fp32"
    for name, calls in (("multiply", 2), ("sum", 2), ("divide", 1),
                        ("subtract", 1)):
        assert pstats[name]["calls"] == calls, name
        assert pstats[name][bucket] == calls == jstats[name][bucket], name


def test_decorate_o2_casts_what_the_reference_casts(berts, resnet):
    """decorate(level="O2") on both models of each package: the same
    parameter names end bf16 (all but the BatchNorm and LayerNorm ones),
    the rest f32, and the optimizer keeps f32 master weights."""
    jmodel, model, _ = berts
    jnet, net, _, _ = resnet
    for jm, pm in ((jmodel, model), (jnet, net)):
        # the reference's casts are read off its own decorate, then undone
        jstate = {k: v._value for k, v in jm.named_parameters()}
        jopt = paddle.optimizer.AdamW(parameters=list(jm.parameters()))
        paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
        want = {k: str(v._value.dtype) for k, v in jm.named_parameters()}
        for k, v in jm.named_parameters():
            v._set_value(jstate[k])
        saved = {k: v.detach().clone() for k, v in pm.named_parameters()}
        opt = popt.AdamW(parameters=list(pm.parameters()))
        out_m, out_o = pamp.decorate(pm, opt, level="O2", dtype="bfloat16")
        assert out_m is pm and out_o is opt and opt._multi_precision
        got = {k: str(v.dtype).replace("torch.", "")
               for k, v in pm.named_parameters()}
        assert got == want
        assert "float32" in got.values() and "bfloat16" in got.values()
        for p in pm.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        assert all(mw.dtype == torch.float32
                   for mw in opt._master_weights.values())
        assert len(opt._master_weights) == sum(
            v == "bfloat16" for v in got.values())
        with torch.no_grad():
            for k, v in pm.named_parameters():
                v.data = saved[k]
