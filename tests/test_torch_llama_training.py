"""The port's LLaMA Layer model, its norm and rotary embedding, and the
AdamW optimizer against the JAX reference.

The reference's tiny LLaMA (GQA active: 4 query heads over 2 K/V heads)
is carried across through numpy (``state_dict`` → ``load_numpy``), then
the same seeded batch goes through both packages in fp32. The reference
runs as its own tests run it on the CPU: ``FLAGS_flash_attention_interpret``
on, so its attention reaches the Pallas flash kernels in interpret mode;
the tests parametrised over ``mlp`` run with ``FLAGS_fused_mlp`` off (the
dense SwiGLU in both packages) and on with ``FLAGS_fused_mlp_interpret``
(the reference's Pallas SwiGLU kernels in interpret mode, the port's
fused route: the kernels' plain versions on the CPU). All flags are
restored afterwards.

Tolerances (fp32 unless stated):
- logits and loss atol 1e-5 / rtol 1e-4; every gradient leaf within 1e-5
  of its largest entry: the same f32 arithmetic in other GEMM and
  reduction orders, 2 layers.
- rms_norm and the rotary embedding: atol 1e-6 / rtol 1e-5 (elementwise
  f32 arithmetic; sin and cos of positions up to 63 in another libm).
- bf16 rotary embedding: the port's output within one bf16 rounding
  (2^-8 relative) of the reference's f32 output.
- AdamW fed the same gradients: f32 parameters atol 1e-7 / rtol 1e-6 (one
  f32 rounding apart per step); bf16 parameters under multi_precision
  equal to the f32 master rounded, masters as f32.
- Three training steps of the Layer model with AdamW: losses rtol 1e-5;
  parameters within 2·lr·steps of each other entry by entry (Adam divides
  each gradient by its own root-mean-square, so an entry whose gradient
  is rounding noise moves by up to lr per step in either package) and
  all but 1e-3 of each leaf's entries within 1e-6.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.mlp import last_mlp_path as jax_last_mlp_path
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmf
from paddle_tpu_torch.models import llama as pllama
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as PF

B, S = 2, 16


def _set_mlp_flags(on):
    paddle.set_flags({"FLAGS_fused_mlp": on,
                      "FLAGS_fused_mlp_interpret": on})
    pt_set_flags({"FLAGS_fused_mlp": on})


@pytest.fixture(scope="module", autouse=True)
def reference_flags():
    old = {n: jax_get_flag(n) for n in ("flash_attention_interpret",
                                        "fused_mlp", "fused_mlp_interpret")}
    old_pt = pt_get_flag("fused_mlp")
    try:
        paddle.set_flags({"FLAGS_flash_attention_interpret": True})
        _set_mlp_flags(False)
        mesh_mod.reset_mesh()
        yield
    finally:
        paddle.set_flags({f"FLAGS_{n}": v for n, v in old.items()})
        pt_set_flags({"FLAGS_fused_mlp": old_pt})
        mesh_mod.reset_mesh()


@pytest.fixture(params=[False, True], ids=["dense_mlp", "fused_mlp"])
def mlp(request):
    _set_mlp_flags(request.param)
    try:
        yield request.param
    finally:
        _set_mlp_flags(False)


def _numpy(t):
    return np.asarray(t.numpy(), np.float32)


def _ref_model(seed=0):
    paddle.seed(seed)
    cfg = jllama.CONFIGS["tiny"]
    assert cfg.kv_heads != cfg.num_attention_heads     # GQA active
    return jllama.LlamaForCausalLM(cfg)


def _state(jmodel):
    return {k: _numpy(v) for k, v in jmodel.state_dict().items()}


def _port_model(state):
    return pllama.LlamaForCausalLM(pllama.CONFIGS["tiny"], device="cpu",
                                   dtype=torch.float32).load_numpy(state)


def _ids(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jllama.CONFIGS["tiny"].vocab_size,
                        (B, S)).astype(np.int64)


# ---------------------------------------------------------------------------
# rms_norm, RMSNorm, the rotary embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx = paddle.to_tensor(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    for jw, pw in ((None, None), (paddle.to_tensor(w), torch.from_numpy(w))):
        ref = JF.rms_norm(jx, jw, epsilon=1e-6)
        got = PF.rms_norm(px, pw, epsilon=1e-6)
        assert str(got.dtype).split(".")[-1] == str(ref.dtype).split(".")[-1]
        np.testing.assert_allclose(got.float().numpy(), _numpy(ref),
                                   atol=1e-6, rtol=1e-5)


def test_rms_norm_layer_has_a_unit_weight():
    layer = RMSNorm(64, epsilon=1e-5, device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight"]
    assert torch.equal(layer.weight, torch.ones(64))
    x = torch.randn(2, 64)
    assert torch.equal(layer(x), PF.rms_norm(x, layer.weight, 1e-5))


def _rope_inputs(seed, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, 4, d)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, d)).astype(np.float32)
    pos = np.stack([rng.permutation(40)[:S] for _ in range(B)]).astype(
        np.int64)
    return q, k, pos


@pytest.mark.parametrize("tables", ["built", "given"])
@pytest.mark.parametrize("position_ids", [False, True], ids=["arange",
                                                             "position_ids"])
@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
def test_rotary_embedding_matches_reference(neox, position_ids, tables):
    q, k, pos = _rope_inputs(3)
    kw_j, kw_p = {}, {}
    if tables == "given":
        rng = np.random.default_rng(4)
        n = 40 if position_ids else S
        sin = rng.uniform(-1, 1, (1, n, 1, 16)).astype(np.float32)
        cos = rng.uniform(-1, 1, (1, n, 1, 16)).astype(np.float32)
        kw_j = dict(sin=paddle.to_tensor(sin), cos=paddle.to_tensor(cos))
        kw_p = dict(sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
    if position_ids:
        kw_j["position_ids"] = paddle.to_tensor(pos)
        kw_p["position_ids"] = torch.from_numpy(pos)
    jq, jk, jv = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k),
        use_neox_rotary_style=neox, **kw_j)
    pq, pk, pv = PIF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k),
        use_neox_rotary_style=neox, **kw_p)
    assert jv is None and pv is None
    for got, ref in ((pq, jq), (pk, jk)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _numpy(ref), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
def test_bf16_rotary_embedding_stays_bf16(neox):
    """The recorded deviation (ROADMAP C): the reference's op promotes bf16
    q and k to f32 (its f32 tables, amp 'promote'); the port rounds the
    f32 rotation back to the input's dtype, so its outputs are the
    reference's rounded to bf16."""
    q, k, _ = _rope_inputs(5)
    jq, jk, _ = JIF.fused_rotary_position_embedding(
        paddle.to_tensor(q).astype("bfloat16"),
        paddle.to_tensor(k).astype("bfloat16"), use_neox_rotary_style=neox)
    pq, pk, _ = PIF.fused_rotary_position_embedding(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        use_neox_rotary_style=neox)
    assert str(jq.dtype).endswith("float32")
    assert str(jk.dtype).endswith("float32")
    for got, ref in ((pq, jq), (pk, jk)):
        assert got.dtype == torch.bfloat16
        ref = _numpy(ref)
        err = np.abs(got.float().numpy() - ref)
        assert (err <= 2.0 ** -8 * np.abs(ref) + 1e-30).all()


# ---------------------------------------------------------------------------
# the Layer model
# ---------------------------------------------------------------------------

def test_state_dict_keys_equal_the_reference():
    jmodel = _ref_model()
    model = pllama.LlamaForCausalLM(pllama.CONFIGS["tiny"], device="cpu",
                                    dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in jmodel.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert list(got) == list(want)
    assert got == want
    with pytest.raises(KeyError, match="lm_head.weight"):
        model.load_numpy({k: v for k, v in _state(jmodel).items()
                          if k != "lm_head.weight"})


def test_weights_carry_across_and_init_follows_the_reference():
    jmodel = _ref_model()
    state = _state(jmodel)
    model = _port_model(state)
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), state[name], err_msg=name)
    # a fresh port model draws from the reference's distributions
    cfg = pllama.CONFIGS["llama-7b"]._replace(
        num_hidden_layers=1, vocab_size=2048, hidden_size=1024,
        num_attention_heads=8, intermediate_size=2816)
    fresh = pllama.LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                                    seed=3)
    sd = fresh.state_dict()
    H, FF = cfg.hidden_size, cfg.intermediate_size
    for name, fan in (("llama.layers.0.self_attn.q_proj.weight", H + H),
                      ("llama.layers.0.mlp.down_proj.weight", FF + H),
                      ("lm_head.weight", H + cfg.vocab_size)):
        assert abs(float(sd[name].std()) / (2.0 / fan) ** 0.5 - 1) < 0.01
    assert abs(float(sd["llama.embed_tokens.weight"].std()) - 1) < 0.01
    assert torch.equal(sd["llama.norm.weight"], torch.ones(H))
    again = pllama.LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                                    seed=3)
    assert all(torch.equal(a, b) for a, b in zip(sd.values(),
                                                 again.state_dict().values()))


def test_logits_loss_and_every_gradient_match(mlp):
    jmodel = _ref_model(1)
    model = _port_model(_state(jmodel))
    ids = _ids(2)
    labels = np.roll(ids, 1, axis=1)
    jlogits = _numpy(jmodel(paddle.to_tensor(ids)))
    jloss = jmodel.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: _numpy(p.grad) for n, p in jmodel.named_parameters()}
    before = {**pfa.launches, **pmf.launches}
    logits = model(torch.from_numpy(ids))
    loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert {**pfa.launches, **pmf.launches} == before   # CPU: no launches
    assert jax_last_mlp_path() == ("fused_swiglu/interpret" if mlp
                                   else "dense")
    assert PF.last_mlp_path() == ("fused_swiglu/plain" if mlp else "dense")
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), atol=1e-5,
                               rtol=1e-4)
    for name, p in model.named_parameters():
        ref = jgrads[name]
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), (name, err)


def test_bf16_model_stays_bf16():
    """The port's bf16 model keeps bf16 through RoPE, attention and the
    MLP (the reference's promotes to f32 at RoPE, ROADMAP C); the loss is
    taken on f32 logits."""
    model = pllama.LlamaForCausalLM(pllama.CONFIGS["tiny"], device="cpu",
                                    seed=2)
    ids = torch.from_numpy(_ids(3))
    assert model(ids).dtype == torch.bfloat16
    loss = model.loss(ids, ids)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    loss.backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in model.parameters())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

ADAM_CASES = {
    "defaults": dict(dtype="float32", kw={}),
    "weight_decay": dict(dtype="float32", kw=dict(weight_decay=0.3)),
    "multi_precision_bf16": dict(dtype="bfloat16",
                                 kw=dict(multi_precision=True,
                                         weight_decay=0.3)),
}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_three_adamw_steps_match_reference(case):
    """The same parameters and the same three gradients into both
    packages' AdamW: the parameters after each step agree."""
    dtype, kw = ADAM_CASES[case]["dtype"], ADAM_CASES[case]["kw"]
    rng = np.random.default_rng(6)
    shapes = [(8, 16), (16,), (4, 4)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [JParameter(jnp.asarray(a).astype(dtype)) for a in init]
    pparams = [torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch,
                                                                 dtype)))
               for a in init]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jparams,
                                  **kw)
    popt_ = popt.AdamW(learning_rate=1e-2, parameters=pparams, **kw)
    for _ in range(3):
        for jp, pp in zip(jparams, pparams):
            g = rng.standard_normal(jp.shape).astype(np.float32)
            jp.grad = jnp.asarray(g).astype(dtype)
            pp.grad = torch.from_numpy(g).to(pp.dtype)
        jopt.step()
        popt_.step()
        jopt.clear_grad()
        popt_.clear_grad()
        assert all(p.grad is None for p in pparams)
        for jp, pp in zip(jparams, pparams):
            assert pp.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(pp.detach().float().numpy(),
                                       _numpy(jp), atol=1e-7, rtol=1e-6)
    if dtype == "bfloat16":
        for jp, pp in zip(jparams, pparams):
            jm = np.asarray(jopt._master_weights[id(jp)].numpy())
            pm = popt_._master_weights[id(pp)]
            assert pm.dtype == torch.float32
            np.testing.assert_allclose(pm.numpy(), jm, atol=1e-7, rtol=1e-6)
            assert torch.equal(pp.detach(), pm.to(torch.bfloat16))


def test_adam_folds_weight_decay_into_the_gradient():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    jp, pp = JParameter(jnp.asarray(a)), torch.nn.Parameter(
        torch.from_numpy(a.copy()))
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=[jp],
                                 weight_decay=0.5)
    popt_ = popt.Adam(learning_rate=1e-2, parameters=[pp], weight_decay=0.5)
    for _ in range(3):
        g = rng.standard_normal(a.shape).astype(np.float32)
        jp.grad, pp.grad = jnp.asarray(g), torch.from_numpy(g)
        jopt.step()
        popt_.step()
    np.testing.assert_allclose(pp.detach().numpy(), _numpy(jp), atol=1e-7,
                               rtol=1e-6)
    assert popt_.get_lr() == jopt.get_lr() == 1e-2
    popt_.set_lr(3e-3)
    assert popt_.get_lr() == 3e-3


def test_three_training_steps_match_reference(mlp):
    """The reference's training loop (tests/test_models.py:109-126):
    model.loss → backward → AdamW step → clear_grad, three times on one
    batch, the labels being the ids."""
    lr, steps = 1e-3, 3
    jmodel = _ref_model(8)
    model = _port_model(_state(jmodel))
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jmodel.parameters())
    opt = popt.AdamW(learning_rate=lr, parameters=model.parameters())
    ids = _ids(9)
    jl, pl = [], []
    for _ in range(steps):
        loss = jmodel.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = model.loss(torch.from_numpy(ids), torch.from_numpy(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        pl.append(loss.item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    ref = _state(jmodel)
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - ref[name])
        assert float(diff.max()) <= 2 * lr * steps, name
        assert float((diff > 1e-6).mean()) <= 1e-3, name


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["lr_scheduler", "grad_clip", "lr_ratio",
                                  "apply_decay_param_fun", "amsgrad",
                                  "param_groups", "set_lr_scheduler"])
def test_unported_optimizer_options_raise_naming_a5(what):
    """The options A5a ported construct and step (their values are held
    against the reference in test_torch_lr_clip.py); the ten optimizers
    of A5b-2 are ported too (held in test_torch_optimizers_more.py), so
    Adamax constructs and steps where it raised naming A5b."""
    from paddle_tpu_torch import nn as pnn
    params = [torch.nn.Parameter(torch.ones(3))]
    kw = {"lr_scheduler": dict(learning_rate=popt.lr.StepDecay(0.1, 2)),
          "grad_clip": dict(grad_clip=pnn.ClipGradByGlobalNorm(1.0)),
          "lr_ratio": dict(lr_ratio=lambda p: 0.5),
          "apply_decay_param_fun": dict(apply_decay_param_fun=lambda n: True),
          "amsgrad": dict(amsgrad=True),
          "param_groups": dict(parameters=[{"params": params}])}.get(what, {})
    kw.setdefault("parameters", params)
    opt = popt.AdamW(**kw)
    if what == "set_lr_scheduler":
        opt.set_lr_scheduler(popt.lr.StepDecay(0.1, 2))
    params[0].grad = torch.ones(3)
    opt.step()
    assert bool((params[0] < 1.0).all())
    before = params[0].detach().clone()
    popt.Adamax(parameters=params).step()
    assert bool((params[0] < before).all())
    with pytest.raises(ValueError, match="parameters is required"):
        popt.AdamW()


@pytest.mark.parametrize("cls", ["LlamaForCausalLM", "LlamaModel",
                                 "LlamaAttention", "LlamaMLP",
                                 "LlamaDecoderLayer"])
def test_tensor_parallel_raises_naming_a10(cls):
    with pytest.raises(NotImplementedError, match="A10"):
        getattr(pllama, cls)(pllama.CONFIGS["tiny"], use_tp=True,
                             device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pllama.LlamaForCausalLM(pllama.CONFIGS["tiny"])
