"""The port's GPT training step against the JAX reference, in fp32.

The reference's ``init_hybrid_params`` tree is carried across through
numpy (``train_params_from_numpy``), then the same seeded batch goes
through both packages. The reference runs as its own tests run it on the
CPU: ``FLAGS_flash_attention_interpret`` on, so its routing reaches the
Pallas flash kernels in interpret mode; the mesh reset, so it runs on
one device. ``FLAGS_fused_mlp`` is off by default here (the dense MLP in
both packages); the tests parametrised over ``mlp`` also run with it on,
the reference's default, with ``FLAGS_fused_mlp_interpret`` on so the
reference reaches its Pallas MLP kernels in interpret mode and the port
takes its fused route (the kernels' plain versions on the CPU). All
flags are restored afterwards.

Tolerances: logits, loss and every gradient leaf atol 1e-5 / rtol 1e-4
(the same f32 arithmetic, other GEMM and reduction orders, 4 layers).
After AdamW steps, f32 moments atol 1e-6 / rtol 1e-3. Parameters: Adam
divides each gradient by its own root-mean-square, so an entry whose
gradient is near the rounding noise moves by up to lr per step in either
package independently. Every entry is held to 2·lr·steps (the most two
independent Adam runs can part); all but 1e-4 of each leaf's entries to
2e-6; the key bias (softmax cancels it, its true gradient is 0: pure
noise) only to the first bound. bf16 moments: rtol 2^-5, four bf16 ulps
(both round the same f32 moments; a flipped rounding at step 1 carries
into step 2 through the gradient as well as the moment).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.functional.mlp import last_mlp_path as jax_last_mlp_path
from paddle_tpu_torch import get_flag as pt_get_flag
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.kernels import chunked_xent as pcx
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import mlp_fusion as pmlp
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn.functional import last_mlp_path, last_norm_path

B, LR = 2, 1e-4
POLICIES = ("dots_saveable", "save_small", "save_qkv", "save_ffn",
            "save_except_big", "full", "none")


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
    """FLAGS_fused_mlp in both packages for one test: off (the dense MLP)
    or on (the reference's interpret-mode Pallas kernels, the port's
    fused route). Yields the flag; turned off again afterwards."""
    _set_mlp_flags(request.param)
    try:
        yield request.param
    finally:
        _set_mlp_flags(False)


def _cfgs(**kw):
    return (jgpt.CONFIGS["tiny"]._replace(dtype=jnp.float32, **kw),
            pgpt.CONFIGS["tiny"]._replace(dtype=torch.float32, **kw))


def _batch(cfg, seed, s=128):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32))


def _ref_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jgpt.init_hybrid_params(jcfg, seed=seed))


def _ref_grads(tree, ids, labels, jcfg):
    loss, grads = jax.value_and_grad(jgpt.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(labels), jcfg)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_grads(tree, ids, labels, pcfg):
    params = pgpt.train_params_from_numpy(tree, device="cpu")
    leaves = pgpt._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = pgpt.loss_fn(params, torch.from_numpy(ids),
                        torch.from_numpy(labels), pcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), pgpt.train_params_to_numpy(
        pgpt._unflatten(params, grads))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(tree[k])


def _assert_trees_close(got, ref, atol, rtol):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        assert got[name].shape == r.shape, name
        np.testing.assert_allclose(got[name], r, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = _cfgs()
    tree = _ref_tree(jcfg)
    ids, labels = _batch(jcfg, 0)
    return jcfg, pcfg, tree, ids, labels


def test_params_carry_across(tiny):
    jcfg, pcfg, tree, _, _ = tiny
    params = pgpt.train_params_from_numpy(tree, device="cpu")
    assert params["blocks"]["qkv_w"].shape == (4, 128, 384)
    back = pgpt.train_params_to_numpy(params)
    _assert_trees_close(back, tree, atol=0, rtol=0)
    own = pgpt.train_params_to_numpy(
        pgpt.init_hybrid_params(pcfg, seed=0, device="cpu"))
    for name, a in _flat(tree):
        b = dict(_flat(own))[name]
        assert b.shape == a.shape and b.dtype == a.dtype, name
        if name.endswith("_w") or name in ("wte", "wpe"):
            assert 0.018 < float(b.std()) < 0.022, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_logits_loss_and_every_gradient_match(tiny, mlp):
    jcfg, pcfg, tree, ids, labels = tiny
    jlogits, _ = jgpt._forward(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(ids), jcfg, 1)
    params = pgpt.train_params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        plogits, _ = pgpt._forward(params, torch.from_numpy(ids), pcfg)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-4)
    jloss, jgrads = _ref_grads(tree, ids, labels, jcfg)
    ploss, pgrads = _port_grads(tree, ids, labels, pcfg)
    np.testing.assert_allclose(ploss, jloss, atol=1e-5, rtol=1e-4)
    _assert_trees_close(pgrads, jgrads, atol=1e-5, rtol=1e-4)
    assert jax_last_mlp_path() == ("fused_mlp/interpret" if mlp else "dense")
    assert last_mlp_path() == ("fused_mlp/plain" if mlp else "dense")


def _ref_steps(tree, ids, labels, jcfg, n):
    params = jax.tree.map(jnp.asarray, tree)
    opt = jgpt.init_opt_state(params, dtype=jcfg.opt_dtype)
    step = jgpt.make_train_step(jcfg, lr=LR)
    losses = []
    for _ in range(n):
        params, opt, loss = step(params, opt, jnp.asarray(ids),
                                 jnp.asarray(labels))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), jax.tree.map(
        np.asarray, (opt["m"], opt["v"]))


def _port_steps(tree, ids, labels, pcfg, n):
    params = pgpt.train_params_from_numpy(tree, device="cpu")
    opt = pgpt.init_opt_state(params, dtype=pcfg.opt_dtype)
    step = pgpt.make_train_step(pcfg, lr=LR)
    losses = []
    for _ in range(n):
        same, opt2, loss = step(params, opt, torch.from_numpy(ids),
                                torch.from_numpy(labels))
        assert same is params and opt2 is opt      # updated in place
        losses.append(float(loss))
    assert int(opt["step"]) == n
    return losses, pgpt.train_params_to_numpy(params), tuple(
        pgpt.train_params_to_numpy(opt[k]) for k in ("m", "v"))


def _assert_adam_params_close(got, ref, steps):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        diff = np.abs(got[name] - r)
        assert float(diff.max()) <= 2 * LR * steps, name
        if name != "blocks.qkv_b":
            assert int((diff > 2e-6).sum()) <= max(1, r.size // 10000), name


def test_three_adamw_steps_match(tiny, mlp):
    jcfg, pcfg, tree, ids, labels = tiny
    jl, jp, (jm, jv) = _ref_steps(tree, ids, labels, jcfg, 3)
    pl, pp, (pm, pv) = _port_steps(tree, ids, labels, pcfg, 3)
    np.testing.assert_allclose(pl, jl, atol=1e-5, rtol=1e-4)
    assert pl[-1] < pl[0]
    _assert_trees_close(pm, jm, atol=1e-6, rtol=1e-3)
    _assert_trees_close(pv, jv, atol=1e-6, rtol=1e-3)
    _assert_adam_params_close(pp, jp, 3)


def test_bf16_moments_match_reference(tiny):
    jcfg, pcfg, tree, ids, labels = tiny
    jcfg = jcfg._replace(num_layers=2, opt_dtype=jnp.bfloat16)
    pcfg = pcfg._replace(num_layers=2, opt_dtype=torch.bfloat16)
    tree = _ref_tree(jcfg, seed=1)
    jl, jp, (jm, jv) = _ref_steps(tree, ids, labels, jcfg, 2)
    pl, pp, (pm, pv) = _port_steps(tree, ids, labels, pcfg, 2)
    np.testing.assert_allclose(pl, jl, atol=1e-5, rtol=1e-4)
    _assert_trees_close(pm, jm, atol=1e-8, rtol=2 ** -5)
    _assert_trees_close(pv, jv, atol=1e-10, rtol=2 ** -5)
    _assert_adam_params_close(pp, jp, 2)


def test_remat_policies_give_the_same_gradients(tiny, mlp, monkeypatch):
    _, pcfg, tree, ids, labels = tiny
    runs = {"flash": 0, "mlp": 0}

    def counting(key, fn):
        def run(*args):
            runs[key] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(pfa, "flash_fwd_ref",
                        counting("flash", pfa.flash_fwd_ref))
    monkeypatch.setattr(pmlp, "fused_mlp_fwd_ref",
                        counting("mlp", pmlp.fused_mlp_fwd_ref))
    results = {}
    L = pcfg.num_layers
    for policy in POLICIES:
        runs.update(flash=0, mlp=0)
        results[policy] = _port_grads(tree, ids, labels,
                                      pcfg._replace(remat_policy=policy))
        # every policy but 'full' keeps the flash forward's (out, lse):
        # the forward runs once per layer, 'full' re-runs it in backward.
        # The fused MLP forward's output is fc2_out: kept by the save_*
        # policies, re-run under 'full' and 'dots_saveable'
        assert runs["flash"] == L * (2 if policy == "full" else 1)
        again = policy in ("full", "dots_saveable")
        assert runs["mlp"] == (L * (2 if again else 1) if mlp else 0)
    base_loss, base = results["none"]
    for policy, (loss, grads) in results.items():
        assert loss == pytest.approx(base_loss, abs=1e-6), policy
        _assert_trees_close(grads, base, atol=1e-6, rtol=1e-5)


# per layer, the products each policy recomputes in the backward: (qkv,
# proj, fc1, fc2 addmm; GeLU; flash forward; fused MLP forward), with the
# dense MLP and with the fused one. Only what a backward needs is
# recomputed: fc2's output never is; the GeLU's backward needs fc1's
# output; the flash backward needs q/k/v, which save_except_big keeps as
# the copies the flash op takes, so with the dense MLP its qkv product is
# never needed. The fused MLP op saves its inputs only after it has run,
# so the recompute runs it again unless the policy saves its output
# (fc2_out); with it the recompute under save_except_big also redoes the
# qkv product.
RECOMPUTED = {
    False: {"none": (0, 0, 0, 0), "full": (3, 1, 1, 0),
            "dots_saveable": (0, 1, 0, 0), "save_small": (2, 1, 0, 0),
            "save_qkv": (1, 1, 0, 0), "save_ffn": (2, 0, 0, 0),
            "save_except_big": (1, 1, 0, 0)},
    True: {"none": (0, 0, 0, 0), "full": (2, 0, 1, 1),
           "dots_saveable": (0, 0, 0, 1), "save_small": (1, 0, 0, 0),
           "save_qkv": (0, 0, 0, 0), "save_ffn": (1, 0, 0, 0),
           "save_except_big": (1, 0, 0, 0)}}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_saves_the_reference_names(policy, mlp):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    _, pcfg = _cfgs(num_layers=1, remat_policy=policy)
    params = pgpt.init_hybrid_params(pcfg, seed=0, device="cpu")
    leaves = pgpt._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ids, labels = map(torch.from_numpy, _batch(pcfg, 6))
    loss = pgpt.loss_fn(params, ids, labels, pcfg)
    with Count() as seen:
        torch.autograd.grad(loss, leaves)
    ops = (torch.ops.aten.addmm.default, torch.ops.aten.gelu.default,
           torch.ops.paddle_tpu_torch.flash_fwd.default,
           torch.ops.paddle_tpu_torch.fused_mlp_fwd.default)
    assert tuple(seen.ops.count(op) for op in ops) == RECOMPUTED[mlp][policy]


def test_unknown_remat_policy_raises_the_reference_error(tiny):
    jcfg, pcfg, tree, ids, labels = tiny
    with pytest.raises(ValueError) as jerr:
        _ref_grads(tree, ids, labels, jcfg._replace(remat_policy="bogus"))
    with pytest.raises(ValueError) as terr:
        _port_grads(tree, ids, labels, pcfg._replace(remat_policy="bogus"))
    assert str(terr.value) == str(jerr.value)


def test_chunked_head_matches_reference(monkeypatch):
    jcfg, pcfg = _cfgs(vocab_size=8192, num_layers=2, lm_head="chunked")
    tree = _ref_tree(jcfg, seed=2)
    ids, labels = _batch(jcfg, 2)
    calls = []
    chunked = pcx.chunked_softmax_xent
    monkeypatch.setattr(pgpt, "chunked_softmax_xent",
                        lambda *a: calls.append(1) or chunked(*a))
    jloss, jgrads = _ref_grads(tree, ids, labels, jcfg)
    ploss, pgrads = _port_grads(tree, ids, labels, pcfg)
    assert calls == [1]
    np.testing.assert_allclose(ploss, jloss, atol=1e-5, rtol=1e-4)
    _assert_trees_close(pgrads, jgrads, atol=1e-5, rtol=1e-4)
    plain, _ = _port_grads(tree, ids, labels, pcfg._replace(lm_head="plain"))
    assert plain == pytest.approx(ploss, abs=1e-5)


def test_dense_attention_branch_at_s120():
    jcfg, pcfg = _cfgs(num_layers=2)
    tree = _ref_tree(jcfg, seed=3)
    ids, labels = _batch(jcfg, 3, s=120)
    assert pgpt._attn_mode(120, 32) is None and jgpt._attn_mode(120, 32) is None
    jloss, jgrads = _ref_grads(tree, ids, labels, jcfg)
    ploss, pgrads = _port_grads(tree, ids, labels, pcfg)
    np.testing.assert_allclose(ploss, jloss, atol=1e-5, rtol=1e-4)
    _assert_trees_close(pgrads, jgrads, atol=1e-5, rtol=1e-4)


def test_head_pack_matches_packed_reference():
    jcfg, pcfg = _cfgs(num_layers=2, head_pack=64)
    tree = _ref_tree(jcfg, seed=4)
    assert tree["blocks"]["qkv_w"].shape == (1, 2, 128, 3 * 4 * 64)
    ids, labels = _batch(jcfg, 4)
    jloss, jgrads = _ref_grads(tree, ids, labels, jcfg)
    ploss, pgrads = _port_grads(tree, ids, labels, pcfg)
    np.testing.assert_allclose(ploss, jloss, atol=1e-5, rtol=1e-4)
    _assert_trees_close(pgrads, jgrads, atol=1e-5, rtol=1e-4)
    gq = pgrads["blocks"]["qkv_w"].reshape(1, 2, 128, 3, 4, 64)
    assert float(np.abs(gq[..., 32:]).max()) == 0.0
    own = pgpt.init_hybrid_params(pcfg, seed=0, device="cpu")["blocks"]
    assert float(own["qkv_w"].reshape(2, 128, 3, 4, 64)[..., 32:].abs()
                 .max()) == 0.0
    assert float(own["proj_w"].reshape(2, 4, 64, 128)[:, :, 32:].abs()
                 .max()) == 0.0


def test_layer_model_matches_reference_layer_model(mlp):
    jcfg, pcfg = _cfgs(num_layers=2)
    paddle.seed(11)
    jmodel = jgpt.GPTForCausalLM(jcfg)
    tree = jax.tree.map(np.asarray, jgpt.serving_params(jmodel))
    model = pgpt.GPTForCausalLM(pcfg, device="cpu").load_numpy(tree)
    ids, labels = _batch(jcfg, 5)
    jlogits = np.asarray(jmodel(paddle.to_tensor(ids)).numpy())
    jloss = float(jmodel.loss(paddle.to_tensor(ids),
                              paddle.to_tensor(labels.astype(np.int64)))
                  .numpy())
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        loss = model.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    # the Layer model's logits reach ~108, where one f32 rounding is
    # ~1e-5: the dense MLP reads 0.91 of atol 1e-5 here, the fused route
    # (other summation orders in both packages' fused MLP) 1.07; the
    # fused case is held to 3e-5
    atol = 3e-5 if mlp else 1e-5
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=atol, rtol=1e-4)
    np.testing.assert_allclose(float(loss), jloss, atol=1e-5, rtol=1e-4)
    assert jax_last_mlp_path() == ("fused_mlp/interpret" if mlp else "dense")
    assert last_mlp_path() == ("fused_mlp/plain" if mlp else "dense")
    # the Layer model's norms take the fused LayerNorm route, as the
    # reference's nn.LayerNorm does at the default FLAGS_fused_norm
    assert last_norm_path() == "fused_ln/plain"


@pytest.mark.parametrize("what", ["vpp_chunks", "moe_experts", "n_micro"])
def test_multi_device_options_raise(what, tiny):
    _, pcfg, tree, ids, labels = tiny
    if what == "n_micro":
        with pytest.raises(NotImplementedError, match="A10"):
            pgpt.make_train_step(pcfg, n_micro=2)
        return
    cfg = pcfg._replace(**{what: 2})
    with pytest.raises(NotImplementedError, match="A10"):
        pgpt.init_hybrid_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        pgpt.make_train_step(cfg)
