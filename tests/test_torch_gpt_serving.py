"""The port's GPT serving functions against the JAX reference.

The reference model's serving parameters are converted through numpy
(GPTForCausalLM.load_numpy); then prefill (last logits and per-layer
K/V), the no-cache forward, and 6 greedy decode steps through a real
BlockPool — with FLAGS_serving_decode_kernel off (composite path) and
on (the reference's Pallas kernel in interpret mode vs the port's
kernel wrapper, which takes its plain version on the CPU) — run on the
same inputs in both packages, in fp32.

Tolerances follow tests/test_mlp_fusion.py:746-749: logits atol 2e-5,
pools atol 1e-5 — the same fp32 arithmetic in other GEMM and reduction
orders. Tokens are exact. Pools are compared without the trash row,
which holds garbage by contract.
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import BlockPool as JaxBlockPool
from paddle_tpu.inference.kv_cache import kv_append as jax_kv_append
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import get_flag
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.inference import BlockPool, kv_append
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn.functional import last_mlp_path

PROMPT = np.array([5, 9, 3, 17, 2], np.int32)
N_NEW, BS, WIDTH, S_PRE = 7, 8, 2, 8   # prefill token + 6 decode steps


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jcfg = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=jnp.float32)
    jparams = jgpt.serving_params(jgpt.GPTForCausalLM(jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    pcfg = pgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=torch.float32)
    model = pgpt.GPTForCausalLM(pcfg, device="cpu").load_numpy(tree)
    return jcfg, jparams, pcfg, pgpt.serving_params(model), tree


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape,
                                                dtype=np.int32)


def test_prefill_matches_reference(models):
    jcfg, jparams, pcfg, pparams, _ = models
    ids = _ids(0, (2, 8))
    lengths = np.array([5, 8], np.int32)
    jl, jk, jv = jgpt.serving_prefill(jparams, jnp.asarray(ids),
                                      jnp.asarray(lengths), jcfg)
    pl, pk, pv = pgpt.serving_prefill(pparams, torch.from_numpy(ids),
                                      torch.from_numpy(lengths), pcfg)
    assert pl.shape == (2, 128) and pk.shape == (2, 2, 8, 4, 16)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_forward_logits_match_reference(models):
    jcfg, jparams, pcfg, pparams, _ = models
    ids = _ids(1, (1, 16))
    ref = np.asarray(jgpt.serving_forward_logits(jparams, jnp.asarray(ids),
                                                 jcfg))
    got = pgpt.serving_forward_logits(pparams, torch.from_numpy(ids), pcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_params_from_numpy_equal_load_numpy(models):
    _, _, _, pparams, tree = models
    direct = pgpt.serving_params_from_numpy(tree, device="cpu")
    assert torch.equal(direct["wte"], pparams["wte"])
    for a, b in zip(direct["blocks"], pparams["blocks"]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[n], b[n]) for n in a)


def _jax_generate(params, cfg):
    """Prefill + greedy decode through a real BlockPool (the
    test_mlp_fusion.py flow, B=1)."""
    pool = JaxBlockPool(cfg.num_layers, 16, BS, cfg.num_heads,
                        cfg.hidden_size // cfg.num_heads, dtype=jnp.float32)
    pool.alloc("r0", pool.blocks_needed(len(PROMPT) + N_NEW))
    ids = np.zeros((1, S_PRE), np.int32)
    ids[0, :len(PROMPT)] = PROMPT
    last, ks, vs = jgpt.serving_prefill(params, jnp.asarray(ids),
                                        jnp.asarray([len(PROMPT)]), cfg)
    slots = np.full((S_PRE,), pool.num_slots, np.int32)
    slots[:len(PROMPT)] = pool.slots_for("r0", 0, len(PROMPT))
    shape = (cfg.num_layers, S_PRE, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    sl = jnp.asarray(slots)
    pool.k = jax.vmap(lambda p, kv: jax_kv_append(p, kv, sl))(
        pool.k, ks.reshape(shape))
    pool.v = jax.vmap(lambda p, kv: jax_kv_append(p, kv, sl))(
        pool.v, vs.reshape(shape))
    dec = jax.jit(lambda p, kp, vp, t, po, bt: jgpt.serving_decode_step(
        p, kp, vp, t, po, bt, cfg, BS))
    bt = jnp.asarray(pool.block_table("r0", WIDTH))[None]
    tok = int(np.argmax(np.asarray(last)[0]))
    gen, rows, pos = [tok], [np.asarray(last)[0]], len(PROMPT)
    for _ in range(N_NEW - 1):
        lg, pool.k, pool.v = dec(params, pool.k, pool.v,
                                 jnp.asarray([tok], jnp.int32),
                                 jnp.asarray([pos], jnp.int32), bt)
        tok = int(np.argmax(np.asarray(lg)[0]))
        gen.append(tok)
        rows.append(np.asarray(lg)[0])
        pos += 1
    return gen, np.stack(rows), np.asarray(pool.k), np.asarray(pool.v)


def _port_generate(params, cfg):
    pool = BlockPool(cfg.num_layers, 16, BS, cfg.num_heads,
                     cfg.hidden_size // cfg.num_heads, device="cpu")
    pool.alloc("r0", pool.blocks_needed(len(PROMPT) + N_NEW))
    ids = np.zeros((1, S_PRE), np.int32)
    ids[0, :len(PROMPT)] = PROMPT
    last, ks, vs = pgpt.serving_prefill(params, torch.from_numpy(ids),
                                        torch.tensor([len(PROMPT)]), cfg)
    slots = np.full((S_PRE,), pool.num_slots, np.int32)
    slots[:len(PROMPT)] = pool.slots_for("r0", 0, len(PROMPT))
    sl = torch.from_numpy(slots)
    for layer in range(cfg.num_layers):
        kv_append(pool.k[layer], ks[layer, 0], sl)
        kv_append(pool.v[layer], vs[layer, 0], sl)
    bt = torch.from_numpy(pool.block_table("r0", WIDTH))[None]
    tok = int(torch.argmax(last[0]))
    gen, rows, pos = [tok], [last[0].numpy()], len(PROMPT)
    for _ in range(N_NEW - 1):
        lg, pool.k, pool.v = pgpt.serving_decode_step(
            params, pool.k, pool.v, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), bt, cfg, BS)
        tok = int(torch.argmax(lg[0]))
        gen.append(tok)
        rows.append(lg[0].numpy())
        pos += 1
    pool.free("r0")
    assert pool.leaked_blocks() == 0
    return gen, np.stack(rows), pool.k.numpy(), pool.v.numpy()


@pytest.mark.parametrize("kernel", [False, True], ids=["composite", "kernel"])
def test_greedy_decode_through_blockpool_matches_reference(models, kernel):
    jcfg, jparams, pcfg, pparams, _ = models
    paddle.set_flags({"FLAGS_serving_decode_kernel": kernel})
    pt_set_flags({"FLAGS_serving_decode_kernel": kernel})
    try:
        jt, jrows, jk, jv = _jax_generate(jparams, jcfg)
        pt, prows, pk, pv = _port_generate(pparams, pcfg)
        assert jgpt.last_decode_kernel_path() == (
            "kernel/interpret" if kernel else "composite")
        assert pgpt.last_decode_kernel_path() == (
            "kernel/plain" if kernel else "composite")
    finally:
        paddle.set_flags({"FLAGS_serving_decode_kernel": False})
        pt_set_flags({"FLAGS_serving_decode_kernel": False})
    assert pt == jt
    np.testing.assert_allclose(prows, jrows, atol=2e-5, rtol=0)
    np.testing.assert_allclose(pk[:, :-1], jk[:, :-1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pv[:, :-1], jv[:, :-1], atol=1e-5, rtol=0)


def test_b_gt_1_keeps_composite_with_once_warn():
    pt_set_flags({"FLAGS_serving_decode_kernel": True})
    cpu = torch.device("cpu")
    try:
        pgpt._DECODE_KERNEL_WARNED = False
        with pytest.warns(UserWarning, match="composite decode path"):
            assert pgpt._decode_kernel_mode(4, cpu) is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert pgpt._decode_kernel_mode(2, cpu) is None
        assert pgpt._decode_kernel_mode(1, cpu) == "plain"
    finally:
        pt_set_flags({"FLAGS_serving_decode_kernel": False})
        pgpt._DECODE_KERNEL_WARNED = False


def test_layer_forward_names_the_training_slice():
    cfg = pgpt.GPTConfig(vocab_size=16, hidden_size=8, num_layers=1,
                         num_heads=2, max_seq_len=8, dtype=torch.float32)
    model = pgpt.GPTForCausalLM(cfg, device="cpu", seed=1)
    names = {n for n, _ in model.named_parameters()}
    assert {"gpt.wte.weight", "gpt.blocks.0.qkv.weight",
            "gpt.ln_f.bias"} <= names
    assert model.gpt.blocks[0].qkv.weight.shape == (8, 24)   # [in, out]
    # the Layer forward is ported with the training step: it computes the
    # serving forward's function, on the dense MLP with FLAGS_fused_mlp
    # off and through nn.functional.fused_mlp (the kernels' plain
    # versions on the CPU) with it on
    ids = torch.tensor([[3, 1, 4, 1]])
    want = pgpt.serving_forward_logits(pgpt.serving_params(model), ids,
                                       cfg).numpy()
    old = get_flag("fused_mlp")
    try:
        for flag, path in ((False, "dense"), (True, "fused_mlp/plain")):
            pt_set_flags({"FLAGS_fused_mlp": flag})
            with torch.no_grad():
                np.testing.assert_allclose(model(ids).numpy(), want,
                                           atol=1e-6, rtol=0)
            assert last_mlp_path() == path
    finally:
        pt_set_flags({"FLAGS_fused_mlp": old})
