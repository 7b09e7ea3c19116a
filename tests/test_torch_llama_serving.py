"""The port's LLaMA serving functions against the JAX reference.

The reference's tiny LLaMA (GQA: 4 query heads over 2 K/V heads) is
carried across through numpy (``state_dict`` → ``load_numpy``); then the
no-cache forward, prefill (last logits and the post-RoPE K/V), the RoPE
tables, and 6 greedy decode steps through a real BlockPool of KVH=2
heads run on the same inputs in both packages, in fp32. The decode step
is held against the reference's decode step, not the full forward (the
reference's own decode-vs-forward test misses its 2e-5 atol).

Tolerances follow tests/test_torch_gpt_serving.py: logits atol 2e-5,
pools atol 1e-5 (the same fp32 arithmetic in other GEMM and reduction
orders); RoPE tables atol 1e-6 (sin and cos in another libm). Tokens are
exact. Pools are compared without the trash row, garbage by contract.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import BlockPool as JaxBlockPool
from paddle_tpu.inference.kv_cache import kv_append as jax_kv_append
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import BlockPool, kv_append
from paddle_tpu_torch.models import llama as pllama

PROMPT = np.array([5, 9, 3, 17, 2, 44, 301], np.int32)
N_NEW, BS, WIDTH, S_PRE = 7, 8, 2, 8   # prefill token + 6 decode steps


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    cfg = jllama.CONFIGS["tiny"]
    assert cfg.kv_heads != cfg.num_attention_heads      # GQA active
    jmodel = jllama.LlamaForCausalLM(cfg)
    jparams = jllama.llama_serving_params(jmodel)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jmodel.state_dict().items()}
    pmodel = pllama.LlamaForCausalLM(pllama.CONFIGS["tiny"], device="cpu",
                                     dtype=torch.float32).load_numpy(state)
    return (cfg, jparams, pmodel, pllama.llama_serving_params(pmodel),
            jax.tree.map(np.asarray, jparams))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, size=shape,
                                                dtype=np.int32)


def test_serving_params_are_views_and_match_the_reference_tree(models):
    _, _, pmodel, pparams, tree = models
    layer = pmodel.llama.layers[1]
    assert pparams["blocks"][1]["k_w"].data_ptr() == \
        layer.self_attn.k_proj.weight.data_ptr()
    assert pparams["head_w"].data_ptr() == pmodel.lm_head.weight.data_ptr()
    assert pparams["blocks"][0]["k_w"].shape == (64, 32)    # KVH * D
    direct = pllama.llama_serving_params_from_numpy(tree, device="cpu")
    for name in ("embed", "norm_g", "head_w"):
        assert torch.equal(direct[name], pparams[name]), name
    for a, b in zip(direct["blocks"], pparams["blocks"]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[n], b[n]) for n in a)
    for name in ("rope_sin", "rope_cos"):
        assert pparams[name].dtype == torch.float32
        assert pparams[name].shape == (64, 16)
        np.testing.assert_allclose(pparams[name].numpy(), tree[name],
                                   atol=1e-6, rtol=0)


def test_prefill_matches_reference(models):
    cfg, jparams, pmodel, pparams, _ = models
    ids = _ids(0, (2, 8))
    lengths = np.array([5, 8], np.int32)
    jl, jk, jv = jllama.llama_serving_prefill(
        jparams, jnp.asarray(ids), jnp.asarray(lengths), cfg)
    pl, pk, pv = pllama.llama_serving_prefill(
        pparams, torch.from_numpy(ids), torch.from_numpy(lengths), pmodel.cfg)
    assert pl.shape == (2, 512) and pk.shape == (2, 2, 8, 2, 16)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_forward_logits_match_reference(models):
    cfg, jparams, pmodel, pparams, _ = models
    ids = _ids(1, (1, 24))
    ref = np.asarray(jllama.llama_serving_forward_logits(
        jparams, jnp.asarray(ids), cfg))
    got = pllama.llama_serving_forward_logits(pparams, torch.from_numpy(ids),
                                              pmodel.cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_serving_forward_is_the_layer_forward(models):
    """The serving tree computes the Layer model's function."""
    _, _, pmodel, pparams, _ = models
    ids = torch.from_numpy(_ids(2, (2, 12)))
    with torch.no_grad():
        want = pmodel(ids)
    got = pllama.llama_serving_forward_logits(pparams, ids, pmodel.cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def _jax_generate(params, cfg):
    KVH, D = cfg.kv_heads, cfg.hidden_size // cfg.num_attention_heads
    pool = JaxBlockPool(cfg.num_hidden_layers, 16, BS, KVH, D,
                        dtype=jnp.float32)
    pool.alloc("r0", pool.blocks_needed(len(PROMPT) + N_NEW))
    ids = np.zeros((1, S_PRE), np.int32)
    ids[0, :len(PROMPT)] = PROMPT
    last, ks, vs = jllama.llama_serving_prefill(
        params, jnp.asarray(ids), jnp.asarray([len(PROMPT)]), cfg)
    slots = np.full((S_PRE,), pool.num_slots, np.int32)
    slots[:len(PROMPT)] = pool.slots_for("r0", 0, len(PROMPT))
    sl = jnp.asarray(slots)
    shape = (cfg.num_hidden_layers, S_PRE, KVH, D)
    pool.k = jax.vmap(lambda p, kv: jax_kv_append(p, kv, sl))(
        pool.k, ks.reshape(shape))
    pool.v = jax.vmap(lambda p, kv: jax_kv_append(p, kv, sl))(
        pool.v, vs.reshape(shape))
    dec = jax.jit(lambda p, kp, vp, t, po, bt:
                  jllama.llama_serving_decode_step(p, kp, vp, t, po, bt, cfg,
                                                   BS))
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
    KVH, D = cfg.kv_heads, cfg.hidden_size // cfg.num_attention_heads
    pool = BlockPool(cfg.num_hidden_layers, 16, BS, KVH, D, device="cpu")
    pool.alloc("r0", pool.blocks_needed(len(PROMPT) + N_NEW))
    ids = np.zeros((1, S_PRE), np.int32)
    ids[0, :len(PROMPT)] = PROMPT
    last, ks, vs = pllama.llama_serving_prefill(
        params, torch.from_numpy(ids), torch.tensor([len(PROMPT)]), cfg)
    slots = np.full((S_PRE,), pool.num_slots, np.int32)
    slots[:len(PROMPT)] = pool.slots_for("r0", 0, len(PROMPT))
    sl = torch.from_numpy(slots)
    for layer in range(cfg.num_hidden_layers):
        kv_append(pool.k[layer], ks[layer, 0], sl)
        kv_append(pool.v[layer], vs[layer, 0], sl)
    bt = torch.from_numpy(pool.block_table("r0", WIDTH))[None]
    tok = int(torch.argmax(last[0]))
    gen, rows, pos = [tok], [last[0].numpy()], len(PROMPT)
    for _ in range(N_NEW - 1):
        lg, pool.k, pool.v = pllama.llama_serving_decode_step(
            params, pool.k, pool.v, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), bt, cfg, BS)
        tok = int(torch.argmax(lg[0]))
        gen.append(tok)
        rows.append(lg[0].numpy())
        pos += 1
    pool.free("r0")
    assert pool.leaked_blocks() == 0
    return gen, np.stack(rows), pool.k.numpy(), pool.v.numpy()


def test_greedy_decode_through_gqa_blockpool_matches_reference(models):
    cfg, jparams, pmodel, pparams, _ = models
    jt, jrows, jk, jv = _jax_generate(jparams, cfg)
    pt, prows, pk, pv = _port_generate(pparams, pmodel.cfg)
    assert pk.shape[2] == cfg.kv_heads        # the pool holds KVH heads
    assert pt == jt
    np.testing.assert_allclose(prows, jrows, atol=2e-5, rtol=0)
    np.testing.assert_allclose(pk[:, :-1], jk[:, :-1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pv[:, :-1], jv[:, :-1], atol=1e-5, rtol=0)


def test_decode_step_pad_lane_writes_only_the_trash_row(models):
    """A B=2 decode step whose second lane is a pad lane (table all
    num_blocks, position 0): the real lane's logits and K/V row match the
    B=1 step's (another GEMM shape: atol 1e-6), and no slot but those two
    rows changes."""
    _, _, pmodel, pparams, _ = models
    cfg = pmodel.cfg
    KVH, D = cfg.kv_heads, cfg.hidden_size // cfg.num_attention_heads
    g = torch.Generator().manual_seed(3)
    pools = [torch.randn(cfg.num_hidden_layers, 16 * BS + 1, KVH, D,
                         generator=g) for _ in range(2)]
    bt1 = torch.tensor([[3, 5]], dtype=torch.int32)
    tok = torch.tensor([7], dtype=torch.int32)
    pos = torch.tensor([10], dtype=torch.int32)
    k1, v1 = (p.clone() for p in pools)
    want, k1, v1 = pllama.llama_serving_decode_step(pparams, k1, v1, tok, pos,
                                                    bt1, cfg, BS)
    k2, v2 = (p.clone() for p in pools)
    bt2 = torch.cat([bt1, torch.full((1, 2), 16, dtype=torch.int32)])
    got, k2, v2 = pllama.llama_serving_decode_step(
        pparams, k2, v2, torch.tensor([7, 0], dtype=torch.int32),
        torch.tensor([10, 0], dtype=torch.int32), bt2, cfg, BS)
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    real = 5 * BS + 10 % BS                 # the real lane's new slot
    for before, one, two in zip(pools, (k1, v1), (k2, v2)):
        np.testing.assert_allclose(two[:, real].numpy(), one[:, real].numpy(),
                                   atol=1e-6, rtol=0)
        keep = torch.ones(before.shape[1], dtype=torch.bool)
        keep[[real, -1]] = False
        assert torch.equal(two[:, keep], before[:, keep])
