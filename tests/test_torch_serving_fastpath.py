"""The serving fast path against the JAX reference: chunk steps,
``kv_copy``, ``chunk_spans``, the refcounted ``BlockPool`` and
``PrefixCache``, ``draft_window``, and the engine with chunked prefill,
the prefix cache and speculative decoding.

Models, carried across through numpy: the reference's tiny LLaMA (GQA,
through ``llama_adapter``) and the tiny GPT of the reference's fast-path
tests (tests/test_serving.py ``gpt64``: vocab 128, H 64, 2 layers, 64
positions) with its independent draft (H 32, 1 layer). Everything runs in
fp32 on the CPU; the reference engines jit their steps as they do in
their own tests.

Tolerances follow tests/test_torch_gpt_serving.py: logits atol 2e-5,
pools atol 1e-5 (the same fp32 arithmetic in other GEMM and reduction
orders), pools compared without the trash row (garbage by contract).
Token streams, states, counters, block ids and refcounts are exact.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import BlockPool as JBlockPool
from paddle_tpu.inference import PrefixCache as JPrefixCache
from paddle_tpu.inference import SamplingParams as JSampling
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference import SpeculativeConfig as JSpec
from paddle_tpu.inference import gpt_adapter as j_gpt_adapter
from paddle_tpu.inference import llama_adapter as j_llama_adapter
from paddle_tpu.inference.batching import chunk_spans as j_chunk_spans
from paddle_tpu.inference.device_loop import draft_window as j_draft_window
from paddle_tpu.inference.kv_cache import kv_copy as j_kv_copy
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.inference import (BlockPool, CacheExhaustedError,
                                        ModelAdapter, PrefixCache,
                                        SamplingParams, ServingEngine,
                                        SpeculativeConfig, chunk_spans,
                                        gpt_adapter, kv_copy, llama_adapter)
from paddle_tpu_torch.inference.device_loop import draft_window
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.models import llama as pllama

BS = 8
ENGINE = dict(num_blocks=32, block_size=BS, max_model_len=64, max_batch=4)


@pytest.fixture(scope="module")
def gpt64():
    """(reference target, port target, reference draft, port draft)."""
    def pair(seed, **kw):
        paddle.seed(seed)
        jcfg = jgpt.GPTConfig(vocab_size=128, max_seq_len=64,
                              dtype=jnp.float32, **kw)
        jmodel = jgpt.GPTForCausalLM(jcfg)
        tree = jax.tree.map(np.asarray, jgpt.serving_params(jmodel))
        pcfg = pgpt.GPTConfig(vocab_size=128, max_seq_len=64,
                              dtype=torch.float32, **kw)
        return jmodel, pgpt.GPTForCausalLM(pcfg, device="cpu").load_numpy(
            tree)
    target = pair(7, hidden_size=64, num_layers=2, num_heads=4)
    draft = pair(11, hidden_size=32, num_layers=1, num_heads=2)
    return target + draft


@pytest.fixture(scope="module")
def llama_tiny():
    """(reference model, port model): tiny LLaMA, GQA 4 / 2 heads."""
    paddle.seed(7)
    jmodel = jllama.LlamaForCausalLM(jllama.CONFIGS["tiny"])
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jmodel.state_dict().items()}
    return jmodel, pllama.LlamaForCausalLM(
        pllama.CONFIGS["tiny"], device="cpu",
        dtype=torch.float32).load_numpy(state)


def _prompts():
    """A 43-token donor; the donor again (5 full blocks shared); the
    donor's first 38 tokens + 1 (4 full blocks + 6 copied rows); two
    unrelated prompts, one of them 23 tokens (3 chunks of 8)."""
    rng = np.random.default_rng(3)
    donor = rng.integers(0, 128, size=43).astype(np.int32)
    cow = np.concatenate([donor[:38], [9]]).astype(np.int32)
    return [[donor], [donor.copy(), cow,
                      rng.integers(0, 128, size=5).astype(np.int32),
                      rng.integers(0, 128, size=23).astype(np.int32)]]


def _serve(engine, sampling_cls, waves, max_new=6):
    """Each wave submitted whole, then run until idle."""
    reqs = []
    for w, wave in enumerate(waves):
        for i, prompt in enumerate(wave):
            reqs.append(engine.submit(prompt, sampling_cls(max_new),
                                      request_id=f"w{w}-{i}"))
        engine.run_until_idle()
    return reqs, engine.stats()


COUNTERS = ("prefills", "decode_steps", "tokens_generated", "finished",
            "prefill_chunks", "chunk_tokens", "prefix_recompute_tokens",
            "spec_drafted", "spec_accepted", "spec_verify_steps",
            "device_loop_windows", "device_loop_tokens", "leaked_blocks",
            "draft_leaked_blocks")
PREFIX_STATS = ("hits", "misses", "tokens_reused", "cow_tokens",
                "evictions", "cached_blocks")


def _same_run(jreqs, jst, preqs, pst):
    for j, p in zip(jreqs, preqs):
        assert p.tokens == j.tokens, p.request_id
        assert (p.state, p.finish_reason) == (j.state, j.finish_reason)
        assert p.reused_tokens == j.reused_tokens, p.request_id
    for key in COUNTERS:
        assert pst.get(key) == jst.get(key), key
    if "prefix_cache" in jst:
        for key in PREFIX_STATS:
            assert pst["prefix_cache"][key] == jst["prefix_cache"][key], key
    assert pst["pool"]["free_blocks"] == jst["pool"]["free_blocks"]
    assert pst["leaked_blocks"] == 0
    assert pst.get("draft_leaked_blocks", 0) == 0


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------

def test_chunk_spans_match_reference():
    for chunk in (1, 3, 8, 16):
        for n in range(1, 70):
            assert chunk_spans(n, chunk) == j_chunk_spans(n, chunk)
    assert chunk_spans(37, 16) == [(0, 16), (16, 32), (32, 37)]
    for bad in ((0, 16), (5, 0)):
        with pytest.raises(ValueError):
            chunk_spans(*bad)
        with pytest.raises(ValueError):
            j_chunk_spans(*bad)


@pytest.mark.parametrize("case", ["unit", "block_with_pads"])
def test_kv_copy_matches_reference(case):
    """Source rows are read (clipped onto the trash row) before any
    destination is written (past the trash row: dropped)."""
    if case == "unit":
        base = np.arange(36, dtype=np.float32).reshape(9, 2, 2)
        src = np.array([0, 1, 9], np.int32)    # 9 clips to row 8
        dst = np.array([4, 0, 10], np.int32)   # 10 drops
    else:   # the engine's copy-on-write shape: m = 5 of an 8-row block
        base = np.random.default_rng(0).standard_normal(
            (4 * BS + 1, 2, 4)).astype(np.float32)
        src = np.full((BS,), 4 * BS, np.int32)
        dst = np.full((BS,), 4 * BS + 1, np.int32)
        src[:5] = 1 * BS + np.arange(5)
        dst[:5] = 3 * BS + np.arange(5)
    want = np.asarray(j_kv_copy(jnp.asarray(base), jnp.asarray(src),
                                jnp.asarray(dst)))
    pool = torch.from_numpy(base.copy())
    out = kv_copy(pool, torch.from_numpy(src), torch.from_numpy(dst))
    assert out is pool                       # in place
    np.testing.assert_array_equal(pool.numpy(), want)


def _trie_script(pool_cls, cache_cls, exhausted, dtype):
    """The reference's refcount/trie unit test (tests/test_serving.py
    :1017) as a script; returns what it observes after each step."""
    seen = []
    pool = pool_cls(1, 8, 4, 1, 4, dtype=dtype)
    cache = cache_cls(pool)
    seen.append(pool.alloc("a", 3))
    blocks = pool.owned("a")
    cache.insert(np.arange(9, dtype=np.int32), blocks)
    seen.append((len(cache), sorted(cache.blocks()),
                 [pool.refcount(b) for b in range(8)]))
    seen.append(cache.match(np.arange(8, dtype=np.int32)))
    seen.append(cache.match(np.arange(9, dtype=np.int32)))
    seen.append(cache.match(np.arange(4, 12, dtype=np.int32)))
    seen.append(cache.warm_prefix_tokens(np.arange(12, dtype=np.int32)))
    seen.append(sorted(cache.block_keys()))
    seen.append(pool.alloc_shared("b", blocks[:2], 1))
    with pytest.raises(exhausted):
        pool.alloc_shared("c", blocks[:1], 99)
    with pytest.raises(ValueError):
        pool.alloc_shared("b", blocks[:1], 1)        # duplicate owner
    with pytest.raises(ValueError):
        pool.alloc_shared("d", [7], 1)               # a block not live
    seen.append([pool.refcount(b) for b in range(8)])
    seen.append(pool.free("b"))
    seen.append(pool.free("a"))
    seen.append([pool.refcount(b) for b in range(8)])
    seen.append((pool.leaked_blocks(live_owners=(), cached=cache.blocks()),
                 pool.leaked_blocks(live_owners=(), cached=())))
    pool.alloc("e", 5)
    seen.append((pool.free_blocks, cache.evict_for(7), pool.free_blocks))
    seen.append(cache.evict_for(pool.num_blocks, keep=()))  # e holds 5
    pool.free("e")
    seen.append((cache.evict_for(pool.num_blocks, keep=()),
                 len(cache), pool.free_blocks))
    st = cache.stats()
    seen.append((st, pool.leaked_blocks(), pool.stats()["shared_refs"]))
    return seen


def test_prefix_cache_trie_and_pool_refcounts_match_reference():
    port = _trie_script(
        lambda *a, dtype: BlockPool(*a, dtype=dtype, device="cpu"),
        PrefixCache, CacheExhaustedError, torch.float32)
    from paddle_tpu.inference import CacheExhaustedError as JExhausted
    ref = _trie_script(JBlockPool, JPrefixCache, JExhausted, jnp.float32)
    assert port == ref
    # the reference test's own claims, on the port's run
    blocks = port[0]
    assert port[1][0] == 2 and port[1][2][blocks[0]] == 2  # owner + trie
    assert port[2] == (blocks[:1], (blocks[1], 3))         # capped at len-1
    assert port[3][0] == blocks[:2] and port[4] == ([], None)
    assert port[8][blocks[0]] == 3                         # failed: no move
    assert port[11][blocks[0]] == 1                        # the trie's ref
    assert port[12] == (0, 2)                              # both directions
    assert port[13] == (1, False, 3) and port[14] is False  # e holds 5
    assert port[15] == (True, 0, 8)
    assert port[16][0]["evictions"] == 2 and port[16][1] == 0


# ---------------------------------------------------------------------------
# the device steps
# ---------------------------------------------------------------------------

def _chunk_calls(pool_cls, ctx):
    """Two chunk calls through one pool: positions [0, 5) of request r
    padded to Q=8 (pad rows: id 0, position ctx, the trash slot), then a
    B=2 verify-shaped call — r's rows 5..8 and a pad lane."""
    rng = np.random.default_rng(5)
    pool = pool_cls()
    pool.alloc("r", 2)
    table = pool.block_table("r", 2)
    ids = np.zeros((1, 8), np.int32)
    ids[0, :5] = rng.integers(0, 128, 5)
    pos = np.full((1, 8), ctx, np.int32)
    pos[0, :5] = np.arange(5)
    slots = np.full((1, 8), pool.num_slots, np.int32)
    slots[0, :5] = pool.slots_for("r", 0, 5)
    ids2 = np.zeros((2, 4), np.int32)
    ids2[0] = rng.integers(0, 128, 4)
    pos2 = np.full((2, 4), ctx, np.int32)
    pos2[0] = 5 + np.arange(4)
    slots2 = np.full((2, 4), pool.num_slots, np.int32)
    slots2[0] = pool.slots_for("r", 5, 9)
    tables2 = np.stack([table, pool.pad_block_table(2)])
    return pool, [(ids, pos, slots, table[None]),
                  (ids2, pos2, slots2, tables2)], [5, 4]


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_chunk_step_matches_reference(gpt64, llama_tiny, arch):
    if arch == "gpt":
        jmodel, pmodel = gpt64[:2]
        jad, pad = j_gpt_adapter(jmodel), gpt_adapter(pmodel)
    else:
        jmodel, pmodel = llama_tiny
        jad, pad = j_llama_adapter(jmodel), llama_adapter(pmodel)
    geo = (pad.num_layers, 4, BS, pad.num_kv_heads, pad.head_dim)
    jpool, calls, real = _chunk_calls(
        lambda: JBlockPool(*geo, dtype=jnp.float32), 2 * BS)
    ppool, _, _ = _chunk_calls(lambda: BlockPool(*geo, device="cpu"), 2 * BS)
    for (ids, pos, slots, tables), n in zip(calls, real):
        jl, jpool.k, jpool.v = jad.chunk(
            jad.params, jpool.k, jpool.v, *(jnp.asarray(a) for a in (
                ids, pos, slots, tables)), BS)
        pl, ppool.k, ppool.v = pad.chunk(
            pad.params, ppool.k, ppool.v, *(torch.from_numpy(a) for a in (
                ids, pos, slots, tables)), BS)
        assert pl.shape == ids.shape + (pad.vocab_size,)
        np.testing.assert_allclose(pl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                   atol=2e-5, rtol=0)
        for p, j in ((ppool.k, jpool.k), (ppool.v, jpool.v)):
            np.testing.assert_allclose(p[:, :-1].numpy(),
                                       np.asarray(j)[:, :-1], atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("kernel", [False, True],
                         ids=["b2_composite", "b1_kernel"])
def test_draft_window_matches_reference(gpt64, kernel):
    """k=3 greedy draft steps; one lane passes its write limit mid-window
    (its later writes go to the trash row). B=1 with
    FLAGS_serving_decode_kernel on takes the decode kernel's wrapper (its
    plain version on the CPU) at every step."""
    jmodel, pmodel = gpt64[:2]
    jad, pad = j_gpt_adapter(jmodel), gpt_adapter(pmodel)
    B = 1 if kernel else 2
    geo = (pad.num_layers, 8, BS, pad.num_kv_heads, pad.head_dim)
    pools = []
    for cls in (lambda: JBlockPool(*geo, dtype=jnp.float32),
                lambda: BlockPool(*geo, device="cpu")):
        pool = cls()
        for i in range(B):
            pool.alloc(f"r{i}", 3)
        pools.append(pool)
    rng = np.random.default_rng(1)
    base = rng.standard_normal(np.asarray(pools[0].k).shape).astype(
        np.float32)
    jpool, ppool = pools
    jpool.k, jpool.v = jnp.asarray(base), jnp.asarray(base * 0.5)
    ppool.k, ppool.v = torch.from_numpy(base.copy()), torch.from_numpy(
        base * 0.5)
    tables = np.stack([ppool.block_table(f"r{i}", 3) for i in range(B)])
    tokens = np.array([17, 3][:B], np.int32)
    positions = np.array([9, 20][:B], np.int32)
    limits = np.array([10, 30][:B], np.int32)   # lane 0 stops at 10
    paddle.set_flags({"FLAGS_serving_decode_kernel": kernel})
    pt_set_flags({"FLAGS_serving_decode_kernel": kernel})
    try:
        jd, jk, jv = j_draft_window(
            lambda p, kk, vv, tt, oo, bb: jad.decode(p, kk, vv, tt, oo, bb,
                                                     BS),
            jad.params, jpool.k, jpool.v, jnp.asarray(tokens),
            jnp.asarray(positions), jnp.asarray(tables),
            jnp.asarray(limits), 8, 3, BS)
        pd, pk, pv = draft_window(
            lambda p, kk, vv, tt, oo, bb: pad.decode(p, kk, vv, tt, oo, bb,
                                                     BS),
            pad.params, ppool.k, ppool.v, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(tables),
            torch.from_numpy(limits), 8, 3, BS)
        assert pgpt.last_decode_kernel_path() == (
            "kernel/plain" if kernel else "composite")
    finally:
        paddle.set_flags({"FLAGS_serving_decode_kernel": False})
        pt_set_flags({"FLAGS_serving_decode_kernel": False})
    assert pd.dtype == torch.int32 and pd.shape == (B, 3)
    assert pd.numpy().tolist() == np.asarray(jd).tolist()
    for p, j in ((pk, jk), (pv, jv)):
        np.testing.assert_allclose(p[:, :-1].numpy(), np.asarray(j)[:, :-1],
                                   atol=1e-5, rtol=0)
    # lane 0 wrote positions 9 and 10 only: 11 stayed as it was
    slot11 = tables[0, 11 // BS] * BS + 11 % BS
    assert torch.equal(pk[:, slot11], torch.from_numpy(base[:, slot11]))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

RUNS = {
    "llama_plain": dict(),
    "llama_chunk8": dict(prefill_chunk=8),
    "llama_prefix_cow": dict(prefix_cache=True),
    "llama_spec_k2": dict(spec=2),
    "llama_spec_k3": dict(spec=3),
    "llama_spec_k2_host_loop": dict(spec=2, device_loop=False),
    "llama_all": dict(prefill_chunk=8, prefix_cache=True, spec=3),
    "gpt_all_independent_draft": dict(prefill_chunk=8, prefix_cache=True,
                                      spec=2),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_engine_streams_match_reference(gpt64, llama_tiny, run):
    kw = dict(RUNS[run])
    k = kw.pop("spec", None)
    loop = kw.pop("device_loop", True)
    if run.startswith("gpt"):
        jm, pm, jdraft, pdraft = gpt64
        jad, pad = j_gpt_adapter, gpt_adapter
    else:
        (jm, pm), (jdraft, pdraft) = llama_tiny, llama_tiny  # self-draft
        jad, pad = j_llama_adapter, llama_adapter
    paddle.set_flags({"FLAGS_serving_device_loop": loop})
    pt_set_flags({"FLAGS_serving_device_loop": loop})
    try:
        jspec = dict(speculative=JSpec(jad(jdraft), k=k)) if k else {}
        pspec = dict(speculative=SpeculativeConfig(pad(pdraft), k=k)) \
            if k else {}
        jreqs, jst = _serve(JEngine(jad(jm), **ENGINE, **kw, **jspec),
                            JSampling, _prompts())
        preqs, pst = _serve(ServingEngine(pad(pm), **ENGINE, **kw, **pspec,
                                          device="cpu"),
                            SamplingParams, _prompts())
    finally:
        paddle.set_flags({"FLAGS_serving_device_loop": True})
        pt_set_flags({"FLAGS_serving_device_loop": True})
    _same_run(jreqs, jst, preqs, pst)
    assert pst["finished"] == 5 and pst["tokens_generated"] == 30
    assert pst["prefix_recompute_tokens"] == 0
    if kw.get("prefill_chunk"):
        # each request's uncached tail in chunks of 8
        assert pst["prefill_chunks"] == sum(
            len(chunk_spans(r.prompt.size - r.reused_tokens, 8))
            for r in preqs)
    if kw.get("prefix_cache"):
        pc = pst["prefix_cache"]
        assert pc["hits"] == 2 and pc["cow_tokens"] == 6
        assert [r.reused_tokens for r in preqs[1:3]] == [40, 38]
    if k:
        assert pst["spec_verify_steps"] > 0
        if jdraft is jm:     # a self-draft: drafts agree with the target
            assert pst["spec_accepted"] > 0


def test_plain_chunked_prefix_and_spec_streams_agree(llama_tiny):
    """The fast path changes how the port computes the stream, never the
    stream: fp32 greedy tokens of all four engines are equal."""
    _, pm = llama_tiny
    streams = []
    for kw in (dict(), dict(prefill_chunk=8), dict(prefix_cache=True),
               dict(speculative=SpeculativeConfig(llama_adapter(pm), k=2))):
        reqs, st = _serve(ServingEngine(llama_adapter(pm), **ENGINE, **kw,
                                        device="cpu"),
                          SamplingParams, _prompts())
        streams.append([r.tokens for r in reqs])
        assert st["leaked_blocks"] == 0
    assert all(s == streams[0] for s in streams[1:])


def test_chunked_prefill_interleaves_with_decode(gpt64):
    """A long prompt admitted beside a short one does not stall the short
    one's decode: it finishes while the long one is still PREFILLING."""
    pm = gpt64[1]
    rng = np.random.default_rng(5)
    eng = ServingEngine(gpt_adapter(pm), **ENGINE, prefill_chunk=8,
                        device="cpu")
    short = eng.submit(rng.integers(0, 128, size=5),
                       SamplingParams(max_new_tokens=4), request_id="short")
    long = eng.submit(rng.integers(0, 128, size=40),
                      SamplingParams(max_new_tokens=2), request_id="long")
    out = eng.step()
    assert len(short.tokens) == 2 and long.state == "PREFILLING"
    assert out["prefilling"] == 1
    while short.state == "RUNNING":
        before = len(short.tokens)
        eng.step()
        assert len(short.tokens) == before + 1
    assert short.state == "FINISHED" and long.state == "PREFILLING"
    assert long.tokens == []
    eng.run_until_idle()
    assert long.state == "FINISHED" and len(long.tokens) == 2
    st = eng.stats()
    assert st["leaked_blocks"] == 0
    assert st["prefill_chunks"] == 1 + len(chunk_spans(40, 8))


def test_speculative_finish_mid_burst_discards_accepted_rows(llama_tiny):
    """tests/test_serving.py:913 on the port, against the reference: the
    token budget lands inside an accepted burst (max_new 8, k 3), and eos
    at the first token finishes a request at prefill; both streams end
    where the plain engine's do, in both packages."""
    (jm, pm) = llama_tiny
    prompt = np.random.default_rng(3).integers(0, 512, size=12).astype(
        np.int32)
    out = {}
    for name, eng_cls, samp, ad, spec in (
            ("ref", JEngine, JSampling, j_llama_adapter, JSpec),
            ("port", ServingEngine, SamplingParams, llama_adapter,
             SpeculativeConfig)):
        model = jm if name == "ref" else pm
        dev = {} if name == "ref" else dict(device="cpu")
        plain = eng_cls(ad(model), **ENGINE, **dev)
        r0 = plain.submit(prompt, samp(max_new_tokens=8))
        plain.run_until_idle()
        eng = eng_cls(ad(model), **ENGINE, **dev,
                      speculative=spec(ad(model), k=3))
        r1 = eng.submit(prompt, samp(max_new_tokens=8))
        eng.run_until_idle()
        eos = r0.tokens[0]
        r2 = eng.submit(prompt, samp(max_new_tokens=8, eos_token_id=eos),
                        request_id="eos")
        eng.run_until_idle()
        st = eng.stats()
        out[name] = (r0.tokens, r1.tokens, r2.tokens, r2.finish_reason,
                     st["spec_verify_steps"], st["spec_accepted"],
                     st["leaked_blocks"], st["draft_leaked_blocks"])
    assert out["port"] == out["ref"]
    t0, t1, t2, why, verify, accepted, leak, dleak = out["port"]
    assert t1 == t0 and len(t1) == 8
    assert verify == 2 and accepted + verify > len(t1) - 1
    assert t2 == [t0[0]] and why == "eos"
    assert leak == 0 and dleak == 0


def test_prefix_cache_eviction_under_pressure(gpt64):
    """tests/test_serving.py:804 on the port, against the reference: a
    full pool LRU-evicts cache-only blocks and the request runs."""
    jm, pm = gpt64[:2]
    rng = np.random.default_rng(9)
    waves = [[rng.integers(0, 128, size=24).astype(np.int32)],
             [rng.integers(0, 128, size=24).astype(np.int32)
              for _ in range(2)]]
    kw = dict(ENGINE, num_blocks=8, prefix_cache=True)
    jreqs, jst = _serve(JEngine(j_gpt_adapter(jm), **kw), JSampling, waves,
                        max_new=4)
    preqs, pst = _serve(ServingEngine(gpt_adapter(pm), **kw, device="cpu"),
                        SamplingParams, waves, max_new=4)
    _same_run(jreqs, jst, preqs, pst)
    assert all(r.state == "FINISHED" for r in preqs)
    assert pst["prefix_cache"]["evictions"] >= 1


def test_loud_rejections_with_the_reference_messages(gpt64):
    jm, pm, _, pdraft = gpt64
    eng = ServingEngine(gpt_adapter(pm), **ENGINE, device="cpu",
                        speculative=SpeculativeConfig(gpt_adapter(pdraft)))
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(np.arange(4, dtype=np.int32),
                   SamplingParams(temperature=0.8, top_p=0.9))
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeConfig(gpt_adapter(pdraft), k=0)
    with pytest.raises(ValueError, match=r"prefill_chunk must be >= 1 "
                                         r"\(None = off\), got 0"):
        ServingEngine(gpt_adapter(pm), **ENGINE, prefill_chunk=0,
                      device="cpu")
    with pytest.raises(ValueError, match="must be a SpeculativeConfig"):
        ServingEngine(gpt_adapter(pm), **ENGINE, speculative=object(),
                      device="cpu")
    with pytest.raises(ValueError, match="contradictory"):
        ServingEngine(gpt_adapter(pm), **ENGINE, device_loop_k=2,
                      speculative=SpeculativeConfig(gpt_adapter(pdraft)),
                      device="cpu")
    ad = gpt_adapter(pm)
    bare = ModelAdapter(name=ad.name, params=ad.params, prefill=ad.prefill,
                        decode=ad.decode, num_layers=ad.num_layers,
                        num_kv_heads=ad.num_kv_heads, head_dim=ad.head_dim,
                        vocab_size=ad.vocab_size,
                        max_positions=ad.max_positions, device=ad.device)
    with pytest.raises(ValueError, match="chunk"):
        SpeculativeConfig(bare)
    for kw in ({"prefill_chunk": 8}, {"prefix_cache": True},
               {"speculative": SpeculativeConfig(gpt_adapter(pdraft))}):
        with pytest.raises(ValueError, match="has no chunk"):
            ServingEngine(bare, num_blocks=8, block_size=8, max_model_len=64,
                          device="cpu", **kw)


def test_self_draft_row_hole_after_a_fully_accepted_round(llama_tiny,
                                                          monkeypatch):
    """A fault of the reference's speculative round, kept by the port so
    both count the same (ROADMAP C): a round whose k drafts are all
    accepted emits k+1 tokens, but the draft loop wrote K/V only at
    positions P..P+k-1, so the draft pool's row at P+k (the accepted
    d_k) stays unwritten and the next round's draft attends it stale.
    The stream is untouched (the target verifies every token); the
    accept rate drops. One more draft step a round fills the row."""
    from paddle_tpu_torch.inference import engine as pengine
    jm, pm = llama_tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, 20).astype(np.int32) for _ in range(3)]
    k, P = 2, 20
    for name, eng in (
            ("ref", JEngine(j_llama_adapter(jm), **ENGINE,
                            speculative=JSpec(j_llama_adapter(jm), k=k))),
            ("port", ServingEngine(llama_adapter(pm), **ENGINE, device="cpu",
                                   speculative=SpeculativeConfig(
                                       llama_adapter(pm), k=k)))):
        eng.submit(prompts[0], (JSampling if name == "ref" else
                                SamplingParams)(max_new_tokens=8),
                   request_id="r")
        eng.step()           # admission, prefill, the first round
        assert eng.stats()["spec_accepted"] == k, name     # fully accepted
        row = int(eng.draft_pool.slots_for("r", P + k, P + k + 1)[0])
        trow = int(eng.pool.slots_for("r", P + k, P + k + 1)[0])
        assert not np.asarray(eng.draft_pool.k)[:, row].any(), name
        assert np.asarray(eng.pool.k)[:, trow].any(), name
    counts = {}
    for filled in (False, True):
        if filled:
            hole = pengine.draft_window
            monkeypatch.setattr(
                pengine, "draft_window",
                lambda fn, p, kp, vp, t, po, tb, lim, pad, kk, bs: (
                    lambda d: (d[0][:, :kk], d[1], d[2]))(
                    hole(fn, p, kp, vp, t, po, tb, lim, pad, kk + 1, bs)))
        eng = ServingEngine(llama_adapter(pm), **ENGINE, device="cpu",
                            speculative=SpeculativeConfig(llama_adapter(pm),
                                                          k=k))
        reqs, st = _serve(eng, SamplingParams, [prompts], max_new=20)
        counts[filled] = (st["spec_accepted"], st["spec_drafted"],
                          [r.tokens for r in reqs])
    jreqs, jst = _serve(JEngine(j_llama_adapter(jm), **ENGINE,
                                speculative=JSpec(j_llama_adapter(jm), k=k)),
                        JSampling, [prompts], max_new=20)
    assert counts[False][:2] == (jst["spec_accepted"], jst["spec_drafted"])
    assert counts[False][2] == counts[True][2] == [r.tokens for r in jreqs]
    rate = {f: a / d for f, (a, d, _) in counts.items()}
    assert rate[True] > rate[False]
