"""The slice as a whole: the port's ServingEngine against the JAX one.

Both engines serve the same seeded trace — tiny GPT (as
tests/test_serving.py), 6 requests with prompts of 3–10 tokens and
max_new_tokens 5, greedy and sampled (temperature 0.8, top_p 0.9)
mixed, block_size 8, max_model_len 32 — with the port's weights
converted from the reference model. Two runs:

(a) max_batch=1 with FLAGS_serving_decode_kernel on in both (the
    reference's Pallas kernel in interpret mode, the port's kernel
    wrapper on its plain version);
(b) max_batch=4 with device_loop_k=4 (the composite decode path).

Each request's token stream must be identical (sampled streams too:
the port's threefry draws are bitwise the reference's), finished /
tokens_generated must agree, and no block may leak.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import SamplingParams as JaxSampling
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import gpt_adapter as jax_gpt_adapter
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import set_flags as pt_set_flags
from paddle_tpu_torch.inference import (SamplingParams, ServingEngine,
                                        gpt_adapter)
from paddle_tpu_torch.models import gpt as pgpt

ENGINE = dict(num_blocks=16, block_size=8, max_model_len=32)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jcfg = jgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=jnp.float32)
    jmodel = jgpt.GPTForCausalLM(jcfg)
    tree = jax.tree.map(np.asarray, jgpt.serving_params(jmodel))
    pcfg = pgpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, max_seq_len=32, dtype=torch.float32)
    return jmodel, pgpt.GPTForCausalLM(pcfg, device="cpu").load_numpy(tree)


def _trace():
    rng = np.random.default_rng(17)
    out = []
    for i in range(6):
        prompt = rng.integers(0, 128, size=int(rng.integers(3, 11)))
        samp = (dict(temperature=0.8, top_p=0.9, seed=100 + i) if i % 2
                else dict())
        out.append((prompt.astype(np.int32), samp))
    return out


def _serve(engine, sampling_cls):
    reqs = [engine.submit(p, sampling_cls(max_new_tokens=5, **s),
                          request_id=f"r{i}")
            for i, (p, s) in enumerate(_trace())]
    engine.run_until_idle()
    return reqs, engine.stats()


@pytest.mark.parametrize("run", ["a_batch1_kernel", "b_batch4_k4"])
def test_token_streams_match_reference(models, run):
    jmodel, pmodel = models
    kw = (dict(max_batch=1) if run.startswith("a")
          else dict(max_batch=4, device_loop_k=4))
    kernel = run.startswith("a")
    paddle.set_flags({"FLAGS_serving_decode_kernel": kernel})
    pt_set_flags({"FLAGS_serving_decode_kernel": kernel})
    try:
        jreqs, jstats = _serve(JaxEngine(jax_gpt_adapter(jmodel), **ENGINE,
                                         **kw), JaxSampling)
        preqs, pstats = _serve(ServingEngine(gpt_adapter(pmodel), **ENGINE,
                                             **kw, device="cpu"),
                               SamplingParams)
        if kernel:
            assert pgpt.last_decode_kernel_path() == "kernel/plain"
    finally:
        paddle.set_flags({"FLAGS_serving_decode_kernel": False})
        pt_set_flags({"FLAGS_serving_decode_kernel": False})
    for j, p in zip(jreqs, preqs):
        assert p.tokens == j.tokens, p.request_id
        assert (p.state, p.finish_reason) == (j.state, j.finish_reason)
    for key in ("finished", "tokens_generated", "prefills"):
        assert pstats[key] == jstats[key], key
    assert pstats["finished"] == 6 and pstats["tokens_generated"] == 30
    assert pstats["leaked_blocks"] == 0 and jstats["leaked_blocks"] == 0
    assert pstats["pool"]["free_blocks"] == ENGINE["num_blocks"]


def test_host_decode_branch_greedy_matches_device_loop(models):
    """FLAGS_serving_device_loop off: one step per dispatch with host
    numpy sampling; greedy streams equal the device loop's."""
    _, pmodel = models
    prompts = [p for p, _ in _trace()]
    streams = []
    for loop in (True, False):
        pt_set_flags({"FLAGS_serving_device_loop": loop})
        try:
            eng = ServingEngine(gpt_adapter(pmodel), **ENGINE, max_batch=2,
                                device="cpu")
        finally:
            pt_set_flags({"FLAGS_serving_device_loop": True})
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=4))
                for p in prompts]
        eng.run_until_idle()
        streams.append([r.tokens for r in reqs])
        assert eng.stats()["leaked_blocks"] == 0
    assert streams[0] == streams[1]


def test_reject_shed_timeout_paths_are_leak_free_with_spans(models):
    """The terminal paths besides FINISHED: admission='reject' on a full
    pool, max_queue shedding, a queue timeout — each frees what it held
    and leaves one serving_span record in the flight recorder."""
    from paddle_tpu_torch.profiler import flightrec
    adapter = gpt_adapter(models[1])
    eng = ServingEngine(adapter, num_blocks=4, block_size=8,
                        max_model_len=32, max_batch=1, admission="reject",
                        device="cpu")
    a = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=18),
                   request_id="pol-a")                     # 3 blocks
    eng.step()                                    # a admitted: 1 block free
    b = eng.submit([4, 5, 6], SamplingParams(max_new_tokens=18),
                   request_id="pol-b")
    assert b.state == "REJECTED" and "pool full" in b.finish_reason
    eng.run_until_idle()
    assert a.state == "FINISHED" and len(a.tokens) == 18

    eng2 = ServingEngine(adapter, **ENGINE, max_batch=1, max_queue=1,
                         device="cpu")
    x = eng2.submit([1, 2], SamplingParams(max_new_tokens=8),
                    request_id="pol-x")
    eng2.step()                                   # x admitted, queue empty
    y = eng2.submit([3, 4], SamplingParams(max_new_tokens=8),
                    timeout_steps=2, request_id="pol-y")
    z = eng2.submit([5, 6], SamplingParams(max_new_tokens=8),
                    request_id="pol-z")
    assert z.state == "REJECTED" and "load shed" in z.finish_reason
    eng2.run_until_idle()
    assert x.state == "FINISHED" and y.state == "TIMED_OUT"
    assert y.finish_reason == "timed out in queue"
    for e, reqs in ((eng, (a, b)), (eng2, (x, y, z))):
        st = e.stats()
        assert st["leaked_blocks"] == 0
        assert st["pool"]["free_blocks"] == e.pool.num_blocks
        for r in reqs:
            spans = flightrec.records(kind="serving_span",
                                      request=r.request_id)
            assert spans and spans[-1]["state"] == r.state
    assert eng.stats()["rejected"] == 1
    assert eng2.stats()["shed"] == 1 and eng2.stats()["timed_out"] == 1


@pytest.mark.parametrize("kw", [dict(num_priorities=2),
                                dict(deadline_percentile=0.5),
                                dict(xprio_preempt_steps=3),
                                dict(watchdog=object())],
                         ids=lambda kw: next(iter(kw)))
def test_later_slice_knobs_raise(models, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(gpt_adapter(models[1]), **ENGINE, device="cpu", **kw)


def test_deadlines_at_submit_raise(models):
    eng = ServingEngine(gpt_adapter(models[1]), **ENGINE, device="cpu")
    with pytest.raises(NotImplementedError, match="deadlines"):
        eng.submit([1, 2, 3], ttft_deadline_ms=50.0)


def test_default_device_without_a_card_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(gpt_adapter(models[1]), **ENGINE)
    cfg = pgpt.GPTConfig(vocab_size=16, hidden_size=8, num_layers=1,
                         num_heads=2, max_seq_len=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pgpt.GPTForCausalLM(cfg)
