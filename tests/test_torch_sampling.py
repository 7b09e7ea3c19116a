"""The port's token samplers against the JAX reference.

* threefry PRNGKey / fold_in / uniform are BITWISE jax.random's (the
  key words and the float32 bits) for seeds {0, 1, 7, 2^31+5, 2^32-1}
  x counts 0..63 — the property that makes sampled streams identical;
* greedy_math and categorical_math give JAX's exact tokens for the same
  uniform u, including ties, top-k and top-p;
* the knob errors carry the reference's exact messages.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import sampling as jax_s
from paddle_tpu_torch.nn.functional import sampling as pt_s

SEEDS = [0, 1, 7, 2**31 + 5, 2**32 - 1]


def test_pinned_vector():
    key = pt_s.fold_in(pt_s.prng_key(7), 3)
    assert key.tolist() == [276534068, 1641862660]
    u = pt_s.uniform(key)
    assert u.dtype == torch.float32
    assert u.numpy() == np.float32(0.23133409)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_uniforms_bitwise(seed):
    counts = jnp.arange(64, dtype=jnp.uint32)
    keys = jax.vmap(lambda c: jax.random.fold_in(
        jax.random.PRNGKey(seed), c))(counts)
    us = jax.vmap(jax.random.uniform)(keys)
    ours = pt_s.derive_key(seed, torch.arange(64))
    np.testing.assert_array_equal(ours.numpy().astype(np.uint32),
                                  np.asarray(keys))
    np.testing.assert_array_equal(
        pt_s.uniform(ours).numpy().view(np.uint32),
        np.asarray(us).view(np.uint32))
    np.testing.assert_array_equal(
        pt_s.prng_key(seed).numpy().astype(np.uint32),
        np.asarray(jax.random.PRNGKey(seed)))


def test_greedy_first_occurrence_ties():
    rng = np.random.default_rng(1)
    logits = np.round(rng.normal(size=(32, 40)), 1).astype(np.float32)
    logits[:, 7] = logits.max(axis=1)        # force ties with later ids
    ref = np.asarray(jax_s.greedy_math(jnp.asarray(logits)))
    got = pt_s.greedy_math(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("rounded", [False, True], ids=["distinct", "ties"])
def test_categorical_exact_tokens(rounded):
    rng = np.random.default_rng(2 + rounded)
    B, V = 60, 50
    logits = rng.normal(size=(B, V)) * 2.0
    if rounded:
        logits = np.round(logits)            # many equal probabilities
    logits = logits.astype(np.float32)
    u = rng.uniform(size=(B,)).astype(np.float32)
    temp = rng.choice([0.5, 1.0, 1.7], size=B).astype(np.float32)
    top_k = rng.choice([0, 1, 5, V, V + 10], size=B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.3], size=B).astype(np.float32)
    ref = np.asarray(jax_s.categorical_math(
        jnp.asarray(logits), jnp.asarray(u), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p)))
    t = torch.from_numpy
    got = pt_s.categorical_math(t(logits), t(u), t(temp), t(top_k),
                                t(top_p)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.0, 0, 1.0), (0.8, 0, 0.9), (1.3, 4, 1.0)])
def test_sample_token_matches_reference(temperature, top_k, top_p):
    rng = np.random.default_rng(5)
    for count in range(6):
        row = rng.normal(size=(64,)).astype(np.float32)
        ref = jax_s.sample_token(jnp.asarray(row), 11, count, temperature,
                                 top_k, top_p)
        got = pt_s.sample_token(torch.from_numpy(row), 11, count,
                                temperature, top_k, top_p)
        assert got == ref


@pytest.mark.parametrize("kw", [dict(temperature=-1.0),
                                dict(temperature=0.0),
                                dict(top_k=-2),
                                dict(top_p=0.0),
                                dict(top_p=1.5)])
def test_knob_errors_match_reference(kw):
    logits = np.zeros((2, 8), np.float32)
    u = np.full((2,), 0.5, np.float32)
    with pytest.raises(ValueError) as ref:
        jax_s._sample_categorical(jnp.asarray(logits), jnp.asarray(u), **kw)
    with pytest.raises(ValueError) as got:
        pt_s.sample_categorical(torch.from_numpy(logits),
                                torch.from_numpy(u), **kw)
    assert str(got.value) == str(ref.value)


def test_logits_rank_error_matches_reference():
    with pytest.raises(ValueError) as ref:
        jax_s._sample_categorical(jnp.zeros((8,)), jnp.zeros((1,)))
    with pytest.raises(ValueError) as got:
        pt_s.sample_categorical(torch.zeros(8), torch.zeros(1))
    assert str(got.value) == str(ref.value)
