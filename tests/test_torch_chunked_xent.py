"""The port's chunked softmax cross-entropy against the JAX reference.

Loss and the gradients of x, w (and the bias, where there is one) for
K = 1 and 4 vocab chunks, fp32, the same numpy inputs on both sides.
Tolerance atol 1e-5 / rtol 1e-5: the same f32 online softmax, in another
summation order.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import chunked_xent as jcx
from paddle_tpu_torch.kernels import chunked_xent as pcx

B, S, H, V = 2, 6, 16, 64


def _inputs(seed, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    w = (rng.standard_normal((V, H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32) if bias else None
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    g = rng.standard_normal((B, S)).astype(np.float32)
    return x, w, b, labels, g


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_mean_loss_and_grads_match(k):
    x, w, _, labels, _ = _inputs(k, False)
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda x, w: jcx.chunked_softmax_xent(x, w, jnp.asarray(labels), k),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    loss = pcx.chunked_softmax_xent(tx, tw, torch.from_numpy(labels), k)
    loss.backward()
    _close(loss, jl)
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)


@pytest.mark.parametrize("k", [1, 4])
def test_per_token_with_bias_matches(k):
    x, w, b, labels, g = _inputs(10 + k, True)

    def ref(x, w, b):
        return jcx.chunked_softmax_xent_per_token(x, w, b,
                                                  jnp.asarray(labels), k)

    jl, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    loss = pcx.chunked_softmax_xent_per_token(tx, tw, tb,
                                              torch.from_numpy(labels), k)
    assert loss.shape == (B, S) and loss.dtype == torch.float32
    loss.backward(torch.from_numpy(g))
    _close(loss, jl)
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)
    _close(tb.grad, jdb)


def test_default_chunks_match_dense_loss():
    x, w, _, labels, _ = _inputs(3, False)
    tx, tw, tl = map(torch.from_numpy, (x, w, labels))
    got = pcx.chunked_softmax_xent(tx, tw, tl)
    dense = torch.nn.functional.cross_entropy((tx @ tw.T).reshape(-1, V),
                                              tl.reshape(-1).long())
    _close(got, dense.numpy())
    assert pcx._pick_chunks(V) == 8 and pcx._pick_chunks(50304) == 8
    assert pcx._pick_chunks(7) == 7 and pcx._pick_chunks(11) == 1


def test_non_divisor_chunks_raise_the_reference_error():
    x, w, _, labels, _ = _inputs(4, False)
    with pytest.raises(ValueError) as jerr:
        jcx.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(labels), 5)
    with pytest.raises(ValueError) as terr:
        pcx.chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(labels), 5)
    assert str(terr.value) == str(jerr.value)
