"""The port's flash attention against the JAX reference's Pallas kernels.

The reference runs as its own tests run it on the CPU: the Pallas
kernels in interpret mode, with 64-row blocks so that S=128/200/256 give
several blocks, blocks crossing the causal diagonal and (S=200) a ragged
tail the reference pads. The port's plain versions (``flash_fwd_ref``,
``flash_bwd_ref``) and ``flash_attention_bshd`` with autograd (the custom
ops take the plain versions for CPU tensors) see the same numpy inputs.

Tolerance: atol 2e-5 on out, lse, dq, dk and dv — the same f32
arithmetic in another summation order (online softmax over blocks in the
reference, whole rows in the plain version).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

ATOL = 2e-5
BLOCK = 64


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 200, 256])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_versions_match_pallas_kernels(causal, s, d):
    bh = 3
    q, k, v, dout = _arrays(s + d, [(bh, s, d)] * 4)
    scale = d ** -0.5
    jout, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None, None, causal, scale, BLOCK, BLOCK, True, 1,
                          0.0)
    jdq, jdk, jdv = jfa._bwd(causal, scale, BLOCK, BLOCK, True, 1, 0.0,
                             (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None, None, jout, jlse), jnp.asarray(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = pfa.flash_fwd_ref(tq, tk, tv, causal, scale)
    assert out.shape == (bh, s, d) and lse.shape == (bh, s)
    assert lse.dtype == torch.float32
    _close(out, jout)
    _close(lse, jlse)
    dq, dk, dv = pfa.flash_bwd_ref(tq, tk, tv, out, lse, tdo, causal, scale)
    _close(dq, jdq)
    _close(dk, jdk)
    _close(dv, jdv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 200, 256])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_bshd_autograd_matches_reference_vjp(causal, s, d, heads):
    h, hk = heads
    q, k, v, dout = _arrays(7 * s + d + hk, [(1, s, h, d), (1, s, hk, d),
                                             (1, s, hk, d), (1, s, h, d)])

    def ref(q, k, v):
        return jfa.flash_attention_bshd(q, k, v, causal=causal,
                                        block_q=BLOCK, block_k=BLOCK,
                                        interpret=True)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(dout))
    before = dict(pfa.launches)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = pfa.flash_attention_bshd(tq, tk, tv, causal=causal)
    assert out.shape == (1, s, h, d)
    out.backward(torch.from_numpy(dout))
    _close(out, jout)
    _close(tq.grad, jdq)
    _close(tk.grad, jdk)     # GQA: the repeat's gradient sums the groups
    _close(tv.grad, jdv)
    assert pfa.launches == before == {"flash_fwd": 0, "flash_dq": 0,
                                      "flash_dkv": 0}


def test_custom_ops_are_dispatcher_ops():
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, [(2, 128, 32)] * 3))
    out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True, 0.25)
    ref_out, ref_lse = pfa.flash_fwd_ref(q, k, v, True, 0.25)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    grads = torch.ops.paddle_tpu_torch.flash_bwd(q, k, v, out, lse, q, True,
                                                 0.25)
    assert [g.shape for g in grads] == [q.shape] * 3


def _raises_same(exc, jax_call, torch_call):
    with pytest.raises(exc) as jerr:
        jax_call()
    with pytest.raises(exc) as terr:
        torch_call()
    assert str(terr.value) == str(jerr.value)


def test_reference_errors_keep_their_messages():
    q = np.zeros((2, 16, 2, 8), np.float32)
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    bias = np.zeros((2, 16), np.float32)
    _raises_same(NotImplementedError,
                 lambda: jfa.flash_attention_bshd(jq, jq, jq, causal=True,
                                                  kv_bias=jnp.asarray(bias)),
                 lambda: pfa.flash_attention_bshd(tq, tq, tq, causal=True,
                                                  kv_bias=torch.from_numpy(
                                                      bias)))
    _raises_same(ValueError,
                 lambda: jfa.flash_attention_bshd(jq, jq, jq, dropout_p=0.1),
                 lambda: pfa.flash_attention_bshd(tq, tq, tq, dropout_p=0.1))
    bad = np.zeros((2, 15), np.float32)
    _raises_same(ValueError,
                 lambda: jfa.flash_attention_bshd(jq, jq, jq, block_q=8,
                                                  block_k=8, interpret=True,
                                                  kv_bias=jnp.asarray(bad)),
                 lambda: pfa.flash_attention_bshd(tq, tq, tq,
                                                  kv_bias=torch.from_numpy(
                                                      bad)))


def test_bias_and_dropout_variants_name_a6():
    t = torch.zeros((2, 16, 2, 8))
    with pytest.raises(NotImplementedError, match="A6"):
        pfa.flash_attention_bshd(t, t, t, kv_bias=torch.zeros((2, 16)))
    with pytest.raises(NotImplementedError, match="A6"):
        pfa.flash_attention_bshd(t, t, t, dropout_p=0.1,
                                 dropout_seed=torch.zeros(2))
    with pytest.raises(NotImplementedError, match="A6"):
        scaled_dot_product_attention(t, t, t, attn_mask=torch.zeros(2, 1, 1,
                                                                    16))
    with pytest.raises(NotImplementedError, match="A6"):
        scaled_dot_product_attention(t, t, t, dropout_p=0.1)


def test_sdpa_routes_to_flash():
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, [(2, 40, 4, 16)] * 3))
    got = scaled_dot_product_attention(q, k, v, is_causal=True,
                                       dropout_p=0.5, training=False)
    ref = pfa.flash_attention_bshd(q, k, v, causal=True)
    assert torch.equal(got, ref)
    dense = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


def test_cpu_calls_launch_no_kernel():
    q = torch.zeros((1, 128, 2, 32), requires_grad=True)
    pfa.flash_attention_bshd(q, q, q, causal=True).sum().backward()
    assert pfa.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
