"""The port's flash attention against the JAX reference's Pallas kernels.

The reference runs as its own tests run it on the CPU: the Pallas
kernels in interpret mode, with 64-row blocks so that S=128/200/256 give
several blocks, blocks crossing the causal diagonal and (S=200) a ragged
tail the reference pads. The port's plain versions (``flash_fwd_ref``,
``flash_bwd_ref``) and ``flash_attention_bshd`` with autograd (the custom
ops take the plain versions for CPU tensors) see the same numpy inputs.

The key-padding (``kv_bias``) variant runs the same way: through
``flash_attention_bshd`` and ``scaled_dot_product_attention`` with a
[B, 1, 1, Sk] mask in both packages (the reference's
``FLAGS_flash_attention_interpret`` on, restored afterwards), bool and
additive masks, a KV block wholly masked for some batch rows (the
reference skips it), no row without a valid key.

Tolerance: atol 2e-5 on out, lse, dq, dk and dv — the same f32
arithmetic in another summation order (online softmax over blocks in the
reference, whole rows in the plain version).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.nn.functional import (last_attn_path,
                                            scaled_dot_product_attention)

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
    """The key-padding bias variant is ported (an all-zero bias is no
    bias; held against the reference below); the dropout variants raise
    naming A6b."""
    t = torch.from_numpy(_arrays(2, [(2, 16, 2, 8)])[0])
    plain = pfa.flash_attention_bshd(t, t, t)
    assert torch.equal(pfa.flash_attention_bshd(
        t, t, t, kv_bias=torch.zeros((2, 16))), plain)
    assert torch.equal(scaled_dot_product_attention(
        t, t, t, attn_mask=torch.zeros(2, 1, 1, 16)), plain)
    with pytest.raises(NotImplementedError, match="A6b"):
        pfa.flash_attention_bshd(t, t, t, dropout_p=0.1,
                                 dropout_seed=torch.zeros(2))
    with pytest.raises(NotImplementedError, match="A6b"):
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


# ---------------------------------------------------------------------------
# the key-padding (kv_bias) variant
# ---------------------------------------------------------------------------

B_MASK, H_MASK = 3, 2
# valid keys per batch row: full; 50 (KV blocks 1-3 of 64 wholly masked at
# s=200, 1 at s=128); 130 (block 3 wholly masked at s=200)
LENGTHS = (None, 50, 130)


def _padding(s, kind):
    """[B, s] keep-mask and the bias of kind 'bool', 'additive' (the
    model's -1e9 convention), 'neg_inf' or 'soft' (finite extra biases on
    the kept keys beside the -1e9 padding)."""
    keep = np.ones((B_MASK, s), bool)
    for b, n in enumerate(LENGTHS):
        if n is not None:
            keep[b, n:] = False
    if kind == "bool":
        return keep, keep
    fill = -np.inf if kind == "neg_inf" else -1e9
    bias = np.where(keep, 0.0, fill).astype(np.float32)
    if kind == "soft":
        rng = np.random.default_rng(s)
        bias = np.where(keep, rng.uniform(-3, 1, keep.shape), bias).astype(
            np.float32)
    return keep, bias


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("kind", ["additive", "neg_inf", "soft"])
def test_kv_bias_matches_reference_vjp(kind, s):
    d = 32
    q, k, v, dout = _arrays(s + len(kind), [(B_MASK, s, H_MASK, d)] * 4)
    _, bias = _padding(s, kind)

    def ref(q, k, v):
        return jfa.flash_attention_bshd(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                        interpret=True,
                                        kv_bias=jnp.asarray(bias))

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = pfa.flash_attention_bshd(tq, tk, tv,
                                   kv_bias=torch.from_numpy(bias))
    out.backward(torch.from_numpy(dout))
    _close(out, jout)
    _close(tq.grad, jdq)
    _close(tk.grad, jdk)     # masked keys: dk = dv = 0 in both
    _close(tv.grad, jdv)
    assert float(tk.grad[1, 64:].abs().max()) == 0.0
    assert pfa.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_kv_bias_plain_versions_match_pallas_kernels():
    """The plain forward and backward with the bias rows (bias shared by
    the heads of a batch row) against the reference's kernels."""
    s, d = 200, 64
    q, k, v, dout = _arrays(11, [(B_MASK * H_MASK, s, d)] * 4)
    _, bias = _padding(s, "additive")
    bias = np.where(bias <= -1e8, -1e30, bias).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jb = jnp.asarray(bias)
    jout, jlse = jfa._fwd(jq, jk, jv, jb, None, False, scale, BLOCK, BLOCK,
                          True, H_MASK, 0.0)
    jdq, jdk, jdv = jfa._bwd(False, scale, BLOCK, BLOCK, True, H_MASK, 0.0,
                             (jq, jk, jv, jb, None, jout, jlse),
                             jnp.asarray(dout))
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, dout, bias))
    out, lse = pfa.flash_fwd_ref(tq, tk, tv, False, scale, tb, H_MASK)
    _close(out, jout)
    _close(lse, jlse)
    for got, ref in zip(pfa.flash_bwd_ref(tq, tk, tv, out, lse, tdo, False,
                                          scale, tb, H_MASK),
                        (jdq, jdk, jdv)):
        _close(got, ref)


@pytest.fixture
def flash_interpret():
    old = jax_get_flag("flash_attention_interpret")
    paddle.set_flags({"FLAGS_flash_attention_interpret": True})
    yield
    paddle.set_flags({"FLAGS_flash_attention_interpret": old})


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_sdpa_key_padding_mask_matches_reference(kind, flash_interpret):
    s, d = 128, 32
    q, k, v, dout = _arrays(21, [(B_MASK, s, H_MASK, d)] * 4)
    _, mask = _padding(s, kind)
    mask = mask[:, None, None, :]
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    jout = JF.scaled_dot_product_attention(jq, jk, jv,
                                           attn_mask=paddle.to_tensor(mask))
    (jout * paddle.to_tensor(dout)).sum().backward()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = scaled_dot_product_attention(tq, tk, tv,
                                       attn_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout))
    assert (jattn.last_attn_path(), last_attn_path()) == (
        "flash_masked/interpret", "flash_masked/plain")
    _close(out, np.asarray(jout.numpy()))
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _close(t.grad, np.asarray(j.grad.numpy()))


@pytest.mark.parametrize("case", ["dense_mask", "causal_and_mask"])
def test_other_masks_take_the_reference_dense_math(case, flash_interpret,
                                                   monkeypatch):
    s, d = 32, 16
    q, k, v = _arrays(31, [(2, s, H_MASK, d)] * 3)
    rng = np.random.default_rng(5)
    if case == "dense_mask":
        mask = rng.uniform(-2, 0, (2, 1, s, s)).astype(np.float32)
    else:
        mask = np.where(rng.random((2, 1, 1, s)) < 0.2, -1e9, 0.0).astype(
            np.float32)
        mask[:, :, :, 0] = 0.0
    causal = case == "causal_and_mask"
    monkeypatch.setattr(pattn, "_DENSE_MASK_WARNED", False)
    monkeypatch.setattr(jattn, "_DENSE_MASK_WARNED", False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jout = JF.scaled_dot_product_attention(
            *map(paddle.to_tensor, (q, k, v)),
            attn_mask=paddle.to_tensor(mask), is_causal=causal)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        out = scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)),
            attn_mask=torch.from_numpy(mask), is_causal=causal)
    assert jattn.last_attn_path() == last_attn_path() == "ref"
    assert len(pw) == len(jw) == 1
    _close(out, np.asarray(jout.numpy()))
