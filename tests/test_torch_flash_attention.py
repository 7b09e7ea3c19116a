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

The dropout variant (``dropout_p``, ``dropout_seed``) runs the same way,
the reference's interpret-mode keep-mask against the port's plain hash
keyed by the reference's tiles: the ``_auto_blocks`` pick for f32 inputs,
explicit 64-row blocks, and, seen through a one-hot v, the bf16 table pick
(128, 128) at BERT-base's S=512 — the masks equal bit for bit.

Tolerance: atol 2e-5 on out, lse, dq, dk and dv — the same f32
arithmetic in another summation order (online softmax over blocks in the
reference, whole rows in the plain version).
"""
import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.flags import get_flag as jax_get_flag
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.core import generator as pgen
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
    bias; held against the reference below); so is the dropout variant:
    rate 0 is no dropout, a rate draws one mask per key and tile (held
    against the reference below), and the functional takes one
    generator split per call while training."""
    t = torch.from_numpy(_arrays(2, [(2, 16, 2, 8)])[0])
    plain = pfa.flash_attention_bshd(t, t, t)
    assert torch.equal(pfa.flash_attention_bshd(
        t, t, t, kv_bias=torch.zeros((2, 16))), plain)
    assert torch.equal(scaled_dot_product_attention(
        t, t, t, attn_mask=torch.zeros(2, 1, 1, 16)), plain)
    assert torch.equal(pfa.flash_attention_bshd(
        t, t, t, dropout_p=0.0, dropout_seed=[1, 2]), plain)
    drop = [pfa.flash_attention_bshd(t, t, t, dropout_p=0.1,
                                     dropout_seed=seed)
            for seed in ([1, 2], torch.tensor([1, 2]), [1, 3])]
    assert torch.equal(drop[0], drop[1]) and not torch.equal(drop[0],
                                                             drop[2])
    assert not torch.equal(drop[0], plain)
    pt_seed(4)
    state = pgen.default_generator.get_state()
    a = scaled_dot_product_attention(t, t, t, dropout_p=0.1)
    assert last_attn_path() == "flash_masked/plain"
    pgen.default_generator.set_state(state)
    key = pgen.default_generator.split_key()
    assert torch.equal(a, pfa.flash_attention_bshd(t, t, t, dropout_p=0.1,
                                                   dropout_seed=key))
    scaled_dot_product_attention(t, t, t, dropout_p=0.1, training=False)
    assert last_attn_path() == "flash/plain"     # eval mode: no split
    fresh = pgen.Generator(4)
    fresh.split_key()
    assert pgen.default_generator.split_key() == fresh.split_key()
    with pytest.raises(ValueError, match="requires dropout_seed"):
        pfa.flash_attention_bshd(t, t, t, dropout_p=0.1)


DROP_SEED = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)   # a word >= 2^31


@pytest.mark.parametrize("case", ["plain", "causal", "key_padding", "gqa"])
@pytest.mark.parametrize("s", [200, 256])
def test_dropout_forward_and_backward_match_pallas_kernels(case, s):
    """flash_attention_bshd with dropout 0.1 and autograd against the
    reference's kernels in interpret mode, same seed pair, at the
    reference's tile picks for f32 (a ragged S=200 and S=256; explicit
    64-row tiles are held in the plain-version test below)."""
    b, h, d = 2, 3, 32
    hk = 1 if case == "gqa" else h
    q, dout = _arrays(s + 7, [(b, s, h, d)] * 2)
    k, v = _arrays(s + 8, [(b, s, hk, d)] * 2)
    kw = dict(causal=case == "causal", dropout_p=0.1)
    bias = None
    if case == "key_padding":
        bias = np.zeros((b, s), np.float32)
        bias[1, 90:] = -1e9

    def jf(q, k, v):
        return jfa.flash_attention_bshd(
            q, k, v, interpret=True, dropout_seed=jnp.asarray(DROP_SEED),
            kv_bias=None if bias is None else jnp.asarray(bias), **kw)

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = pfa.flash_attention_bshd(
        tq, tk, tv, dropout_seed=torch.from_numpy(DROP_SEED.astype(np.int64)),
        kv_bias=None if bias is None else torch.from_numpy(bias), **kw)
    out.backward(torch.from_numpy(dout))
    _close(out, jout)
    for t, ref in zip((tq, tk, tv), jgrads):
        _close(t.grad, ref)
    assert pfa.launches == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_dropout_mask_at_the_bf16_table_tile_equals_the_reference():
    """BERT-base's bf16 signature (S=512, non-causal) takes the tuning
    table's (128, 128), where f32 takes (256, 512). With q = k = 0 every
    probability is 1/512 and v is the identity, so out[b, i, h, j] is
    nonzero exactly where key j is kept for query i: the bf16 masks of
    both packages, bit for bit."""
    s, h = 512, 2
    q = np.zeros((1, s, h, s), np.float32)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :],
                        (1, s, h, s)).copy()
    bf = jnp.bfloat16
    assert jfa._auto_blocks(s, s, False, bf) == (128, 128)
    assert pfa.flash_drop_tile(s, s, False, torch.bfloat16) == (128, 128)
    jout = jfa.flash_attention_bshd(
        jnp.asarray(q, bf), jnp.asarray(q, bf), jnp.asarray(v, bf),
        interpret=True, dropout_p=0.1, dropout_seed=jnp.asarray(DROP_SEED))
    tq, tv = (torch.from_numpy(a).bfloat16() for a in (q, v))
    out = pfa.flash_attention_bshd(tq, tq, tv, dropout_p=0.1,
                                   dropout_seed=DROP_SEED.tolist())
    want = np.asarray(jout.astype(jnp.float32)) != 0
    got = out.float().numpy() != 0
    np.testing.assert_array_equal(got, want)
    assert 0.88 < got.mean() < 0.92
    # f32 inputs key the mask by (256, 512): another mask
    out32 = pfa.flash_attention_bshd(tq.float(), tq.float(), tv.float(),
                                     dropout_p=0.1,
                                     dropout_seed=DROP_SEED.tolist())
    assert not np.array_equal(out32.numpy() != 0, got)


def test_dropout_plain_versions_match_pallas_kernels():
    """The plain forward and backward with the keep-mask and the bias
    rows against the reference's kernels at 64-row blocks."""
    s, d = 200, 64
    q, k, v, dout = _arrays(13, [(B_MASK * H_MASK, s, d)] * 4)
    _, bias = _padding(s, "additive")
    bias = np.where(bias <= -1e8, -1e30, bias).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jb = jnp.asarray(bias)
    seeds = jax.lax.bitcast_convert_type(jnp.asarray(DROP_SEED), jnp.int32)
    jout, jlse = jfa._fwd(jq, jk, jv, jb, seeds, False, scale, BLOCK, BLOCK,
                          True, H_MASK, 0.1)
    jgrads = jfa._bwd(False, scale, BLOCK, BLOCK, True, H_MASK, 0.1,
                      (jq, jk, jv, jb, seeds, jout, jlse), jnp.asarray(dout))
    key = pfa.DropKey(0.1, *map(int, DROP_SEED), BLOCK, BLOCK)
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, dout, bias))
    out, lse = pfa.flash_fwd_ref(tq, tk, tv, False, scale, tb, H_MASK, key)
    _close(out, jout)
    _close(lse, jlse)
    for got, ref in zip(pfa.flash_bwd_ref(tq, tk, tv, out, lse, tdo, False,
                                          scale, tb, H_MASK, key), jgrads):
        _close(got, ref)


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


@pytest.mark.parametrize("route", ["flash_masked", "ref"])
def test_sdpa_dropout_matches_reference(route, flash_interpret):
    """scaled_dot_product_attention with dropout 0.1 while training, from
    the same generator seed in both packages: the key-padding mask takes
    the flash kernels' in-kernel mask, a dense [B, 1, S, S] mask the dense
    route's bernoulli mask over the probabilities; one split each."""
    s, d = 64, 16
    q, k, v, dout = _arrays(41, [(B_MASK, s, H_MASK, d)] * 4)
    _, bias = _padding(s, "additive")
    mask = bias[:, None, None, :]
    if route == "ref":
        mask = np.broadcast_to(mask, (B_MASK, 1, s, s)).copy()
    paddle.seed(9)
    pt_seed(9)
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout = JF.scaled_dot_product_attention(
            jq, jk, jv, attn_mask=paddle.to_tensor(mask), dropout_p=0.1)
        out = scaled_dot_product_attention(
            tq, tk, tv, attn_mask=torch.from_numpy(mask), dropout_p=0.1)
    (jout * paddle.to_tensor(dout)).sum().backward()
    out.backward(torch.from_numpy(dout))
    assert jattn.last_attn_path().split("/")[0] == route
    assert last_attn_path().split("/")[0] == route
    _close(out, np.asarray(jout.numpy()))
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _close(t.grad, np.asarray(j.grad.numpy()))
    np.testing.assert_array_equal(
        pgen.default_generator.get_state().numpy(),
        np.asarray(paddle.core.generator.default_generator.get_state()))
