"""The port's B=1 decode kernel wrapper against the JAX reference.

paddle_tpu_torch.kernels.mlp_fusion.decode_attn_proj_ref (the plain
version the wrapper takes for CPU tensors) is held against
paddle_tpu.kernels.mlp_fusion.decode_attn_proj run as the Pallas kernel
in interpret mode, on the same numpy inputs, for MHA and GQA, at the
first position, both sides of a page boundary and the last position,
with pad entries in the block table. Tolerance: atol 2e-5 — the same
fp32 arithmetic summed in another order (the interpret kernel's online
softmax runs page by page, the plain version in one pass).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

from paddle_tpu.kernels.mlp_fusion import decode_attn_proj as jax_decode
from paddle_tpu_torch.kernels.mlp_fusion import (decode_attn_proj,
                                                 decode_attn_proj_ref)

BS, NBLOCKS, MB, D, HO = 8, 6, 4, 16, 24


def _inputs(nh, kvh, seed, pad_table):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.normal(size=(nh, D)).astype(f)
    kp = rng.normal(size=(NBLOCKS * BS + 1, kvh, D)).astype(f)
    vp = rng.normal(size=(NBLOCKS * BS + 1, kvh, D)).astype(f)
    table = rng.permutation(NBLOCKS)[:MB].astype(np.int32)
    if pad_table:
        table[2:] = NBLOCKS          # pad entries (= num_blocks)
    w = (rng.normal(size=(nh * D, HO)) * 0.1).astype(f)
    b = rng.normal(size=(HO,)).astype(f)
    return q, kp, vp, table, w, b


@pytest.mark.parametrize("nh,kvh", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("pos,pad_table", [(0, True), (7, True), (8, True),
                                           (15, True), (MB * BS - 1, False)],
                         ids=["pos0", "pos7", "pos8", "last-real-pad",
                              "last"])
def test_plain_matches_jax_interpret(nh, kvh, pos, pad_table):
    q, kp, vp, table, w, b = _inputs(nh, kvh, 10 * nh + pos, pad_table)
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), pos,
        jnp.asarray(table), jnp.asarray(w), jnp.asarray(b), block_size=BS,
        scale=scale, interpret=True))
    t = torch.from_numpy
    got = decode_attn_proj_ref(t(q), t(kp), t(vp), pos, t(table), t(w), t(b),
                               block_size=BS, scale=scale)
    assert got.shape == (HO,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    q, kp, vp, table, w, b = _inputs(8, 2, 3, True)
    t = torch.from_numpy
    before = decode_attn_proj.launches
    got = decode_attn_proj(t(q), t(kp), t(vp), torch.tensor([9], dtype=torch.int32),
                           t(table), t(w), t(b), block_size=BS, scale=0.25)
    ref = decode_attn_proj_ref(t(q), t(kp), t(vp), 9, t(table), t(w), t(b),
                               block_size=BS, scale=0.25)
    assert torch.equal(got, ref)
    assert decode_attn_proj.launches == before


def _errors(fn, q, pools, w, b, table, to):
    msgs = []
    for args, kw in (
            ((to(np.zeros((7, 16), np.float32)), pools, pools, 3, table,
              w, b), dict(block_size=8, scale=1.0)),
            ((q, pools, pools, 3, table, w, b), dict(block_size=7,
                                                     scale=1.0)),
            ((q, pools, pools, 3, table, to(np.zeros((64, 24), np.float32)),
              b), dict(block_size=8, scale=1.0))):
        with pytest.raises(ValueError) as ei:
            fn(*args, **kw)
        msgs.append(str(ei.value))
    return msgs


def test_validation_errors_match_reference():
    rng = np.random.default_rng(70)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    pools = rng.normal(size=(17, 2, 16)).astype(np.float32)
    w = rng.normal(size=(128, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    table = np.asarray([0, 1], np.int32)
    jax_msgs = _errors(jax_decode, jnp.asarray(q), jnp.asarray(pools),
                       jnp.asarray(w), jnp.asarray(b), jnp.asarray(table),
                       jnp.asarray)
    t = torch.from_numpy
    port_msgs = _errors(decode_attn_proj, t(q), t(pools), t(w), t(b),
                        t(table), t)
    assert port_msgs == jax_msgs
    assert "multiple of kv heads" in port_msgs[0]
    assert "block_size" in port_msgs[1]
    assert "proj weight" in port_msgs[2]
