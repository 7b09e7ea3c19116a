"""The port's paged KV cache against the JAX reference.

BlockPool accounting is host bookkeeping and must match the reference
exactly; kv_append's scatter-drop and kv_gather's clip semantics
(paddle_tpu/inference/kv_cache.py:78-100) are held against the JAX ops
on the same numpy inputs. The trash row is compared only where the
reference pins it: the port may leave another pad lane's row there.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads under xdist)

import jax.numpy as jnp

from paddle_tpu.inference import kv_cache as jax_kv
from paddle_tpu_torch.inference import (BlockPool, CacheExhaustedError,
                                        kv_append, kv_gather)


def test_block_pool_alloc_free_accounting():
    pool = BlockPool(2, 8, 4, 2, 8, device="cpu")
    assert pool.free_blocks == 8 and pool.used_blocks == 0
    assert pool.blocks_needed(9) == 3
    pool.alloc("a", 3)
    pool.alloc("b", 2)
    assert pool.used_blocks == 5
    assert pool.utilization() == pytest.approx(5 / 8)
    pool.free("a")
    assert pool.free_blocks == 6
    pool.alloc("c", 6)
    assert pool.free_blocks == 0
    assert pool.k.shape == (2, 8 * 4 + 1, 2, 8)


def test_block_pool_matches_reference_allocation_order():
    """Same free-list discipline as the reference: identical block ids
    and tables for the same alloc/free sequence."""
    ours = BlockPool(1, 8, 4, 2, 8, device="cpu")
    ref = jax_kv.BlockPool(1, 8, 4, 2, 8)
    for op, owner, n in (("alloc", "a", 3), ("alloc", "b", 2),
                         ("free", "a", 0), ("alloc", "c", 4)):
        for pool in (ours, ref):
            pool.alloc(owner, n) if op == "alloc" else pool.free(owner)
    for owner in ("b", "c"):
        np.testing.assert_array_equal(ours.block_table(owner, 6),
                                      ref.block_table(owner, 6))
        np.testing.assert_array_equal(ours.slots_for(owner, 0, 7),
                                      ref.slots_for(owner, 0, 7))
    np.testing.assert_array_equal(ours.pad_block_table(3),
                                  ref.pad_block_table(3))


def test_block_pool_exhaustion_and_double_free():
    pool = BlockPool(1, 4, 4, 2, 8, device="cpu")
    pool.alloc("a", 3)
    with pytest.raises(CacheExhaustedError, match="exhausted"):
        pool.alloc("b", 2)
    assert pool.free_blocks == 1   # a failed alloc consumes nothing
    pool.free("a")
    with pytest.raises(KeyError, match="double free"):
        pool.free("a")


def test_block_pool_leak_detection_and_tables():
    pool = BlockPool(1, 8, 4, 2, 8, device="cpu")
    pool.alloc("live", 2)
    pool.alloc("dead", 1)
    assert pool.leaked_blocks(live_owners=["live", "dead"]) == 0
    assert pool.leaked_blocks(live_owners=["live"]) == 1
    table = pool.block_table("live", 4)
    assert table.shape == (4,) and list(table[2:]) == [8, 8]
    with pytest.raises(ValueError, match="beyond owner"):
        pool.slots_for("live", 0, 9)


def test_block_pool_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BlockPool(1, 4, 4, 2, 8)


def test_kv_append_drop_and_gather_clip_match_reference():
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(9, 2, 4)).astype(np.float32)   # 8 slots + trash
    kv = rng.normal(size=(4, 2, 4)).astype(np.float32)
    # slot 8 is the trash row (in range), 9 and 12 are dropped
    slots = np.asarray([0, 5, 9, 12], np.int32)
    ref = np.asarray(jax_kv.kv_append(jnp.asarray(pool), jnp.asarray(kv),
                                      jnp.asarray(slots)))
    t = torch.from_numpy(pool.copy())
    out = kv_append(t, torch.from_numpy(kv), torch.from_numpy(slots))
    assert out is t                       # in place
    np.testing.assert_array_equal(out.numpy(), ref)   # trash untouched too

    gslots = np.asarray([[0, 5, 11], [8, 3, 40]], np.int32)
    ref_g = np.asarray(jax_kv.kv_gather(jnp.asarray(ref),
                                        jnp.asarray(gslots)))
    got_g = kv_gather(out, torch.from_numpy(gslots))
    assert got_g.shape == (2, 3, 2, 4)
    np.testing.assert_array_equal(got_g.numpy(), ref_g)


def test_kv_append_pad_lanes_touch_only_the_trash_row():
    """Pad lanes of a decode batch: one at page offset 0 writes the
    trash row, one past it is dropped. Real slots are exact; the trash
    row holds either the pad lane's row (the reference) or its old
    value — garbage by contract either way."""
    pool = np.zeros((17, 1, 2), np.float32)
    kv = np.arange(6, dtype=np.float32).reshape(3, 1, 2) + 1
    slots = np.asarray([3, 16, 17], np.int32)
    ref = np.asarray(jax_kv.kv_append(jnp.asarray(pool), jnp.asarray(kv),
                                      jnp.asarray(slots)))
    got = kv_append(torch.from_numpy(pool.copy()), torch.from_numpy(kv),
                    torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got[:16], ref[:16])
    assert (got[16] == kv[1]).all() or (got[16] == pool[16]).all()
