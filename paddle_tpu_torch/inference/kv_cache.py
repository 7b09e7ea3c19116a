"""Paged (block) KV cache for autoregressive serving.

Counterpart: ``paddle_tpu/inference/kv_cache.py`` — ``CacheExhaustedError``,
``kv_append``, ``kv_gather`` and ``BlockPool`` (:135-350). ``PrefixCache``
and ``kv_copy`` belong to a later slice (ROADMAP.md).

Layout, as in the reference: one pool per layer stack,
``[L, NSLOT + 1, KVH, D]`` with ``NSLOT = num_blocks * block_size``; the
final row (index ``NSLOT``) is the TRASH slot that pad lanes write.
``slot(pos) = block_table[pos // bs] * bs + pos % bs``; pad entries of a
block table are ``num_blocks``, so their slots land at or after NSLOT.

Two departures from the reference, both forced by PyTorch:

* The pools are updated IN PLACE (JAX returns new arrays): ``kv_append``
  writes into the tensor it is given and returns it.
* Torch indexing neither drops nor clips out-of-range indices. The
  reference's scatter ``mode='drop'`` is rebuilt without a host sync: an
  out-of-range row is redirected to the trash row and writes back the
  value already there. So an in-range slot is written exactly as in the
  reference, and only the trash row — garbage by contract, never read
  unmasked — may end up holding another pad lane's row. The gather's
  ``mode='clip'`` is a clamp.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["BlockPool", "CacheExhaustedError", "kv_append", "kv_gather"]


class CacheExhaustedError(RuntimeError):
    """The block pool cannot satisfy an allocation. Loud by design:
    admission control must see this, never a silently-corrupt cache."""


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

def kv_append(pool: torch.Tensor, kv: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """Scatter one K (or V) row per lane into the flat pool, in place.

    pool [NSLOT+1, KVH, D]; kv [B, KVH, D]; slots [B] (>= 0). Slots past
    the trash row are dropped (see the module docstring). Returns
    ``pool``."""
    n = pool.shape[0]
    slots = slots.long()
    valid = slots < n
    idx = torch.where(valid, slots, torch.full_like(slots, n - 1))
    src = torch.where(valid[:, None, None], kv.to(pool.dtype), pool[idx])
    return pool.index_copy_(0, idx, src)


def kv_gather(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Gather context rows: pool [NSLOT+1, KVH, D]; slots [B, CTX] →
    [B, CTX, KVH, D]. Out-of-range slots clip onto the last (trash) row;
    callers mask those positions out of attention."""
    return pool[slots.long().clamp(0, pool.shape[0] - 1)]


# ---------------------------------------------------------------------------
# host-side pool
# ---------------------------------------------------------------------------

class BlockPool:
    """Preallocated per-layer KV pools + a host-side block free list.

    ``.k`` / ``.v`` (``[L, NSLOT + 1, KVH, D]``) live on ``device`` for
    the engine's lifetime; the host side only moves block ids around, so
    alloc/free never touch the card. Blocks are reference counted as in
    the reference (this slice has no sharing, so every count is 1)."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device: DeviceLike = None):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(
                f"BlockPool needs positive num_blocks/block_size, got "
                f"{num_blocks}/{block_size}")
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.num_slots = self.num_blocks * self.block_size
        shape = (self.num_layers, self.num_slots + 1, self.num_kv_heads,
                 self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._owned: Dict[object, List[int]] = {}
        self._ref: Dict[int, int] = {}

    # -- accounting -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def leaked_blocks(self, live_owners=()) -> int:
        """Reference-count consistency defect count: every block's
        refcount must equal the listings in live owners' tables. Counts
        refs held by dead owners and missing refs alike."""
        live = set(live_owners)
        expected: Dict[int, int] = {}
        for owner, blks in self._owned.items():
            if owner in live:
                for b in blks:
                    expected[b] = expected.get(b, 0) + 1
        return sum(abs(self._ref.get(b, 0) - expected.get(b, 0))
                   for b in set(self._ref) | set(expected))

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free_blocks": self.free_blocks,
                "used_blocks": self.used_blocks,
                "utilization": round(self.utilization(), 4),
                "owners": len(self._owned),
                "bytes_per_layer_pair":
                    int(2 * self.k.element_size() * (self.num_slots + 1)
                        * self.num_kv_heads * self.head_dim)}

    # -- alloc / free -----------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)  # ceil div

    def alloc(self, owner, n_blocks: int) -> List[int]:
        """Hand ``n_blocks`` blocks to ``owner``. Raises
        CacheExhaustedError (allocating nothing) when the pool cannot
        cover the request."""
        n_blocks = int(n_blocks)
        if n_blocks <= 0:
            raise ValueError(f"alloc of {n_blocks} blocks")
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds blocks; "
                             f"free first or use extend()")
        if n_blocks > len(self._free):
            raise CacheExhaustedError(
                f"KV block pool exhausted: owner {owner!r} asked for "
                f"{n_blocks} blocks, only {len(self._free)} of "
                f"{self.num_blocks} free ({len(self._owned)} owners hold "
                f"{self.used_blocks})")
        got = [self._free.pop() for _ in range(n_blocks)]
        for b in got:
            self._ref[b] = 1
        self._owned[owner] = got
        return list(got)

    def free(self, owner) -> int:
        """Drop one reference per block in ``owner``'s table; a block
        returns to the free list at refcount 0."""
        if owner not in self._owned:
            raise KeyError(f"free() of unknown owner {owner!r} "
                           f"(double free or never allocated)")
        blks = self._owned.pop(owner)
        for b in reversed(blks):
            ref = self._ref.get(b, 0)
            if ref <= 0:
                raise ValueError(f"refcount underflow on block {b} "
                                 f"(double release)")
            if ref == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = ref - 1
        return len(blks)

    # -- addressing -------------------------------------------------------
    def block_table(self, owner, width: int) -> np.ndarray:
        """[width] int32 block table for ``owner``, padded with the
        out-of-range block id ``num_blocks`` (→ trash-slot traffic)."""
        blks = self._owned.get(owner)
        if blks is None:
            raise KeyError(f"block_table() of unknown owner {owner!r}")
        if len(blks) > width:
            raise ValueError(
                f"owner {owner!r} holds {len(blks)} blocks > table "
                f"width {width}")
        table = np.full((width,), self.num_blocks, np.int32)
        table[:len(blks)] = blks
        return table

    def pad_block_table(self, width: int) -> np.ndarray:
        """A batch-pad row: every entry out of range → trash slot."""
        return np.full((width,), self.num_blocks, np.int32)

    def slots_for(self, owner, start: int, stop: int) -> np.ndarray:
        """Physical slots for logical positions [start, stop) — the
        prefill scatter targets."""
        blks = self._owned.get(owner)
        if blks is None:
            raise KeyError(f"slots_for() of unknown owner {owner!r}")
        pos = np.arange(int(start), int(stop))
        if pos.size and pos[-1] // self.block_size >= len(blks):
            raise ValueError(
                f"position {int(pos[-1])} beyond owner {owner!r}'s "
                f"{len(blks)} blocks (block_size={self.block_size})")
        blk = np.asarray(blks, np.int64)[pos // self.block_size]
        return (blk * self.block_size + pos % self.block_size).astype(
            np.int32)
