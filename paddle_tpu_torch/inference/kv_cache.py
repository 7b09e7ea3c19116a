"""Paged (block) KV cache for autoregressive serving.

Counterpart: ``paddle_tpu/inference/kv_cache.py`` — ``CacheExhaustedError``,
``kv_append``, ``kv_gather``, ``kv_copy``, the reference-counted
``BlockPool`` (:135-345) and the prefix trie ``PrefixCache`` (:352-545).

Layout, as in the reference: one pool per layer stack,
``[L, NSLOT + 1, KVH, D]`` with ``NSLOT = num_blocks * block_size``; the
final row (index ``NSLOT``) is the TRASH slot that pad lanes write.
``slot(pos) = block_table[pos // bs] * bs + pos % bs``; pad entries of a
block table are ``num_blocks``, so their slots land at or after NSLOT.

Sharing, as in the reference: blocks are reference counted, so one
physical block can back the same prefix for many requests. ``alloc``
hands out blocks at refcount 1, ``alloc_shared`` admits a request onto
live blocks plus fresh ones, ``free`` only decrements. ``PrefixCache``
maps exact full-block token tuples (position-aligned) to blocks, holds
one cache reference per node and evicts LRU leaves that no request
shares; a partial tail is copied (``kv_copy``) into the request's own
block, never shared.

Two departures from the reference, both forced by PyTorch:

* The pools are updated IN PLACE (JAX returns new arrays): ``kv_append``
  and ``kv_copy`` write into the tensor they are given and return it.
* Torch indexing neither drops nor clips out-of-range indices. The
  reference's scatter ``mode='drop'`` is rebuilt without a host sync: an
  out-of-range row is redirected to the trash row and writes back the
  value already there. So an in-range slot is written exactly as in the
  reference, and only the trash row — garbage by contract, never read
  unmasked — may end up holding another pad lane's row. The gather's
  ``mode='clip'`` is a clamp.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["BlockPool", "CacheExhaustedError", "PrefixCache", "context_slots",
           "kv_append", "kv_gather", "kv_copy"]


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


def kv_copy(pool: torch.Tensor, src_slots: torch.Tensor,
            dst_slots: torch.Tensor) -> torch.Tensor:
    """Copy rows ``src_slots`` → ``dst_slots`` within one flat pool, in
    place: the copy-on-write primitive of partial-tail prefix reuse.

    pool [NSLOT+1, KVH, D]; src_slots/dst_slots [N] (>= 0). Every source
    row is read (clipped onto the trash row) before any destination is
    written (past the trash row: dropped), so overlapping ranges behave
    like memmove. In-range destinations must be distinct. Returns
    ``pool``."""
    return kv_append(pool, kv_gather(pool, src_slots), dst_slots)


def context_slots(block_tables: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """[B, MB] block tables → [B, MB * block_size] int64 slots of each
    lane's context window: slot(j) = table[j // bs] * bs + j % bs."""
    ctx_i = torch.arange(block_tables.shape[1] * block_size,
                         device=block_tables.device)
    return (block_tables[:, ctx_i // block_size].long() * block_size
            + (ctx_i % block_size)[None, :])


# ---------------------------------------------------------------------------
# host-side pool
# ---------------------------------------------------------------------------

class BlockPool:
    """Preallocated per-layer KV pools + a host-side block free list.

    ``.k`` / ``.v`` (``[L, NSLOT + 1, KVH, D]``) live on ``device`` for
    the engine's lifetime; the host side only moves block ids around, so
    alloc/free never touch the card. A block is on the free list iff it
    has no reference count; ``free`` and ``cache_release`` only
    decrement and recycle at zero, so a shared block survives any single
    holder."""

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

    def leaked_blocks(self, live_owners=(), cached: Iterable[int] = ()) \
            -> int:
        """Reference-count consistency defect count: every block's
        refcount must equal one per listing in a live owner's table plus
        one if the prefix cache holds it (``cached``). Counts refs held
        by dead owners and missing refs alike."""
        live = set(live_owners)
        expected: Dict[int, int] = {}
        for owner, blks in self._owned.items():
            if owner in live:
                for b in blks:
                    expected[b] = expected.get(b, 0) + 1
        for b in cached:
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
                "shared_refs": sum(self._ref.values()) - self.used_blocks,
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

    def alloc_shared(self, owner, shared_blocks: List[int],
                     n_new: int) -> List[int]:
        """Admit ``owner`` onto ``shared_blocks`` (one new reference
        each) plus ``n_new`` fresh blocks. Atomic like ``alloc``: the
        capacity check comes before any refcount moves. The shared
        blocks must be live."""
        n_new = int(n_new)
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds blocks; "
                             f"free first or use extend()")
        if n_new < 0:
            raise ValueError(f"alloc_shared of {n_new} fresh blocks")
        for b in shared_blocks:
            if self._ref.get(b, 0) <= 0:
                raise ValueError(
                    f"alloc_shared: block {b} is not live (refcount "
                    f"{self._ref.get(b, 0)}) — stale prefix-cache entry?")
        if n_new > len(self._free):
            raise CacheExhaustedError(
                f"KV block pool exhausted: owner {owner!r} asked for "
                f"{n_new} fresh blocks (+{len(shared_blocks)} shared), "
                f"only {len(self._free)} of {self.num_blocks} free")
        got = [self._free.pop() for _ in range(n_new)]
        for b in got:
            self._ref[b] = 1
        for b in shared_blocks:
            self._ref[b] += 1
        self._owned[owner] = list(shared_blocks) + got
        return list(self._owned[owner])

    def free(self, owner) -> int:
        """Drop one reference per block in ``owner``'s table; a block
        returns to the free list at refcount 0."""
        if owner not in self._owned:
            raise KeyError(f"free() of unknown owner {owner!r} "
                           f"(double free or never allocated)")
        blks = self._owned.pop(owner)
        for b in reversed(blks):
            self._release(b)
        return len(blks)

    def _release(self, block: int):
        ref = self._ref.get(block, 0)
        if ref <= 0:
            raise ValueError(f"refcount underflow on block {block} "
                             f"(double release)")
        if ref == 1:
            del self._ref[block]
            self._free.append(block)
        else:
            self._ref[block] = ref - 1

    def refcount(self, block: int) -> int:
        return self._ref.get(int(block), 0)

    def cache_acquire(self, block: int):
        """One extra reference held by the prefix cache, not by any
        request: keeps the block's K/V alive after its writer ends."""
        block = int(block)
        if self._ref.get(block, 0) <= 0:
            raise ValueError(f"cache_acquire of non-live block {block}")
        self._ref[block] += 1

    def cache_release(self, block: int):
        """Drop the prefix cache's reference (eviction)."""
        self._release(int(block))

    def owned(self, owner) -> List[int]:
        return list(self._owned.get(owner, []))

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


# ---------------------------------------------------------------------------
# prefix → blocks trie (host-side)
# ---------------------------------------------------------------------------

class _PrefixNode:
    """One full KV block in the trie: ``key`` is the exact tuple of the
    block's block_size tokens, ``block`` the physical block id (one cache
    reference held while the node lives)."""

    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_PrefixNode"], last_used: int):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.parent = parent
        self.last_used = last_used


class PrefixCache:
    """Exact-token prefix→blocks trie over a refcounted BlockPool.

    A node at depth i asserts: "this block holds the K/V rows for
    positions [i*bs, (i+1)*bs) of exactly these bs tokens", so full
    blocks match position-aligned and copy-free; the best partially
    matching child of the last full match is the copy-on-write donor.
    Reuse is capped at len(prompt) - 1 tokens: the last prompt token is
    always computed, since its logits give the first generated token.
    ``insert`` runs when a request's prefill completes; eviction takes
    LRU leaves whose block no request shares."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.bs = pool.block_size
        self._root: Dict[Tuple[int, ...], _PrefixNode] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.cow_tokens = 0
        self.evictions = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup -----------------------------------------------------------
    def match(self, prompt) -> Tuple[List[int],
                                     Optional[Tuple[int, int]]]:
        """→ (shared_blocks, partial): the full-block matches in
        position order, and (donor_block, m) when the next m (< bs)
        tokens match a cached child's leading rows, else None. The
        hit/miss counters are the engine's to move."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        limit = len(toks) - 1  # always compute the final prompt token
        shared: List[int] = []
        children = self._root
        i = 0
        while (i + 1) * self.bs <= limit:
            node = children.get(tuple(toks[i * self.bs:(i + 1) * self.bs]))
            if node is None:
                break
            node.last_used = self._tick()
            shared.append(node.block)
            children = node.children
            i += 1
        partial: Optional[Tuple[int, int]] = None
        rest = toks[i * self.bs:limit]
        if rest:
            best_m, best_block = 0, -1
            for key, node in sorted(children.items()):
                m = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best_m, best_block = m, node.block
            if best_m > 0:
                partial = (best_block, best_m)
        return shared, partial

    # -- insertion --------------------------------------------------------
    def insert(self, prompt, blocks: List[int]):
        """Walk/extend the trie with every FULL block of ``prompt``; a
        new node takes one cache reference on the request's own block,
        an existing one keeps its block."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        children = self._root
        parent: Optional[_PrefixNode] = None
        for j in range(len(toks) // self.bs):
            key = tuple(toks[j * self.bs:(j + 1) * self.bs])
            node = children.get(key)
            if node is None:
                node = _PrefixNode(key, int(blocks[j]), parent,
                                   self._tick())
                self.pool.cache_acquire(node.block)
                children[key] = node
            else:
                node.last_used = self._tick()
            parent = node
            children = node.children

    # -- read-only affinity digest ---------------------------------------
    def block_keys(self) -> frozenset:
        """(depth, token_tuple) for every cached node; touches no LRU
        clock, refcount or counter."""
        out = set()
        stack = [(0, node) for node in self._root.values()]
        while stack:
            depth, node = stack.pop()
            out.add((depth, node.key))
            stack.extend((depth + 1, c) for c in node.children.values())
        return frozenset(out)

    def warm_prefix_tokens(self, prompt) -> int:
        """Leading tokens of ``prompt`` warm in this cache: ``match``'s
        full-block walk and len(prompt) - 1 cap, strictly read-only."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        limit = len(toks) - 1
        children = self._root
        i = 0
        while (i + 1) * self.bs <= limit:
            node = children.get(tuple(toks[i * self.bs:(i + 1) * self.bs]))
            if node is None:
                break
            children = node.children
            i += 1
        return i * self.bs

    # -- introspection / eviction ----------------------------------------
    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def blocks(self) -> set:
        """Physical blocks the cache holds a reference on."""
        return {n.block for n in self._iter_nodes()}

    def __len__(self):
        return sum(1 for _ in self._iter_nodes())

    def evict_for(self, n_free_wanted: int, keep: Iterable[int] = ()) \
            -> bool:
        """Release LRU leaves until the pool has ``n_free_wanted`` free
        blocks. Only leaves whose block is cache-only (refcount 1) and
        not in ``keep`` are evictable. True when the target is met."""
        keep = set(keep)
        while self.pool.free_blocks < n_free_wanted:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n.block not in keep
                      and self.pool.refcount(n.block) == 1]
            if not leaves:
                return False
            victim = min(leaves, key=lambda n: n.last_used)
            siblings = (victim.parent.children if victim.parent is not None
                        else self._root)
            del siblings[victim.key]
            self.pool.cache_release(victim.block)
            self.evictions += 1
        return True

    def stats(self) -> dict:
        return {"nodes": len(self), "cached_blocks": len(self.blocks()),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / (self.hits + self.misses)
                             if (self.hits + self.misses) else 0.0),
                "tokens_reused": self.tokens_reused,
                "cow_tokens": self.cow_tokens,
                "evictions": self.evictions}
