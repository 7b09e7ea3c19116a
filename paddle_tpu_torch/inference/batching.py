"""Shared shape-bucket policy and waiting queue for serving.

Counterpart: ``paddle_tpu/inference/batching.py`` — a copy of that
numpy-only module (the port imports nothing of ``paddle_tpu``). The
engine pads prompts to a prefill bucket and the decode batch to a batch
bucket, so the card sees a small fixed set of shapes; ``chunk_spans``
plans a chunked prefill; ``SLOQueue`` is the priority-banded,
tenant-fair waiting line (one band until the SLO slice lands, see
ROADMAP.md).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketLadder", "SLOQueue", "chunk_spans", "pad_batch",
           "pad_spatial_nchw", "pad_tokens"]


class BucketLadder:
    """A sorted ladder of allowed sizes; `bucket_for` rounds up.

    Loud policy: a value above the top bucket raises (the caller must
    decide between rejecting the request and running unpadded — see
    `bucket_or_none`); empty/invalid ladders never construct.
    """

    def __init__(self, buckets: Sequence[int]):
        bs = sorted({int(b) for b in buckets})
        if not bs:
            raise ValueError("BucketLadder needs at least one bucket")
        if bs[0] <= 0:
            raise ValueError(f"buckets must be positive, got {bs}")
        self.buckets: List[int] = bs

    @classmethod
    def pow2(cls, max_value: int, start: int = 1) -> "BucketLadder":
        """1, 2, 4, ... ladder covering [start, max_value]."""
        if max_value < start:
            raise ValueError(f"max_value {max_value} < start {start}")
        b, out = int(start), []
        while b < max_value:
            out.append(b)
            b *= 2
        out.append(int(max_value))
        return cls(out)

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self):
        return len(self.buckets)

    def bucket_or_none(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None when n exceeds the ladder."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"bucket_for({n}): size must be positive")
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def bucket_for(self, n: int) -> int:
        b = self.bucket_or_none(n)
        if b is None:
            raise ValueError(
                f"size {n} exceeds the bucket ladder (max {self.max}); "
                f"admission must reject or the ladder must grow")
        return b


class SLOQueue:
    """Priority-banded, tenant-fair waiting queue for the serving engine.

    Structure: ``num_priorities`` bands (priority 0 is MOST urgent);
    within a band each tenant has its own FIFO lane and slots are
    granted across lanes by smooth weighted round-robin (the nginx
    algorithm): each pick, every *non-empty* lane's credit grows by its
    weight, the max-credit lane wins (ties broken by lane age, i.e.
    first-seen tenant order — deterministic), and the winner pays back
    the total active weight. Over any window the grant ratio between
    two backlogged tenants converges to their weight ratio, and an
    idle tenant accumulates nothing (credits only move while a lane is
    non-empty), so it cannot hoard credit and burst-starve others.

    The degenerate config (one band, one tenant) is byte-identical to
    the plain FIFO deque it replaces: push → append, ``push_front`` →
    appendleft, ``next_candidate`` → head. That identity is what keeps
    the pre-SLO chaos gates bitwise-stable.

    Split peek/commit: ``next_candidate()`` NEVER mutates credits —
    the engine peeks, tries block reservation, and only a successful
    admission calls ``grant()`` (which pops and charges the lane).
    A failed reservation therefore cannot skew fairness accounting.
    """

    def __init__(self, num_priorities: int = 1,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        if not isinstance(num_priorities, int) or num_priorities < 1:
            raise ValueError(
                f"num_priorities must be an int >= 1, got {num_priorities!r}")
        w = dict(tenant_weights or {})
        for t, v in w.items():
            if not t or not isinstance(t, str):
                raise ValueError(
                    f"tenant names must be non-empty strings, got {t!r}")
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v > 0):
                raise ValueError(
                    f"tenant weight for {t!r} must be a finite number > 0, "
                    f"got {v!r}")
        if not (isinstance(default_weight, (int, float))
                and math.isfinite(default_weight) and default_weight > 0):
            raise ValueError(
                f"default_weight must be a finite number > 0, "
                f"got {default_weight!r}")
        self.num_priorities = num_priorities
        self.tenant_weights = {t: float(v) for t, v in w.items()}
        self.default_weight = float(default_weight)
        self._bands: List[Dict[str, deque]] = [
            {} for _ in range(num_priorities)]
        self._order: List[List[str]] = [[] for _ in range(num_priorities)]
        self._credits: List[Dict[str, float]] = [
            {} for _ in range(num_priorities)]
        self._seq = 0

    def weight_of(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, self.default_weight)

    def _lane(self, req) -> deque:
        p = int(getattr(req, "priority", 0))
        if not 0 <= p < self.num_priorities:
            raise ValueError(
                f"request priority {p} outside [0, {self.num_priorities})")
        t = str(getattr(req, "tenant", "default"))
        band = self._bands[p]
        if t not in band:
            band[t] = deque()
            self._order[p].append(t)
            self._credits[p].setdefault(t, 0.0)
        return band[t]

    def push(self, req) -> None:
        """Append `req` to its (priority, tenant) lane; first push stamps
        an arrival sequence number (``_seq``) used by shed ordering."""
        lane = self._lane(req)
        if getattr(req, "_seq", None) is None:
            req._seq = self._seq
            self._seq += 1
        lane.append(req)

    def push_front(self, req) -> None:
        """Re-queue at the FRONT of its lane (preemption requeue): the
        victim keeps its original ``_seq``, so it reads as old — a
        preempted request must not become the next shed candidate."""
        lane = self._lane(req)
        if getattr(req, "_seq", None) is None:
            req._seq = self._seq
            self._seq += 1
        lane.appendleft(req)

    def __len__(self) -> int:
        return sum(len(dq) for band in self._bands for dq in band.values())

    def __bool__(self) -> bool:
        return any(dq for band in self._bands for dq in band.values())

    def __iter__(self):
        """Deterministic scan order: bands ascending (most-urgent
        first), lanes in first-seen tenant order, FIFO within a lane."""
        for p in range(self.num_priorities):
            for t in self._order[p]:
                yield from self._bands[p][t]

    def remove(self, req) -> None:
        """Remove a specific waiting request (timeout / deadline miss /
        shed). Loud when absent — a double-remove is an engine bug."""
        p = int(getattr(req, "priority", 0))
        t = str(getattr(req, "tenant", "default"))
        try:
            self._bands[p][t].remove(req)
        except (KeyError, IndexError, ValueError):
            raise ValueError(
                f"request {getattr(req, 'rid', req)!r} is not waiting in "
                f"band {p} lane {t!r}") from None

    def _wrr_pick(self, p: int, mutate: bool) -> Optional[str]:
        band = self._bands[p]
        active = [t for t in self._order[p] if band[t]]
        if not active:
            return None
        credits = self._credits[p]
        hypo = {t: credits[t] + self.weight_of(t) for t in active}
        best = max(active, key=lambda t: hypo[t])  # max() keeps first tie
        if mutate:
            total = sum(self.weight_of(t) for t in active)
            for t in active:
                credits[t] = hypo[t]
            credits[best] -= total
        return best

    def next_candidate(self):
        """Peek the next request a free slot would go to (None when
        empty). Does NOT move credits — pair with ``grant()``."""
        for p in range(self.num_priorities):
            t = self._wrr_pick(p, mutate=False)
            if t is not None:
                return self._bands[p][t][0]
        return None

    def grant(self, req) -> None:
        """Commit the admission of `req` (must be the current
        ``next_candidate()``): pop it and charge its lane's credit."""
        p = int(req.priority)
        t = str(req.tenant)
        dq = self._bands[p].get(t)
        if not dq or dq[0] is not req:
            raise ValueError(
                f"grant() of {getattr(req, 'rid', req)!r} out of order: it "
                f"is not the head of band {p} lane {t!r}")
        pick = self._wrr_pick(p, mutate=False)
        if pick != t:
            raise ValueError(
                f"grant() of lane {t!r} violates round-robin order "
                f"(WRR pick is {pick!r}); use next_candidate()")
        self._wrr_pick(p, mutate=True)
        dq.popleft()

    def shed_candidate(self):
        """The request load shedding would drop: the YOUNGEST (max
        arrival ``_seq``) request of the lowest-priority (highest band
        index) non-empty band. None when empty."""
        for p in range(self.num_priorities - 1, -1, -1):
            best = None
            for t in self._order[p]:
                for r in self._bands[p][t]:
                    if best is None or r._seq > best._seq:
                        best = r
            if best is not None:
                return best
        return None

    def max_waiting_priority(self) -> Optional[int]:
        """Numerically largest (least-urgent) priority value currently
        waiting, or None when empty — the shed-ordering witness."""
        for p in range(self.num_priorities - 1, -1, -1):
            if any(self._bands[p][t] for t in self._order[p]):
                return p
        return None


def chunk_spans(n_tokens: int, chunk: int) -> List[Tuple[int, int]]:
    """Fixed-stride chunk plan for chunked prefill: [(start, stop), ...]
    covering [0, n_tokens) in strides of ``chunk``; only the last span
    may be short. The engine pads each span up to the pow2 ladder capped
    at ``chunk``, so the chunk shapes are bounded by the ladder."""
    n_tokens, chunk = int(n_tokens), int(chunk)
    if n_tokens < 1:
        raise ValueError(f"chunk_spans over {n_tokens} tokens")
    if chunk < 1:
        raise ValueError(f"chunk size must be >= 1, got {chunk}")
    return [(s, min(s + chunk, n_tokens))
            for s in range(0, n_tokens, chunk)]


def pad_batch(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading (batch) dim up to `target` by repeating the last
    row — a valid sample, so padded rows cannot produce NaN side
    effects (the Predictor.enable_batch_bucketing convention). Returns
    `arr` unchanged when already at target."""
    arr = np.asarray(arr)
    b = arr.shape[0]
    if b > target:
        raise ValueError(f"batch {b} > bucket {target}")
    if b == target:
        return arr
    pad = np.repeat(arr[-1:], target - b, axis=0)
    return np.concatenate([arr, pad], axis=0)


def pad_spatial_nchw(img: np.ndarray, bucket: int) -> np.ndarray:
    """Pad an NCHW image's H/W up to `bucket` with zeros (bottom/right)
    — the PP-YOLOE ladder policy: conv/BN are translation-local, so the
    true-image region's activations are exact and padded rows can only
    add candidate boxes outside the image, which post-process drops."""
    img = np.asarray(img)
    if img.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {img.shape}")
    n, c, h, w = img.shape
    if h > bucket or w > bucket:
        raise ValueError(f"image {h}x{w} exceeds bucket {bucket}")
    if h == bucket and w == bucket:
        return img
    out = np.zeros((n, c, bucket, bucket), img.dtype)
    out[:, :, :h, :w] = img
    return out


def pad_tokens(ids: np.ndarray, target: int, pad_id: int = 0) -> np.ndarray:
    """Right-pad a 1-D token sequence up to `target` with `pad_id`.
    Padded positions never reach the KV cache (their scatter slots are
    out of range) and never win attention (masked by position)."""
    ids = np.asarray(ids)
    if ids.ndim != 1:
        raise ValueError(f"expected a 1-D token sequence, got {ids.shape}")
    if ids.shape[0] > target:
        raise ValueError(f"sequence {ids.shape[0]} > bucket {target}")
    out = np.full((target,), pad_id, ids.dtype)
    out[:ids.shape[0]] = ids
    return out
