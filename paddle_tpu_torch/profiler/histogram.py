"""Log-bucket latency histogram: stdlib-only, O(1) per sample,
deterministic.

Counterpart: ``paddle_tpu/profiler/histogram.py`` — the parts the
serving engine calls (``add``, ``count``, ``percentile``, ``summary``),
copied. The engine records TTFT and inter-token latencies into these;
percentiles come from geometric bucket boundaries, so the same sample
sequence gives the same summary, and the relative error of a reported
percentile is bounded by ``bucket_base``.
"""
from __future__ import annotations

import math

SCHEMA = 1


class LogHistogram:
    """Geometric-bucket histogram over positive values.

    Bucket i holds values in (min_value * base**(i-1), min_value *
    base**i]; values <= min_value land in bucket 0, values beyond
    max_buckets clamp into the last bucket (clamping is counted and
    reported — a silent clamp would fake the tail).
    """

    def __init__(self, base: float = 2.0, min_value: float = 1e-3,
                 max_buckets: int = 64):
        if base <= 1.0:
            raise ValueError(f"histogram base must be > 1, got {base}")
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        if max_buckets < 2:
            raise ValueError(f"max_buckets must be >= 2, got {max_buckets}")
        self.base = float(base)
        self.min_value = float(min_value)
        self.max_buckets = int(max_buckets)
        self._counts = [0] * self.max_buckets
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._clamped = 0

    def _bucket(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        i = int(math.ceil(math.log(value / self.min_value)
                          / math.log(self.base)))
        # float roundoff at exact boundaries: keep the invariant
        # upper_bound(i) >= value
        while self.min_value * self.base ** i < value:
            i += 1
        if i >= self.max_buckets:
            self._clamped += 1
            i = self.max_buckets - 1
        return i

    def add(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v) or v < 0.0:
            raise ValueError(f"histogram values must be finite and >= 0, "
                             f"got {value!r}")
        self._counts[self._bucket(v)] += 1
        self._n += 1
        self._sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def count(self) -> int:
        return self._n

    def percentile(self, q: float) -> float:
        """Value at quantile q in [0, 1]: the geometric midpoint of the
        bucket holding the ceil(q*n)-th sample, clamped to the observed
        [min, max] (so p0/p100 are exact).

        An EMPTY histogram has no sample to rank, so asking for a
        percentile raises instead of inventing a number — a 0.0 here
        used to read as "instant latency" downstream. ``summary()``
        reports the percentiles of an empty histogram as None (the
        JSON-honest spelling of the same contract)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._n == 0:
            raise ValueError(
                "percentile() on an empty histogram: no samples to rank "
                "(count() == 0); check count() first or use summary(), "
                "which reports empty percentiles as None")
        rank = max(1, math.ceil(q * self._n))
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= rank:
                hi = self.min_value * self.base ** i
                lo = hi / self.base if i else 0.0
                mid = math.sqrt(max(lo, self.min_value / self.base) * hi)
                return min(max(mid, self._min), self._max)
        return self._max  # unreachable unless counts desynced

    def summary(self) -> dict:
        """JSON-ready summary; sparse ``buckets`` maps each non-empty
        bucket's upper bound to its count. Percentiles of an empty
        histogram are None — phases that never happened are reported as
        absent, not as fabricated zeros (the serving-span convention)."""
        pct = (self.percentile if self._n
               else (lambda q: None))  # type: ignore[return-value]
        out = {
            "schema": SCHEMA, "count": self._n,
            "bucket_base": self.base,
            "p50": pct(0.50), "p90": pct(0.90),
            "p99": pct(0.99),
            "mean": (self._sum / self._n) if self._n else 0.0,
            "min": self._min if self._n else 0.0,
            "max": self._max if self._n else 0.0,
            "clamped": self._clamped,
            "buckets": {
                f"{self.min_value * self.base ** i:g}": c
                for i, c in enumerate(self._counts) if c
            },
        }
        return out
