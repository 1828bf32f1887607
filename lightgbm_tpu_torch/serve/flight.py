"""Mergeable log-bucketed latency histograms for the serving queue.

Same bins and percentile rule as ``lightgbm_tpu/serve/flight.py``: bin
0 is [0, ORIGIN); bin i >= 1 covers [ORIGIN*G^(i-1), ORIGIN*G^i); the
last bin absorbs overflow.  With G = 2^0.25 (about 19% a bin) and 96
bins the range is 1 us to about 16.7 s, and percentiles derived from
the counts land within one bin of the exact sample percentile.  The
windowed flight recorder comes with the port's ``obs/``.
"""
from __future__ import annotations

import math
from typing import List, Optional

HIST_ORIGIN_S = 1e-6
HIST_GROWTH = 2.0 ** 0.25
HIST_BUCKETS = 96
_LOG_GROWTH = math.log(HIST_GROWTH)


def bucket_index(seconds: float) -> int:
    """The histogram bin a latency falls in (clamped; never raises)."""
    if seconds < HIST_ORIGIN_S:
        return 0
    i = int(math.log(max(seconds, HIST_ORIGIN_S) / HIST_ORIGIN_S)
            / _LOG_GROWTH) + 1
    return min(max(i, 1), HIST_BUCKETS - 1)


def bucket_value_s(i: int) -> float:
    """The representative latency of bin ``i`` (geometric midpoint;
    the overflow bin reports its lower edge)."""
    if i <= 0:
        return HIST_ORIGIN_S / 2.0
    if i >= HIST_BUCKETS - 1:
        return HIST_ORIGIN_S * HIST_GROWTH ** (HIST_BUCKETS - 2)
    return HIST_ORIGIN_S * HIST_GROWTH ** (i - 0.5)


def percentile_from_counts(counts: List[int], q: float) -> float:
    """The q-th percentile (0..100) derived from bin counts alone.
    Returns 0.0 for an empty histogram."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = max(q, 0.0) / 100.0 * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c:
            return bucket_value_s(i)
    return 0.0


class LatencyHistogram:
    """Fixed-size mergeable latency histogram (one per dispatch
    bucket)."""

    __slots__ = ("counts", "count")

    def __init__(self, counts: Optional[List[int]] = None):
        self.counts = list(counts) if counts else [0] * HIST_BUCKETS
        if len(self.counts) != HIST_BUCKETS:
            self.counts = (self.counts + [0] * HIST_BUCKETS)[
                :HIST_BUCKETS]
        self.count = sum(self.counts)

    def add(self, seconds: float) -> None:
        self.counts[bucket_index(seconds)] += 1
        self.count += 1

    def merge(self, other: "LatencyHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count

    def percentile_s(self, q: float) -> float:
        return percentile_from_counts(self.counts, q)
