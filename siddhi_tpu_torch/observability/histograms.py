"""Fixed-bucket latency histograms with p50/p95/p99 read-out.

One histogram is a flat list of counters over a fixed exponential
millisecond bucket ladder — recording is one ``bisect`` plus three
scalar updates, so the per-batch cost matches the existing tracker
style of ``util/statistics.py`` (host ints, no locks, no allocation on
the hot path).  Quantiles interpolate linearly inside the landing
bucket, the same estimate Prometheus' ``histogram_quantile`` computes
from the exposed ``_bucket`` series, so the REST feed and a scraping
dashboard agree on the tails.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import List, Tuple


class LatencyHistogram:
    """Fixed exponential ms buckets; lock-light (GIL-sized races lose a
    count at worst, never corrupt the ladder)."""

    #: upper bounds in ms; everything past the last bound lands in the
    #: +Inf overflow bucket.  50 µs .. 5 s covers a host callback tick
    #: through a tunneled checkpoint write.
    BOUNDS_MS: Tuple[float, ...] = (
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
        100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    )

    __slots__ = ("counts", "count", "sum_ms", "max_ms")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * (len(self.BOUNDS_MS) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def record_ms(self, ms: float) -> None:
        self.counts[bisect_left(self.BOUNDS_MS, ms)] += 1
        self.count += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def record_s(self, seconds: float) -> None:
        self.record_ms(seconds * 1000.0)

    def quantile_ms(self, q: float) -> float:
        """Estimate the q-quantile (0 < q <= 1) by linear interpolation
        inside the landing bucket; the overflow bucket reports the
        observed max (the only honest upper bound it has)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                if i >= len(self.BOUNDS_MS):
                    return self.max_ms
                lo = self.BOUNDS_MS[i - 1] if i > 0 else 0.0
                hi = self.BOUNDS_MS[i]
                return lo + (hi - lo) * ((rank - prev) / c)
        return self.max_ms

    def p50_ms(self) -> float:
        return self.quantile_ms(0.50)

    def p95_ms(self) -> float:
        return self.quantile_ms(0.95)

    def p99_ms(self) -> float:
        return self.quantile_ms(0.99)

    def snapshot(self) -> Tuple[Tuple[float, ...], Tuple[int, ...], float, int]:
        """(bounds_ms, per-bucket counts incl. overflow, sum_ms, count)
        — the exact series a Prometheus histogram family exposes."""
        return self.BOUNDS_MS, tuple(self.counts), self.sum_ms, self.count

    def reset(self) -> None:
        self.counts = [0] * (len(self.BOUNDS_MS) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
