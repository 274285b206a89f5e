"""Log-bucketed latency histograms: the port of `log_bounds`,
`DEFAULT_LATENCY_BOUNDS_MS` and `LogHistogram` from
``sbr_tpu.obs.metrics``. Pure Python: the same recorded values give the
same quantiles, deltas and Prometheus lines as the reference. The
registry (counters, gauges, timers) and the labeled histogram families
wait for the rest of ``obs`` (ROADMAP item 1.A 9).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def log_bounds(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Geometric bucket boundaries from ``lo`` to at least ``hi`` with
    ``per_decade`` buckets per decade — the shared shape for latency
    histograms (serve live metrics, timer summaries)."""
    step = 10.0 ** (1.0 / per_decade)
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * step)
    return tuple(bounds)


# The ONE latency bucket family (ms): 0.05 ms .. ~2 min. Serve's window
# histograms and the registry's default value histograms share it, so
# `LogHistogram.add`/`delta` can always fold across the two and quantiles
# stay comparable.
DEFAULT_LATENCY_BOUNDS_MS = log_bounds(0.05, 120_000.0, per_decade=4)


class LogHistogram:
    """Fixed-boundary histogram with O(1) record and derivable quantiles.

    ``bounds`` are ascending upper edges; values above the last edge land
    in an overflow bucket. Recording is append-free (one list-index
    increment), so a histogram shared across threads needs no lock under
    CPython — increments of an int slot are effectively atomic at this
    granularity, and the worst race drops one count from a *window*
    aggregate, never corrupts state. Quantiles interpolate within the
    winning bucket (log-bucketed bounds ⇒ bounded relative error), which is
    exactly the Prometheus histogram contract — `to_prometheus` renders the
    cumulative ``le`` form."""

    __slots__ = ("bounds", "counts", "count", "total", "max")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        v = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (bisect, inlined: hot path)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def add(self, other: "LogHistogram") -> None:
        """Fold ``other`` (same bounds) into this histogram — the window
        aggregation step. Bounds mismatch is a programming error."""
        if other.bounds != self.bounds:
            raise ValueError("LogHistogram.add: bucket bounds differ")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max

    def delta(self, before: "LogHistogram") -> "LogHistogram":
        """New histogram holding the samples recorded since ``before`` (a
        prior snapshot of this histogram with the same bounds) — the
        phase-isolation counterpart of `add` (e.g. a bench's measured-phase
        quantiles must exclude warmup samples). ``max`` carries this
        histogram's lifetime max: an exact delta max is unknowable from
        bucket counts, and only the overflow bucket's quantile reads it —
        an UPPER bound for the phase, never an undershoot."""
        if before.bounds != self.bounds:
            raise ValueError("LogHistogram.delta: bucket bounds differ")
        out = LogHistogram(self.bounds)
        out.counts = [a - b for a, b in zip(self.counts, before.counts)]
        out.count = self.count - before.count
        out.total = self.total - before.total
        out.max = self.max
        return out

    def copy(self) -> "LogHistogram":
        out = LogHistogram(self.bounds)
        out.counts = list(self.counts)
        out.count = self.count
        out.total = self.total
        out.max = self.max
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (0..1) from the buckets; None when empty.
        Interpolates linearly inside the winning bucket; the overflow
        bucket reports the observed max."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                if i >= len(self.bounds):  # overflow bucket
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.max

    def summary(self) -> dict:
        """JSON-ready reduction: count/sum/max plus p50/p95/p99."""
        out = {
            "count": self.count,
            "sum": round(self.total, 6),
            "max": round(self.max, 6),
        }
        for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            out[name] = None if v is None else round(v, 6)
        return out

    def to_prometheus(self, name: str, labels: str = "") -> List[str]:
        """Cumulative ``le``-labeled Prometheus text lines for this
        histogram (``labels`` is a pre-rendered ``k="v",...`` fragment)."""
        sep = "," if labels else ""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{{labels}{sep}le="{bound:g}"}} {cum}')
        cum += self.counts[-1]
        lines.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {cum}')
        brace = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{brace} {self.total:g}")
        lines.append(f"{name}_count{brace} {self.count}")
        return lines

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.total, "max": self.max}

    @classmethod
    def from_dict(cls, doc: dict) -> "LogHistogram":
        h = cls(tuple(doc.get("bounds") or (1.0,)))
        counts = list(doc.get("counts") or [])
        if len(counts) == len(h.counts):
            h.counts = [int(c) for c in counts]
        h.count = int(doc.get("count", sum(h.counts)))
        h.total = float(doc.get("sum", 0.0))
        h.max = float(doc.get("max", 0.0))
        return h
