"""Metrics registry and log-bucketed latency histograms: the port of
``sbr_tpu.obs.metrics``. Pure Python: the same recorded values give the
same quantiles, deltas, summaries and Prometheus lines as the reference.

Metrics are recorded only from host code, at the boundary of a finished
solve or sweep, so enabling them changes no computation. Every recording
method of `MetricsRegistry` starts with one attribute test and returns
when the registry is disabled. A `RunContext` enables the process-global
registry (`metrics()`) for its run and folds its summary into the
manifest.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple


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


class LabeledHistograms:
    """A family of `LogHistogram`s keyed by one label value.

    The shape behind per-layer span-duration histograms on ``/metrics``
    (``sbr_trace_span_ms{layer="engine.dispatch"}``): `record` is the same
    O(1) lock-free-under-CPython increment `LogHistogram.record` is — the
    dict-get worst race creates one extra throwaway histogram whose single
    sample is lost, never corrupts existing buckets. ``max_labels`` bounds
    cardinality: past it, new labels fold into ``"other"`` instead of
    growing the exposition without bound."""

    __slots__ = ("bounds", "by_label", "max_labels")

    def __init__(self, bounds: Tuple[float, ...], max_labels: int = 64) -> None:
        self.bounds = tuple(bounds)
        self.by_label: Dict[str, LogHistogram] = {}
        self.max_labels = max_labels

    def record(self, label: str, value: float) -> None:
        h = self.by_label.get(label)
        if h is None:
            if len(self.by_label) >= self.max_labels:
                label = "other"
                h = self.by_label.get(label)
            if h is None:
                h = self.by_label.setdefault(label, LogHistogram(self.bounds))
        h.record(value)

    def summaries(self) -> Dict[str, dict]:
        """JSON-ready per-label reductions, label-sorted for determinism."""
        return {k: self.by_label[k].summary() for k in sorted(self.by_label)}

    def to_prometheus(self, name: str, label_key: str = "layer") -> List[str]:
        """Exposition lines for every label's histogram under one family.

        Emits the ``# TYPE`` header once; per-label lines carry
        ``label_key="<label>"`` so a single scrape shows the full per-layer
        latency breakdown."""
        if not self.by_label:
            return []
        lines = [f"# TYPE {name} histogram"]
        for label in sorted(self.by_label):
            sub = self.by_label[label].to_prometheus(
                name, labels=f'{label_key}="{label}"'
            )
            lines.extend(sub[1:])  # drop the per-label TYPE header
        return lines


class MetricsRegistry:
    """Process-local counters / gauges / timer histograms.

    Disabled by default; `RunContext` enables it for the run's duration and
    folds `summary()` into the run manifest. All recording methods are
    no-ops while disabled (see module docstring for the overhead contract).
    """

    __slots__ = ("_on", "counters", "gauges", "timers", "hists")

    def __init__(self) -> None:
        self._on = False
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, List[float]] = {}
        self.hists: Dict[str, LogHistogram] = {}

    # -- lifecycle ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self) -> None:
        self._on = True

    def disable(self) -> None:
        self._on = False

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.timers.clear()
        self.hists.clear()

    # -- recording (all no-ops while disabled) ------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        """Increment counter ``name`` by ``n``."""
        if not self._on:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to its latest ``value``."""
        if not self._on:
            return
        self.gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        """Record one duration sample into timer histogram ``name``."""
        if not self._on:
            return
        self.timers.setdefault(name, []).append(float(seconds))

    _DEFAULT_HIST_BOUNDS = DEFAULT_LATENCY_BOUNDS_MS

    def observe_value(self, name: str, value: float,
                      bounds: Optional[Tuple[float, ...]] = None) -> None:
        """Record one sample into the log-bucketed value histogram ``name``
        (created on first use; default bounds cover 0.05 ms .. 2 min —
        the serving latency shape). Unlike `observe`, memory is O(buckets)
        however many samples land, so hot query paths can record every
        event without growing a list."""
        if not self._on:
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LogHistogram(bounds or self._DEFAULT_HIST_BOUNDS)
        h.record(value)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Time the enclosed block into histogram ``name`` (host wall-clock;
        callers timing device work should fence first — see obs.timing)."""
        if not self._on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready snapshot: counters/gauges verbatim, timers reduced to
        count/total/min/mean/p50/p95/max (keys sorted for determinism)."""

        def _hist(samples: List[float]) -> dict:
            s = sorted(samples)
            n = len(s)
            return {
                "count": n,
                "total_s": sum(s),
                "min_s": s[0],
                "mean_s": sum(s) / n,
                "p50_s": s[n // 2],
                "p95_s": s[min(n - 1, (19 * n) // 20)],
                "max_s": s[-1],
            }

        out = {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "timers": {k: _hist(v) for k, v in sorted(self.timers.items())},
        }
        if self.hists:
            out["hists"] = {k: self.hists[k].summary() for k in sorted(self.hists)}
        return out


_GLOBAL = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-global registry (instrumentation call sites and tests)."""
    return _GLOBAL
