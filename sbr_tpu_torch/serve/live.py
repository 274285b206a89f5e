"""Live windowed metrics for the serving engine: the port of
``sbr_tpu.serve.live``.

- **Windowed aggregation** over a ring of time slots: the window (default
  60 s, ``SBR_SERVE_WINDOW_S``) is cut into `_N_SLOTS` slots, each holding
  a log-bucketed latency histogram (`obs.metrics.LogHistogram`) and plain
  counters. Recording touches only the current slot; reads fold the live
  slots. Slots are replaced by one reference assignment and counters are
  int increments, so the hot path takes no lock under CPython: the worst
  cross-thread race drops one count from a rolling window.
- **Lifetime totals** beside the window: Prometheus counters must be
  monotone.
- **CUDA-graph counters** where the reference reads XLA's trace and
  compile counters: graphs captured per bucket and replays
  (`GraphCounters`, owned by the engine). A scrape, not a log, proves that
  a warm server captures nothing new.

The rolling ``live.json`` in a run directory (`maybe_write` given a run)
waits for the port's obs run log (ROADMAP item 1.A 9).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS as LATENCY_BOUNDS_MS
from sbr_tpu_torch.obs.metrics import LogHistogram

_N_SLOTS = 12

SCHEMA = "sbr-serve-live/1"


def window_seconds() -> float:
    env = os.environ.get("SBR_SERVE_WINDOW_S", "").strip()
    return float(env) if env else 60.0


class _Slot:
    """One time slot of the rolling window."""

    __slots__ = ("epoch", "hist", "counters")

    def __init__(self, epoch: int) -> None:
        self.epoch = epoch
        self.hist = LogHistogram(LATENCY_BOUNDS_MS)
        self.counters: Dict[str, float] = {}

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


# Counter keys shared by slots and totals. "queries" counts fulfilled
# queries; "cache_hits" = LRU or disk hits, split out as "disk_hits";
# "computed" = queries that went through a device dispatch; "shed" =
# queries rejected at admission because their deadline could not be met
# (backpressure: an explicit 429, never silent queue growth);
# "degraded" = queries answered from the degradation ladder (global tile
# cache) while the solver path was unavailable.
_COUNTERS = (
    "queries",
    "cache_hits",
    "disk_hits",
    "cache_misses",
    "computed",
    "errors",
    "divergent_cells",
    "shed",
    "degraded",
    "batches",
    "batch_queries",
    "padded_lanes",
)


class GraphCounters:
    """The engine's per-bucket program counters: CUDA graphs captured (per
    bucket, plain and grads programs apart), their replays, the seconds spent capturing, and the eager
    runs of the program on the CPU. Written by the one thread that
    dispatches at a time (the engine serializes dispatches)."""

    def __init__(self) -> None:
        self.captured: Dict[int, int] = {}
        self.captured_grads: Dict[int, int] = {}  # the grads programs'
        self.replays = 0
        self.capture_s = 0.0
        self.eager_runs = 0

    @property
    def captures(self) -> int:
        return sum(self.captured.values()) + sum(self.captured_grads.values())

    def snapshot(self) -> dict:
        return {
            "captured": {str(b): n for b, n in sorted(self.captured.items())},
            "captured_grads": {str(b): n for b, n in sorted(self.captured_grads.items())},
            "captures": self.captures,
            "replays": self.replays,
            "capture_s": round(self.capture_s, 6),
            "eager_runs": self.eager_runs,
        }


class LiveMetrics:
    """Windowed + lifetime serving metrics (see module docstring).

    ``time_fn`` is injectable so tests can drive window expiry without
    sleeping; ``graphs`` is the engine's `GraphCounters` (fresh zeros when
    not given)."""

    _MAX_SCENARIOS = 64  # distinct tags tracked; overflow folds into _other

    def __init__(self, window_s: Optional[float] = None, time_fn=time.monotonic,
                 graphs: Optional[GraphCounters] = None) -> None:
        self.graphs = graphs if graphs is not None else GraphCounters()
        self.window_s = float(window_s) if window_s else window_seconds()
        self._slot_s = self.window_s / _N_SLOTS
        self._time = time_fn
        self._slots = [_Slot(-1) for _ in range(_N_SLOTS)]
        self.totals: Dict[str, float] = {k: 0 for k in _COUNTERS}
        self.total_hist = LogHistogram(LATENCY_BOUNDS_MS)
        self.scenarios: Dict[str, int] = {}
        self.queue_depth = 0
        self.inflight = 0
        self.started_at = time.time()
        self._t0 = self._time()

    # -- recording (engine threads) -----------------------------------------
    def _slot(self) -> _Slot:
        epoch = int(self._time() / self._slot_s)
        pos = epoch % _N_SLOTS
        slot = self._slots[pos]
        if slot.epoch != epoch:
            # Replace stale slot wholesale: one reference assignment, so a
            # concurrent reader folds either the old or the new slot.
            slot = _Slot(epoch)
            self._slots[pos] = slot
        return slot

    def record_query(
        self,
        latency_s: float,
        source: str,
        scenario: str = "default",
        divergent: bool = False,
    ) -> None:
        """One fulfilled query: ``source`` is "lru", "disk", "coalesced"
        (deduplicated against an identical query in the same batch — no
        device work, so it counts as a cache hit), "computed", or
        "tilecache" (a degradation-ladder answer)."""
        ms = latency_s * 1e3
        slot = self._slot()
        slot.hist.record(ms)
        self.total_hist.record(ms)
        keys = ["queries"]
        if source in ("lru", "disk", "coalesced"):
            keys.append("cache_hits")
            if source == "disk":
                keys.append("disk_hits")
        elif source == "tilecache":
            # Degradation-ladder answer: served from the global tile cache
            # while the solver path was down, neither a cache hit nor a
            # computed query.
            keys.append("degraded")
        else:
            keys += ["cache_misses", "computed"]
        if divergent:
            keys.append("divergent_cells")
        for k in keys:
            slot.inc(k)
            self.totals[k] += 1
        # Scenario tags are caller-chosen strings: cap the table so a
        # long-lived server with per-request-derived tags cannot grow the
        # snapshot without bound.
        if scenario in self.scenarios or len(self.scenarios) < self._MAX_SCENARIOS:
            self.scenarios[scenario] = self.scenarios.get(scenario, 0) + 1
        else:
            self.scenarios["_other"] = self.scenarios.get("_other", 0) + 1

    def record_error(self, n: int = 1) -> None:
        self._slot().inc("errors", n)
        self.totals["errors"] += n

    def record_shed(self, n: int = 1) -> None:
        """One query rejected at admission (deadline unmeetable): explicit
        load shedding, counted so backpressure is observable, never silent."""
        self._slot().inc("shed", n)
        self.totals["shed"] += n

    def record_batch(self, n_queries: int, bucket: int) -> None:
        """One device dispatch: ``bucket`` lanes launched for ``n_queries``
        real queries (occupancy = batch_queries / padded capacity)."""
        slot = self._slot()
        slot.inc("batches")
        slot.inc("batch_queries", n_queries)
        slot.inc("padded_lanes", bucket - n_queries)
        self.totals["batches"] += 1
        self.totals["batch_queries"] += n_queries
        self.totals["padded_lanes"] += bucket - n_queries

    # -- reading (endpoint / snapshot threads) ------------------------------
    def _window_fold(self) -> tuple:
        """(hist, counters) folded over the slots still inside the window.

        ONE fold is one coherent read of the 12-slot ring: every consumer of a given exposition — the `/statz`
        document's ``window`` section, the ``healthz`` verdict embedded in
        the same document, the Prometheus gauges of one scrape — must
        derive from a SINGLE fold, passed down as a ``window`` dict, not
        re-fold per reader. Two folds taken microseconds apart can span a
        slot rotation and disagree (a scrape racing `record_query` would
        report a healthz divergence count from a different window than the
        ``divergent_cells`` gauge beside it)."""
        min_epoch = int(self._time() / self._slot_s) - _N_SLOTS + 1
        hist = LogHistogram(LATENCY_BOUNDS_MS)
        counters: Dict[str, float] = {k: 0 for k in _COUNTERS}
        for slot in list(self._slots):
            if slot.epoch < min_epoch:
                continue
            hist.add(slot.hist)
            # list() snapshot: the recording thread may insert a new counter
            # key mid-iteration (lock-free contract — a torn read drops one
            # count from a rolling window, never raises).
            for k, v in list(slot.counters.items()):
                counters[k] = counters.get(k, 0) + v
        return hist, counters

    @staticmethod
    def _derived(counters: Dict[str, float]) -> dict:
        q = counters.get("queries", 0)
        hits = counters.get("cache_hits", 0)
        launched = counters.get("batch_queries", 0) + counters.get("padded_lanes", 0)
        return {
            "hit_rate": round(hits / q, 4) if q else None,
            "occupancy": (
                round(counters.get("batch_queries", 0) / launched, 4) if launched else None
            ),
        }

    def window(self) -> dict:
        """The rolling-window view, from exactly ONE fold of the slot ring
        (counters, derived rates, and both latency renderings all come from
        the same (hist, counters) pair — internally consistent by
        construction). Callers that embed the window into a larger document
        alongside window-derived verdicts (`Engine.statz`) take this dict
        once and pass it down instead of re-folding."""
        hist, counters = self._window_fold()
        return {
            "window_s": self.window_s,
            **{k: counters.get(k, 0) for k in _COUNTERS},
            **self._derived(counters),
            "latency_ms": hist.summary(),
            "latency_hist_ms": hist.to_dict(),
        }

    def snapshot(self, extra: Optional[dict] = None,
                 window: Optional[dict] = None) -> dict:
        """The full live document — `live.json` body and `/statz` payload.
        ``window`` (a prior `window()` result) lets the caller share one
        fold between this document and any window-derived extras (the
        healthz verdict) — see `_window_fold` on why that matters."""
        doc = {
            "schema": SCHEMA,
            "ts": round(time.time(), 3),
            "started_at": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(self.started_at)
            ),
            "uptime_s": round(self._time() - self._t0, 3),
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "totals": {
                **{k: self.totals.get(k, 0) for k in _COUNTERS},
                **self._derived(self.totals),
                "latency_ms": self.total_hist.summary(),
            },
            "window": window if window is not None else self.window(),
            "scenarios": dict(sorted(list(self.scenarios.items()))),
            # The CUDA-graph counters ride along so that a scrape, not a
            # log, proves zero captures after warm-up.
            "graphs": self.graphs.snapshot(),
        }
        if extra:
            doc.update(extra)
        return doc

    def maybe_write(self, run, extra: Optional[dict] = None,
                    min_interval_s: float = 0.5, force: bool = False,
                    window: Optional[dict] = None) -> bool:
        """The reference writes the rolling ``live.json`` through
        ``run.live_snapshot``; the port has no run log yet (ROADMAP 1.A
        item 9), so a run raises `NotImplementedError`. Without a run it
        writes nothing and returns False."""
        if run is not None:
            raise NotImplementedError(
                "live.json in a run directory needs the obs run log, not ported "
                "yet (ROADMAP item 1.A 9)"
            )
        return False

    # -- prometheus exposition ----------------------------------------------
    def to_prometheus(self, extra: Optional[dict] = None) -> str:
        """Prometheus text exposition (0.0.4): lifetime counters, window
        gauges, the cumulative latency histogram, and the CUDA-graph
        counters. ``extra`` maps name -> (type, value) for engine-owned
        series."""
        lines = []
        for k in _COUNTERS:
            name = f"sbr_serve_{k}_total"
            lines += [f"# TYPE {name} counter", f"{name} {int(self.totals.get(k, 0))}"]
        hist, counters = self._window_fold()
        derived = self._derived(counters)
        window_gauges = {
            "sbr_serve_queue_depth": self.queue_depth,
            "sbr_serve_inflight": self.inflight,
            "sbr_serve_window_queries": counters.get("queries", 0),
            "sbr_serve_window_hit_rate": derived["hit_rate"],
            "sbr_serve_window_occupancy": derived["occupancy"],
            "sbr_serve_window_divergent_cells": counters.get("divergent_cells", 0),
            "sbr_serve_window_shed": counters.get("shed", 0),
            "sbr_serve_window_degraded": counters.get("degraded", 0),
        }
        for q in (0.5, 0.95, 0.99):
            v = hist.quantile(q)
            window_gauges[f"sbr_serve_window_latency_ms_p{int(q * 100)}"] = v
        for name, v in window_gauges.items():
            lines += [f"# TYPE {name} gauge", f"{name} {'NaN' if v is None else f'{v:g}'}"]
        lines += self.total_hist.to_prometheus("sbr_serve_latency_ms")
        g = self.graphs
        lines += [
            "# TYPE sbr_serve_graph_captures_total counter",
            f"sbr_serve_graph_captures_total {g.captures}",
            "# TYPE sbr_serve_graph_replays_total counter",
            f"sbr_serve_graph_replays_total {g.replays}",
            "# TYPE sbr_serve_graph_capture_seconds_total counter",
            f"sbr_serve_graph_capture_seconds_total {g.capture_s:g}",
            "# TYPE sbr_serve_eager_runs_total counter",
            f"sbr_serve_eager_runs_total {g.eager_runs}",
            "# TYPE sbr_serve_bucket_graphs gauge",
        ]
        for bucket, n in sorted(g.captured.items()):
            lines.append(f'sbr_serve_bucket_graphs{{bucket="{bucket}"}} {n}')
        for name, (typ, value) in (extra or {}).items():
            lines += [f"# TYPE {name} {typ}", f"{name} {value:g}"]
        return "\n".join(lines) + "\n"
