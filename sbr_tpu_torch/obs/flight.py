"""Dispatch-pipeline flight recorder: the port of ``sbr_tpu.obs.flight``.

Spans time stages serially and traces time requests end to end; neither
says whether the device sat idle while the host formed the next batch.
This module records enough to tell: a fixed-capacity ring of
(monotonic-ns, stream, kind, tag, seq) records written lock-free from
any thread, with paired begin/end records on three streams:

- **engine**: admission, queue wait, batch formation, ``dispatch`` and
  result unpack, per bucket, plus ``queue_depth`` / ``occupancy`` /
  ``shed`` point records. The dispatch span closes only once the
  program's one device-to-host copy has returned, so it covers copy-in,
  replay (or the eager solve) and the fetch: the host's view of the
  device path, as in the reference. No CUDA event is recorded.
- **sweeps**: `utils.checkpoint.TileRunner.produce` split into compute,
  checkpoint load and save, and tile-cache I/O, per tile.
- **collectives**: the multihost and elastic barrier polls.

The ring is lock-free by construction: each record is one immutable
tuple stored into one list slot (``slots[g % cap] = rec``, one store,
atomic under CPython), indexed by a global `itertools.count` whose
``next()`` is atomic too. Overflow overwrites the oldest; a snapshot
copies the slot list, and `derive_utilization` drops torn pairs (an end
whose begin was overwritten).

`derive_utilization` is a pure fold from a snapshot to the surface:
device-busy fraction (the union of dispatch spans over the engine
window), host-gap fraction with per-cause attribution (batch formation,
cache I/O, admission shed, queue starvation), queue-depth percentiles,
batch occupancy per bucket and the per-tile sweep bubble series. It rides
``/metrics`` (``sbr_flight_*``), ``/statz``, a rolling ``flight.json``
next to ``live.json`` and the ``report util`` gate.

``SBR_FLIGHT=0`` (the default) is a structural no-op: the serving path
never imports this module, the engine holds no recorder, ``/metrics``
and ``/statz`` carry no ``sbr_flight`` bytes, and answers are
bit-identical. The recorder adds no fence and no device work.

Imports no torch: ``report util`` runs without a device runtime.
"""

from __future__ import annotations

import itertools
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from sbr_tpu_torch.obs import switch_on
from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LabeledHistograms

LIVE_SCHEMA = "sbr-flight-live/1"
UTIL_SCHEMA = "sbr-flight-util/1"

#: The three instrumented streams. Per-stream seq counters give pair
#: identity; per-stream labeled histograms give the /metrics latency
#: breakdown by kind.
STREAMS = ("engine", "sweeps", "collectives")

#: Sweep bubble series cap — enough to see the pipeline shape without
#: letting a thousand-tile sweep bloat flight.json.
_MAX_BUBBLES = 64


# ---------------------------------------------------------------------------
# Env knobs
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """Whether the flight recorder is on (``SBR_FLIGHT``; default off —
    and off must be a structural no-op, see the module docstring)."""
    return switch_on("SBR_FLIGHT")


def cap_n() -> int:
    """Ring capacity in records (``SBR_FLIGHT_CAP``, default 4096 slots
    ≈ 2048 spans — a few seconds of busy serving)."""
    env = os.environ.get("SBR_FLIGHT_CAP", "").strip()
    return max(int(env), 8) if env else 4096


def util_floor() -> Optional[float]:
    """The `report util` gate floor (``SBR_FLIGHT_UTIL_FLOOR``):
    device-busy fraction below it exits 1. None = gate disarmed."""
    env = os.environ.get("SBR_FLIGHT_UTIL_FLOOR", "").strip()
    return float(env) if env else None


def min_dispatches() -> int:
    """Minimum dispatches before the floor gate arms
    (``SBR_FLIGHT_MIN_DISPATCHES``, default 3) — a one-dispatch window is
    all compile shadow, not a utilization measurement."""
    env = os.environ.get("SBR_FLIGHT_MIN_DISPATCHES", "").strip()
    return max(int(env), 1) if env else 3


# ---------------------------------------------------------------------------
# Recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Lock-free ring of flight records + per-stream latency histograms.

    Internal slot layout (never serialized as-is):
    ``(g, t_ns, stream, kind, tag, seq, phase, val)`` where ``g`` is the
    global write index (drives overwrite-oldest and the dropped-records
    accounting) and ``phase`` is ``"b"``/``"e"`` for a paired span or
    ``"p"`` for a point record. Every public record path is wrapped in
    try/except: telemetry must never take down serving."""

    def __init__(self, cap: Optional[int] = None,
                 time_fn=time.monotonic) -> None:
        self.cap = max(int(cap), 8) if cap is not None else cap_n()
        self._time = time_fn
        self._reinit()
        self._last_write = 0.0
        self._last_rotate = 0.0
        self._rotations = 0

    def _reinit(self) -> None:
        self._slots: List[Optional[tuple]] = [None] * self.cap
        self._idx = itertools.count()
        self._last_g = -1
        # (last_g, util) memo: heartbeat_block / prometheus_lines /
        # maybe_write all need the derived surface and often fire in the
        # same live-write tick — deriving over the full ring is O(cap),
        # so reuse the result while no new record has landed. Exact, not
        # TTL-stale: any write moves _last_g and misses the memo.
        self._util_memo: Optional[tuple] = None
        self._seq: Dict[str, itertools.count] = {
            s: itertools.count(1) for s in STREAMS
        }
        self._hists: Dict[str, LabeledHistograms] = {
            s: LabeledHistograms(DEFAULT_LATENCY_BOUNDS_MS, max_labels=16)
            for s in STREAMS
        }

    # -- write side ----------------------------------------------------------
    def _put(self, t_ns: int, stream: str, kind: str, tag: str,
             seq: int, phase: str, val) -> None:
        g = next(self._idx)  # GIL-atomic: unique global index per record
        self._last_g = g
        # One atomic store of one immutable tuple — records cannot tear.
        self._slots[g % self.cap] = (g, t_ns, stream, kind, tag, seq,
                                     phase, val)

    def mark(self, stream: str, kind: str, t0_s: float, t1_s: float,
             tag: str = "") -> None:
        """Record one closed span as a begin/end pair sharing a seq.
        Timestamps are `time.monotonic()` seconds (the engine already has
        them in hand at every instrumented site — no double clock reads)."""
        try:
            if t1_s < t0_s:
                t0_s = t1_s
            seq = next(self._seq[stream])
            self._put(int(t0_s * 1e9), stream, kind, tag, seq, "b", None)
            self._put(int(t1_s * 1e9), stream, kind, tag, seq, "e", None)
            self._hists[stream].record(kind, (t1_s - t0_s) * 1e3)
        except Exception:
            pass

    def point(self, stream: str, kind: str, tag: str = "",
              val=None) -> None:
        """Record one instantaneous event (shed, queue depth, occupancy)."""
        try:
            seq = next(self._seq[stream])
            self._put(int(self._time() * 1e9), stream, kind, tag, seq,
                      "p", val)
        except Exception:
            pass

    @contextmanager
    def span(self, stream: str, kind: str, tag: str = ""):
        """``with rec.span("sweeps", "compute", tag=tile_id): ...`` — for
        call sites that don't already hold both timestamps."""
        t0 = self._time()
        try:
            yield
        finally:
            self.mark(stream, kind, t0, self._time(), tag=tag)

    def reset(self) -> None:
        """Drop every record, seq, and histogram (bench warm-up isolation
        and test fixtures — the measured window starts clean)."""
        self._reinit()

    # -- read side -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Copy the ring under active writes. ``writes_total`` is derived
        from the largest global index visible (a lower bound only while
        writes are in flight — exact once writers quiesce), so
        ``dropped_records`` never needs a lock either."""
        slots = list(self._slots)
        recs = [r for r in slots if r is not None]
        top = max((r[0] for r in recs), default=-1)
        writes_total = max(top, self._last_g) + 1
        recs.sort(key=lambda r: (r[1], r[0]))
        return {
            "schema": LIVE_SCHEMA,
            "cap": self.cap,
            "writes_total": writes_total,
            "dropped_records": max(0, writes_total - self.cap),
            "records": [[r[1], r[2], r[3], r[4], r[5], r[6], r[7]]
                        for r in recs],
        }

    def _derived_util(self) -> dict:
        """Memoized ``derive_utilization`` over the current ring: reuse
        the last derived surface while ``_last_g`` is unchanged (an idle
        engine's heartbeats and the paired heartbeat+flight.json writes
        of one live tick), re-derive the moment any record lands."""
        memo = self._util_memo
        g = self._last_g
        if memo is not None and memo[0] == g:
            return memo[1]
        util = derive_utilization(self.snapshot())
        self._util_memo = (g, util)
        return util

    def heartbeat_block(self) -> dict:
        """The compact util block riding worker heartbeats (what the
        router folds into the fleet utilization surface)."""
        util = self._derived_util()
        return {
            "device_busy_frac": util.get("device_busy_frac"),
            "host_gap_frac": util.get("host_gap_frac"),
            "dispatches": util.get("dispatches", 0),
            "queue_p99": (util.get("queue_depth") or {}).get("p99"),
            "dropped_records": util.get("dropped_records", 0),
            "records": util.get("records", 0),
        }

    def prometheus_lines(self) -> list:
        """``sbr_flight_*`` exposition. SBR_FLIGHT=0 engines contribute
        NOTHING (the recorder doesn't exist) — tests assert the exposition
        is byte-free of the prefix when flight is off."""
        util = self._derived_util()
        busy = util.get("device_busy_frac")
        gap = util.get("host_gap_frac")
        lines = [
            "# TYPE sbr_flight_records gauge",
            f"sbr_flight_records {util.get('records', 0)}",
            "# TYPE sbr_flight_dropped_records counter",
            f"sbr_flight_dropped_records {util.get('dropped_records', 0)}",
            "# TYPE sbr_flight_dispatches gauge",
            f"sbr_flight_dispatches {util.get('dispatches', 0)}",
            "# TYPE sbr_flight_device_busy_frac gauge",
            f"sbr_flight_device_busy_frac "
            f"{busy if busy is not None else 0:g}",
            "# TYPE sbr_flight_host_gap_frac gauge",
            f"sbr_flight_host_gap_frac {gap if gap is not None else 0:g}",
        ]
        for s in STREAMS:
            lines.extend(
                self._hists[s].to_prometheus(f"sbr_flight_{s}_ms",
                                             label_key="kind")
            )
        return lines

    # -- rolling snapshot ----------------------------------------------------
    def _rotate_s(self) -> float:
        env = os.environ.get("SBR_FLIGHT_ROTATE_S", "").strip()
        return float(env) if env else 0.0

    def maybe_write(self, run, min_interval_s: float = 0.5,
                    force: bool = False) -> bool:
        """Write the rolling ``flight.json`` through ``run.live_snapshot``
        at a bounded cadence (``force`` for the final write at engine
        close). The document carries both the raw ring (``records``) and
        the derived ``util`` surface so `report util` works even against
        a snapshot from a newer/older deriver. With ``SBR_FLIGHT_ROTATE_S``
        set, the previous snapshot is archived as ``flight.NNN.json``
        before each rotation-due overwrite (what ``report gc
        --flight-keep`` prunes). Never raises."""
        if run is None:
            return False
        now = self._time()
        if not force and now - self._last_write < min_interval_s:
            return False
        self._last_write = now
        try:
            rotate_s = self._rotate_s()
            if rotate_s > 0 and now - self._last_rotate >= rotate_s:
                self._archive_snapshot(run)
                self._last_rotate = now
            g = self._last_g
            doc = self.snapshot()
            util = derive_utilization(doc)
            doc["util"] = util
            # Seed the memo: the heartbeat/exposition reader of this
            # same tick reuses the derive paid here.
            self._util_memo = (g, util)
            doc["ts"] = round(time.time(), 3)
            run.live_snapshot(doc, name="flight.json")
            if force:
                util = doc["util"]
                try:
                    run.log_flight(
                        "final",
                        records=util.get("records", 0),
                        dispatches=util.get("dispatches", 0),
                        dropped_records=util.get("dropped_records", 0),
                        device_busy_frac=util.get("device_busy_frac"),
                        host_gap_frac=util.get("host_gap_frac"),
                    )
                except Exception:
                    pass
            return True
        except Exception:
            return False

    def _archive_snapshot(self, run) -> None:
        """Archive the active ``flight.json`` as the next free
        ``flight.NNN.json`` (rotation — the gc candidates)."""
        active = Path(run.run_dir) / "flight.json"
        if not active.exists():
            return
        idx = self._rotations
        while (Path(run.run_dir) / f"flight.{idx:03d}.json").exists():
            idx += 1
        (Path(run.run_dir) / f"flight.{idx:03d}.json").write_bytes(
            active.read_bytes()
        )
        self._rotations = idx + 1
        try:
            run.log_flight("rotate", index=idx)
        except Exception:
            pass

    def close(self, run) -> None:
        """Final force-write at engine/sweeper close."""
        self.maybe_write(run, force=True)


# ---------------------------------------------------------------------------
# Process-wide recorder
# ---------------------------------------------------------------------------

_SHARED: Optional[FlightRecorder] = None


def shared() -> FlightRecorder:
    """The process-wide recorder. The engine, the sweep tile loop, and
    the collectives host paths all write here, so one ``flight.json``
    shows engine/sweeps/collectives on one monotonic timeline (a prewarm
    sweeper inside a serving process lands its tile spans next to the
    dispatches it's hiding behind)."""
    global _SHARED
    if _SHARED is None:
        _SHARED = FlightRecorder()
    return _SHARED


def reset_shared() -> None:
    """Drop the process-wide recorder (tests re-enter with a fresh cap)."""
    global _SHARED
    _SHARED = None


# ---------------------------------------------------------------------------
# Pure derivation: snapshot -> utilization surface
# ---------------------------------------------------------------------------


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge possibly-overlapping (t0, t1) intervals into a sorted
    disjoint union."""
    out: List[Tuple[int, int]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _overlap_ns(union: List[Tuple[int, int]], g0: int, g1: int) -> int:
    """Total length of ``union`` falling inside [g0, g1]."""
    total = 0
    for t0, t1 in union:
        lo, hi = max(t0, g0), min(t1, g1)
        if hi > lo:
            total += hi - lo
    return total


def _pct(samples: List[float], p: float) -> float:
    s = sorted(samples)
    return s[min(int(p / 100.0 * len(s)), len(s) - 1)]


def derive_utilization(snap: dict) -> dict:
    """PURE fold from a ring snapshot to the utilization surface — no
    clock reads, no I/O, so `report util` and tests can replay canned
    snapshots deterministically.

    Attribution walks each host gap (the complement of the dispatch-span
    union inside the engine window) and splits it by overlap priority:
    batch-formation spans first, then cache I/O, and the unexplained
    remainder is admission shed (if a shed point landed in the gap) or
    queue starvation (nothing to run). Torn pairs — an end whose begin
    was overwritten, or vice versa — are counted in ``unpaired`` and
    otherwise ignored."""
    rows = []
    for r in snap.get("records") or []:
        try:
            t_ns, stream, kind, tag, seq, phase, val = r
            rows.append((int(t_ns), str(stream), str(kind), str(tag or ""),
                         int(seq), str(phase), val))
        except Exception:
            continue  # malformed row (hand-edited snapshot) — skip
    spans: Dict[str, List[Tuple[int, int, str, str]]] = {}
    points: Dict[str, List[Tuple[int, str, str, object]]] = {}
    begins: Dict[tuple, Tuple[int, str]] = {}
    unpaired = 0
    for t_ns, stream, kind, tag, seq, phase, val in sorted(rows):
        if phase == "p":
            points.setdefault(stream, []).append((t_ns, kind, tag, val))
        elif phase == "b":
            begins[(stream, kind, seq)] = (t_ns, tag)
        elif phase == "e":
            b = begins.pop((stream, kind, seq), None)
            if b is None:
                unpaired += 1
                continue
            t0, tag0 = b
            if t_ns >= t0:
                spans.setdefault(stream, []).append((t0, t_ns, kind, tag0))
    unpaired += len(begins)

    out = {
        "schema": UTIL_SCHEMA,
        "records": len(rows),
        "dropped_records": int(snap.get("dropped_records") or 0),
        "unpaired": unpaired,
        "dispatches": 0,
        "window_s": None,
        "device_busy_frac": None,
        "host_gap_frac": None,
        "gap_causes": {},
    }

    # -- engine stream -------------------------------------------------------
    eng = spans.get("engine", [])
    eng_points = points.get("engine", [])
    times = [t for t0, t1, _, _ in eng for t in (t0, t1)]
    times.extend(t for t, _, _, _ in eng_points)
    dispatch = [(t0, t1) for t0, t1, k, _ in eng if k == "dispatch"]
    out["dispatches"] = len(dispatch)
    if times and max(times) > min(times):
        w0, w1 = min(times), max(times)
        window_ns = w1 - w0
        busy = _union(dispatch)
        busy_ns = sum(t1 - t0 for t0, t1 in busy)
        out["window_s"] = round(window_ns / 1e9, 6)
        out["device_busy_frac"] = round(
            min(busy_ns / window_ns, 1.0), 4)
        out["host_gap_frac"] = round(1.0 - out["device_busy_frac"], 4)
        # Gaps: complement of the busy union inside the window.
        gaps: List[Tuple[int, int]] = []
        cursor = w0
        for t0, t1 in busy:
            if t0 > cursor:
                gaps.append((cursor, t0))
            cursor = max(cursor, t1)
        if cursor < w1:
            gaps.append((cursor, w1))
        batch_u = _union([(t0, t1) for t0, t1, k, _ in eng if k == "batch"])
        cache_u = _union([(t0, t1) for t0, t1, k, _ in eng if k == "cache"])
        sheds = [t for t, k, _, _ in eng_points if k == "shed"]
        causes = {"batch_formation": 0, "cache_io": 0,
                  "admission_shed": 0, "queue_starvation": 0}
        for g0, g1 in gaps:
            glen = g1 - g0
            bf = min(_overlap_ns(batch_u, g0, g1), glen)
            ci = min(_overlap_ns(cache_u, g0, g1), glen - bf)
            rem = glen - bf - ci
            causes["batch_formation"] += bf
            causes["cache_io"] += ci
            if rem > 0:
                if any(g0 <= t <= g1 for t in sheds):
                    causes["admission_shed"] += rem
                else:
                    causes["queue_starvation"] += rem
        gap_ns = sum(g1 - g0 for g0, g1 in gaps)
        out["gap_causes"] = {
            c: {"s": round(ns / 1e9, 6),
                "frac": round(ns / gap_ns, 4) if gap_ns else 0.0}
            for c, ns in causes.items() if ns > 0
        }
    depth = [float(v) for t, k, _, v in eng_points
             if k == "queue_depth" and v is not None]
    if depth:
        out["queue_depth"] = {
            "p50": _pct(depth, 50), "p95": _pct(depth, 95),
            "p99": _pct(depth, 99), "max": max(depth),
            "samples": len(depth),
        }
    occ = [(tag, float(v)) for t, k, tag, v in eng_points
           if k == "occupancy" and v is not None]
    if occ:
        by_bucket: Dict[str, List[float]] = {}
        for tag, v in occ:
            by_bucket.setdefault(tag or "?", []).append(v)
        out["occupancy"] = {
            "mean": round(sum(v for _, v in occ) / len(occ), 4),
            "by_bucket": {
                b: round(sum(vs) / len(vs), 4)
                for b, vs in sorted(by_bucket.items())
            },
        }
    shed_tags: Dict[str, int] = {}
    for t, k, tag, _ in eng_points:
        if k == "shed":
            shed_tags[tag or "?"] = shed_tags.get(tag or "?", 0) + 1
    if shed_tags:
        out["sheds"] = dict(sorted(shed_tags.items()))

    # -- sweeps stream -------------------------------------------------------
    sw = spans.get("sweeps", [])
    if sw:
        by_kind: Dict[str, int] = {}
        tiles: Dict[str, Tuple[int, int]] = {}
        for t0, t1, k, tag in sw:
            by_kind[k] = by_kind.get(k, 0) + (t1 - t0)
            tid = tag or "?"
            lo, hi = tiles.get(tid, (t0, t1))
            tiles[tid] = (min(lo, t0), max(hi, t1))
        ordered = sorted(tiles.values())
        bubbles = []
        for (_, prev_hi), (nxt_lo, _) in zip(ordered, ordered[1:]):
            if nxt_lo > prev_hi:
                bubbles.append(round((nxt_lo - prev_hi) / 1e6, 3))
        out["sweeps"] = {
            "tiles": len(tiles),
            "by_kind_ms": {k: round(ns / 1e6, 3)
                           for k, ns in sorted(by_kind.items())},
            "bubbles_ms": bubbles[:_MAX_BUBBLES],
            "bubble_total_ms": round(sum(bubbles), 3),
        }

    # -- collectives stream --------------------------------------------------
    col = spans.get("collectives", [])
    col_points = points.get("collectives", [])
    if col or col_points:
        agg: Dict[str, dict] = {}
        for t0, t1, k, _ in col:
            a = agg.setdefault(k, {"count": 0, "total_ms": 0.0})
            a["count"] += 1
            a["total_ms"] += (t1 - t0) / 1e6
        for t, k, _, _ in col_points:
            a = agg.setdefault(k, {"count": 0, "total_ms": 0.0})
            a["count"] += 1
        out["collectives"] = {
            k: {"count": a["count"], "total_ms": round(a["total_ms"], 3)}
            for k, a in sorted(agg.items())
        }
    return out


# ---------------------------------------------------------------------------
# Retention (report gc --flight-keep)
# ---------------------------------------------------------------------------


def gc_flight_files(root, keep: int = 4,
                    running_grace_s: float = 6 * 3600.0) -> list:
    """Prune rotated flight snapshots (``flight.NNN.json``) inside each
    run dir under ``root`` down to the newest ``keep``, mirroring the
    ``--demand-keep`` / ``--prewarm-keep`` contract: live runs (manifest
    "running" with recent mtime) are never touched, and the ACTIVE
    ``flight.json`` is never a candidate (the glob requires the
    rotation's second dot). Returns removed paths."""
    from sbr_tpu_torch.obs import runlog

    keep = max(int(keep), 0)
    removed: list = []
    root = Path(root)
    if not root.is_dir():
        return removed
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        if runlog._run_is_live(d, running_grace_s):
            continue
        rotated = sorted(d.glob("flight.*.json"))
        for path in rotated[: max(len(rotated) - keep, 0)]:
            try:
                path.unlink()
                removed.append(str(path))
            except OSError:
                pass
    return removed
