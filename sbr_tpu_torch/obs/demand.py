"""Workload demand observatory and prefetch advisor: the port of
``sbr_tpu.obs.demand``.

The other obs layers watch the system; this one watches the workload:
what the engine is asked. Three streams per rolling window (the serve
slot ring's window, ``SBR_SERVE_WINDOW_S``, and its lock-free
epoch-replacement slots, as in `serve.live`):

- **(β, u) demand histogram** on a fixed binning aligned to the sweep
  grid: ``SBR_DEMAND_BINS``² bins over β ∈ [0.5, 4.0], u ∈ [0.02, 0.9]
  (the ranges `serve.loadgen.build_pool` and the baseline sweeps draw
  from), out-of-range queries clamped into the edge bins. Fixed binning
  makes surfaces mergeable bin for bin.
- **Heavy-hitter sketch** (Misra-Gries, ``SBR_DEMAND_TOPK`` counters)
  over query fingerprints: deterministic for a given stream and
  mergeable (itemwise sum, then the uniform (k+1)-th-count offset, so
  ``a.merge(b)`` equals ``b.merge(a)`` item for item). Each tracked item
  carries its exact (β, u, scenario, kind).
- **Answer-source labels** per bin (lru, disk, coalesced, computed,
  tilecache): every hot bin carries its warm/cold split.

On top sits the **prefetch advisor** (`advisor_plan`): a pure function
from (demand surface × tile-cache coverage) to a ranked tile plan, per
hot bin the exact β/u axes of its tracked heavy hitters, scored by
``demand × (1 − covered fraction)``. The plan (``advisor_plan.json``) is
fingerprint-keyed and byte-stable: the same stream against the same
coverage gives the same bytes here and in the reference.

Coverage comes from the port's own tile cache (`coverage_from_cache_dir`
reads its ``*.meta.json`` sidecars); a sidecar whose cell tag lacks the
port's backend tag was written by ``sbr_tpu`` and is skipped, as the
serving ladder skips it.

Surfaces flow to a ``demand`` block on ``/statz``, ``sbr_demand_*``
gauges on ``/metrics``, a rolling ``demand.json`` and offline replay
(``python -m sbr_tpu_torch.obs.demand replay`` over loadgen
``--trace-out`` rows; rows without (β, u) are counted and skipped).

``SBR_DEMAND=0`` (the default) is a structural no-op: the serving path
never imports this module, the engine holds no tracker, ``/metrics``
carries no ``sbr_demand`` bytes and answers are bit-identical.

Imports no torch: ``report demand`` and replay run without a device
runtime.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from sbr_tpu_torch.obs import switch_on

# ---------------------------------------------------------------------------
# Env knobs
# ---------------------------------------------------------------------------

#: The fixed demand-grid ranges — the Figure-4/5 sweep ranges shared with
#: `serve.loadgen.build_pool` and the baseline β/u sweeps, so demand bins
#: line up with the tile footprints an elastic sweep would compute.
BETA_RANGE = (0.5, 4.0)
U_RANGE = (0.02, 0.9)

SURFACE_SCHEMA = "sbr-demand/1"
LIVE_SCHEMA = "sbr-demand-live/1"
PLAN_SCHEMA = "sbr-demand-advisor/1"

#: Heartbeat blocks cap their cell table so a wide workload cannot bloat
#: every beat (the sketch already bounds the fingerprint side).
_MAX_HB_CELLS = 64


def enabled() -> bool:
    """Whether the demand observatory is on (``SBR_DEMAND``; default off —
    and off must be a structural no-op, see the module docstring)."""
    return switch_on("SBR_DEMAND")


def topk() -> int:
    """Sketch capacity (``SBR_DEMAND_TOPK``, default 32 counters)."""
    env = os.environ.get("SBR_DEMAND_TOPK", "").strip()
    return max(int(env), 1) if env else 32


def bins_n() -> int:
    """Bins per axis of the (β, u) histogram (``SBR_DEMAND_BINS``,
    default 16 → 256 fixed bins)."""
    env = os.environ.get("SBR_DEMAND_BINS", "").strip()
    return max(int(env), 1) if env else 16


def coverage_floor() -> Optional[float]:
    """The `report demand` gate floor (``SBR_DEMAND_COVERAGE_FLOOR``):
    hot-region warm coverage below it exits 1. None = gate disarmed."""
    env = os.environ.get("SBR_DEMAND_COVERAGE_FLOOR", "").strip()
    return float(env) if env else None


# ---------------------------------------------------------------------------
# Binning + fingerprints
# ---------------------------------------------------------------------------


def bin_of(beta: float, u: float, nb: int) -> tuple:
    """(i, j) bin of one query on the fixed grid; out-of-range coordinates
    clamp into the edge bins so every query lands somewhere."""
    blo, bhi = BETA_RANGE
    ulo, uhi = U_RANGE
    i = int((float(beta) - blo) / (bhi - blo) * nb)
    j = int((float(u) - ulo) / (uhi - ulo) * nb)
    return (min(max(i, 0), nb - 1), min(max(j, 0), nb - 1))


def bin_bounds(i: int, j: int, nb: int) -> dict:
    """The (β, u) rectangle of bin (i, j) — hot-region table rendering."""
    blo, bhi = BETA_RANGE
    ulo, uhi = U_RANGE
    bw = (bhi - blo) / nb
    uw = (uhi - ulo) / nb
    return {
        "beta_lo": round(blo + i * bw, 6), "beta_hi": round(blo + (i + 1) * bw, 6),
        "u_lo": round(ulo + j * uw, 6), "u_hi": round(ulo + (j + 1) * uw, 6),
    }


def query_fingerprint(beta: float, u: float, scenario: str = "default",
                      kind: str = "plain") -> str:
    """Deterministic short fingerprint of one query shape. Hashed from the
    full-precision float reprs (the `params_doc` wire convention: repr
    round-trips exactly), so an engine-side record and an offline replay of
    the same traced query produce the SAME item — the cross-process
    mergeability contract of the sketch."""
    payload = f"{float(beta)!r}|{float(u)!r}|{scenario}|{kind}"
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Misra-Gries heavy-hitter sketch
# ---------------------------------------------------------------------------


class MisraGries:
    """Misra-Gries heavy-hitter summary with per-item payloads.

    ``k`` counters; any item with true frequency > N/(k+1) is guaranteed
    tracked, and every tracked count undershoots the true count by at most
    N/(k+1). Deterministic for a given stream (the decrement step touches
    ALL counters uniformly — no tie-breaking choice exists), and mergeable
    (`merge`: itemwise sum, then subtract the (k+1)-th largest combined
    count from everything and drop the non-positive — the Agarwal et al.
    mergeable-summaries combine, symmetric in its arguments so
    ``a.merge(b)`` equals ``b.merge(a)`` item for item).

    ``payloads`` carry each tracked item's exact (β, u, scenario, kind) —
    payloads are pure functions of the fingerprint, so merges can never
    conflict (first writer wins, all writers agree)."""

    __slots__ = ("k", "counters", "payloads")

    def __init__(self, k: int) -> None:
        self.k = max(int(k), 1)
        self.counters: Dict[str, int] = {}
        self.payloads: Dict[str, dict] = {}

    def update(self, item: str, payload: Optional[dict] = None, n: int = 1) -> None:
        c = self.counters
        n = int(n)
        if n <= 0:
            return
        if item in c:
            c[item] += n
            return
        while n > 0 and item not in c and len(c) >= self.k:
            # Batched decrement: one pass removes min(remaining, min-count)
            # from every counter (equivalent to that many unit decrements).
            d = min(n, min(c.values()))
            for key in list(c):
                c[key] -= d
                if c[key] <= 0:
                    del c[key]
                    self.payloads.pop(key, None)
            n -= d
        if n > 0:
            c[item] = c.get(item, 0) + n
            if payload is not None:
                self.payloads.setdefault(item, payload)

    def merge(self, other: "MisraGries") -> "MisraGries":
        """Pure combine (neither operand mutated); capacity = max(k, k')."""
        out = MisraGries(max(self.k, other.k))
        summed: Dict[str, int] = dict(self.counters)
        for item, n in other.counters.items():
            summed[item] = summed.get(item, 0) + n
        payloads = dict(other.payloads)
        payloads.update(self.payloads)  # agree by construction; self wins
        if len(summed) > out.k:
            offset = sorted(summed.values(), reverse=True)[out.k]
            summed = {i: n - offset for i, n in summed.items() if n - offset > 0}
        out.counters = summed
        out.payloads = {i: payloads[i] for i in summed if i in payloads}
        return out

    def top(self, n: Optional[int] = None) -> List[tuple]:
        """[(item, count, payload), ...] by descending count, item-sorted
        ties — fully deterministic for rendering and plan building."""
        ranked = sorted(self.counters.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            ranked = ranked[:n]
        return [(i, c, self.payloads.get(i)) for i, c in ranked]

    def to_doc(self) -> dict:
        return {
            "k": self.k,
            "items": [[i, c, p] for i, c, p in self.top()],
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "MisraGries":
        out = cls(int(doc.get("k") or 1))
        for entry in doc.get("items") or []:
            try:
                item, count = str(entry[0]), int(entry[1])
                payload = entry[2] if len(entry) > 2 else None
            except (TypeError, ValueError, IndexError):
                continue
            if count > 0:
                out.counters[item] = count
                if isinstance(payload, dict):
                    out.payloads[item] = payload
        return out


# ---------------------------------------------------------------------------
# Demand surfaces (the mergeable document)
# ---------------------------------------------------------------------------


def _surface_doc(counts: Dict[str, int], sources: Dict[str, Dict[str, int]],
                 sketch: MisraGries, nb: int, max_cells: Optional[int] = None) -> dict:
    cells = {}
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    if max_cells is not None:
        ranked = ranked[:max_cells]
    for key, n in ranked:
        cells[key] = {
            "count": int(n),
            "sources": {s: int(v) for s, v in sorted((sources.get(key) or {}).items())},
        }
    return {
        "schema": SURFACE_SCHEMA,
        "bins": int(nb),
        "beta_range": list(BETA_RANGE),
        "u_range": list(U_RANGE),
        "queries": int(sum(counts.values())),
        "cells": cells,
        "sketch": sketch.to_doc(),
    }


def merge_surfaces(surfaces: List[dict]) -> dict:
    """Fold N demand surfaces (worker heartbeat blocks, per-run totals)
    into one — the router's fleet merge and `report demand`'s multi-run
    merge. Surfaces on a different bin grid are skipped (counted in
    ``skipped_surfaces``): fixed binning is the merge contract; silently
    re-binning would smear the heatmap."""
    surfaces = [s for s in surfaces if isinstance(s, dict)]
    nb = None
    for s in surfaces:
        if isinstance(s.get("bins"), int):
            nb = s["bins"]
            break
    if nb is None:
        nb = bins_n()
    counts: Dict[str, int] = {}
    sources: Dict[str, Dict[str, int]] = {}
    sketch = MisraGries(topk())
    skipped = 0
    for s in surfaces:
        if s.get("bins") != nb:
            skipped += 1
            continue
        for key, cell in (s.get("cells") or {}).items():
            try:
                n = int(cell.get("count", 0))
            except (TypeError, AttributeError, ValueError):
                continue
            counts[key] = counts.get(key, 0) + n
            dst = sources.setdefault(key, {})
            for src, v in (cell.get("sources") or {}).items():
                dst[src] = dst.get(src, 0) + int(v)
        sketch = sketch.merge(MisraGries.from_doc(s.get("sketch") or {}))
    out = _surface_doc(counts, sources, sketch, nb)
    if skipped:
        out["skipped_surfaces"] = skipped
    return out


_WARM_SOURCES = ("lru", "disk", "coalesced", "tilecache")


def _cell_warm(cell: dict) -> int:
    srcs = cell.get("sources") or {}
    return sum(int(srcs.get(s, 0)) for s in _WARM_SOURCES)


def hot_bins(surface: dict, mass: float = 0.5) -> List[dict]:
    """The hot region: the smallest count-ranked set of bins covering at
    least ``mass`` of the window's queries (ties broken by bin key — fully
    deterministic). Each entry carries its warm/cold split from the
    answer-source labels."""
    cells = surface.get("cells") or {}
    total = sum(int(c.get("count", 0)) for c in cells.values())
    if total <= 0:
        return []
    nb = int(surface.get("bins") or bins_n())
    ranked = sorted(cells.items(), key=lambda kv: (-int(kv[1].get("count", 0)), kv[0]))
    out, cum = [], 0
    for key, cell in ranked:
        n = int(cell.get("count", 0))
        if n <= 0:
            break
        warm = _cell_warm(cell)
        try:
            i, j = (int(v) for v in key.split(","))
        except ValueError:
            continue
        out.append({
            "bin": key,
            **bin_bounds(i, j, nb),
            "count": n,
            "share": round(n / total, 4),
            "warm": warm,
            "warm_coverage": round(warm / n, 4),
        })
        cum += n
        if cum >= mass * total:
            break
    return out


# ---------------------------------------------------------------------------
# Tile-cache coverage + the prefetch advisor
# ---------------------------------------------------------------------------


#: The backend tag (`utils.checkpoint.BACKEND`) as it sits in a canonical
#: cell tag: ``[..., dtype, 'torch', version]``. A reference tag holds its
#: x64 flag there instead. Kept as a copy: this module imports no torch.
_BACKEND_TOKEN = ",'torch',"


def coverage_from_cache_dir(cache_dir) -> Optional[dict]:
    """Scan a tile-cache root's ``*.meta.json`` cell-index sidecars
    (`resilience.elastic.tile_meta`) into the advisor's coverage input:
    the exact (β, u) cells the cache can already answer. Torn or alien
    sidecars are skipped (the `TileCacheBridge._scan` tolerance), and so
    is a sidecar whose cell tag lacks the port's backend tag: ``sbr_tpu``
    wrote it, and the port's serving ladder never answers from it. None
    when the root does not exist (no cache configured ≠ an empty cache)."""
    root = Path(cache_dir)
    if not root.is_dir():
        return None
    pairs = set()
    entries = 0
    for meta_path in sorted(root.rglob("*.meta.json")):
        try:
            meta = json.loads(meta_path.read_text())
            if _BACKEND_TOKEN not in str(meta["cell_tag"]):
                continue
            betas = [float(b) for b in meta["betas"]]
            us = [float(u) for u in meta["us"]]
        except (OSError, ValueError, KeyError, TypeError):
            continue
        entries += 1
        for b in betas:
            for u in us:
                pairs.add((b, u))
    return {
        "entries": entries,
        "pairs": sorted([b, u] for b, u in pairs),
    }


def _coverage_pairs(coverage: Optional[dict]) -> set:
    out = set()
    for pair in (coverage or {}).get("pairs") or []:
        try:
            out.add((float(pair[0]), float(pair[1])))
        except (TypeError, ValueError, IndexError):
            continue
    return out


def advisor_plan(surface: dict, coverage: Optional[dict] = None,
                 max_tiles: int = 8, floor: Optional[float] = None) -> dict:
    """The prefetch advisor: PURE deterministic function from (merged
    demand surface × tile-cache coverage) to a ranked tile plan.

    Per hot bin, the tile is the exact sorted β/u axes of the sketch's
    tracked heavy hitters inside the bin — precisely the cells a sweep
    must compute for `TileCacheBridge.lookup`'s exact-membership match to
    serve them warm. Tiles are scored ``demand_weight × (1 − covered
    fraction)`` (a fully covered hot bin ranks zero — nothing to
    prefetch) and ranked by (-score, bin). The plan is fingerprint-keyed
    (sha256 over its canonical JSON) and byte-stable: no timestamps, keys
    sorted — two processes replaying the same stream against the same
    cache write identical bytes."""
    hot = hot_bins(surface)
    nb = int(surface.get("bins") or bins_n())
    covered = _coverage_pairs(coverage)
    sketch = MisraGries.from_doc(surface.get("sketch") or {})
    by_bin: Dict[str, list] = {}
    for item, count, payload in sketch.top():
        if not isinstance(payload, dict):
            continue
        try:
            b, u = float(payload["beta"]), float(payload["u"])
        except (KeyError, TypeError, ValueError):
            continue
        i, j = bin_of(b, u, nb)
        by_bin.setdefault(f"{i},{j}", []).append((item, count, b, u))
    tiles = []
    for entry in hot:
        items = by_bin.get(entry["bin"]) or []
        betas = sorted({b for _, _, b, _ in items})
        us = sorted({u for _, _, _, u in items})
        weight = sum(c for _, c, _, _ in items)
        covered_weight = sum(c for _, c, b, u in items if (b, u) in covered)
        tile_cov = round(covered_weight / weight, 4) if weight else 0.0
        score = entry["count"] * (1.0 - tile_cov)
        tiles.append({
            "bin": entry["bin"],
            "count": entry["count"],
            "warm_coverage": entry["warm_coverage"],
            "tile_coverage": tile_cov,
            "score": round(score, 4),
            "betas": betas,
            "us": us,
            "cells": len(betas) * len(us),
            "fingerprints": [i for i, _, _, _ in items],
        })
    tiles.sort(key=lambda t: (-t["score"], t["bin"]))
    tiles = tiles[:max_tiles]
    for rank, t in enumerate(tiles, start=1):
        t["rank"] = rank
    plan = {
        "schema": PLAN_SCHEMA,
        "bins": nb,
        "beta_range": list(BETA_RANGE),
        "u_range": list(U_RANGE),
        "surface_queries": int(surface.get("queries") or 0),
        "coverage_floor": floor,
        "cache_entries": (coverage or {}).get("entries"),
        "tiles": tiles,
    }
    plan["plan_fingerprint"] = hashlib.sha256(
        json.dumps(plan, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]
    return plan


def plan_bytes(plan: dict) -> bytes:
    """The canonical byte form of a plan — what `write_plan` lands and the
    cross-process determinism witness compares."""
    return (json.dumps(plan, sort_keys=True, separators=(",", ":")) + "\n").encode()


def write_plan(plan: dict, path) -> Path:
    """Atomically write ``advisor_plan.json`` (tmp + rename, the manifest
    discipline) in its canonical byte form."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(plan_bytes(plan))
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# The streaming tracker (engine-side)
# ---------------------------------------------------------------------------


class _Slot:
    """One time slot of the rolling demand window (the `serve.live`
    epoch-replacement idiom: recording touches only the current slot,
    stale slots are replaced wholesale by one reference assignment)."""

    __slots__ = ("epoch", "counts", "sources", "sketch")

    def __init__(self, epoch: int, k: int) -> None:
        self.epoch = epoch
        self.counts: Dict[str, int] = {}
        self.sources: Dict[str, Dict[str, int]] = {}
        self.sketch = MisraGries(k)


class DemandTracker:
    """Streaming workload observatory for one serving engine.

    Windowing reuses the serve slot machinery: the window
    (``SBR_SERVE_WINDOW_S``, default 60 s) divides into the same 12 slots
    `serve.live.LiveMetrics` uses, with the same lock-free contract (the
    hot path runs on the single batcher thread; a scrape racing a slot
    rotation folds either the old or the new slot, never corrupts state).
    Lifetime totals accumulate beside the window for `report demand`.

    ``time_fn`` is injectable so tests drive window expiry without
    sleeping. ``coverage_fn`` (optional, engine-supplied) feeds the
    advisor the live tile-cache coverage at snapshot time."""

    def __init__(self, window_s: Optional[float] = None,
                 bins: Optional[int] = None, topk_n: Optional[int] = None,
                 time_fn=time.monotonic, run=None, coverage_fn=None) -> None:
        from sbr_tpu_torch.serve import live as _live

        self.window_s = float(window_s) if window_s else _live.window_seconds()
        self._n_slots = _live._N_SLOTS
        self._slot_s = self.window_s / self._n_slots
        self.bins = int(bins) if bins else bins_n()
        self.k = int(topk_n) if topk_n else topk()
        self._time = time_fn
        self._run = run
        self._coverage_fn = coverage_fn
        self._slots = [_Slot(-1, self.k) for _ in range(self._n_slots)]
        self.totals_counts: Dict[str, int] = {}
        self.totals_sources: Dict[str, Dict[str, int]] = {}
        self.totals_sketch = MisraGries(self.k)
        self.queries_total = 0
        self._last_write = 0.0
        self._last_rotate = self._time()
        self._rotations = 0

    # -- recording (engine batcher thread) ----------------------------------
    def _slot(self) -> _Slot:
        epoch = int(self._time() / self._slot_s)
        pos = epoch % self._n_slots
        slot = self._slots[pos]
        if slot.epoch != epoch:
            slot = _Slot(epoch, self.k)
            self._slots[pos] = slot
        return slot

    def record(self, beta: float, u: float, scenario: str = "default",
               kind: str = "plain", source: str = "computed") -> None:
        """One served query. Never raises: demand telemetry must not sink
        the serving path (the `LiveMetrics` contract)."""
        try:
            i, j = bin_of(beta, u, self.bins)
            key = f"{i},{j}"
            fp = query_fingerprint(beta, u, scenario, kind)
            payload = {"beta": float(beta), "u": float(u),
                       "scenario": scenario, "kind": kind}
            slot = self._slot()
            slot.counts[key] = slot.counts.get(key, 0) + 1
            srcs = slot.sources.setdefault(key, {})
            srcs[source] = srcs.get(source, 0) + 1
            slot.sketch.update(fp, payload)
            self.totals_counts[key] = self.totals_counts.get(key, 0) + 1
            tsrcs = self.totals_sources.setdefault(key, {})
            tsrcs[source] = tsrcs.get(source, 0) + 1
            self.totals_sketch.update(fp, payload)
            self.queries_total += 1
        except Exception:
            pass

    def record_params(self, params, scenario: str = "default",
                      source: str = "computed", grads: bool = False,
                      kind: Optional[str] = None) -> None:
        """Engine hook: one fulfilled query (β/u read off the params). The
        kind defaults to the grads flag; composed routes pass their own
        ("scenario" / "population")."""
        try:
            self.record(
                params.learning.beta, params.economic.u, scenario=scenario,
                kind=kind or ("grads" if grads else "plain"), source=source,
            )
        except Exception:
            pass

    # -- reading ------------------------------------------------------------
    def _window_fold(self) -> tuple:
        """(counts, sources, sketch) over the live slots, folded in epoch
        order — ONE fold per exposition, deterministic slot order."""
        min_epoch = int(self._time() / self._slot_s) - self._n_slots + 1
        counts: Dict[str, int] = {}
        sources: Dict[str, Dict[str, int]] = {}
        sketch = MisraGries(self.k)
        for slot in sorted(list(self._slots), key=lambda s: s.epoch):
            if slot.epoch < min_epoch:
                continue
            for key, n in list(slot.counts.items()):
                counts[key] = counts.get(key, 0) + n
            for key, srcs in list(slot.sources.items()):
                dst = sources.setdefault(key, {})
                for s, v in list(srcs.items()):
                    dst[s] = dst.get(s, 0) + v
            sketch = sketch.merge(slot.sketch)
        return counts, sources, sketch

    def window_surface(self) -> dict:
        counts, sources, sketch = self._window_fold()
        out = _surface_doc(counts, sources, sketch, self.bins)
        out["window_s"] = self.window_s
        return out

    def totals_surface(self) -> dict:
        return _surface_doc(
            self.totals_counts, self.totals_sources, self.totals_sketch, self.bins
        )

    def snapshot(self) -> dict:
        """The `/statz` demand block and the rolling ``demand.json`` body
        (minus the `ts` stamp the writer adds)."""
        window = self.window_surface()
        totals = self.totals_surface()
        return {
            "schema": LIVE_SCHEMA,
            "bins": self.bins,
            "topk": self.k,
            "queries_total": self.queries_total,
            "window": window,
            "totals": totals,
            "hot_bins": hot_bins(window),
        }

    def heartbeat_block(self) -> dict:
        """The compact surface riding worker heartbeats (what the router
        merges into the fleet demand surface). The cell table caps at the
        hottest `_MAX_HB_CELLS` bins; the sketch is already k-bounded."""
        counts, sources, sketch = self._window_fold()
        return _surface_doc(counts, sources, sketch, self.bins,
                            max_cells=_MAX_HB_CELLS)

    def prometheus_lines(self) -> list:
        """``sbr_demand_*`` exposition. SBR_DEMAND=0 engines contribute
        NOTHING (the tracker doesn't exist) — tests assert the exposition
        is byte-free of the prefix when demand is off."""
        window = self.window_surface()
        hot = hot_bins(window)
        hot_q = sum(h["count"] for h in hot)
        hot_warm = sum(h["warm"] for h in hot)
        cov = hot_warm / hot_q if hot_q else 0.0
        return [
            "# TYPE sbr_demand_queries_total counter",
            f"sbr_demand_queries_total {self.queries_total}",
            "# TYPE sbr_demand_window_queries gauge",
            f"sbr_demand_window_queries {window['queries']}",
            "# TYPE sbr_demand_hot_bins gauge",
            f"sbr_demand_hot_bins {len(hot)}",
            "# TYPE sbr_demand_hot_warm_coverage gauge",
            f"sbr_demand_hot_warm_coverage {cov:g}",
            "# TYPE sbr_demand_sketch_items gauge",
            f"sbr_demand_sketch_items {len(window['sketch']['items'])}",
        ]

    # -- rolling snapshot + advisor artifact --------------------------------
    def _rotate_s(self) -> float:
        env = os.environ.get("SBR_DEMAND_ROTATE_S", "").strip()
        return float(env) if env else 0.0

    def maybe_write(self, run, min_interval_s: float = 0.5,
                    force: bool = False) -> bool:
        """Write the rolling ``demand.json`` through ``run.live_snapshot``
        at a bounded cadence (``force`` for the final write at engine
        close, which also lands ``advisor_plan.json``). With
        ``SBR_DEMAND_ROTATE_S`` set, the previous snapshot is archived as
        ``demand.NNN.json`` before each rotation-due overwrite (what
        ``report gc --demand-keep`` prunes). Never raises."""
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
            doc = self.snapshot()
            doc["ts"] = round(time.time(), 3)
            run.live_snapshot(doc, name="demand.json")
            if force:
                coverage = None
                if self._coverage_fn is not None:
                    try:
                        coverage = self._coverage_fn()
                    except Exception:
                        coverage = None
                plan = advisor_plan(self.totals_surface(), coverage,
                                    floor=coverage_floor())
                write_plan(plan, Path(run.run_dir) / "advisor_plan.json")
                try:
                    run.log_demand("plan", tiles=len(plan["tiles"]),
                                   fingerprint=plan["plan_fingerprint"])
                except Exception:
                    pass
            return True
        except Exception:
            return False

    def _archive_snapshot(self, run) -> None:
        """Archive the active ``demand.json`` as the next free
        ``demand.NNN.json`` (rotation — the gc candidates)."""
        active = Path(run.run_dir) / "demand.json"
        if not active.exists():
            return
        idx = self._rotations
        while (Path(run.run_dir) / f"demand.{idx:03d}.json").exists():
            idx += 1
        (Path(run.run_dir) / f"demand.{idx:03d}.json").write_bytes(
            active.read_bytes()
        )
        self._rotations = idx + 1
        try:
            run.log_demand("rotate", index=idx)
        except Exception:
            pass

    def close(self, run) -> None:
        """Final force-write at engine close (rolling snapshot + advisor
        plan artifact)."""
        self.maybe_write(run, force=True)


# ---------------------------------------------------------------------------
# Retention (report gc --demand-keep)
# ---------------------------------------------------------------------------


def gc_demand_files(root, keep: int = 4,
                    running_grace_s: float = 6 * 3600.0) -> list:
    """Prune rotated demand snapshots (``demand.NNN.json``) and aged
    advisor plans (``advisor_plan.NNN.json``) inside each run dir under
    ``root`` down to the newest ``keep`` per kind, mirroring the
    ``--trace-keep`` / ``--audit-keep`` contract: live runs (manifest
    "running" with recent mtime) are never touched, and the ACTIVE
    ``demand.json`` / ``advisor_plan.json`` are never candidates (the
    globs require the rotation's second dot). Returns removed paths."""
    from sbr_tpu_torch.obs import runlog

    keep = max(int(keep), 0)
    removed: list = []
    root = Path(root)
    if not root.is_dir():
        return removed
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        if runlog._run_is_live(d, running_grace_s):
            continue
        for pattern in ("demand.*.json", "advisor_plan.*.json"):
            rotated = sorted(d.glob(pattern))
            for path in rotated[: max(len(rotated) - keep, 0)]:
                try:
                    path.unlink()
                    removed.append(str(path))
                except OSError:
                    pass
    return removed


# ---------------------------------------------------------------------------
# Offline replay (loadgen --trace-out rows)
# ---------------------------------------------------------------------------


def replay_rows(rows, bins: Optional[int] = None,
                topk_n: Optional[int] = None) -> tuple:
    """Rebuild a demand surface from loadgen ``--trace-out`` rows.

    Backfill-tolerant reader (the satellite contract): legacy rows without
    the (β, u) coordinates are counted in
    ``legacy_rows`` and skipped, never a crash; rows without an answer
    source label land under source "unknown" (cold). Returns
    ``(surface, stats)``. No wall-clock anywhere: replaying the same
    stream twice (in two processes) yields an identical surface — the
    byte-identical advisor-plan witness builds on this."""
    nb = int(bins) if bins else bins_n()
    k = int(topk_n) if topk_n else topk()
    counts: Dict[str, int] = {}
    sources: Dict[str, Dict[str, int]] = {}
    sketch = MisraGries(k)
    stats = {"rows": 0, "replayed": 0, "legacy_rows": 0, "bad_rows": 0}
    for row in rows:
        stats["rows"] += 1
        if not isinstance(row, dict):
            stats["bad_rows"] += 1
            continue
        beta, u = row.get("beta"), row.get("u")
        if not (isinstance(beta, (int, float)) and isinstance(u, (int, float))
                and math.isfinite(beta) and math.isfinite(u)):
            stats["legacy_rows"] += 1
            continue
        scenario = str(row.get("scenario") or "mix")
        kind = str(row.get("kind") or "plain")
        source = str(row.get("source") or "unknown")
        i, j = bin_of(beta, u, nb)
        key = f"{i},{j}"
        counts[key] = counts.get(key, 0) + 1
        srcs = sources.setdefault(key, {})
        srcs[source] = srcs.get(source, 0) + 1
        sketch.update(
            query_fingerprint(beta, u, scenario, kind),
            {"beta": float(beta), "u": float(u),
             "scenario": scenario, "kind": kind},
        )
        stats["replayed"] += 1
    return _surface_doc(counts, sources, sketch, nb), stats


def _iter_trace_rows(paths):
    """JSONL rows from loadgen ``--trace-out`` files; torn lines are
    yielded as None (counted as bad rows by `replay_rows`)."""
    for path in paths:
        with open(path, "r") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    yield None


def _main_replay(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.demand replay",
        description="Rebuild a demand surface (and optionally the advisor "
        "plan) from loadgen --trace-out JSONL rows; deterministic — two "
        "replays of the same stream write byte-identical plans",
    )
    parser.add_argument("traces", nargs="+", help="loadgen --trace-out file(s)")
    parser.add_argument("--bins", type=int, default=None,
                        help="bins per axis (default SBR_DEMAND_BINS or 16)")
    parser.add_argument("--topk", type=int, default=None,
                        help="sketch capacity (default SBR_DEMAND_TOPK or 32)")
    parser.add_argument("--cache-dir", default=None, dest="cache_dir",
                        help="tile-cache root whose *.meta.json sidecars "
                        "feed the advisor's coverage input")
    parser.add_argument("--plan-out", default=None, dest="plan_out",
                        help="write the ranked advisor plan here "
                        "(canonical bytes — the determinism witness)")
    parser.add_argument("--out", default=None,
                        help="also write the rebuilt surface JSON here")
    parser.add_argument("--floor", type=float, default=None,
                        help="gate: exit 1 when hot-region warm coverage "
                        "is under FLOOR (default: no gate)")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    for p in args.traces:
        if not Path(p).is_file():
            print(f"error: not a trace file: {p}", file=sys.stderr)
            return 2
    surface, stats = replay_rows(
        _iter_trace_rows(args.traces), bins=args.bins, topk_n=args.topk
    )
    if stats["replayed"] == 0:
        print("no replayable rows (no (beta, u) coordinates, or an empty "
              "file)", file=sys.stderr)
        return 3
    coverage = coverage_from_cache_dir(args.cache_dir) if args.cache_dir else None
    plan = advisor_plan(surface, coverage, floor=args.floor)
    if args.plan_out:
        write_plan(plan, args.plan_out)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(surface, sort_keys=True) + "\n")
    hot = hot_bins(surface)
    hot_q = sum(h["count"] for h in hot)
    hot_warm = sum(h["warm"] for h in hot)
    cov = hot_warm / hot_q if hot_q else 0.0
    doc = {
        "stats": stats,
        "queries": surface["queries"],
        "hot_bins": hot,
        "hot_warm_coverage": round(cov, 4),
        "plan_fingerprint": plan["plan_fingerprint"],
        "planned_tiles": len(plan["tiles"]),
    }
    if args.json:
        print(json.dumps(doc, sort_keys=True))
    else:
        print(f"replayed {stats['replayed']}/{stats['rows']} row(s) "
              f"({stats['legacy_rows']} legacy, {stats['bad_rows']} bad) -> "
              f"{len(hot)} hot bin(s), warm coverage {cov:.3f}, "
              f"plan {plan['plan_fingerprint']} "
              f"({len(plan['tiles'])} tile(s))")
    if args.floor is not None and cov < args.floor:
        print(f"hot-region warm coverage {cov:.3f} under floor "
              f"{args.floor:g}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "replay":
        return _main_replay(argv[1:])
    print("usage: python -m sbr_tpu_torch.obs.demand replay TRACE.jsonl... "
          "[--plan-out PLAN] [--cache-dir DIR] [--json]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
