"""Dispatch circuit breaking, the per-query deadline default and the
tile-cache rung of the degradation ladder: the port of `CircuitBreaker`,
`default_deadline_ms`, `_env_float` and `TileCacheBridge` from
``sbr_tpu.serve.fleet``.

`CircuitBreaker` is the closed → open → half-open state machine the
engine holds over its own device dispatch: ``threshold`` consecutive
failures open it, ``cooldown_s`` later exactly one half-open probe is let
through, and a success closes it. Injectable clock, no threads: the state
advances lazily on `allow()` reads.

`TileCacheBridge` answers a point query from the cross-run tile cache
(`resilience.elastic.TileCache`) when the solver path is down: only a
cell whose tag and (β, u) match the query exactly.

Fleet membership (`WorkerAnnouncer`, `live_workers`) and the worker
process entry wait for the fleet (ROADMAP 1.A item 10).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

from sbr_tpu_torch.resilience.elastic import cell_tag, default_tile_cache


def default_deadline_ms() -> Optional[float]:
    """Fleet-wide default per-query deadline (``SBR_SERVE_DEADLINE_MS``);
    None when unset (queries without an explicit deadline never shed)."""
    raw = os.environ.get("SBR_SERVE_DEADLINE_MS", "").strip()
    return float(raw) if raw else None


def _env_float(name: str, default):
    """Float env override with a passthrough default (None allowed)."""
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


class CircuitBreaker:
    """Consecutive-failure breaker: closed → open → half-open → closed.

    ``allow()`` is the single gate: True while closed; False while open
    until ``cooldown_s`` has elapsed, then exactly ONE True (the half-open
    probe) until its outcome lands — a success closes the breaker, a
    failure re-opens it (and restarts the cooldown). Lazy state (no timer
    thread), injectable ``clock`` so tests drive transitions
    deterministically. ``on_transition(old, new)`` observes state changes.
    """

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None) -> None:
        self.threshold = int(threshold if threshold is not None
                             else _env_float("SBR_BREAKER_THRESHOLD", 3))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _env_float("SBR_BREAKER_COOLDOWN_S", 5.0))
        self._clock = clock
        self._on_transition = on_transition
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        # Monotonic time of the last state change (None = never changed),
        # to tell a breaker legitimately open from one stuck open.
        self.last_transition_at: Optional[float] = None

    def age_s(self) -> Optional[float]:
        """Seconds since the last state transition (None = never moved)."""
        if self.last_transition_at is None:
            return None
        return self._clock() - self.last_transition_at

    def _transition(self, new: str) -> None:
        old = self.state
        if old == new:
            return
        self.state = new
        self.last_transition_at = self._clock()
        if self._on_transition is not None:
            try:
                self._on_transition(old, new)
            except Exception:
                pass  # observation must never sink the breaker

    def admissible(self) -> bool:
        """Side-effect-free view of `allow()`: would a request be admitted
        right now? Candidate *selection* must use this — `allow()` grants
        the single half-open probe, and granting it to a worker that is
        merely being RANKED (not forwarded to) would strand the breaker in
        half_open forever, since no outcome ever lands for that probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            return self._clock() - (self._opened_at or 0.0) >= self.cooldown_s
        return not self._probe_inflight

    def allow(self) -> bool:
        """Whether one request may proceed right now (see class docstring).
        Call this only when the request will actually be SENT — a True in
        half-open state grants the single probe, and the caller then owes
        the breaker a `record_success`/`record_failure` outcome."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._clock() - (self._opened_at or 0.0) >= self.cooldown_s:
                self._transition("half_open")
                self._probe_inflight = True
                return True
            return False
        # half_open: one probe at a time — concurrent traffic keeps waiting
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._probe_inflight = False
        self._transition("closed")

    def record_abandoned(self) -> None:
        """The request ended with no verdict on the PEER (e.g. the query's
        own deadline expired in flight): release a held half-open probe
        without moving the state machine in either direction."""
        self._probe_inflight = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        self._probe_inflight = False
        if self.state == "half_open" or (
            self.state == "closed" and self.consecutive_failures >= self.threshold
        ):
            self._opened_at = self._clock()
            self._transition("open")


class TileCacheBridge:
    """Point-query lookups in the cross-run tile cache.

    The cache stores whole tiles by content; the ``<key>.meta.json``
    sidecar of a plain tile (`resilience.elastic.TileCache.store`) holds
    its cell tag and β/u axes, which make its cells addressable one by
    one. The bridge keeps an index of those sidecars, invalidated by
    mtime: only shard directories whose mtime moved since the last scan
    are listed again, and only new or rewritten sidecars parsed again.
    `lookup` returns the verified entry's exact (β, u) cell, or None on
    any miss, mismatch or corruption. Every read goes through
    `TileCache.load`, so the sha256 check and the quarantine apply."""

    #: A directory whose mtime is this close to "now" is listed again even
    #: when its mtime looks unchanged: a store landing in the same mtime
    #: tick as a scan must not be missed.
    MTIME_SLACK_S = 3.0

    def __init__(self, cache_dir=None, refresh_s: float = 5.0) -> None:
        self.cache = default_tile_cache(cache_dir)
        self.refresh_s = refresh_s
        self._index: Dict[str, list] = {}  # cell tag -> [meta, ...]
        self._scanned_at: Optional[float] = None
        self._dir_mtimes: Dict[str, float] = {}
        # sidecar path -> {"mtime", "tag", "meta"} (tag None: torn or alien)
        self._entries: Dict[str, dict] = {}

    @property
    def available(self) -> bool:
        return self.cache is not None

    def _scan(self) -> None:
        now_wall = time.time()
        root = self.cache.root
        dirs = [root]
        try:
            dirs += [p for p in root.iterdir() if p.is_dir()]
        except OSError:
            dirs = [root]
        seen_dirs = set()
        for d in dirs:
            dkey = str(d)
            seen_dirs.add(dkey)
            try:
                mtime = d.stat().st_mtime
            except OSError:
                continue
            prev = self._dir_mtimes.get(dkey)
            if prev is not None and mtime == prev and now_wall - mtime > self.MTIME_SLACK_S:
                continue  # nothing stored or removed here since the last list
            self._dir_mtimes[dkey] = mtime
            try:
                files = list(d.glob("*.meta.json"))
            except OSError:
                continue
            live = set()
            for meta_path in files:
                fkey = str(meta_path)
                live.add(fkey)
                try:
                    fm = meta_path.stat().st_mtime
                except OSError:
                    continue
                ent = self._entries.get(fkey)
                if ent is not None and ent["mtime"] == fm:
                    continue
                try:
                    meta = json.loads(meta_path.read_text())
                    parsed = {
                        "key": str(meta["key"]),
                        "betas": [float(b) for b in meta["betas"]],
                        "us": [float(u) for u in meta["us"]],
                    }
                    tag = str(meta["cell_tag"])
                except (OSError, ValueError, KeyError, TypeError):
                    tag, parsed = None, None
                self._entries[fkey] = {"mtime": fm, "tag": tag, "meta": parsed}
            for fkey in [k for k in self._entries
                         if os.path.dirname(k) == dkey and k not in live]:
                del self._entries[fkey]  # sidecar removed (gc, quarantine)
        for dkey in [k for k in self._dir_mtimes if k not in seen_dirs]:
            del self._dir_mtimes[dkey]
            for fkey in [k for k in self._entries if os.path.dirname(k) == dkey]:
                del self._entries[fkey]
        index: Dict[str, list] = {}
        for fkey in sorted(self._entries):
            ent = self._entries[fkey]
            if ent["tag"] is not None:
                index.setdefault(ent["tag"], []).append(ent["meta"])
        self._index = index
        self._scanned_at = time.monotonic()

    def lookup(self, params, config, dtype_name: str) -> Optional[dict]:
        """The degraded answer to one query, or None: a match by exact cell
        tag and exact (β, u) membership in a swept tile's axes, so the
        bridge serves only cells that are the query."""
        if self.cache is None:
            return None
        now = time.monotonic()
        if self._scanned_at is None or now - self._scanned_at >= self.refresh_s:
            self._scan()
        tag = cell_tag(params, config, dtype_name)
        beta = float(params.learning.beta)
        u = float(params.economic.u)
        for meta in self._index.get(tag, []):
            if beta not in meta["betas"] or u not in meta["us"]:
                continue
            arrays = self.cache.load(meta["key"], tile="serve-bridge")
            if arrays is None:
                continue  # quarantined or raced away: try another tile
            i = meta["betas"].index(beta)
            j = meta["us"].index(u)
            try:
                return {
                    "xi": float(arrays["xi"][i, j]),
                    "tau_bar_in": float("nan"),  # tiles do not store it
                    "aw_max": float(arrays["max_aw"][i, j]),
                    "status": int(arrays["status"][i, j]),
                    "flags": 0,
                    "residual": float("nan"),
                }
            except (IndexError, KeyError, ValueError):
                continue  # the meta drifted from the entry: not an answer
        return None
