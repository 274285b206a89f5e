"""Serving-fleet membership, circuit breaking, the tile-cache rung of the
degradation ladder and the fleet worker process: the port of
``sbr_tpu.serve.fleet``.

- **Membership.** A serve worker announces itself with the heartbeat
  files of the elastic sweep (`resilience.elastic.Heartbeat`: atomic
  rewrite, TTL, handed back by `resilience.shutdown`), written into a
  shared *fleet dir* (``SBR_FLEET_DIR``). A beat carries the worker's HTTP
  endpoint (``url``) and its live numbers (qps, p50 ms, inflight, queue
  depth, ``/healthz``), and, while their switches are on, the audit,
  demand, prewarm and flight blocks: the router's cost model and its
  quarantine read the same record as the membership check.
  `live_workers` is `elastic.live_hosts` restricted to records with an
  endpoint.
- **Circuit breaking.** `CircuitBreaker` is the closed → open → half-open
  state machine: ``threshold`` consecutive failures open it,
  ``cooldown_s`` later exactly one half-open probe is let through, and a
  success closes it. The router holds one per worker, the engine one over
  its own dispatch. Injectable clock, no threads: the state advances
  lazily on `allow()` reads.
- **Tile-cache rung.** `TileCacheBridge` answers a point query from the
  cross-run tile cache (`resilience.elastic.TileCache`) when the solver
  path is down: only a cell whose tag and (β, u) match the query exactly.

Worker process: ``python -m sbr_tpu_torch.serve.fleet --fleet-dir DIR``
runs one engine, its endpoint and the heartbeat loop under the graceful
shutdown envelope. The engine runs on the CUDA card unless ``--device
cpu``; with no card and no ``--device cpu`` the worker exits 2 before it
announces anything. SIGTERM finishes in-flight batches, removes the
heartbeat (peers reclaim at once instead of waiting out the TTL) and
finalizes the obs manifest as ``"interrupted"`` (exit 143).

Standard library and numpy at import: the router and loadgen's fleet
mode import this module without starting a device runtime.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from sbr_tpu_torch.resilience import elastic
from sbr_tpu_torch.resilience.elastic import cell_tag, default_tile_cache


def fleet_dir(value=None) -> Optional[Path]:
    """The shared fleet rendezvous dir (``SBR_FLEET_DIR``); None = no fleet
    (single-process serving)."""
    root = value or os.environ.get("SBR_FLEET_DIR", "").strip()
    return Path(root) if root else None


def default_deadline_ms() -> Optional[float]:
    """Fleet-wide default per-query deadline (``SBR_SERVE_DEADLINE_MS``);
    None when unset (queries without an explicit deadline never shed)."""
    raw = os.environ.get("SBR_SERVE_DEADLINE_MS", "").strip()
    return float(raw) if raw else None


def _env_float(name: str, default):
    """Float env override with a passthrough default (None allowed)."""
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


class WorkerAnnouncer:
    """One serve worker's membership record: an `elastic.Heartbeat` in the
    fleet dir whose stats carry the worker's endpoint and live numbers.
    `beat` passes through the ``fleet.heartbeat`` fault point, so a fault
    plan can silence a worker's beats (the router then ages it out by the
    TTL, as it would a silent death)."""

    def __init__(self, fleet_root, url: str, ttl_s: Optional[float] = None,
                 host: Optional[str] = None) -> None:
        self.root = Path(fleet_root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.url = url
        self.hb = elastic.Heartbeat(self.root, host=host, ttl_s=ttl_s)
        self.host = self.hb.host

    def beat(self, **stats) -> None:
        from sbr_tpu_torch.resilience import faults
        from sbr_tpu_torch.resilience.faults import InjectedFault

        try:
            faults.fire("fleet.heartbeat", target=self.host)
        except InjectedFault:
            return  # a silenced beat is a stale heartbeat, aged out by the TTL
        self.hb.beat(url=self.url, role="serve_worker", **stats)

    def withdraw(self) -> None:
        self.hb.withdraw()


def live_workers(fleet_root, now: Optional[float] = None) -> Dict[str, dict]:
    """{host id: heartbeat record} of the live serve workers: elastic's
    membership scan restricted to records with an HTTP endpoint (a sweep
    host sharing the dir never routes traffic)."""
    root = Path(fleet_root)
    if not root.is_dir():
        return {}
    return {h: rec for h, rec in elastic.live_hosts(root, now=now).items() if rec.get("url")}


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

    def trip(self) -> None:
        """Open now, whatever the count: the peer is known to be down (it
        refused the connection), so the threshold's grace for transient
        errors does not apply."""
        self.consecutive_failures = max(self.consecutive_failures + 1, self.threshold)
        self._probe_inflight = False
        if self.state != "open":
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


# ---------------------------------------------------------------------------
# Worker process entry
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """One fleet worker: engine, HTTP endpoint and heartbeat announcements.

    Runs until SIGTERM/SIGINT; the graceful-shutdown envelope then drains
    in-flight batches (engine close), withdraws the heartbeat and finalizes
    the obs manifest as "interrupted". Prints one JSON line ``{"url",
    "host", "pid", "device"}`` on stdout once ready, every bucket's program
    built (on the card, captured): ``loadgen --fleet`` reads it."""
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.serve.fleet",
        description="Run one serving-fleet worker (engine + endpoint + "
        "heartbeat membership) until SIGTERM",
    )
    parser.add_argument("--fleet-dir", required=True,
                        help="shared fleet rendezvous dir (heartbeats)")
    parser.add_argument("--port", type=int, default=0,
                        help="HTTP port (default 0 = ephemeral)")
    parser.add_argument("--n-grid", type=int, default=192, dest="n_grid")
    parser.add_argument("--bisect-iters", type=int, default=40, dest="bisect_iters")
    parser.add_argument("--buckets", default="1,8,64")
    parser.add_argument("--cache-dir", default=None,
                        help="on-disk result cache (shared across the fleet: "
                        "results are fingerprint-keyed and pure, so concurrent "
                        "writers are benign)")
    parser.add_argument("--run-dir", default=None,
                        help="obs run dir for this worker's telemetry")
    parser.add_argument("--heartbeat-ttl", type=float, default=None,
                        help="heartbeat TTL seconds (default SBR_HEARTBEAT_TTL_S)")
    parser.add_argument("--beat-s", type=float, default=0.5,
                        help="announcement cadence (default 0.5 s)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs eagerly)")
    args = parser.parse_args(argv)

    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.resilience.shutdown import graceful_shutdown
    from sbr_tpu_torch.serve.endpoint import ServeEndpoint
    from sbr_tpu_torch.serve.engine import Engine, ServeConfig

    buckets = tuple(sorted({int(v) for v in args.buckets.split(",") if v.strip()}))
    serve_cfg = ServeConfig.from_env(
        buckets=buckets, **({"cache_dir": args.cache_dir} if args.cache_dir else {})
    )
    config = SolverConfig(n_grid=args.n_grid, bisect_iters=args.bisect_iters,
                          refine_crossings=False)

    # The WORKER owns the obs run, not the engine: on SIGTERM the envelope
    # must finalize the manifest as "interrupted", and an engine-owned run
    # would be finalized "complete" by the drain's engine.close() first.
    run = None
    if args.run_dir:
        from sbr_tpu_torch import obs

        run = obs.start_run(label="serve_worker", run_dir=args.run_dir)
    try:
        engine = Engine(config=config, serve=serve_cfg, run=run, device=args.device)
    except RuntimeError as err:  # no card and no --device cpu
        print(f"[serve.fleet] {err}", file=sys.stderr)
        return 2
    # a worker on the card captures every bucket before it announces
    # itself: the router ranks workers by their latency, and a capture in
    # the first queries would charge the worker seconds of it
    engine.capture_programs()
    engine.start()
    endpoint = ServeEndpoint(engine, port=args.port).start()
    url = f"http://127.0.0.1:{endpoint.port}"
    announcer = WorkerAnnouncer(args.fleet_dir, url, ttl_s=args.heartbeat_ttl)
    with graceful_shutdown(label="serve_worker"):
        try:
            announcer.beat(**_worker_stats(engine))
            print(json.dumps({"url": url, "host": announcer.host, "pid": os.getpid(),
                              "device": str(engine.device)}), flush=True)
            while True:
                time.sleep(args.beat_s)
                announcer.beat(**_worker_stats(engine))
        finally:
            # The graceful drain, on SIGTERM while unwinding toward the
            # envelope's handler: in-flight batches finish (engine.close
            # drains the queue), the heartbeat goes so router peers reclaim
            # at once, and only then does the envelope finalize the obs
            # manifest as "interrupted" and exit 143.
            endpoint.close()
            engine.close()
            announcer.withdraw()
    return 0


def _worker_stats(engine) -> dict:
    """The heartbeat's stats block: what the router's cost model reads,
    plus each switch-gated block while its switch is on (the router
    quarantines on an audit "drift", merges the demand surfaces, rolls up
    the prewarm and flight blocks)."""
    from sbr_tpu_torch.obs import trace as qtrace

    window = engine.live.window()
    lat = window.get("latency_ms") or {}
    qps = (window.get("queries", 0) or 0) / max(engine.live.window_s, 1e-9)
    return {
        "qps": round(qps, 3),
        "p50_ms": lat.get("p50"),
        "inflight": engine.live.inflight,
        "queue_depth": engine.live.queue_depth,
        "healthz": engine.healthz(window=window)["status"],
        # resolved at the worker, so `report slo` judges each run dir
        # against the SLO its owner served under
        "slo_ms": qtrace.slo_ms(),
        **({"audit": engine.audit.heartbeat_block()}
           if getattr(engine, "audit", None) is not None else {}),
        **({"demand": engine.demand.heartbeat_block()}
           if getattr(engine, "demand", None) is not None else {}),
        **({"prewarm": engine.prewarm.heartbeat_block()}
           if getattr(engine, "prewarm", None) is not None else {}),
        **({"flight": engine.flight.heartbeat_block()}
           if getattr(engine, "flight", None) is not None else {}),
    }


if __name__ == "__main__":
    sys.exit(main())
