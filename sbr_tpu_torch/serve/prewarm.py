"""Self-healing prefetch controller: plan-driven sweeps that turn the
degradation ladder into a *prefetch* ladder; the port of
``sbr_tpu.serve.prewarm``.

The demand observatory (`obs.demand`) merges the fleet's (β, u) surfaces
and ranks ``advisor_plan.json`` tiles; this module acts on the plan:

- **`PrewarmController`** runs inside a serving engine (``SBR_PREWARM``,
  the `AuditScheduler` idiom: a daemon thread that works only while the
  engine is idle and ``/healthz`` is "ready", each tile under the engine's
  dispatch lock, so a tile never overlaps a bucket's capture or replay)
  and as a standalone sweeper (``python -m sbr_tpu_torch.serve.prewarm
  --plan PLAN --once``). Tiles compute on the engine's device (the CUDA
  card unless the engine runs on the CPU), standalone on ``--device``.
- **Crash-safe tiles on the elastic substrate.** Each plan tile is claimed
  with the O_EXCL lease files of the elastic scheduler
  (`parallel.distributed._try_lease`: expired-lease takeover with nonce
  verification), so N sweepers sharing a state dir never duplicate a tile
  and a killed sweeper's claims are adopted by a peer at the lease TTL.
  Sweeper liveness rides `elastic.Heartbeat` files beside the leases.
  Tiles run through `utils.checkpoint.tile_runner` / `produce` with
  ``scenario_spec=None``, so every computed tile lands in the cross-run
  `TileCache` WITH its ``cell_tag`` sidecar: what
  `serve.fleet.TileCacheBridge` needs to serve the cell warm while the
  solver path is down.
- **Retries**: `RetryPolicy` backoff under a per-plan `RetryBudget`
  (``SBR_PREWARM_RETRY_*``); a tile that exhausts its attempts is counted
  failed and skipped, never spun on.
- **Plan epochs.** The controller watches the plan file's mtime; a new
  ``plan_fingerprint`` abandons the stale plan's remaining tiles at the
  next tile boundary (``abandon`` reason "stale") and starts the new
  epoch in its own state dir.
- **Hard work budget.** ``SBR_PREWARM_BUDGET_TILES`` /
  ``SBR_PREWARM_BUDGET_SECONDS`` bound one plan's sweep; exhaustion
  abandons the remainder (reason "budget", which `report prewarm` gates).
- **Fail-closed keys.** A plan stamped with a ``program_version`` other
  than `sweeps.baseline_sweeps.GRID_PROGRAM_VERSION` is rejected
  outright. The tile-cache key embeds the version and the backend tag
  ``"torch"``; so do the epoch's state dir (``plan_<fp>_torch``) and every
  done marker, which count only when both match. A prewarmed tile is
  never served by another solver generation or by the reference's
  solver, and a reference-written cache is never read as this one's.

``SBR_PREWARM`` off (the default) is a structural no-op: the engine
never imports this module, ``/metrics`` carries no ``sbr_prewarm`` line,
and answers are bit-identical.

Fault points (`resilience.faults`): ``prewarm.plan_load`` before every
plan read and ``prewarm.sweep`` before every tile attempt.

Standard library at import: `obs.report gc --prewarm-keep` imports it
without starting a device runtime.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

#: The advisor plan schema this controller executes (obs.demand).
PLAN_SCHEMA = "sbr-demand-advisor/1"

_DONE_PREFIX = "done_"
# The backend tag (`utils.checkpoint.BACKEND`, which imports torch) that
# the epoch dirs and the done markers carry.
_BACKEND = "torch"


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """``SBR_PREWARM`` truthy — the engine-side structural gate."""
    from sbr_tpu_torch.obs import switch_on

    return switch_on("SBR_PREWARM")


def poll_s() -> float:
    raw = os.environ.get("SBR_PREWARM_POLL_S", "").strip()
    return float(raw) if raw else 2.0


def budget_tiles(value: Optional[int] = None) -> Optional[int]:
    """Hard per-plan tile budget (``SBR_PREWARM_BUDGET_TILES``, default
    256; <= 0 disables the bound)."""
    if value is None:
        raw = os.environ.get("SBR_PREWARM_BUDGET_TILES", "").strip()
        value = int(raw) if raw else 256
    value = int(value)
    return value if value > 0 else None


def budget_seconds(value: Optional[float] = None) -> Optional[float]:
    """Hard per-plan wall-clock budget (``SBR_PREWARM_BUDGET_SECONDS``,
    default unbounded; <= 0 disables the bound)."""
    if value is None:
        raw = os.environ.get("SBR_PREWARM_BUDGET_SECONDS", "").strip()
        if not raw:
            return None
        value = float(raw)
    value = float(value)
    return value if value > 0 else None


def lease_ttl_s(value: Optional[float] = None) -> float:
    """Tile-lease TTL: the elastic scheduler's knob, shared verbatim —
    adoption timing is one fleet-wide property, not a prewarm one."""
    if value is not None:
        return float(value)
    return float(os.environ.get("SBR_STEAL_LEASE_TTL_S", "900"))


def state_dir(value=None, cache_root=None) -> Optional[Path]:
    """Where sweepers rendezvous (leases + heartbeats + done markers per
    plan epoch): ``SBR_PREWARM_STATE_DIR``, else ``<tile cache>/_prewarm``
    (the two-hex shard layout never collides with an underscore name).
    None = no tile cache configured, nothing to prewarm into."""
    root = value or os.environ.get("SBR_PREWARM_STATE_DIR", "").strip()
    if root:
        return Path(root)
    if cache_root is not None:
        return Path(cache_root) / "_prewarm"
    return None


def _program_version() -> int:
    from sbr_tpu_torch.sweeps.baseline_sweeps import GRID_PROGRAM_VERSION

    return int(GRID_PROGRAM_VERSION)


def plan_dir_name(fingerprint: str) -> str:
    """The state dir of one plan epoch: its fingerprint and the backend tag,
    so the reference's sweepers and this package's never share one."""
    return f"plan_{fingerprint}_{_BACKEND}"


# ---------------------------------------------------------------------------
# Plan loading
# ---------------------------------------------------------------------------


def load_plan(path) -> Optional[dict]:
    """Read + validate one advisor plan, through the ``prewarm.plan_load``
    fault point. Returns None on a missing/torn/alien file or an injected
    fault (the controller keeps its current epoch), and raises nothing:
    plan ingestion must never take down a serve worker."""
    from sbr_tpu_torch.resilience import faults
    from sbr_tpu_torch.resilience.faults import InjectedFault

    path = Path(path)
    try:
        faults.fire("prewarm.plan_load", target=path.name)
        doc = json.loads(path.read_text())
    except (InjectedFault, OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != PLAN_SCHEMA:
        return None
    if not doc.get("plan_fingerprint") or not isinstance(doc.get("tiles"), list):
        return None
    return doc


def _plan_tiles(plan: dict) -> List[dict]:
    """The executable tile list, in advisor rank order.

    Each advisor tile (one hot bin's heavy-hitter β/u axes) is EXPANDED
    into one executable tile per distinct β: `cell_tag` includes the
    derived η and tspan — which `make_model_params` resolves from β
    (η = η̄/β, tspan = (0, 2η)) — so a single sweep base can only ever
    match queries at its own β. Per-β tiles, each swept under the
    canonical base for that β, are exactly the cells the serving pool's
    queries tag-match.

    Lease coordinates (and the matching done-marker names) are the
    tile's INDEX in this fully sorted expansion — deterministic across
    sweepers because the plan bytes are fingerprint-keyed."""
    expanded = []
    for t in plan.get("tiles") or []:
        try:
            bi, ui = (int(v) for v in str(t["bin"]).split(","))
            betas = sorted({float(b) for b in t["betas"]})
            us = sorted({float(u) for u in t["us"]})
        except (KeyError, TypeError, ValueError):
            continue
        if not betas or not us:
            continue
        for b in betas:
            expanded.append({
                "bin": f"{bi},{ui}", "beta": b, "us": us,
                "rank": t.get("rank"),
            })
    expanded.sort(key=lambda t: (t["rank"] is None, t["rank"], t["bin"], t["beta"]))
    for n, t in enumerate(expanded):
        t["id"] = f"t{n:05d}_00000"
        t["lease"] = (n, 0)
        t["betas"] = [t.pop("beta")]
    return expanded


def _log_prewarm(action: str, **fields) -> None:
    """Guarded telemetry hook (the `elastic._log_sched` shape): only
    touches obs when a run is already active."""
    try:
        from sbr_tpu_torch import obs

        obs.log_prewarm(action, **fields)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class PrewarmController:
    """Plan-driven background prefetch sweeps (see module docstring).

    Embedded in a serve engine (``engine=...``) it defers to traffic:
    tiles only run while the engine is idle AND `/healthz` is "ready", on
    the engine's device and under its dispatch lock. Standalone
    (``engine=None``, the sweeper role) it is always admissible and runs
    on ``device`` (default: the CUDA card). ``run_cycle()``/`step()` are
    the synchronous test hooks; the `start()`ed daemon thread drives the
    same methods."""

    def __init__(self, engine=None, plan_file=None, state_root=None,
                 base=None, config=None, dtype=None, cache_dir=None,
                 max_tiles: Optional[int] = None,
                 max_seconds: Optional[float] = None,
                 ttl_s: Optional[float] = None,
                 scenario_spec=None, device=None) -> None:
        self.engine = engine
        if device is None and engine is not None:
            device = engine.device
        self._device = device
        self._plan_file = Path(plan_file) if plan_file else None
        self._state_root = Path(state_root) if state_root else None
        self._base = base
        self._config = config
        self._dtype = dtype
        self._cache_dir = cache_dir
        self._max_tiles = budget_tiles(max_tiles)
        self._max_seconds = budget_seconds(max_seconds)
        self._ttl_s = lease_ttl_s(ttl_s)
        self.scenario_spec = scenario_spec

        self.status = "idle"  # idle|sweeping|done|budget_exhausted|rejected|no_cache
        self.counts: Dict[str, int] = {
            "plans": 0, "plans_rejected": 0, "plan_errors": 0,
            "tiles_done": 0, "computed": 0, "cache": 0, "local": 0,
            "failed": 0, "adopted": 0,
            "abandoned_stale": 0, "abandoned_budget": 0,
        }
        self._plan: Optional[dict] = None
        self._plan_fp: Optional[str] = None
        self._plan_mtime: Optional[float] = None
        self._plan_dir: Optional[Path] = None
        self._tiles: List[dict] = []
        self._failed_tiles: set = set()
        self._tiles_run = 0
        self._plan_started: Optional[float] = None
        self._warm: Optional[int] = None
        self._cache = None
        self._cache_resolved = False
        self._retry_budget = None
        self._policy = None
        self._hb = None
        self._runners: Dict[str, object] = {}

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --
    def start(self) -> "PrewarmController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sbr-prewarm", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._withdraw_hb()

    def _withdraw_hb(self) -> None:
        if self._hb is not None:
            try:
                self._hb.withdraw()
            except Exception:
                pass
            self._hb = None

    # -- scheduling --
    def _admissible(self) -> bool:
        """Yield-to-traffic admission: an embedded controller never takes
        the device while the engine has inflight/queued work or /healthz
        is anything but "ready" (the `AuditScheduler` idle check plus the
        health verdict — a degraded window means the ladder may be
        answering queries, the worst moment to add solver load)."""
        eng = self.engine
        if eng is None:
            return True
        try:
            if eng.live.inflight or eng.live.queue_depth or eng._queue.qsize():
                return False
            return eng.healthz()["status"] == "ready"
        except Exception:
            return False

    def _hold(self):
        """The engine's dispatch lock with its card current (a tile never
        overlaps a capture or a replay); nothing for a standalone sweeper."""
        hold = getattr(self.engine, "_on_device", None)
        return hold() if hold is not None else nullcontext()

    def _loop(self) -> None:
        dev = self._device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            torch.cuda.set_device(dev)
        next_poll = 0.0
        while not self._stop.wait(0.25):
            now = time.monotonic()
            if now >= next_poll:
                self.poll_plan()
                next_poll = now + poll_s()
            if self.status != "sweeping" or not self._admissible():
                continue
            self.step()

    def run_cycle(self) -> Optional[dict]:
        """One synchronous controller beat: refresh the plan, then run one
        tile if admissible (the test hook)."""
        self.poll_plan()
        if self.status != "sweeping" or not self._admissible():
            return None
        return self.step()

    # -- cache / plan resolution --
    def _resolve_cache(self):
        if not self._cache_resolved:
            from sbr_tpu_torch.resilience.elastic import default_tile_cache

            self._cache = default_tile_cache(self._cache_dir)
            self._cache_resolved = True
        return self._cache

    def _resolve_plan_file(self) -> Optional[Path]:
        if self._plan_file is not None:
            return self._plan_file
        raw = os.environ.get("SBR_PREWARM_PLAN", "").strip()
        if raw:
            return Path(raw)
        run = getattr(self.engine, "_run", None)
        if run is not None and getattr(run, "run_dir", None):
            return Path(run.run_dir) / "advisor_plan.json"
        return None

    def poll_plan(self) -> bool:
        """(Re)load the watched plan when its file changed; a new
        fingerprint abandons the stale epoch's remaining tiles at this
        boundary. Returns True while an epoch is active."""
        cache = self._resolve_cache()
        if cache is None:
            self.status = "no_cache"
            return False
        path = self._resolve_plan_file()
        if path is None:
            if self._plan is None:
                self.status = "idle"
            return self._plan is not None
        try:
            mtime = path.stat().st_mtime
        except OSError:
            return self._plan is not None
        if self._plan is not None and mtime == self._plan_mtime:
            return True
        plan = load_plan(path)
        if plan is None:
            with self._lock:
                self.counts["plan_errors"] += 1
            _log_prewarm("plan_error", path=str(path))
            self._plan_mtime = mtime  # don't re-parse a torn file every tick
            return self._plan is not None
        self._plan_mtime = mtime
        if plan["plan_fingerprint"] == self._plan_fp:
            return True
        self._adopt_plan(plan)
        return self._plan is not None

    def _adopt_plan(self, plan: dict) -> None:
        # Epoch boundary: count the outgoing plan's unfinished tiles as
        # stale-abandoned (the new plan supersedes their demand evidence).
        if self._plan is not None and self.status == "sweeping":
            remaining = sum(
                1 for t in self._tiles
                if not self._tile_done(t) and t["id"] not in self._failed_tiles
            )
            if remaining:
                with self._lock:
                    self.counts["abandoned_stale"] += remaining
                _log_prewarm("abandon", reason="stale", count=remaining,
                             fingerprint=self._plan_fp)
        self._withdraw_hb()

        fp = plan["plan_fingerprint"]
        pv = plan.get("program_version")
        if pv is not None and int(pv) != _program_version():
            # Fail closed: a plan ranked against another solver generation
            # must not drive sweeps whose cache keys it cannot describe.
            with self._lock:
                self.counts["plans_rejected"] += 1
            self._plan, self._plan_fp, self._tiles = None, None, []
            self.status = "rejected"
            _log_prewarm("plan_reject", fingerprint=fp, reason="program_version",
                         plan_version=int(pv), running_version=_program_version())
            return

        self._plan, self._plan_fp = plan, fp
        self._tiles = _plan_tiles(plan)
        self._runners = {}
        self._failed_tiles = set()
        self._tiles_run = 0
        self._plan_started = time.monotonic()
        self._warm = None
        self.status = "sweeping" if self._tiles else "done"
        with self._lock:
            self.counts["plans"] += 1

        root = state_dir(self._state_root, cache_root=self._cache.root)
        self._plan_dir = root / plan_dir_name(fp)
        self._plan_dir.mkdir(parents=True, exist_ok=True)
        snap = self._plan_dir / "plan.json"
        if not snap.exists():
            from sbr_tpu_torch.obs.demand import write_plan

            write_plan({**plan, "program_version": _program_version()}, snap)
        from sbr_tpu_torch.resilience import elastic

        self._hb = elastic.Heartbeat(self._plan_dir)
        self._hb.beat(role="prewarm", plan=fp, tiles_done=0)

        from sbr_tpu_torch.utils import checkpoint as ckpt

        self._retry_budget = ckpt.default_retry_budget(max(len(self._tiles), 1))
        from sbr_tpu_torch.resilience import retry

        self._policy = retry.policy_from_env(
            "SBR_PREWARM_RETRY", max_attempts=3, base_delay_s=0.2,
            multiplier=2.0, max_delay_s=30.0,
        )
        _log_prewarm("plan", fingerprint=fp, tiles=len(self._tiles),
                     surface_queries=plan.get("surface_queries"))
        if not self._tiles:
            self._finish_plan()

    # -- tile state --
    def _done_path(self, t: dict) -> Path:
        return self._plan_dir / f"{_DONE_PREFIX}{t['id']}.json"

    def _tile_done(self, t: dict) -> bool:
        """A done marker of the CURRENT program version and backend only: a
        marker left by another solver generation (or the reference's
        solver) describes cache entries this one can never serve, so the
        tile must re-run."""
        try:
            doc = json.loads(self._done_path(t).read_text())
            return (int(doc.get("program_version", -1)) == _program_version()
                    and doc.get("backend") == _BACKEND)
        except (OSError, ValueError, TypeError, AttributeError):
            return False

    def _mark_done(self, t: dict, source: str, key: Optional[str]) -> None:
        path = self._done_path(t)
        tmp = path.with_name(path.name + ".tmp")
        doc = {
            "tile": t["id"], "source": source, "key": key,
            "plan": self._plan_fp, "ts": time.time(),
            "program_version": _program_version(),
            "backend": _BACKEND,
            "host": self._hb.host if self._hb is not None else None,
        }
        tmp.write_text(json.dumps(doc, sort_keys=True))
        os.replace(tmp, path)

    def _over_budget(self) -> Optional[str]:
        if self._max_tiles is not None and self._tiles_run >= self._max_tiles:
            return f"tile budget {self._max_tiles} spent"
        if self._max_seconds is not None and self._plan_started is not None \
                and time.monotonic() - self._plan_started >= self._max_seconds:
            return f"time budget {self._max_seconds:g}s spent"
        return None

    # -- execution --
    def step(self) -> Optional[dict]:
        """Claim and run ONE plan tile; returns its outcome dict, or None
        when nothing was runnable this beat (all claimed elsewhere, all
        done, or the budget closed the plan)."""
        if self.status != "sweeping" or self._plan_dir is None:
            return None
        over = self._over_budget()
        if over is not None:
            remaining = sum(
                1 for t in self._tiles
                if not self._tile_done(t) and t["id"] not in self._failed_tiles
            )
            with self._lock:
                self.counts["abandoned_budget"] += remaining
            self.status = "budget_exhausted"
            _log_prewarm("abandon", reason="budget", count=remaining,
                         detail=over, fingerprint=self._plan_fp)
            self._withdraw_hb()
            return None

        from sbr_tpu_torch.parallel.distributed import _try_lease
        from sbr_tpu_torch.resilience import shutdown

        pending = False
        for t in self._tiles:
            if t["id"] in self._failed_tiles or self._tile_done(t):
                continue
            li, lj = t["lease"]
            lease = self._plan_dir / f"tile_b{li:05d}_u{lj:05d}.lease"
            contested = lease.exists()  # pre-claim: takeover == adoption
            if not _try_lease(self._plan_dir, li, lj, self._ttl_s):
                pending = True
                continue
            shutdown.release_on_exit(lease)
            if contested:
                with self._lock:
                    self.counts["adopted"] += 1
                _log_prewarm("adopt", tile=t["id"], fingerprint=self._plan_fp)
            try:
                source, key = self._run_tile(t)
            except Exception as err:  # noqa: BLE001 — tile failure, not crash
                self._failed_tiles.add(t["id"])
                with self._lock:
                    self.counts["failed"] += 1
                _log_prewarm("tile_failed", tile=t["id"], error=repr(err),
                             fingerprint=self._plan_fp)
                return {"tile": t["id"], "source": "failed", "error": repr(err)}
            finally:
                try:
                    lease.unlink()
                except OSError:
                    pass
                shutdown.unregister_release(lease)
            self._mark_done(t, source, key)
            self._tiles_run += 1
            with self._lock:
                self.counts["tiles_done"] += 1
                self.counts[source] = self.counts.get(source, 0) + 1
            if self._hb is not None:
                try:
                    self._hb.beat(role="prewarm", plan=self._plan_fp,
                                  tiles_done=self.counts["tiles_done"])
                except Exception:
                    pass
            _log_prewarm("tile", tile=t["id"], source=source,
                         cells=len(t["betas"]) * len(t["us"]),
                         fingerprint=self._plan_fp)
            if not pending and self._all_done():
                self._finish_plan()
            return {"tile": t["id"], "source": source, "key": key}
        if not pending and self._all_done():
            self._finish_plan()
        return None

    def _all_done(self) -> bool:
        return all(
            self._tile_done(t) or t["id"] in self._failed_tiles
            for t in self._tiles
        )

    def _tile_base(self, t: dict):
        """The canonical sweep base for one per-β tile: η and tspan are
        RE-DERIVED from the tile's β exactly as `make_model_params` does
        for a serving query (η = η̄/β, tspan = (0, 2η)) — pinning a fixed
        base's η across βs would compute a different cell than the query
        asks for, and the bridge's cell-tag match would rightly refuse
        it. Economics other than the swept pair come from ``base`` when
        the embedding passed one, else the reference defaults."""
        from sbr_tpu_torch.models.params import make_model_params

        beta = t["betas"][0]
        b = self._base
        if b is None:
            return make_model_params(beta=beta)
        return make_model_params(
            beta=beta, eta_bar=b.economic.eta_bar, p=b.economic.p,
            kappa=b.economic.kappa, lam=b.economic.lam, x0=b.learning.x0,
            insurance_cap=b.economic.insurance_cap,
            suspension_t=b.economic.suspension_t,
            lolr_rate=b.economic.lolr_rate,
        )

    def _runner(self, t: dict):
        """The tile's `TileRunner`, built once an epoch: building one runs
        the memory preflight, a measured probe solve on the card, so it
        happens under the engine's dispatch lock."""
        runner = self._runners.get(t["id"])
        if runner is None:
            from sbr_tpu_torch.utils import checkpoint as ckpt

            betas, us = t["betas"], t["us"]
            with self._hold():
                runner = ckpt.tile_runner(
                    betas, us, self._tile_base(t), None,
                    config=self._config, tile_shape=(len(betas), len(us)),
                    dtype=self._dtype, retry_budget=self._retry_budget,
                    tile_cache=self._cache, scenario_spec=self.scenario_spec,
                    device=self._device,
                )
            self._runners[t["id"]] = runner
        return runner

    def _run_tile(self, t: dict) -> tuple:
        """Produce one plan tile through the elastic tile runner (cache
        check first: an already-swept tile is a free "cache" hit), behind
        the ``prewarm.sweep`` fault point and the retry policy, each attempt
        under the engine's dispatch lock."""
        from sbr_tpu_torch.resilience import faults

        runner = self._runner(t)

        def attempt():
            faults.fire("prewarm.sweep", target=t["id"])
            with self._hold():
                return runner.produce(0, 0)

        source, _ = self._policy.call(
            attempt, scope=f"prewarm.{t['id']}", budget=self._retry_budget
        )
        key = None
        try:
            key = runner.cache_key(0, 0)
        except Exception:
            pass
        return source, key

    def _finish_plan(self) -> None:
        """Plan drained: verify the hot region is actually warm (every
        tile's cache entry present under the CURRENT program version) and
        latch the verdict — `report prewarm` gates a completed-but-cold
        plan to exit 1."""
        warm = 0
        for t in self._tiles:
            try:
                key = self._runner(t).cache_key(0, 0)
                if key and self._cache.path(key).exists():
                    warm += 1
            except Exception:
                continue
        self._warm = warm
        self.status = "done"
        _log_prewarm("plan_done", fingerprint=self._plan_fp,
                     tiles=len(self._tiles), warm=warm,
                     failed=len(self._failed_tiles))
        self._withdraw_hb()

    def drain(self, timeout_s: Optional[float] = None,
              idle_sleep_s: float = 0.25) -> dict:
        """Run the ACTIVE plan to a terminal state (done / budget / no
        plan): the sweeper-role loop. Keeps polling while peers hold
        leases — a killed peer's tiles become claimable at the lease TTL
        and are adopted here. Returns the final `snapshot()`."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        while True:
            self.poll_plan()
            if self.status != "sweeping":
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not self._admissible():
                time.sleep(idle_sleep_s)
                continue
            if self.step() is None and self.status == "sweeping":
                time.sleep(idle_sleep_s)  # leases pending expiry elsewhere
        return self.snapshot()

    # -- surfacing --
    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self.counts)
        return {
            "status": self.status,
            "plan_fingerprint": self._plan_fp,
            "tiles_total": len(self._tiles),
            "tiles_done": counts["tiles_done"],
            "warm": self._warm,
            "counts": counts,
            "budget": {
                "tiles": self._max_tiles,
                "seconds": self._max_seconds,
                "tiles_run": self._tiles_run,
            },
        }

    def heartbeat_block(self) -> dict:
        """The compact block riding fleet worker heartbeats (what the
        router's /statz roll-up aggregates)."""
        with self._lock:
            counts = dict(self.counts)
        return {
            "status": self.status,
            "plan": self._plan_fp,
            "tiles_done": counts["tiles_done"],
            "tiles_total": len(self._tiles),
            "abandoned": counts["abandoned_stale"] + counts["abandoned_budget"],
        }

    def status_gauge(self) -> int:
        """``sbr_prewarm_status``: 1 done, 0 idle/sweeping/no_cache,
        -1 rejected/budget_exhausted."""
        return {"done": 1, "rejected": -1, "budget_exhausted": -1}.get(self.status, 0)

    def prometheus_lines(self) -> list:
        with self._lock:
            counts = dict(self.counts)
        return [
            "# TYPE sbr_prewarm_status gauge",
            f"sbr_prewarm_status {self.status_gauge()}",
            "# TYPE sbr_prewarm_tiles_done counter",
            f"sbr_prewarm_tiles_done {counts['tiles_done']}",
            "# TYPE sbr_prewarm_tiles_failed counter",
            f"sbr_prewarm_tiles_failed {counts['failed']}",
            "# TYPE sbr_prewarm_tiles_abandoned counter",
            "sbr_prewarm_tiles_abandoned "
            f"{counts['abandoned_stale'] + counts['abandoned_budget']}",
        ]


# ---------------------------------------------------------------------------
# Retention (report gc --prewarm-keep)
# ---------------------------------------------------------------------------


def gc_prewarm_files(state_root=None, keep: int = 4,
                     ttl_s: Optional[float] = None) -> list:
    """Prune prewarm state, matching the gc retention contract: keep the
    ``keep`` most-recent ``plan_*`` epoch dirs under the state root
    (``SBR_PREWARM_STATE_DIR`` / ``<tile cache>/_prewarm``); older epochs
    are removed ONLY when no live lease or heartbeat remains (a sweeper
    still drains there). Inside every surviving epoch, leases whose tile
    already carries a done marker are debris and removed. The newest
    epoch — the active plan — is never a candidate. Returns removed
    paths."""
    import shutil

    ttl = lease_ttl_s(ttl_s)
    removed: list = []
    root = state_dir(state_root)
    if root is None or not root.is_dir():
        return removed
    epochs = sorted(
        (p for p in root.iterdir() if p.is_dir() and p.name.startswith("plan_")),
        key=lambda p: p.stat().st_mtime,
    )
    now = time.time()

    def _live(d: Path) -> bool:
        from sbr_tpu_torch.resilience import elastic

        if elastic.live_hosts(d, now=now):
            return True
        for lease in d.glob("tile_*.lease"):
            try:
                doc = json.loads(lease.read_text())
                age = now - float(doc.get("ts", 0.0))
                if age < float(doc.get("ttl_s") or ttl):
                    return True
            except (OSError, ValueError, TypeError):
                if now - lease.stat().st_mtime < ttl:
                    return True
        return False

    keep = max(int(keep), 1)  # the active epoch is always kept
    for d in epochs[: max(len(epochs) - keep, 0)]:
        if _live(d):
            continue
        try:
            shutil.rmtree(d)
            removed.append(str(d))
        except OSError:
            pass
    for d in epochs:
        if not d.is_dir():
            continue  # just removed above
        for lease in d.glob("tile_*.lease"):
            # tile_b00001_u00002.lease -> done_t00001_00002.json
            stem = lease.stem.replace("tile_b", "t").replace("_u", "_")
            if (d / f"{_DONE_PREFIX}{stem}.json").exists():
                try:
                    lease.unlink()
                    removed.append(str(lease))
                except OSError:
                    pass
    return removed


# ---------------------------------------------------------------------------
# Standalone sweeper role
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m sbr_tpu_torch.serve.prewarm``: the dedicated sweeper role —
    drain an advisor plan into the shared tile cache from a box with no
    serve engine (always admissible). ``--once`` exits when the plan
    reaches a terminal state; ``--watch`` keeps following the plan file
    across epochs until SIGTERM. Prints one readiness JSON line, then
    (``--once``) one summary JSON line.

    Exit codes: 0 plan done warm, 1 terminal-but-degraded (budget
    exhausted, rejected, failed/cold tiles), 2 setup error."""
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.serve.prewarm",
        description="Autonomous prefetch sweeper: execute advisor-plan "
        "tiles into the shared tile cache (crash-safe leases; N sweepers "
        "cooperate)",
    )
    parser.add_argument("--plan", required=True,
                        help="advisor_plan.json to execute (watched for "
                        "new fingerprints under --watch)")
    parser.add_argument("--state-dir", default=None, dest="state_dir",
                        help="sweeper rendezvous dir (default "
                        "SBR_PREWARM_STATE_DIR or <cache>/_prewarm)")
    parser.add_argument("--cache-dir", default=None, dest="cache_dir",
                        help="tile cache root (default SBR_TILE_CACHE_DIR)")
    parser.add_argument("--n-grid", type=int, default=192, dest="n_grid",
                        help="solver grid — MUST match the serving "
                        "engines' config or the cell tags never match")
    parser.add_argument("--bisect-iters", type=int, default=40, dest="bisect_iters")
    parser.add_argument("--budget-tiles", type=int, default=None, dest="budget_tiles")
    parser.add_argument("--budget-seconds", type=float, default=None,
                        dest="budget_seconds")
    parser.add_argument("--timeout-s", type=float, default=None, dest="timeout_s",
                        help="--once: give up draining after this long")
    parser.add_argument("--run-dir", default=None,
                        help="obs run dir for prewarm telemetry "
                        "(report prewarm gates it)")
    parser.add_argument("--once", action="store_true",
                        help="drain the current plan to a terminal state, "
                        "then exit (default: --watch)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs eagerly)")
    parser.add_argument("--json", action="store_true",
                        help="print the final snapshot as JSON (--once)")
    args = parser.parse_args(argv)

    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.social.agents import default_device
    from sbr_tpu_torch.resilience.elastic import default_tile_cache
    from sbr_tpu_torch.resilience.shutdown import graceful_shutdown

    if default_tile_cache(args.cache_dir) is None:
        print("[prewarm] no tile cache configured (--cache-dir / "
              "SBR_TILE_CACHE_DIR) — nothing to prewarm into", file=sys.stderr)
        return 2

    try:
        device = args.device if args.device is not None else default_device()
    except RuntimeError as err:  # no card and no --device cpu
        print(f"[prewarm] {err}", file=sys.stderr)
        return 2
    config = SolverConfig(
        n_grid=args.n_grid, bisect_iters=args.bisect_iters,
        refine_crossings=False,
    )
    run = None
    if args.run_dir:
        from sbr_tpu_torch import obs

        run = obs.start_run(label="prewarm", run_dir=args.run_dir)
    ctl = PrewarmController(
        engine=None, plan_file=args.plan, state_root=args.state_dir,
        config=config, cache_dir=args.cache_dir,
        max_tiles=args.budget_tiles, max_seconds=args.budget_seconds,
        device=device,
    )
    print(json.dumps({"role": "prewarm", "pid": os.getpid(),
                      "plan": str(args.plan), "device": str(device)}), flush=True)
    rc = 0
    with graceful_shutdown(label="prewarm"):
        try:
            if args.once:
                snap = ctl.drain(timeout_s=args.timeout_s)
                counts = snap["counts"]
                degraded = (
                    snap["status"] != "done"
                    or counts["failed"] > 0
                    or counts["abandoned_budget"] > 0
                    or (snap["warm"] is not None
                        and snap["warm"] < snap["tiles_total"])
                )
                rc = 1 if degraded else 0
                if args.json:
                    print(json.dumps(snap, default=str))
                else:
                    print(f"[prewarm] {snap['status']}: "
                          f"{snap['tiles_done']}/{snap['tiles_total']} tile(s), "
                          f"warm {snap['warm']}", file=sys.stderr)
            else:
                ctl.start()
                while True:
                    time.sleep(0.5)
        finally:
            ctl.close()
            if run is not None:
                from sbr_tpu_torch.obs import runlog

                runlog._finalize_if_active(run)
    return rc


if __name__ == "__main__":
    sys.exit(main())
