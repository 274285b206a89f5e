"""Elastic sweep scheduler and the cross-run tile cache: the port of
``sbr_tpu.resilience.elastic``.

**Membership.** Every host of a sweep announces itself with a heartbeat
file (``host_<id>.hb``, JSON ``{host, pid, ts, ttl_s, tiles_done,
cells_per_sec}``) in the shared checkpoint directory, refreshed between
tiles. A host that joins a running sweep starts claiming tiles from the
remaining queue; one that leaves gracefully (SIGTERM/SIGINT,
`resilience.shutdown`) hands back its leases and heartbeat; one that dies
silently ages out through the lease and heartbeat TTLs
(``SBR_STEAL_LEASE_TTL_S`` / ``SBR_HEARTBEAT_TTL_S``).

**Rebalancing by throughput.** Every poll, each host derives the same
claim plan (`plan_claims`: longest-processing-time placement of the
remaining tiles over the live hosts, weighted by each host's published
cells/s, an in-run EWMA), leases its own share first and then any unleased
tile. The per-tile lease files (``O_EXCL`` create, TTL takeover,
`parallel.distributed._try_lease`) are the one arbiter, so a plan
disagreement costs at most a duplicate compute, never a wrong grid.

**Cross-run tile cache.** `TileCache` (root ``SBR_TILE_CACHE_DIR``) stores
whole tiles under the sha256 of the canonical (params, config, dtype,
backend tag ``"torch"``, grid-program version, tile β values, tile u
values), so a tile any sweep computed serves every later sweep whose cells
match, overlapping grids included. Entries carry sha256 sidecars and are
verified on read: a mismatch is quarantined and recomputed, never served.
The backend tag stands where the reference has its x64 flag, so a port
entry never answers for an ``sbr_tpu`` one (their floats differ by up to
1e-12), nor the other way round.

**Throughput seed.** A host's tracker starts from the median of its
platform's recent ``elastic_cells_per_sec`` records in the perf history's
sidecar (``<history>.elastic.jsonl``, `seed_rate_from_history`); a sweep
that computed tiles appends its measured rate when ``SBR_OBS_HISTORY`` is
set. Records carry the platform tag ``"gpu"`` or ``"cpu"``, so a CPU rate
never seeds the card.

Every membership change, claim, completion and cache outcome is an obs
``scheduler`` / ``cache`` event (``python -m sbr_tpu_torch.obs.report
elastic RUN_DIR``).

Standard library and numpy at import; the solver is imported inside the
functions that need it.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import tempfile
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from sbr_tpu_torch.resilience import faults, heal, shutdown

# Heartbeats refresh at tile boundaries, so the TTL must exceed the
# longest tile's wall-clock time or a working host reads as dead.
DEFAULT_HEARTBEAT_TTL_S = 300.0


def elastic_enabled(flag: Optional[bool] = None) -> bool:
    """An explicit ``flag`` wins, else ``SBR_ELASTIC`` (on unless "0", which
    selects the static split)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("SBR_ELASTIC", "").strip() != "0"


def heartbeat_ttl_s(value: Optional[float] = None) -> float:
    if value is not None:
        return float(value)
    raw = os.environ.get("SBR_HEARTBEAT_TTL_S", "").strip()
    return float(raw) if raw else DEFAULT_HEARTBEAT_TTL_S


def default_tile_cache(cache_dir=None) -> Optional["TileCache"]:
    """The cross-run cache at ``cache_dir`` or ``SBR_TILE_CACHE_DIR`` (None:
    no cache)."""
    root = cache_dir or os.environ.get("SBR_TILE_CACHE_DIR", "").strip()
    return TileCache(root) if root else None


_HOST_ID: Optional[str] = None


def host_identity() -> str:
    """This process's host id: hostname, pid and a random suffix, so two
    workers on one box (or a reused pid) never share one."""
    global _HOST_ID
    if _HOST_ID is None:
        name = re.sub(r"[^A-Za-z0-9_.-]", "-", socket.gethostname())[:48]
        _HOST_ID = f"{name}-p{os.getpid()}-{uuid.uuid4().hex[:6]}"
    return _HOST_ID


def _log(kind: str, action: str, **fields) -> None:
    """One ``scheduler`` or ``cache`` event (``runlog.log_<kind>``)."""
    try:
        from sbr_tpu_torch.obs import runlog

        getattr(runlog, f"log_{kind}")(action=action, **fields)
    except Exception:
        pass  # telemetry must never sink the scheduler


def heartbeat_path(ckpt_dir, host: str) -> Path:
    return Path(ckpt_dir) / f"host_{host}.hb"


class Heartbeat:
    """One host's liveness record in the checkpoint directory (atomic
    rewrite, a TTL like a lease's), registered with `resilience.shutdown`
    so a graceful preemption hands it back at once."""

    def __init__(self, ckpt_dir, host: Optional[str] = None, ttl_s: Optional[float] = None):
        self.host = host or host_identity()
        self.ttl_s = heartbeat_ttl_s(ttl_s)
        self.path = heartbeat_path(ckpt_dir, self.host)
        self.started_at = time.time()

    def beat(self, **stats) -> None:
        rec = {
            "host": self.host,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "ts": time.time(),
            "ttl_s": self.ttl_s,
            "started_at": self.started_at,
            **stats,
        }
        # best effort: a transient error of the shared volume must not sink
        # the host; the next beat retries
        try:
            tmp = Path(f"{self.path}.{os.getpid()}.tmp")
            tmp.write_text(json.dumps(rec))
            os.replace(tmp, self.path)
        except OSError:
            return
        shutdown.release_on_exit(self.path)

    def withdraw(self) -> None:
        shutdown.unregister_release(self.path)
        try:
            self.path.unlink()
        except OSError:
            pass


def live_hosts(ckpt_dir, now: Optional[float] = None) -> Dict[str, dict]:
    """{host id: record} of the heartbeats whose TTL has not lapsed. A torn
    heartbeat counts as dead."""
    now = time.time() if now is None else now
    out: Dict[str, dict] = {}
    for hb in sorted(Path(ckpt_dir).glob("host_*.hb")):
        try:
            rec = json.loads(hb.read_text())
            ts = float(rec.get("ts", 0.0))
            ttl = float(rec.get("ttl_s", DEFAULT_HEARTBEAT_TTL_S))
        except (OSError, ValueError):
            continue
        if now - ts < ttl:
            out[str(rec.get("host", hb.stem[len("host_"):]))] = rec
    return out


def recorded_tile_shape(checkpoint_dir) -> Optional[Tuple[int, int]]:
    """The tile shape the sweep's first host recorded in the checkpoint
    manifest (`utils.checkpoint._check_fingerprint`), or None."""
    try:
        doc = json.loads((Path(checkpoint_dir) / "manifest.json").read_text())
        shape = doc.get("tile_shape")
        if isinstance(shape, list) and len(shape) == 2:
            return int(shape[0]), int(shape[1])
    except (OSError, ValueError):
        pass
    return None


def tile_cells(origin: Tuple[int, int], nb: int, nu: int, tile_shape: Tuple[int, int]) -> int:
    bi, ui = origin
    tb, tu = tile_shape
    return max(0, min(tb, nb - bi)) * max(0, min(tu, nu - ui))


def plan_claims(
    tiles: List[Tuple[Tuple[int, int], float]],
    rates: Dict[str, float],
) -> Dict[str, List[Tuple[int, int]]]:
    """Throughput-weighted longest-processing-time placement of the
    remaining tiles over the live hosts.

    ``tiles`` is ``[(origin, cost), ...]``; ``rates`` maps host id to its
    published cells/s (non-positive or missing: 1.0). Tiles go largest
    first to the host with the smallest projected finish ``(load + cost) /
    rate`` (ties by host id, then plan order), so every host computes the
    same plan from the same heartbeats."""
    hosts = sorted(rates)
    plan: Dict[str, List[Tuple[int, int]]] = {h: [] for h in hosts}
    if not hosts:
        return plan
    eff = {h: (float(rates[h]) if float(rates.get(h) or 0.0) > 0 else 1.0) for h in hosts}
    loads = {h: 0.0 for h in hosts}
    for origin, cost in sorted(tiles, key=lambda tc: (-tc[1], tc[0])):
        best = min(hosts, key=lambda h: ((loads[h] + cost) / eff[h], h))
        plan[best].append(origin)
        loads[best] += float(cost)
    return plan


class ThroughputTracker:
    """EWMA cells/s of this host, seeded from the perf history so a
    rejoining host starts from its platform's typical rate instead of 1.0."""

    def __init__(self, seed_rate: Optional[float] = None, alpha: float = 0.5):
        self.rate = seed_rate
        self.alpha = alpha

    def update(self, cells: int, dur_s: float) -> None:
        if dur_s <= 0 or cells <= 0:
            return
        r = cells / dur_s
        self.rate = r if self.rate is None else self.alpha * r + (1 - self.alpha) * self.rate


def _platform(device=None) -> str:
    """The history's platform tag of ``device`` (default: the card)."""
    if device is None:
        return "gpu"
    import torch

    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _rate_history_path() -> Path:
    """The sidecar of the perf history that holds the elastic throughput
    records (``<history>.elastic.jsonl``): the trend gate reads only the
    latest record of the main history, so these must not land there."""
    from sbr_tpu_torch.obs import history

    return Path(str(history.history_path()) + ".elastic.jsonl")


def seed_rate_from_history(path=None, window: int = 8, device=None) -> Optional[float]:
    """Median of the ``window`` latest ``elastic_cells_per_sec`` records of
    ``device``'s platform in the sidecar history, or None when there is
    none."""
    from sbr_tpu_torch.obs import history

    return history.recent_median(
        "elastic_cells_per_sec", path=path or _rate_history_path(),
        platform=_platform(device), window=window,
    )


def _append_rate_history(rate: Optional[float], tiles_computed: int, device=None) -> None:
    """Record this sweep's measured rate for later seeds. Only with an
    explicit ``SBR_OBS_HISTORY``: tests and ad-hoc sweeps grow no history."""
    if not rate or tiles_computed <= 0 or not os.environ.get("SBR_OBS_HISTORY", "").strip():
        return
    from sbr_tpu_torch.obs import history

    try:
        history.append(
            {"elastic_cells_per_sec": float(rate)}, label="elastic_sweep",
            platform=_platform(device), path=_rate_history_path(),
            meta={"tiles": tiles_computed, "host": host_identity()},
        )
    except OSError:
        pass  # a read-only history must not sink the sweep


def _dtype_name(dtype) -> str:
    from sbr_tpu_torch.utils.checkpoint import dtype_name, sweep_dtype

    return dtype_name(sweep_dtype(dtype))


def _grid_program_version() -> int:
    from sbr_tpu_torch.sweeps.baseline_sweeps import GRID_PROGRAM_VERSION

    return int(GRID_PROGRAM_VERSION)


def cell_tag(params, config, dtype_name: str) -> str:
    """Canonical tag of everything that, with (β, u), determines one sweep
    cell's bytes: the non-swept scalars, the config, the dtype, the
    backend tag, the grid-program version and the params type. The serving
    ladder (`serve.fleet.TileCacheBridge`) matches a query to a swept tile
    exactly when their tags agree: this one function is both sides of that
    contract."""
    from sbr_tpu_torch.utils.checkpoint import BACKEND, canonicalize

    e, lp = params.economic, params.learning
    return canonicalize(
        (
            type(params).__name__,
            float(e.p), float(e.kappa), float(e.lam), float(e.eta),
            float(lp.tspan[0]), float(lp.tspan[1]), float(lp.x0),
            config, str(dtype_name), BACKEND, _grid_program_version(),
        )
    )


def tile_meta(base, config, dtype, tile_betas, tile_us, key: str) -> dict:
    """The ``<key>.meta.json`` document stored beside a plain tile: its cell
    tag and its β/u axes, which make the whole tile's cells addressable one
    by one. ``dtype=None`` resolves to float64, as the sweep and the
    serving engine resolve it."""
    return {
        "key": key,
        "cell_tag": cell_tag(base, config, _dtype_name(dtype)),
        "betas": [float(b) for b in np.asarray(tile_betas).ravel()],
        "us": [float(u) for u in np.asarray(tile_us).ravel()],
    }


class TileCache:
    """Content-addressed cross-run tile store (module docstring).

    Layout: ``<root>/<key[:2]>/<key>.npz`` with a ``.sha256`` sidecar and,
    for plain tiles, a ``<key>.meta.json`` cell index. Writes are atomic;
    reads verify the sidecar and quarantine a mismatch
    (``<root>/<key[:2]>/quarantine/``). A hit refreshes the entry's mtime,
    which `gc_tile_cache` reads."""

    def __init__(self, root):
        self.root = Path(root)

    def key(self, base, config, dtype, tile_betas, tile_us) -> str:
        """sha256 over everything that determines the tile's bytes: the
        canonical params and config, the dtype, the backend tag, the grid
        program's version and the tile's actual β/u values."""
        from sbr_tpu_torch.utils.checkpoint import BACKEND, canonicalize

        payload = canonicalize(
            (
                base,
                config,
                _dtype_name(dtype),
                BACKEND,
                _grid_program_version(),
                np.ascontiguousarray(np.asarray(tile_betas, dtype=np.float64)),
                np.ascontiguousarray(np.asarray(tile_us, dtype=np.float64)),
            )
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.npz"

    def load(self, key: str, tile: str = "?") -> Optional[dict]:
        """Verified read; None on a miss or corruption (a corrupt entry is
        quarantined and the caller recomputes)."""
        from sbr_tpu_torch.utils.checkpoint import _FIELDS

        path = self.path(key)
        if not path.exists():
            _log("cache", "miss", tile=tile, key=key[:12])
            return None
        # outside the quarantine handler: an injected read failure is a
        # miss, never the end of a healthy entry
        try:
            faults.fire("tilecache.load", target=tile)
        except faults.InjectedFault:
            _log("cache", "miss", tile=tile, key=key[:12], injected=True)
            return None
        try:
            # a cache entry has no "legacy" form: anything not verified "ok"
            # is quarantined
            if heal.verify_file(path) != "ok":
                heal.quarantine(path, reason="tilecache-unverifiable")
                _log("cache", "quarantine", tile=tile, key=key[:12])
                return None
            with np.load(path) as data:
                arrays = {f: data[f] for f in _FIELDS}
        except Exception as err:
            if path.exists():
                heal.quarantine(path, reason=f"tilecache-unreadable: {err!r}")
            _log("cache", "quarantine", tile=tile, key=key[:12])
            return None
        try:  # a hit is a use: keep the entry warm for gc
            os.utime(path)
        except OSError:
            pass
        _log("cache", "hit", tile=tile, key=key[:12])
        return arrays

    def store(self, key: str, arrays: dict, tile: str = "?",
              meta: Optional[dict] = None) -> Optional[Path]:
        from sbr_tpu_torch.utils.checkpoint import _FIELDS

        path = self.path(key)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with shutdown.track_tmp(tmp):
                    with os.fdopen(fd, "wb") as fh:
                        np.savez(fh, **{f: np.asarray(arrays[f]) for f in _FIELDS})
                    # the sidecar before the rename, hashed from the staged
                    # file: a reader sees nothing or a verifiable entry
                    heal.write_sidecar(path, source=tmp)
                    os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
        except OSError:
            return None  # a full or read-only cache must not sink the sweep
        if meta is not None:
            # after the entry, best effort: a missing meta only hides the
            # entry from the serving bridge
            try:
                meta_path = Path(str(path)[: -len(".npz")] + ".meta.json")
                fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
                with os.fdopen(fd, "w") as fh:
                    fh.write(json.dumps(meta))
                os.replace(tmp, meta_path)
            except OSError:
                pass
        _log("cache", "store", tile=tile, key=key[:12])
        return path


def gc_tile_cache(root, keep_days: float = 30.0, now: Optional[float] = None) -> list:
    """Prune cold entries: every ``.npz`` (and its sidecars) not read or
    written for ``keep_days``, every ``quarantine/`` directory, and orphaned
    ``*.tmp`` files, sidecars and metas older than an hour. Returns the
    removed paths."""
    import shutil

    root = Path(root)
    removed: list = []
    if not root.is_dir():
        return removed
    now = time.time() if now is None else now
    horizon = now - keep_days * 86400.0
    for q in sorted(root.rglob("quarantine")):
        if not q.is_dir():
            continue
        try:
            shutil.rmtree(q)
            removed.append(q)
        except OSError:
            pass
    for entry in sorted(root.rglob("*.npz")):
        try:
            if entry.stat().st_mtime > horizon:
                continue
            entry.unlink()
            removed.append(entry)
        except OSError:
            continue
        for side in (
            Path(str(entry) + ".sha256"),
            Path(str(entry)[: -len(".npz")] + ".meta.json"),
        ):
            try:
                side.unlink()
                removed.append(side)
            except OSError:
                pass

    def orphans(pattern: str, owner) -> None:
        for p in sorted(root.rglob(pattern)):
            try:
                if (owner is None or not owner(p).exists()) \
                        and now - p.stat().st_mtime >= 3600.0:
                    p.unlink()
                    removed.append(p)
            except OSError:
                continue

    orphans("*.tmp", None)
    orphans("*.npz.sha256", lambda p: Path(str(p)[: -len(".sha256")]))
    orphans("*.meta.json", lambda p: Path(str(p)[: -len(".meta.json")] + ".npz"))
    return removed


def run_elastic_grid(
    beta_values,
    u_values,
    base,
    checkpoint_dir,
    config=None,
    tile_shape=(256, 256),
    dtype=None,
    wait: bool = True,
    poll_s: float = 5.0,
    timeout_s: float = 24 * 3600.0,
    verbose: bool = False,
    lease_ttl_s: Optional[float] = None,
    heartbeat_ttl_s: Optional[float] = None,
    tile_cache_dir=None,
    max_retries: int = 2,
    scenario_spec=None,
    device=None,
    report: Optional[dict] = None,
):
    """Elastic β×u sweep over a shared checkpoint directory (the scheduler
    behind `parallel.run_tiled_grid_multihost`).

    Any number of hosts may run this against one ``checkpoint_dir``,
    joining late or vanishing mid-run; tile ownership is decided a claim at
    a time by `plan_claims` and the lease files, and the final grid is
    byte-identical to a single-host `run_tiled_grid` of the same sweep
    whatever the churn. Tiles compute on ``device`` (default: the CUDA
    card; raises without one).

    ``wait=False`` returns None as soon as nothing is claimable (every
    tile done or leased to a live holder): the worker pattern. ``wait=True``
    polls until every tile exists, then assembles the grid from disk. A
    dict passed as ``report`` receives this host's id, its tile ``counts``,
    the tiles it ``claimed`` and its ``repairs``."""
    from sbr_tpu_torch.parallel.distributed import _cleanup_leases, _try_lease
    from sbr_tpu_torch.utils import checkpoint as ckpt_mod

    if checkpoint_dir is None:
        raise ValueError("elastic sweeps need a shared checkpoint_dir (the rendezvous)")
    if lease_ttl_s is None:
        lease_ttl_s = float(os.environ.get("SBR_STEAL_LEASE_TTL_S", "900"))
    if tile_shape == "auto":
        # a late joiner adopts the sweep's recorded geometry
        adopted = recorded_tile_shape(checkpoint_dir)
        if adopted is not None:
            tile_shape = adopted

    cache = default_tile_cache(tile_cache_dir)
    runner = ckpt_mod.tile_runner(
        beta_values, u_values, base, checkpoint_dir, config=config,
        tile_shape=tile_shape, dtype=dtype, max_retries=max_retries,
        tile_cache=cache, scenario_spec=scenario_spec, device=device,
    )
    ckpt = runner.ckpt
    tiles = ckpt_mod.tile_origins(runner.nb, runner.nu, (runner.tb, runner.tu))
    costs = {
        t: float(tile_cells(t, runner.nb, runner.nu, (runner.tb, runner.tu)))
        for t in tiles
    }

    hid = host_identity()
    hb = Heartbeat(ckpt, hid, ttl_s=heartbeat_ttl_s)
    tracker = ThroughputTracker(seed_rate=seed_rate_from_history(device=device))
    hb.beat(tiles_done=0, cells_per_sec=tracker.rate)
    _log("scheduler", "join", host=hid, tiles=len(tiles), seed_rate=tracker.rate)

    done = 0
    claimed_ids: list = []
    deadline = time.monotonic() + timeout_s
    last_plan_sig = None
    # one full scan at join; afterwards tiles leave the set as they are
    # produced or seen landed, and a full re-scan happens only when nothing
    # was claimable
    remaining = {t for t in tiles if not runner.path(*t).exists()}
    # the plan is recomputed every REPLAN_EVERY claims (or when its order
    # drains): leases arbitrate every claim, so a stale plan is safe
    REPLAN_EVERY = 16
    order: list = []
    next_in_order = 0
    claims_since_plan = 0
    with shutdown.graceful_shutdown(label="elastic_grid"):
        try:
            while remaining:
                faults.fire("barrier.poll", target=f"missing={len(remaining)}")
                fl = ckpt_mod._flight_recorder()
                if fl is not None:
                    fl.point("collectives", "barrier_poll", tag=f"missing={len(remaining)}")
                if next_in_order >= len(order) or claims_since_plan >= REPLAN_EVERY:
                    rates = {
                        h: float(rec.get("cells_per_sec") or 0.0) or 1.0
                        for h, rec in live_hosts(ckpt).items()
                    }
                    rates[hid] = float(tracker.rate or 0.0) or rates.get(hid, 1.0)
                    missing = sorted(remaining)
                    plan = plan_claims([(t, costs[t]) for t in missing], rates)
                    shares = {h: len(v) for h, v in sorted(plan.items())}
                    plan_sig = json.dumps(shares)
                    if plan_sig != last_plan_sig:
                        last_plan_sig = plan_sig
                        _log("scheduler", "plan", host=hid, missing=len(missing), shares=shares)
                    mine = plan.get(hid, [])
                    mine_set = set(mine)
                    order = mine + [t for t in missing if t not in mine_set]
                    next_in_order = 0
                    claims_since_plan = 0

                claimed = None
                while next_in_order < len(order):
                    bi, ui = order[next_in_order]
                    next_in_order += 1
                    if (bi, ui) not in remaining:
                        continue
                    if runner.path(bi, ui).exists():
                        remaining.discard((bi, ui))  # a peer landed it
                        continue
                    lease = ckpt / f"tile_b{bi:05d}_u{ui:05d}.lease"
                    takeover = lease.exists()
                    if _try_lease(ckpt, bi, ui, lease_ttl_s):
                        claimed = (bi, ui, lease, takeover)
                        break
                    # leased to a live holder: revisit on the next plan
                if claimed is None:
                    remaining = {t for t in remaining if not runner.path(*t).exists()}
                    if not remaining or not wait:
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{len(remaining)} tiles still missing after "
                            f"{timeout_s:.0f}s with nothing claimable — live "
                            f"holders: {sorted(live_hosts(ckpt))}; first "
                            f"missing: {sorted(remaining)[0]}"
                        )
                    hb.beat(tiles_done=done, cells_per_sec=tracker.rate)
                    if verbose:
                        print(f"  elastic: waiting on {len(remaining)} leased tile(s) …")
                    time.sleep(poll_s)
                    continue

                bi, ui, lease, takeover = claimed
                tile_id = runner.tile_id(bi, ui)
                _log("scheduler", "reclaim" if takeover else "claim", host=hid, tile=tile_id)
                shutdown.release_on_exit(lease)
                # beat at the tile's start: the staleness clock spans one tile
                hb.beat(tiles_done=done, cells_per_sec=tracker.rate)
                t_tile = time.monotonic()
                try:
                    source, _ = runner.produce(bi, ui)
                finally:
                    try:
                        lease.unlink()
                    except OSError:
                        pass
                    shutdown.unregister_release(lease)
                dur = time.monotonic() - t_tile
                if source == "computed":
                    tracker.update(int(costs[(bi, ui)]), dur)
                done += 1
                claims_since_plan += 1
                claimed_ids.append(tile_id)
                remaining.discard((bi, ui))
                hb.beat(tiles_done=done, cells_per_sec=tracker.rate)
                _log("scheduler", "done", host=hid, tile=tile_id, source=source,
                           dur_s=round(dur, 6), cells=int(costs[(bi, ui)]))
                if verbose:
                    print(f"  elastic: {tile_id} {source} in {dur:.3f}s "
                          f"({len(remaining)} left)")
        finally:
            # inside the shutdown block: on SIGTERM the "leave" lands before
            # the run is finalized as interrupted
            hb.withdraw()
            _log("scheduler", "leave", host=hid, tiles_done=done)

    if runner.ckpt is not None and runner.repairs:
        ckpt_mod._record_repairs(runner.ckpt, runner.repairs)
    if report is not None:
        report.update(host=hid, counts=dict(runner.counts), claimed=claimed_ids,
                      repairs=list(runner.repairs))
    # computed tiles only: an all-hit sweep measured nothing, and echoing
    # its seed would pin the median
    _append_rate_history(tracker.rate, runner.counts.get("computed", 0), device)
    if not wait:
        return None
    # every tile is on disk: assembly is a pure read
    _cleanup_leases(ckpt)
    return ckpt_mod.run_tiled_grid(
        beta_values, u_values, base, config=config, tile_shape=tile_shape,
        checkpoint_dir=checkpoint_dir, dtype=dtype, verbose=verbose,
        tile_cache=cache, scenario_spec=scenario_spec, device=device,
    )
