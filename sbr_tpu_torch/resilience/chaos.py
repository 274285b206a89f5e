"""Chaos drills: prove the resilience layer recovers bit for bit.

The port of ``sbr_tpu.resilience.chaos``, with its five drills, their
fault plans, their shapes, their ``checks`` and their verdict::

    python -m sbr_tpu_torch.resilience.chaos [--out DIR] [--json] [--device DEV]
        [--churn | --fleet | --audit | --prewarm]

``--device`` (default: the CUDA card) is passed to every worker, fleet
worker, sweeper and loadgen a drill starts; ``--device cpu`` runs a drill
without a card. It stands where the reference pins its workers to the CPU
(``JAX_PLATFORMS=cpu``).

1. **The base drill** runs three worker subprocesses over one small β×u
   tiled sweep (4×4 under 2×2 tiles): a fault-free **baseline**, whose
   grid is the ground truth; **chaos**, the same sweep under a seeded plan
   that injects a transient dispatch error (retried), a NaN-poisoned tile
   result (repaired by the degrade ladder in the run), a corrupted
   checkpoint file (a torn write, found later) and a preemption (SIGTERM:
   a graceful shutdown, manifest status ``"interrupted"``, exit 143); and
   **resume**, a clean rerun against the chaos checkpoint directory (the
   corrupt tile quarantined by its sha256 and recomputed, cached tiles
   served, preempted tiles computed). It passes only if the resumed grid
   is byte-identical to the baseline (``max_aw``, ``xi``, ``status``), the
   faults and the interrupted manifest show in the chaos run, the
   quarantine repair in the resume run, and ``report resilience`` exits 0.
2. ``--churn``: the elastic sweep. A fault-free single-host baseline; an
   elastic host preempted after two of four tiles (its leases and
   heartbeat handed back at once); a late-joining host that adopts the
   rest and assembles; a warm re-sweep into a fresh checkpoint directory
   with the cross-run tile cache (``SBR_TILE_CACHE_DIR``) hot. Both grids
   byte-identical to the baseline, and ``report elastic`` shows that the
   warm sweep computed no tile.
3. ``--fleet``: a fault-free single-worker fleet records the answers to a
   seeded query mix; three workers serve the same mix while one is
   SIGKILLed under load. No query lost, every answer byte-identical, the
   failover and breaker events and the joined traces visible through
   ``report fleet|trace|slo``.
4. ``--audit``: the numerics audit. Canary goldens recorded under the
   workers' device; an audit-off control; a clean audited run (no drift,
   p99 within tolerance); and one whose worker 0 has its
   ``graphgen.layout`` canary corrupted (``audit.canary``): drift within
   two cycles, worker 0 quarantined by the router, answers byte-identical.
5. ``--prewarm``: a demand run leaves an advisor plan; a sweeper hung by a
   ``prewarm.sweep`` fault is SIGKILLed holding a tile lease; a second
   sweeper adopts the stranded tile at the 2 s lease TTL and finishes the
   plan; a total solver outage (``serve.dispatch``, p = 1) is answered
   from the prefetched tile cache, byte-identical to the live answers; and
   with ``SBR_PREWARM=0`` the controller's module is never imported.

The verdict is the reference's: one ``checks`` dict a drill, all of which
must hold; ``--json`` prints ``{"ok", "checks", "out"}``; exit 0 or 1.
Every subprocess wait is bounded by the reference's timeout, and every
child is killed on the way out. The drills' own process imports no torch:
its workers are subprocesses.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

# One plan, seeded: same sequence every run (see resilience.faults).
# Tile order for the 4×4 grid under 2×2 tiles: (0,0) (0,2) (2,0) (2,2);
# tile.compute hit order with the retried first attempt: 1=(0,0) attempt 1
# (transient), 2=(0,0) attempt 2, 3=(0,2), 4=(2,0) → preempted.
FAULT_PLAN = {
    "seed": 0,
    "rules": [
        {"point": "tile.compute", "kind": "transient", "at_hits": [1]},
        {"point": "tile.result", "kind": "nan", "match": "b00000_u00002",
         "cells": 1, "max_fires": 1},
        {"point": "checkpoint.save", "kind": "corrupt", "match": "b00000_u00000",
         "max_fires": 1},
        {"point": "tile.compute", "kind": "preempt", "at_hits": [4]},
    ],
}

_FIELDS = ("max_aw", "xi", "status")

# One fixed small sweep shared by every worker mode so grids are
# byte-comparable across phases: 4×4 β×u grid under 2×2 tiles.
_SWEEP = dict(n_grid=96, bisect_iters=40, tile_shape=(2, 2))

_MODULE = "sbr_tpu_torch.resilience.chaos"


def _sweep_values():
    return np.linspace(0.5, 2.0, 4), np.linspace(0.05, 0.5, 4)


def _device_argv(device) -> list:
    return ["--device", str(device)] if device else []


def _save_grid(grid, out_npz: str) -> None:
    arrays = {f: np.asarray(getattr(grid, f)) for f in _FIELDS}
    with open(out_npz, "wb") as fh:
        np.savez(fh, **arrays)


def _worker(ckpt_dir: str, out_npz: str, device=None) -> int:
    """One tiled sweep (fixed small shape), grids saved as npz."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    betas, us = _sweep_values()
    grid = run_tiled_grid(
        betas,
        us,
        make_model_params(),
        config=SolverConfig(n_grid=_SWEEP["n_grid"], bisect_iters=_SWEEP["bisect_iters"]),
        tile_shape=_SWEEP["tile_shape"],
        checkpoint_dir=ckpt_dir,
        device=device,
    )
    _save_grid(grid, out_npz)
    return 0


def _worker_elastic(ckpt_dir: str, out_npz: str, device=None) -> int:
    """The same sweep through the ELASTIC scheduler (heartbeats, claim
    plan, leases, global tile cache from SBR_TILE_CACHE_DIR)."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.parallel import run_tiled_grid_multihost

    betas, us = _sweep_values()
    grid = run_tiled_grid_multihost(
        betas,
        us,
        make_model_params(),
        ckpt_dir,
        config=SolverConfig(n_grid=_SWEEP["n_grid"], bisect_iters=_SWEEP["bisect_iters"]),
        tile_shape=_SWEEP["tile_shape"],
        poll_s=0.2,
        timeout_s=300.0,
        elastic=True,
        device=device,
    )
    _save_grid(grid, out_npz)
    return 0


def _run_phase(name: str, out: Path, ckpt: Path, npz, fault_plan=None,
               timeout_s=600.0, mode: str = "--worker", extra_env=None, device=None):
    """Run one worker subprocess; returns (rc, obs_run_dir_or_None)."""
    obs_root = out / f"obs_{name}"
    env = {
        **os.environ,
        "SBR_OBS": "1",
        "SBR_OBS_LABEL": name,
        "SBR_OBS_DIR": str(obs_root),
        "SBR_RETRY_BASE_DELAY_S": "0.05",
    }
    env.pop("SBR_FAULT_PLAN", None)
    env.pop("SBR_TILE_CACHE_DIR", None)
    if fault_plan is not None:
        env["SBR_FAULT_PLAN"] = json.dumps(fault_plan)
    if extra_env:
        env.update(extra_env)
    argv = [
        sys.executable, "-m", _MODULE,
        mode, str(ckpt), str(npz if npz else out / f"{name}.npz"), *_device_argv(device),
    ]
    proc = subprocess.run(
        argv, env=env, timeout=timeout_s, capture_output=True, text=True
    )
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    runs = sorted(obs_root.iterdir()) if obs_root.is_dir() else []
    return proc.returncode, (runs[0] if runs else None)


def _manifest(run_dir) -> dict:
    try:
        return json.loads((Path(run_dir) / "manifest.json").read_text())
    except (OSError, TypeError, json.JSONDecodeError):
        return {}


def _report(subcommand: str, run_dir) -> tuple:
    """(exit_code, json_doc) from a report subcommand: the user-facing gates."""
    return _report_multi(subcommand, [run_dir])


def _report_multi(subcommand: str, run_dirs) -> tuple:
    """(exit_code, json_doc) for a report subcommand over one or more run
    directories (`trace`/`slo` join spans across the router's AND every
    worker's directory)."""
    proc = subprocess.run(
        [sys.executable, "-m", "sbr_tpu_torch.obs.report", subcommand,
         *[str(d) for d in run_dirs], "--json"],
        capture_output=True, text=True, timeout=120.0,
    )
    try:
        return proc.returncode, json.loads(proc.stdout)
    except json.JSONDecodeError:
        return proc.returncode, {}


def _bit_identical(a_npz, b_npz) -> bool:
    try:
        want, got = np.load(a_npz), np.load(b_npz)
    except OSError:
        return False
    return all(want[f].tobytes() == got[f].tobytes() for f in _FIELDS)


def _finish(name: str, ok_text: str, checks: dict, out: Path, as_json: bool,
            stories=()) -> int:
    """Print the drill's verdict (the JSON document or the PASS/FAIL lines
    and the stories to read next); exit code 0 or 1."""
    ok = all(checks.values())
    if as_json:
        print(json.dumps({"ok": ok, "checks": checks, "out": str(out)}))
    else:
        for check, passed in checks.items():
            print(f"  {'PASS' if passed else 'FAIL'}  {check}")
        print(f"{name}: {('OK — ' + ok_text) if ok else 'FAILED'} ({out})")
        for line in stories:
            print(line)
    return 0 if ok else 1


def main_base(out: Path, as_json: bool, device=None) -> int:
    """The base drill: faulted and resumed sweep byte-identical to the
    fault-free one (module docstring)."""
    checks: dict = {}

    def log(msg):
        if not as_json:
            print(msg)

    log("phase 1/3: fault-free baseline …")
    rc, _ = _run_phase("baseline", out, out / "ckpt_baseline", out / "baseline.npz",
                       device=device)
    checks["baseline_rc0"] = rc == 0

    log("phase 2/3: chaos (transient + nan poison + corrupt tile + preemption) …")
    rc, chaos_run = _run_phase(
        "chaos", out, out / "ckpt_chaos", out / "chaos.npz", fault_plan=FAULT_PLAN,
        device=device,
    )
    checks["chaos_preempted_143"] = rc == 143
    checks["chaos_manifest_interrupted"] = _manifest(chaos_run).get("status") == "interrupted"
    chaos_res = (_manifest(chaos_run).get("resilience") or {})
    faults_seen = chaos_res.get("faults") or {}
    checks["chaos_faults_visible"] = {
        "tile.compute:transient", "tile.result:nan", "checkpoint.save:corrupt",
        "tile.compute:preempt",
    } <= set(faults_seen)

    log("phase 3/3: clean resume against the chaos checkpoint …")
    rc, resume_run = _run_phase("resume", out, out / "ckpt_chaos", out / "resumed.npz",
                                device=device)
    checks["resume_rc0"] = rc == 0
    checks["corrupt_tile_quarantined"] = any((out / "ckpt_chaos" / "quarantine").glob("*.npz"))
    report_rc, report_doc = _report("resilience", resume_run) if resume_run else (2, {})
    checks["report_resilience_rc0"] = report_rc == 0
    checks["resume_repairs_visible"] = "quarantine" in (report_doc.get("repairs") or {})

    if checks["baseline_rc0"] and checks["resume_rc0"]:
        checks["grid_bit_identical"] = _bit_identical(out / "baseline.npz",
                                                      out / "resumed.npz")
    else:
        checks["grid_bit_identical"] = False

    stories = ([f"recovery path: python -m sbr_tpu_torch.obs.report resilience {resume_run}"]
               if resume_run is not None else [])
    return _finish("chaos smoke", "recovery is bit-exact", checks, out, as_json, stories)


# Churn plan: preempt host A at its THIRD tile compute — two tiles land,
# the third is interrupted mid-flight; graceful shutdown must release A's
# lease + heartbeat so the late-joining replacement claims immediately.
CHURN_FAULT_PLAN = {
    "seed": 0,
    "rules": [
        {"point": "tile.compute", "kind": "preempt", "at_hits": [3]},
    ],
}


def main_churn(out: Path, as_json: bool, device=None) -> int:
    """The elastic churn drill: kill one host mid-sweep, late-join a
    replacement, then a warm-cache re-sweep; all three grids
    byte-identical, no tile computed warm (module docstring)."""
    checks: dict = {}
    cache = out / "tile_cache"
    elastic_env = {
        "SBR_TILE_CACHE_DIR": str(cache),
        "SBR_ELASTIC": "1",
        "SBR_HEARTBEAT_TTL_S": "10",
    }

    def log(msg):
        if not as_json:
            print(msg)

    log("phase 1/4: fault-free single-host baseline (no cache) …")
    rc, _ = _run_phase("baseline", out, out / "ckpt_baseline", out / "baseline.npz",
                       device=device)
    checks["baseline_rc0"] = rc == 0

    log("phase 2/4: elastic host A — preempted (SIGTERM) after 2 of 4 tiles …")
    ckpt_churn = out / "ckpt_churn"
    rc, run_a = _run_phase(
        "churn_a", out, ckpt_churn, out / "churn_a.npz",
        fault_plan=CHURN_FAULT_PLAN, mode="--worker-elastic", extra_env=elastic_env,
        device=device,
    )
    checks["host_a_preempted_143"] = rc == 143
    checks["host_a_manifest_interrupted"] = _manifest(run_a).get("status") == "interrupted"
    # even a preempted host's departure is in the census: its "leave"
    # event lands before the run finalizes as interrupted
    _, doc_a = _report("elastic", run_a) if run_a else (2, {})
    checks["host_a_leave_visible"] = (doc_a.get("scheduler") or {}).get("leave", 0) >= 1
    # graceful shutdown hands A's leases AND heartbeat back at SIGTERM, so
    # the replacement never waits out a TTL
    checks["host_a_released_leases"] = not list(ckpt_churn.glob("*.lease"))
    checks["host_a_released_heartbeat"] = not list(ckpt_churn.glob("host_*.hb"))
    checks["host_a_partial_tiles"] = len(list(ckpt_churn.glob("tile_*.npz"))) == 2

    log("phase 3/4: elastic host B late-joins, adopts the rest, assembles …")
    rc, run_b = _run_phase(
        "churn_b", out, ckpt_churn, out / "churn.npz",
        mode="--worker-elastic", extra_env=elastic_env, device=device,
    )
    checks["host_b_rc0"] = rc == 0
    rc_el, doc_b = _report("elastic", run_b) if run_b else (2, {})
    checks["host_b_report_elastic_rc0"] = rc_el == 0
    sched_b = doc_b.get("scheduler") or {}
    checks["host_b_join_leave_visible"] = (
        sched_b.get("join", 0) >= 1 and sched_b.get("leave", 0) >= 1
    )
    checks["host_b_adopted_tiles"] = doc_b.get("tiles_computed", 0) == 2
    checks["churn_grid_bit_identical"] = _bit_identical(
        out / "baseline.npz", out / "churn.npz"
    )

    log("phase 4/4: warm re-sweep — fresh checkpoint dir, hot global cache …")
    rc, run_w = _run_phase(
        "warm", out, out / "ckpt_warm", out / "warm.npz",
        mode="--worker-elastic", extra_env=elastic_env, device=device,
    )
    checks["warm_rc0"] = rc == 0
    rc_el, doc_w = _report("elastic", run_w) if run_w else (2, {})
    checks["warm_report_elastic_rc0"] = rc_el == 0
    # a repeated sweep recomputes nothing
    checks["warm_zero_tiles_computed"] = (
        doc_w.get("tiles_computed", 1) == 0
        and doc_w.get("tiles_from_cache", 0) >= 4
    )
    checks["warm_all_tiles_cache_hits"] = (doc_w.get("cache") or {}).get("hit", 0) >= 4
    checks["warm_grid_bit_identical"] = _bit_identical(
        out / "baseline.npz", out / "warm.npz"
    )

    stories = ([f"scheduler story: python -m sbr_tpu_torch.obs.report elastic {run_b}"]
               if run_b is not None else [])
    return _finish("churn smoke", "churn is bit-exact and the warm sweep computed 0 tiles",
                   checks, out, as_json, stories)


# Fleet drill shape: small enough that three workers bring up their
# buckets in seconds, large enough that the mid-run kill lands while
# queries are still flowing (kill after 8 of 36).
_FLEET = dict(queries=36, pool=6, group=8, n_grid=96, bisect_iters=30,
              kill_after=8)

_ANSWER_FIELDS = ("xi", "tau_bar_in", "aw_max", "status", "flags")

# the environment a fleet run starts from: the drill's own switches only
_FLEET_SCRUB = ("SBR_FAULT_PLAN", "SBR_SERVE_DEADLINE_MS", "SBR_FLEET_DIR",
                "SBR_SERVE_CACHE_DIR", "SBR_TILE_CACHE_DIR",
                "SBR_TRACE_SAMPLE", "SBR_SERVE_SLO_MS",
                "SBR_AUDIT", "SBR_AUDIT_INTERVAL_S", "SBR_AUDIT_PROBES",
                "SBR_AUDIT_REGISTRY_DIR",
                "SBR_DEMAND", "SBR_PREWARM", "SBR_PREWARM_PLAN",
                "SBR_PREWARM_STATE_DIR")


def _run_loadgen_fleet(out: Path, name: str, n_workers: int,
                       kill_after=None, timeout_s: float = 900.0,
                       extra_env=None, trace_out=None,
                       extra_argv=None, device=None) -> tuple:
    """One `loadgen --fleet` subprocess; returns (rc, summary, answers,
    router_run_dir). ``extra_env`` overlays the scrubbed environment (the
    workers inherit it); ``trace_out`` forwards ``--trace-out``;
    ``extra_argv`` appends raw loadgen flags (--audit-fault/--audit-wait)."""
    run_dir = out / f"obs_{name}"
    answers_path = out / f"{name}_answers.json"
    argv = [
        sys.executable, "-m", "sbr_tpu_torch.serve.loadgen",
        "--fleet", str(n_workers),
        "--queries", str(_FLEET["queries"]),
        "--pool", str(_FLEET["pool"]),
        "--group", str(_FLEET["group"]),
        "--n-grid", str(_FLEET["n_grid"]),
        "--bisect-iters", str(_FLEET["bisect_iters"]),
        "--seed", "0",
        "--run-dir", str(run_dir),
        "--answers-out", str(answers_path),
        *_device_argv(device),
    ]
    if kill_after is not None:
        argv += ["--fleet-kill-after", str(kill_after)]
    if trace_out is not None:
        argv += ["--trace-out", str(trace_out)]
    argv += [str(a) for a in (extra_argv or [])]
    env = dict(os.environ)
    for k in _FLEET_SCRUB:
        env.pop(k, None)
    env.update(extra_env or {})
    proc = subprocess.run(argv, env=env, timeout=timeout_s,
                          capture_output=True, text=True)
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    try:
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        summary = {}
    try:
        answers = json.loads(answers_path.read_text())
    except (OSError, ValueError):
        answers = None
    return proc.returncode, summary, answers, run_dir


def _answers_identical(a, b) -> bool:
    """Byte-identity of two answer lists: JSON floats round-trip Python's
    shortest repr exactly, so == on the parsed values IS bit equality of
    the served doubles (None encodes NaN on both sides)."""
    if not isinstance(a, list) or not isinstance(b, list) or len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if not isinstance(x, dict) or not isinstance(y, dict):
            return False
        if x.get("degraded") or y.get("degraded") or "shed" in x or "shed" in y:
            return False  # the fault-free contract: full-fidelity answers
        if any(x.get(f) != y.get(f) for f in _ANSWER_FIELDS):
            return False
    return True


def main_fleet(out: Path, as_json: bool, device=None) -> int:
    """The serving-fleet drill: kill one of three workers mid-loadgen;
    zero lost queries, byte-identical answers, visible failover and
    breaker events, `report fleet` exit 0 (module docstring)."""
    checks: dict = {}

    def log(msg):
        if not as_json:
            print(msg)

    log("phase 1/2: fault-free single-worker fleet (ground-truth answers) …")
    rc1, sum1, ans1, run1 = _run_loadgen_fleet(out, "fleet_solo", 1, device=device)
    checks["solo_rc0"] = rc1 == 0
    checks["solo_zero_lost"] = sum1.get("fleet_lost", 1) == 0
    rc_f1, _doc1 = _report("fleet", run1)
    checks["solo_report_fleet_rc0"] = rc_f1 == 0

    log("phase 2/2: three workers, one SIGKILLed after "
        f"{_FLEET['kill_after']} of {_FLEET['queries']} queries "
        "(tracing on: every query must yield a joinable waterfall) …")
    # tracing is on only here: the solo phase stays untraced, so
    # answers_bit_identical below is also the SBR_TRACE_SAMPLE=0-vs-1
    # bit-identity witness
    rc2, sum2, ans2, run2 = _run_loadgen_fleet(
        out, "fleet_churn", 3, kill_after=_FLEET["kill_after"],
        extra_env={"SBR_TRACE_SAMPLE": "1"},
        trace_out=out / "fleet_churn_trace_rows.jsonl", device=device,
    )
    checks["churn_rc0"] = rc2 == 0
    checks["churn_zero_lost"] = sum2.get("fleet_lost", 1) == 0
    checks["churn_worker_killed"] = bool(sum2.get("killed_worker"))
    checks["churn_zero_shed"] = sum2.get("fleet_shed_rate", 1) == 0
    # the failover must have fired and the dead worker's breaker opened,
    # both visible through report fleet
    rc_f2, doc2 = _report("fleet", run2)
    checks["churn_report_fleet_rc0"] = rc_f2 == 0
    checks["churn_failover_visible"] = doc2.get("failover_count", 0) >= 1
    checks["churn_breaker_visible"] = (doc2.get("events") or {}).get(
        "breaker_open", 0
    ) >= 1
    checks["churn_workers_joined"] = (doc2.get("events") or {}).get(
        "worker_join", 0
    ) == 3
    # spans from the router's and every worker's run directory join into
    # waterfalls, the failed-over queries' too (the killed worker's last
    # trace line may be torn)
    worker_dirs = sorted((run2.parent / (run2.name + "_workers")).glob("w*"))
    rc_t, doc_t = _report_multi("trace", [run2, *worker_dirs])
    checks["churn_report_trace_rc0"] = rc_t == 0
    checks["churn_traces_joined"] = doc_t.get("joined", 0) >= 1
    checks["churn_failover_trace"] = doc_t.get("failover_traces", 0) >= 1
    # the joined span trees explain >= 95% of the total measured latency
    # (duration-weighted); per query only loosely
    checks["churn_trace_coverage_95"] = (
        (doc_t.get("coverage_weighted") or 0) >= 0.95
        and (doc_t.get("coverage_min") or 0) >= 0.70
    )
    rc_s, _doc_s = _report_multi("slo", [run2, *worker_dirs])
    checks["churn_report_slo_rc0"] = rc_s == 0
    checks["churn_trace_rows_written"] = (
        out / "fleet_churn_trace_rows.jsonl"
    ).exists()
    # the headline: every answer the degraded fleet served is byte-
    # identical to the fault-free single-worker ground truth
    checks["answers_bit_identical"] = _answers_identical(ans1, ans2)

    return _finish(
        "fleet smoke",
        "one of three workers died mid-loadgen, zero queries lost, answers byte-identical",
        checks, out, as_json,
        [f"fleet story: python -m sbr_tpu_torch.obs.report fleet {run2}",
         f"trace story: python -m sbr_tpu_torch.obs.report trace {run2} {run2}_workers/w*"])


_AUDIT_ENV = dict(
    SBR_AUDIT="1",
    SBR_AUDIT_INTERVAL_S="1.5",
    # One cheap probe keeps the canary cycle short enough for a smoke (the
    # full battery is the CLI's job, not this proof's); a heavier canary
    # would hold the dispatch lock long enough to move the clean run's p99.
    SBR_AUDIT_PROBES="graphgen.layout",
)

#: Seeded audit.canary corruption, worker 0 only (via loadgen
#: --audit-fault): every graphgen.layout canary RESULT is perturbed before
#: the comparison; the serving path never sees it, so answers must stay
#: byte-identical while the audit flags drift.
_AUDIT_FAULT_PLAN = {
    "seed": 7,
    "rules": [
        {"point": "audit.canary", "kind": "corrupt", "match": "graphgen.layout"},
    ],
}


def _audit_drift_cycles(worker_run_dir: Path) -> list:
    """Cycle numbers of drift probe verdicts in a worker's audit events."""
    cycles = []
    try:
        for line in (worker_run_dir / "events.jsonl").read_text().splitlines():
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if (isinstance(ev, dict) and ev.get("kind") == "audit"
                    and ev.get("action") == "probe"
                    and ev.get("verdict") == "drift"):
                cycles.append(int(ev.get("cycle") or 0))
    except OSError:
        pass
    return cycles


def main_audit(out: Path, as_json: bool, device=None) -> int:
    """The numerics-audit drill: corrupt ONE of three workers' canaries;
    drift detected within 2 cycles, worker quarantined by the router, zero
    lost queries, answers byte-identical to the fault-free control; and on
    a clean audited run, zero drift verdicts with p99 inside the audit-off
    tolerance (canaries never ride the hot path)."""
    checks: dict = {}

    def log(msg):
        if not as_json:
            print(msg)

    # goldens recorded on the workers' device in the workers' dtype: a
    # golden set of another key would leave every canary at "no_golden"
    goldens = out / "audit_goldens"
    log("phase 0/3: generating canary goldens under the worker env …")
    gen = subprocess.run(
        [sys.executable, "-c",
         "import sys;"
         "from sbr_tpu_torch.obs.audit import run_battery;"
         f"r = run_battery(update=True, device={device!r});"
         "sys.exit(0 if r.get('updated') else 1)"],
        env={**os.environ, **_AUDIT_ENV,
             "SBR_AUDIT_REGISTRY_DIR": str(goldens)},
        timeout=600, capture_output=True, text=True,
    )
    if gen.stderr and not as_json:
        sys.stderr.write(gen.stderr)
    checks["goldens_rc0"] = gen.returncode == 0

    audit_env = {**_AUDIT_ENV, "SBR_AUDIT_REGISTRY_DIR": str(goldens)}

    log("phase 1/3: audit-OFF control (ground-truth answers + p99) …")
    rc0, sum0, ans0, _run0 = _run_loadgen_fleet(out, "audit_off", 3, device=device)
    checks["control_rc0"] = rc0 == 0
    checks["control_zero_lost"] = sum0.get("fleet_lost", 1) == 0

    log("phase 2/3: clean 3-worker run, canaries ON (no false positives) …")
    rc1, sum1, ans1, run1 = _run_loadgen_fleet(
        out, "audit_clean", 3, extra_env=audit_env,
        extra_argv=["--audit-wait", "2"], device=device,
    )
    checks["clean_rc0"] = rc1 == 0
    checks["clean_zero_lost"] = sum1.get("fleet_lost", 1) == 0
    blocks1 = (sum1.get("audit") or {}).get("workers") or {}
    checks["clean_canaries_ran"] = len(blocks1) == 3 and all(
        (b or {}).get("cycles", 0) >= 2 for b in blocks1.values()
    )
    checks["clean_no_drift"] = len(blocks1) == 3 and all(
        (b or {}).get("status") == "pass" for b in blocks1.values()
    )
    checks["clean_none_quarantined"] = not (sum1.get("audit") or {}).get("quarantined")
    checks["clean_answers_identical"] = _answers_identical(ans0, ans1)
    # canaries are idle-gated, so the audited fleet's p99 sits inside the
    # usual cross-run tolerance of the audit-off control
    p99_off, p99_on = sum0.get("fleet_p99_ms"), sum1.get("fleet_p99_ms")
    checks["clean_p99_within_tolerance"] = (
        p99_off is not None and p99_on is not None
        and p99_on <= p99_off * 1.5 + 250.0
    )
    w1_dirs = sorted((run1.parent / (run1.name + "_workers")).glob("w*"))
    audit_rcs1 = [_report("audit", d)[0] for d in w1_dirs]
    checks["clean_report_audit_rc0"] = len(audit_rcs1) == 3 and all(
        rc == 0 for rc in audit_rcs1
    )

    log("phase 3/3: corrupt worker 0's canaries (detect + quarantine) …")
    rc2, sum2, ans2, run2 = _run_loadgen_fleet(
        out, "audit_fault", 3, extra_env=audit_env,
        extra_argv=["--audit-fault", json.dumps(_AUDIT_FAULT_PLAN),
                    "--audit-wait", "2"], device=device,
    )
    checks["fault_rc0"] = rc2 == 0
    checks["fault_zero_lost"] = sum2.get("fleet_lost", 1) == 0
    blocks2 = (sum2.get("audit") or {}).get("workers") or {}
    drifted = sorted(h for h, b in blocks2.items()
                     if (b or {}).get("status") == "drift")
    checks["fault_one_worker_drifted"] = len(drifted) == 1
    checks["fault_quarantined"] = bool(
        drifted and (sum2.get("audit") or {}).get("quarantined") == drifted
    )
    # detection latency: worker 0's own audit events show the drift
    # verdict within its first 2 canary cycles
    w2_dirs = sorted((run2.parent / (run2.name + "_workers")).glob("w*"))
    w0_drifts = _audit_drift_cycles(w2_dirs[0]) if w2_dirs else []
    checks["fault_detected_within_2_cycles"] = bool(w0_drifts) and min(w0_drifts) <= 2
    # the fault perturbs only the canary's copy of the result: worker 0
    # keeps serving answers byte-identical to the control's
    checks["fault_answers_identical"] = _answers_identical(ans0, ans2)
    # the quarantine is visible to the fleet: an audit_quarantine event in
    # the router's run directory
    _rc_f, doc_f = _report("fleet", run2)
    checks["fault_quarantine_event"] = (doc_f.get("events") or {}).get(
        "audit_quarantine", 0
    ) >= 1
    # and to the drift gate: exit 1 on worker 0's run dir, 0 on its peers'
    audit_rcs2 = [_report("audit", d)[0] for d in w2_dirs]
    checks["fault_report_audit_w0_rc1"] = bool(audit_rcs2) and audit_rcs2[0] == 1
    checks["fault_report_audit_peers_rc0"] = len(audit_rcs2) == 3 and all(
        rc == 0 for rc in audit_rcs2[1:]
    )

    stories = ([f"drift story: python -m sbr_tpu_torch.obs.report audit {w2_dirs[0]}"]
               if w2_dirs else [])
    return _finish(
        "audit smoke",
        "corrupted canaries detected within 2 cycles, worker quarantined, zero lost, "
        "answers byte-identical", checks, out, as_json, stories)


# Prewarm drill shape: the sweeper pool/mix mirrors _FLEET so the replay
# can rebuild the ground-truth mapping with stdlib random alone.
#: Hang the victim sweeper's SECOND tile attempt (after one clean tile):
#: it dies by SIGKILL holding that tile's lease — the healer must adopt.
_PREWARM_HANG_PLAN = {
    "seed": 0,
    "rules": [
        {"point": "prewarm.sweep", "kind": "hang", "at_hits": [2],
         "duration_s": 600},
    ],
}

#: Total solver outage for the replay: every dispatch attempt fails, so
#: ONLY the degradation ladder's tile-cache rung can answer.
_PREWARM_OUTAGE_PLAN = {
    "seed": 0,
    "rules": [
        {"point": "serve.dispatch", "kind": "transient", "p": 1.0},
    ],
}


def _prewarm_pool_coords(seed: int, pool: int) -> list:
    """`serve.loadgen.build_pool`'s (β, u) stream, replicated with stdlib
    random so this torch-free process can reason about plan coverage."""
    import random

    rng = random.Random(seed)
    return [
        (round(rng.uniform(0.5, 4.0), 6), round(rng.uniform(0.02, 0.9), 6))
        for _ in range(pool)
    ]


def _prewarm_expanded_tiles(plan: dict) -> int:
    """Executable (per-β) tile count of an advisor plan — the granularity
    the prewarm controller claims leases at."""
    return sum(
        len({float(b) for b in (t.get("betas") or [])})
        for t in plan.get("tiles") or []
        if (t.get("betas") and t.get("us"))
    )


def _prewarm_env(cache: Path, fault_plan=None) -> dict:
    """A scrubbed environment for prewarm-phase subprocesses: shared tile
    cache, 2 s lease/heartbeat TTLs (adoption must happen in seconds, not
    the production 900 s), fast retries."""
    env = {
        **os.environ,
        "SBR_TILE_CACHE_DIR": str(cache),
        "SBR_STEAL_LEASE_TTL_S": "2",
        "SBR_HEARTBEAT_TTL_S": "2",
        "SBR_RETRY_BASE_DELAY_S": "0.05",
        "SBR_PREWARM_RETRY_BASE_DELAY_S": "0.05",
    }
    for k in ("SBR_FAULT_PLAN", "SBR_PREWARM", "SBR_PREWARM_PLAN",
              "SBR_PREWARM_STATE_DIR", "SBR_PREWARM_BUDGET_TILES",
              "SBR_PREWARM_BUDGET_SECONDS", "SBR_DEMAND", "SBR_OBS"):
        env.pop(k, None)
    if fault_plan is not None:
        env["SBR_FAULT_PLAN"] = json.dumps(fault_plan)
    return env


def _kill(proc) -> None:
    """SIGKILL a child that still runs, and reap it."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def _spawn_sweeper(plan_path: Path, cache: Path, run_dir=None,
                   fault_plan=None, timeout_s: float = 60.0, device=None):
    """Popen one ``python -m sbr_tpu_torch.serve.prewarm --once`` sweeper
    and wait for its readiness line; returns the process."""
    import threading

    argv = [
        sys.executable, "-m", "sbr_tpu_torch.serve.prewarm",
        "--plan", str(plan_path),
        "--n-grid", str(_FLEET["n_grid"]),
        "--bisect-iters", str(_FLEET["bisect_iters"]),
        *_device_argv(device), "--once", "--json",
        "--timeout-s", "600",
    ]
    if run_dir is not None:
        argv += ["--run-dir", str(run_dir)]
    proc = subprocess.Popen(
        argv, env=_prewarm_env(cache, fault_plan),
        stdout=subprocess.PIPE, stderr=sys.stderr.fileno(), text=True,
    )
    ready: dict = {}

    def read_ready():
        try:
            ready.update(json.loads(proc.stdout.readline()))
        except Exception:
            pass

    t = threading.Thread(target=read_ready, daemon=True)
    t.start()
    t.join(timeout_s)
    if ready.get("role") != "prewarm":
        _kill(proc)
        raise RuntimeError(f"sweeper failed to become ready in {timeout_s:.0f}s")
    return proc


def main_prewarm(out: Path, as_json: bool, device=None) -> int:
    """The self-healing prefetch drill: a demand run leaves a plan, a hung
    sweeper is SIGKILLed holding a lease, a peer adopts and finishes warm,
    and a breaker-open outage is answered 100% warm, byte-identical to the
    live ground truth (module docstring)."""
    import signal as _sig
    import time as _time

    checks: dict = {}
    cache = out / "tile_cache"

    def log(msg):
        if not as_json:
            print(msg)

    log("phase 1/4: single-worker fleet under SBR_DEMAND=1 "
        "(ground-truth answers + advisor plan) …")
    rc1, sum1, _ans1, run1 = _run_loadgen_fleet(
        out, "prewarm_demand", 1, extra_env={"SBR_DEMAND": "1"}, device=device,
    )
    checks["demand_rc0"] = rc1 == 0
    checks["demand_zero_lost"] = sum1.get("fleet_lost", 1) == 0
    plan_path = run1.parent / (run1.name + "_workers") / "w0" / "advisor_plan.json"
    try:
        plan = json.loads(plan_path.read_text())
    except (OSError, ValueError):
        plan = {}
    checks["advisor_plan_written"] = (
        plan.get("schema") == "sbr-demand-advisor/1"
        and bool(plan.get("plan_fingerprint"))
        and bool(plan.get("tiles"))
    )
    # the drill needs >= 2 executable (per-β) tiles: one to land cleanly
    # on the victim, one to be stranded under its lease and adopted
    n_tiles = _prewarm_expanded_tiles(plan)
    checks["plan_multi_tile"] = n_tiles >= 2
    pool_coords = _prewarm_pool_coords(0, _FLEET["pool"])
    covered = set()
    for t in plan.get("tiles") or []:
        bs = {float(b) for b in (t.get("betas") or [])}
        us = {float(u) for u in (t.get("us") or [])}
        covered |= {i for i, (b, u) in enumerate(pool_coords)
                    if b in bs and u in us}
    checks["plan_covers_hot_points"] = len(covered) >= 1
    if not all(checks.values()):
        # the remaining phases would only cascade noise without a plan
        if as_json:
            print(json.dumps({"ok": False, "checks": checks, "out": str(out)}))
        else:
            for name, passed in checks.items():
                print(f"  {'PASS' if passed else 'FAIL'}  {name}")
            print(f"prewarm smoke: FAILED in phase 1 ({out})")
        return 1

    fp = plan["plan_fingerprint"]
    # the port's epoch directories carry its backend tag
    plan_dir = cache / "_prewarm" / f"plan_{fp}_torch"

    log(f"phase 2/4: sweeper A drains the plan ({n_tiles} tile(s)) until a "
        "prewarm.sweep hang, then SIGKILL while it holds a tile lease …")
    victim = healer = None
    try:
        victim = _spawn_sweeper(plan_path, cache, fault_plan=_PREWARM_HANG_PLAN,
                                timeout_s=120.0, device=device)
        deadline = _time.monotonic() + 600.0
        stranded = False
        while _time.monotonic() < deadline:
            if victim.poll() is not None:
                break  # finished without hanging: plan_multi_tile failed us
            done = list(plan_dir.glob("done_*.json")) if plan_dir.is_dir() else []
            leases = list(plan_dir.glob("tile_*.lease")) if plan_dir.is_dir() else []
            if done and leases:
                stranded = True
                break
            _time.sleep(0.25)
        _time.sleep(1.0)  # let the hang engage inside the leased attempt
        checks["victim_hung_holding_lease"] = stranded and victim.poll() is None
        try:
            os.kill(victim.pid, _sig.SIGKILL)
        except OSError:
            pass
        victim.wait(timeout=30)
        checks["victim_stranded_lease"] = bool(list(plan_dir.glob("tile_*.lease")))

        log("phase 3/4: sweeper B adopts the stranded tile at the 2 s lease "
            "TTL and finishes the plan warm …")
        heal_run = out / "obs_prewarm_heal" / "run"
        healer = _spawn_sweeper(plan_path, cache, run_dir=heal_run,
                                timeout_s=120.0, device=device)
        heal_out, _ = healer.communicate(timeout=900)
    finally:
        _kill(victim)
        _kill(healer)
    try:
        snap = json.loads(heal_out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        snap = {}
    counts = snap.get("counts") or {}
    checks["healer_rc0"] = healer.returncode == 0
    checks["healer_plan_done"] = snap.get("status") == "done"
    checks["healer_adopted_stranded_tile"] = counts.get("adopted", 0) >= 1
    checks["healer_zero_failed"] = counts.get("failed", 0) == 0
    checks["healer_all_warm"] = (
        snap.get("warm") is not None
        and snap.get("warm") == snap.get("tiles_total") == n_tiles
    )
    rc_pw, doc_pw = _report("prewarm", heal_run)
    checks["report_prewarm_rc0"] = rc_pw == 0
    checks["report_adoption_visible"] = any(
        (p or {}).get("adopted", 0) >= 1
        for p in (doc_pw.get("plans") or {}).values()
    )

    log("phase 4/4: total solver outage — every plan-covered pool point "
        "must be served from the prefetched cache, byte-identical …")
    replay_json = out / "prewarm_replay.json"
    proc = subprocess.run(
        [sys.executable, "-m", _MODULE,
         "--worker-prewarm-replay", str(plan_path),
         str(out / "prewarm_demand_answers.json"), str(replay_json),
         *_device_argv(device)],
        env=_prewarm_env(cache, fault_plan=_PREWARM_OUTAGE_PLAN),
        timeout=900, capture_output=True, text=True,
    )
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    checks["replay_rc0"] = proc.returncode == 0
    try:
        replay = json.loads(replay_json.read_text())
    except (OSError, ValueError):
        replay = {}
    checks["replay_all_covered_warm"] = (
        bool(replay.get("covered"))
        and replay.get("warm") == replay.get("covered")
    )
    checks["replay_answers_bit_identical"] = (
        replay.get("compared", 0) >= 1 and not replay.get("mismatches")
    )

    # SBR_PREWARM=0 control: the subsystem off is a STRUCTURAL no-op
    ctrl = subprocess.run(
        [sys.executable, "-c",
         "import sys;"
         "from sbr_tpu_torch.models.params import SolverConfig;"
         "from sbr_tpu_torch.serve.engine import Engine, ServeConfig;"
         "eng = Engine(config=SolverConfig(n_grid=64, bisect_iters=30,"
         " refine_crossings=False), serve=ServeConfig(buckets=(1,)),"
         f" device={device!r});"
         "assert eng.prewarm is None;"
         "assert 'sbr_prewarm' not in eng.prometheus();"
         "assert 'prewarm' not in eng.statz();"
         "eng.close();"
         "assert 'sbr_tpu_torch.serve.prewarm' not in sys.modules;"
         "print('structural-noop-ok')"],
        env=_prewarm_env(cache), timeout=300, capture_output=True, text=True,
    )
    if ctrl.stderr:
        sys.stderr.write(ctrl.stderr)
    checks["prewarm_off_structural_noop"] = (
        ctrl.returncode == 0 and "structural-noop-ok" in ctrl.stdout
    )

    return _finish(
        "prewarm smoke",
        "a killed sweeper's tile was adopted and the outage was answered 100% warm, "
        "byte-identical", checks, out, as_json,
        [f"prefetch story: python -m sbr_tpu_torch.obs.report prewarm {heal_run}"])


def _worker_prewarm_replay(plan_path: str, answers_path: str,
                           out_json: str, device=None) -> int:
    """Hidden worker: breaker-open replay against the prefetched cache.

    Queries every loadgen pool point through an engine whose EVERY solver
    dispatch fails (the parent plants the serve.dispatch transient), and
    records, per plan-covered point, whether the degradation ladder
    answered it from the tile cache and whether (xi, aw_max, status)
    equal the fault-free fleet ground truth. NaN is normalized to None on
    both sides (the answers-JSON convention), so equality of the parsed
    values IS bit equality of the served doubles."""
    import math

    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve.engine import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    plan = json.loads(Path(plan_path).read_text())
    answers = json.loads(Path(answers_path).read_text())
    pool = build_pool(0, _FLEET["pool"])
    mix = query_mix(0, _FLEET["pool"], _FLEET["queries"])
    truth: dict = {}
    for pos, idx in enumerate(mix):
        a = answers[pos] if pos < len(answers) else None
        if isinstance(a, dict) and "xi" in a and not a.get("degraded"):
            truth.setdefault(idx, a)

    covered = set()
    for t in plan.get("tiles") or []:
        bs = {float(b) for b in (t.get("betas") or [])}
        us = {float(u) for u in (t.get("us") or [])}
        covered |= {
            i for i, p in enumerate(pool)
            if float(p.learning.beta) in bs and float(p.economic.u) in us
        }

    def norm(v):
        if v is None:
            return None
        f = float(v)
        return None if math.isnan(f) else f

    config = SolverConfig(
        n_grid=_FLEET["n_grid"], bisect_iters=_FLEET["bisect_iters"],
        refine_crossings=False,
    )
    results: dict = {}
    eng = Engine(config=config, serve=ServeConfig(buckets=(1,)), device=device)
    try:
        for i, p in enumerate(pool):
            try:
                r = eng.query(p)
            except Exception as err:  # noqa: BLE001 — a cold point, recorded
                results[i] = {"error": repr(err)}
                continue
            results[i] = {
                "xi": norm(r.xi), "aw_max": norm(r.aw_max),
                "status": int(r.status), "source": r.source,
                "degraded": bool(r.degraded),
            }
    finally:
        eng.close()

    doc = {
        "covered": sorted(covered),
        "warm": sorted(
            i for i in covered if (results.get(i) or {}).get("source") == "tilecache"
        ),
        "compared": 0,
        "mismatches": [],
        "results": {str(i): r for i, r in results.items()},
    }
    for i in sorted(covered):
        t = truth.get(i)
        r = results.get(i) or {}
        if t is None or "error" in r:
            continue
        doc["compared"] += 1
        for field in ("xi", "aw_max", "status"):
            tv = t.get(field) if field == "status" else norm(t.get(field))
            rv = r.get(field)
            if tv != rv:
                doc["mismatches"].append(
                    {"pool": i, "field": field, "truth": tv, "replay": rv}
                )
    Path(out_json).write_text(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}",
        description="Seeded chaos drills: faulted and recovered runs must be "
        "bit-identical to the fault-free ones",
    )
    parser.add_argument("--out", default="/tmp/sbr_chaos", help="scratch/artifact dir")
    parser.add_argument("--json", action="store_true", help="machine-readable verdict")
    parser.add_argument(
        "--device", default=None,
        help="device of every worker, fleet worker, sweeper and loadgen the "
        "drill starts (default: the CUDA card; 'cpu' runs without one)",
    )
    parser.add_argument(
        "--churn", action="store_true",
        help="run the ELASTIC churn drill instead: preempt one host "
        "mid-sweep, late-join a replacement, warm-cache re-sweep — "
        "bit-identical grids, zero warm recomputes",
    )
    parser.add_argument(
        "--fleet", action="store_true",
        help="run the SERVING-FLEET drill instead: SIGKILL one of three "
        "serve workers mid-loadgen — zero lost queries, answers "
        "byte-identical to a fault-free single-worker run, failover + "
        "breaker events visible via report fleet",
    )
    parser.add_argument(
        "--audit", action="store_true",
        help="run the NUMERICS-AUDIT drill instead: corrupt one of three "
        "workers' canary solves (audit.canary fault) — drift detected "
        "within 2 cycles, worker quarantined by the router, zero lost, "
        "answers byte-identical to the audit-off control",
    )
    parser.add_argument(
        "--prewarm", action="store_true",
        help="run the SELF-HEALING-PREFETCH drill instead: demand run "
        "leaves an advisor plan, a sweeper is SIGKILLed mid-plan holding "
        "a tile lease, a peer adopts and finishes warm, and a total "
        "solver outage is answered 100%% from the prefetched cache, "
        "byte-identical to the live ground truth",
    )
    parser.add_argument("--worker", nargs=2, metavar=("CKPT", "NPZ"), help=argparse.SUPPRESS)
    parser.add_argument("--worker-elastic", nargs=2, metavar=("CKPT", "NPZ"), help=argparse.SUPPRESS)
    parser.add_argument(
        "--worker-prewarm-replay", nargs=3, metavar=("PLAN", "ANSWERS", "OUT"),
        help=argparse.SUPPRESS,
    )
    args = parser.parse_args(argv)

    if args.worker:
        return _worker(*args.worker, device=args.device)
    if args.worker_elastic:
        return _worker_elastic(*args.worker_elastic, device=args.device)
    if args.worker_prewarm_replay:
        return _worker_prewarm_replay(*args.worker_prewarm_replay, device=args.device)

    out = Path(args.out)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)

    for flag, drill in (("churn", main_churn), ("fleet", main_fleet), ("audit", main_audit),
                        ("prewarm", main_prewarm)):
        if getattr(args, flag):
            return drill(out, args.json, device=args.device)
    return main_base(out, args.json, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
