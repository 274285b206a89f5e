"""The port's prefetch controller (sbr_tpu_torch.serve.prewarm) against
sbr_tpu.serve.prewarm, on the CPU: the cases of tests/test_prewarm.py.

Contracts:

- plan loading and validation, and the per-β expansion and lease order
  of a plan, equal to the reference's on the same plan; the advisor's
  ``plan_fingerprint`` of one demand surface equal to the reference's hex;
- the drain (module fixture: one two-tile plan drained by each package
  into its own tile cache): the bridge serves the plan's pool-style
  queries, the done markers carry the program version and the backend
  tag, a second sweeper skips done tiles, an expired lease is adopted;
  the drained tiles are the port's `beta_u_grid` bit for bit, and against
  the reference's tiles the statuses are equal and the floats within
  1e-12 (f64); a reference-written cache and the reference's done markers
  are never read as the port's;
- epochs, budgets, program-version fail-closed, gc retention (both
  packages' `gc_prewarm_files` on the same tree), the bridge's incremental
  index, the scenario tiles' sidecar refusal;
- the engine's wiring: ``SBR_PREWARM`` off is a structural no-op (checked
  in a fresh process: the module is not imported, ``/metrics`` and
  ``/statz`` carry nothing of it, answers bit-identical), on attaches a
  controller on the engine's device and dtype whose tiles hold the
  engine's dispatch lock.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.models.params import SolverConfig as JConfig  # noqa: E402
from sbr_tpu.serve import prewarm as jprewarm  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig, make_model_params  # noqa: E402
from sbr_tpu_torch.obs.report import prewarm_doc  # noqa: E402
from sbr_tpu_torch.resilience import faults  # noqa: E402
from sbr_tpu_torch.scenario.spec import ScenarioSpec  # noqa: E402
from sbr_tpu_torch.serve import prewarm  # noqa: E402
from sbr_tpu_torch.serve.fleet import TileCacheBridge  # noqa: E402
from sbr_tpu_torch.serve.prewarm import (  # noqa: E402
    PLAN_SCHEMA,
    PrewarmController,
    _plan_tiles,
    gc_prewarm_files,
    load_plan,
    plan_dir_name,
)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 180  # seconds: every subprocess in this file is bounded
CPU = "cpu"
CFG = SolverConfig(n_grid=96, bisect_iters=30, refine_crossings=False)
JCFG = JConfig(n_grid=96, bisect_iters=30, refine_crossings=False)
# the reference's served-float tolerance (f64)
FLOAT_TOL = 1e-12

BETAS = (0.8, 1.6)
US = (0.1, 0.3)
FP = "feedbeefcafe0119"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SBR_PREWARM", "SBR_PREWARM_PLAN", "SBR_PREWARM_STATE_DIR", "SBR_TILE_CACHE_DIR",
                "SBR_PREWARM_BUDGET_TILES", "SBR_PREWARM_BUDGET_SECONDS", "SBR_FAULT_PLAN",
                "SBR_OBS", "SBR_AUDIT", "SBR_DEMAND", "SBR_FLIGHT"):
        monkeypatch.delenv(var, raising=False)
    yield
    faults.install(None)
    faults.reset()


def _plan(tiles, fp=FP, **extra) -> dict:
    return {"schema": PLAN_SCHEMA, "plan_fingerprint": fp, "tiles": tiles, **extra}


def _hot_tile(betas=BETAS, us=US, rank=1) -> dict:
    return {"bin": "3,1", "betas": list(betas), "us": list(us), "rank": rank}


def _write_plan(path: Path, plan: dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(plan))
    return path


def _controller(plan_path, cache_dir, **kw) -> PrewarmController:
    kw.setdefault("config", CFG)
    kw.setdefault("ttl_s", 60)
    kw.setdefault("device", CPU)
    return PrewarmController(plan_file=plan_path, cache_dir=str(cache_dir), **kw)


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """One drained two-tile plan (the per-β expansion of one hot bin) in
    each package, into each package's own tile cache."""
    from sbr_tpu.utils.platform import pin_cpu_platform

    pin_cpu_platform()
    tmp = tmp_path_factory.mktemp("prewarm")
    plan_path = _write_plan(tmp / "advisor_plan.json", _plan([_hot_tile()]))
    ctl = _controller(plan_path, tmp / "tile_cache")
    snap = ctl.drain(timeout_s=600)
    ctl.close()
    jctl = jprewarm.PrewarmController(plan_file=plan_path, cache_dir=str(tmp / "ref_cache"),
                                      config=JCFG, ttl_s=60)
    jsnap = jctl.drain(timeout_s=600)
    jctl.close()
    return tmp, tmp / "tile_cache", plan_path, snap, jsnap


# ---------------------------------------------------------------------------
# Plan loading and the per-β expansion
# ---------------------------------------------------------------------------


def test_load_plan_validates_as_the_reference(tmp_path):
    cases = {
        "ok": _plan([_hot_tile()]),
        "alien": {"schema": "other/9", "plan_fingerprint": "x", "tiles": []},
        "no_fingerprint": {"schema": PLAN_SCHEMA, "tiles": []},
        "tiles_not_a_list": {"schema": PLAN_SCHEMA, "plan_fingerprint": "x", "tiles": {}},
    }
    for name, doc in cases.items():
        path = _write_plan(tmp_path / f"{name}.json", doc)
        assert load_plan(path) == jprewarm.load_plan(path), name
        assert (load_plan(path) is not None) == (name == "ok")
    torn = tmp_path / "torn.json"
    torn.write_text('{"schema": "sbr-demand-adv')
    assert load_plan(torn) is None is jprewarm.load_plan(torn)
    assert load_plan(tmp_path / "missing.json") is None
    assert load_plan(tmp_path / "ok.json")["plan_fingerprint"] == FP


def test_plan_load_fault_point_returns_none(tmp_path):
    ok = _write_plan(tmp_path / "ok.json", _plan([_hot_tile()]))
    faults.install(faults.FaultPlan({"rules": [{"point": "prewarm.plan_load",
                                                "kind": "transient"}]}))
    assert load_plan(ok) is None


PLANS = {
    "two_bins": [{"bin": "3,1", "betas": [1.6, 0.8], "us": [0.3, 0.1], "rank": 2},
                 {"bin": "0,0", "betas": [2.4], "us": [0.5], "rank": 1},
                 {"bin": "junk"}],
    "unranked": [{"bin": "1,1", "betas": [1.0, 1.0, 0.5], "us": [0.2]},
                 {"bin": "0,2", "betas": [3.0], "us": [0.4, 0.2], "rank": 5},
                 {"bin": "2,2", "betas": [], "us": [0.1]}],
    "one": [_hot_tile()],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_per_beta_expansion_and_lease_order_equal_reference(name):
    tiles = _plan_tiles(_plan(PLANS[name]))
    assert tiles == jprewarm._plan_tiles(_plan(PLANS[name]))
    assert [t["lease"] for t in tiles] == [(n, 0) for n in range(len(tiles))]
    if name == "two_bins":
        assert [t["id"] for t in tiles] == ["t00000_00000", "t00001_00000", "t00002_00000"]
        assert tiles[0]["betas"] == [2.4]
        assert tiles[1]["betas"] == [0.8] and tiles[2]["betas"] == [1.6]
        assert tiles[1]["us"] == [0.1, 0.3]


def test_knobs_equal_reference(monkeypatch, tmp_path):
    for env in ({}, {"SBR_PREWARM_BUDGET_TILES": "0", "SBR_PREWARM_BUDGET_SECONDS": "7.5",
                     "SBR_STEAL_LEASE_TTL_S": "30", "SBR_PREWARM_POLL_S": "0.5",
                     "SBR_PREWARM": "1", "SBR_PREWARM_STATE_DIR": str(tmp_path)}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("enabled", "poll_s", "budget_tiles", "budget_seconds", "lease_ttl_s"):
            assert getattr(prewarm, fn)() == getattr(jprewarm, fn)(), fn
        assert prewarm.state_dir(cache_root=tmp_path / "c") == \
            jprewarm.state_dir(cache_root=tmp_path / "c")
    assert prewarm.budget_tiles(3) == 3 and prewarm.budget_seconds(-1) is None


def test_backend_tag_is_the_checkpoint_tag():
    """The module keeps its own copy of the backend tag so that it imports
    no torch; the copy must be the tile cache's `BACKEND`."""
    from sbr_tpu_torch.utils import checkpoint

    assert prewarm._BACKEND == checkpoint.BACKEND
    assert prewarm.plan_dir_name("ab") == f"plan_ab_{checkpoint.BACKEND}"


def test_advisor_plan_fingerprint_equals_reference():
    """The plan a sweeper executes is keyed by the demand advisor's
    fingerprint: the same surface gives the reference's hex."""
    from sbr_tpu.obs import demand as jdemand
    from sbr_tpu_torch.obs import demand

    plans = []
    for mod in (demand, jdemand):
        tr = mod.DemandTracker(bins=8, topk_n=6, time_fn=lambda: 1000.0)
        for k in range(40):
            tr.record(0.6 + (k % 5) * 0.7, 0.05 + (k % 3) * 0.2, scenario="mix",
                      source="lru" if k % 4 else "computed")
        plans.append(mod.advisor_plan(tr.totals_surface()))
    assert plans[0]["plan_fingerprint"] == plans[1]["plan_fingerprint"]
    assert _plan_tiles(plans[0]) == jprewarm._plan_tiles(plans[1])


# ---------------------------------------------------------------------------
# The drain and the bridge
# ---------------------------------------------------------------------------


def test_drain_completes_warm(drained):
    _, _, _, snap, jsnap = drained
    assert snap["status"] == "done" and snap["tiles_total"] == 2
    assert snap["tiles_done"] == 2 and snap["warm"] == 2 and snap["counts"]["failed"] == 0
    assert {k: snap[k] for k in ("status", "tiles_total", "tiles_done", "warm")} == \
        {k: jsnap[k] for k in ("status", "tiles_total", "tiles_done", "warm")}
    assert snap["counts"] == jsnap["counts"]


def _tiles(cache_root, port: bool) -> dict:
    out = {}
    for meta_path in sorted(Path(cache_root).rglob("*.meta.json")):
        meta = json.loads(meta_path.read_text())
        arrays = np.load(meta_path.with_name(meta_path.name[:-len(".meta.json")] + ".npz"))
        out[tuple(meta["betas"])] = (meta, {f: arrays[f] for f in ("xi", "max_aw", "status")})
    return out


def test_drained_tiles_are_beta_u_grid_and_the_references(drained):
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid
    from sbr_tpu_torch.utils.checkpoint import to_host

    tmp, cache_dir, _, _, _ = drained
    port, ref = _tiles(cache_dir, True), _tiles(tmp / "ref_cache", False)
    assert sorted(port) == sorted(ref) == [(b,) for b in BETAS]
    for betas, (meta, got) in port.items():
        base = make_model_params(beta=betas[0])
        want = beta_u_grid(np.array(betas), np.array(meta["us"]), base, config=CFG, device=CPU)
        for f, h in zip(("xi", "max_aw", "status"), to_host(want.xi, want.max_aw, want.status)):
            assert got[f].dtype == h.dtype and np.array_equal(got[f], h, equal_nan=True), f
        rmeta, r = ref[betas]
        assert meta["us"] == rmeta["us"] and meta["cell_tag"] != rmeta["cell_tag"]
        assert np.array_equal(got["status"], r["status"])
        for f in ("xi", "max_aw"):
            assert np.array_equal(np.isnan(got[f]), np.isnan(r[f]))
            ok = ~np.isnan(got[f])
            assert np.max(np.abs(got[f][ok] - r[f][ok]), initial=0.0) <= FLOAT_TOL


def test_bridge_serves_pool_style_queries(drained):
    _, cache_dir, _, _, _ = drained
    bridge = TileCacheBridge(cache_dir)
    for b in BETAS:
        for u in US:
            assert bridge.lookup(make_model_params(beta=b, u=u), CFG, "float64") is not None
    # an off-plan β: no tile covers it
    assert bridge.lookup(make_model_params(beta=3.3, u=US[0]), CFG, "float64") is None


def test_reference_cache_is_never_read_as_the_ports(drained):
    """The reference's tiles carry the reference's cell tags and keys: the
    port's bridge serves none of them, and a port sweeper over the
    reference's cache recomputes every tile."""
    tmp, _, plan_path, _, _ = drained
    ref_copy = tmp / "ref_copy"
    if not ref_copy.exists():
        shutil.copytree(tmp / "ref_cache", ref_copy)
    bridge = TileCacheBridge(ref_copy)
    assert bridge.lookup(make_model_params(beta=BETAS[0], u=US[0]), CFG, "float64") is None
    ctl = _controller(plan_path, ref_copy)
    snap = ctl.drain(timeout_s=600)
    ctl.close()
    assert snap["counts"]["computed"] == 2 and snap["counts"]["cache"] == 0


def test_done_markers_carry_version_and_backend(drained):
    tmp, cache_dir, _, _, _ = drained
    plan_dir = cache_dir / "_prewarm" / plan_dir_name(FP)
    assert plan_dir.name == f"plan_{FP}_torch"
    done = sorted(p.name for p in plan_dir.glob("done_*.json"))
    assert done == ["done_t00000_00000.json", "done_t00001_00000.json"]
    doc = json.loads((plan_dir / done[0]).read_text())
    assert doc["plan"] == FP and doc["backend"] == "torch"
    from sbr_tpu_torch.sweeps.baseline_sweeps import GRID_PROGRAM_VERSION

    assert doc["program_version"] == GRID_PROGRAM_VERSION
    assert not list(plan_dir.glob("*.lease"))
    # the reference's epoch is its own directory: no state is shared
    assert (tmp / "ref_cache" / "_prewarm" / f"plan_{FP}").is_dir()


def test_second_sweeper_skips_done_tiles(drained):
    _, cache_dir, plan_path, _, _ = drained
    ctl = _controller(plan_path, cache_dir)
    snap = ctl.drain(timeout_s=60)
    ctl.close()
    assert snap["status"] == "done" and snap["tiles_done"] == 0 and snap["warm"] == 2


def test_reference_done_markers_do_not_count(drained, tmp_path):
    """A done marker the reference wrote (no backend tag) is not the
    port's: the tile re-runs (here a free cache hit)."""
    _, cache_dir, plan_path, _, _ = drained
    plan_dir = tmp_path / "state" / plan_dir_name(FP)
    plan_dir.mkdir(parents=True)
    from sbr_tpu_torch.sweeps.baseline_sweeps import GRID_PROGRAM_VERSION

    for t in ("t00000_00000", "t00001_00000"):
        (plan_dir / f"done_{t}.json").write_text(json.dumps(
            {"tile": t, "program_version": GRID_PROGRAM_VERSION}))
    ctl = _controller(plan_path, cache_dir, state_root=tmp_path / "state")
    assert ctl.poll_plan() and not ctl._tile_done(ctl._tiles[0])
    snap = ctl.drain(timeout_s=60)
    ctl.close()
    assert snap["tiles_done"] == 2 and snap["counts"]["cache"] == 2


def test_expired_lease_is_adopted(drained, tmp_path):
    _, cache_dir, plan_path, _, _ = drained
    plan_dir = tmp_path / "state" / plan_dir_name(FP)
    plan_dir.mkdir(parents=True)
    (plan_dir / "tile_b00000_u00000.lease").write_text(json.dumps({
        "pid": 0, "host": "dead-host", "nonce": "stale", "ts": time.time() - 9999.0,
        "ttl_s": 5.0}))
    ctl = _controller(plan_path, cache_dir, state_root=tmp_path / "state")
    snap = ctl.drain(timeout_s=120)
    ctl.close()
    assert snap["status"] == "done" and snap["counts"]["adopted"] == 1
    assert snap["counts"]["cache"] == 2 and snap["counts"]["computed"] == 0


# ---------------------------------------------------------------------------
# Epochs, budgets, fail-closed versioning
# ---------------------------------------------------------------------------


def test_new_fingerprint_abandons_stale_epoch(tmp_path):
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()]))
    ctl = _controller(plan_path, tmp_path / "cache")
    assert ctl.poll_plan() and ctl.status == "sweeping" and len(ctl._tiles) == 2
    _write_plan(plan_path, _plan([_hot_tile(betas=(2.4,), us=(0.5,))], fp="aa" * 8))
    os.utime(plan_path, (time.time() + 5, time.time() + 5))
    ctl.poll_plan()
    ctl.close()
    assert ctl.counts["abandoned_stale"] == 2 and ctl.counts["plans"] == 2
    assert ctl._plan_fp == "aa" * 8 and len(ctl._tiles) == 1


def test_torn_rewrite_keeps_current_epoch(tmp_path):
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()]))
    ctl = _controller(plan_path, tmp_path / "cache")
    assert ctl.poll_plan()
    plan_path.write_text('{"schema": "sbr-d')  # torn mid-rewrite
    os.utime(plan_path, (time.time() + 5, time.time() + 5))
    assert ctl.poll_plan()
    ctl.close()
    assert ctl.counts["plan_errors"] == 1 and ctl._plan_fp == FP and ctl.status == "sweeping"


def test_budget_exhaustion_gates_report_exit1(tmp_path):
    run_dir = tmp_path / "run"
    run = obs.start_run(label="prewarm_budget", run_dir=str(run_dir))
    try:
        plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()]))
        ctl = _controller(plan_path, tmp_path / "cache", max_seconds=0.001)
        assert ctl.poll_plan()
        time.sleep(0.01)
        assert ctl.step() is None  # the budget closed the plan
        ctl.close()
        assert ctl.status == "budget_exhausted" and ctl.counts["abandoned_budget"] == 2
        assert ctl.status_gauge() == -1
    finally:
        obs.end_run()
    doc, code = prewarm_doc(run.run_dir)
    assert code == 1 and any("budget" in b for b in doc["breaches"])


def test_tile_budget_runs_exactly_that_many(tmp_path):
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()]))
    ctl = _controller(plan_path, tmp_path / "cache", max_tiles=1)
    snap = ctl.drain(timeout_s=120)
    ctl.close()
    assert snap["status"] == "budget_exhausted" and snap["tiles_done"] == 1
    assert snap["counts"]["abandoned_budget"] == 1 and snap["budget"]["tiles_run"] == 1


def test_program_version_mismatch_fails_closed(tmp_path):
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()], program_version=999999))
    ctl = _controller(plan_path, tmp_path / "cache")
    ctl.poll_plan()
    ctl.close()
    assert ctl.status == "rejected" and ctl.counts["plans_rejected"] == 1
    assert ctl._tiles == [] and ctl.step() is None and ctl.status_gauge() == -1


def test_stale_program_version_done_marker_reruns(drained, tmp_path):
    _, cache_dir, plan_path, _, _ = drained
    plan_dir = tmp_path / "state" / plan_dir_name(FP)
    plan_dir.mkdir(parents=True)
    (plan_dir / "done_t00000_00000.json").write_text(json.dumps(
        {"tile": "t00000_00000", "program_version": -1, "backend": "torch"}))
    ctl = _controller(plan_path, cache_dir, state_root=tmp_path / "state")
    assert ctl.poll_plan() and not ctl._tile_done(ctl._tiles[0])


def test_no_cache_is_its_own_status(tmp_path):
    ctl = PrewarmController(plan_file=tmp_path / "p.json", config=CFG, device=CPU)
    assert not ctl.poll_plan() and ctl.status == "no_cache"
    assert ctl.heartbeat_block() == {"status": "no_cache", "plan": None, "tiles_done": 0,
                                     "tiles_total": 0, "abandoned": 0}


def test_snapshot_and_prometheus_equal_reference_shape(tmp_path):
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()], program_version=999999))
    ctls = [_controller(plan_path, tmp_path / "cache"),
            jprewarm.PrewarmController(plan_file=plan_path, cache_dir=str(tmp_path / "jcache"),
                                       config=JCFG, ttl_s=60)]
    for c in ctls:
        c.poll_plan()
        c.close()
    assert ctls[0].snapshot() == ctls[1].snapshot()
    assert ctls[0].heartbeat_block() == ctls[1].heartbeat_block()
    assert ctls[0].prometheus_lines() == ctls[1].prometheus_lines()


# ---------------------------------------------------------------------------
# Retention: gc --prewarm-keep
# ---------------------------------------------------------------------------


def _gc_tree(root: Path, now: float):
    for i in range(5):
        (root / f"plan_{i:02d}").mkdir(parents=True)
    live = root / "plan_00" / "tile_b00000_u00000.lease"
    live.write_text(json.dumps({"ts": now, "ttl_s": 600.0, "nonce": "n"}))
    debris = root / "plan_04" / "tile_b00001_u00000.lease"
    debris.write_text(json.dumps({"ts": now - 9999, "ttl_s": 1.0}))
    (root / "plan_04" / "done_t00001_00000.json").write_text("{}")
    for i in range(5):  # staggered AFTER the writes that bump dir mtimes
        t = now - 1000 + i
        os.utime(root / f"plan_{i:02d}", (t, t))
    return live, debris


def test_gc_keeps_recent_live_and_active_epochs_as_the_reference(tmp_path):
    now = time.time()
    kept = []
    for name, fn in (("port", gc_prewarm_files), ("ref", jprewarm.gc_prewarm_files)):
        root = tmp_path / name / "_prewarm"
        live, debris = _gc_tree(root, now)
        removed = fn(state_root=root, keep=2, ttl_s=60)
        kept.append((sorted(p.name for p in root.iterdir()),
                     sorted(str(Path(r).relative_to(root)) for r in removed)))
        assert live.exists() and not debris.exists()
    assert kept[0] == kept[1]
    assert kept[0][0] == ["plan_00", "plan_03", "plan_04"]


def test_gc_without_a_state_root_is_a_noop(tmp_path):
    assert gc_prewarm_files(state_root=tmp_path / "nope") == []
    assert gc_prewarm_files() == [] == jprewarm.gc_prewarm_files()


# ---------------------------------------------------------------------------
# The bridge's incremental index; scenario tiles get no sidecar
# ---------------------------------------------------------------------------


def _lookup_until(bridge, params, want_hit, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while True:
        rec = bridge.lookup(params, CFG, "float64")
        if (rec is not None) == want_hit or time.monotonic() >= deadline:
            return rec


def test_index_tracks_stores_torn_sidecars_and_deletions(drained, tmp_path):
    _, cache_dir, _, _, _ = drained
    cache = tmp_path / "cache_copy"
    shutil.copytree(cache_dir, cache)
    bridge = TileCacheBridge(cache)
    hot = make_model_params(beta=BETAS[0], u=US[0])
    assert bridge.lookup(hot, CFG, "float64") is not None
    shard = next(p for p in cache.rglob("*.meta.json")).parent
    (shard / "torn.meta.json").write_text('{"key": "x", "cell_t')
    assert _lookup_until(bridge, hot, want_hit=True) is not None
    new_q = make_model_params(beta=2.4, u=US[0])
    assert bridge.lookup(new_q, CFG, "float64") is None
    plan_path = _write_plan(tmp_path / "plan_b.json", _plan([_hot_tile(betas=(2.4,))],
                                                            fp="bb" * 8))
    ctl = _controller(plan_path, cache)
    snap = ctl.drain(timeout_s=600)
    ctl.close()
    assert snap["status"] == "done" and snap["warm"] == 1
    assert _lookup_until(bridge, new_q, want_hit=True) is not None
    meta = next(m for m in cache.rglob("*.meta.json")
                if m.name != "torn.meta.json" and json.loads(m.read_text())["betas"] == [2.4])
    npz = meta.with_name(meta.name[: -len(".meta.json")] + ".npz")
    meta.unlink()
    if npz.exists():
        npz.unlink()
    assert _lookup_until(bridge, new_q, want_hit=False) is None
    assert bridge.lookup(hot, CFG, "float64") is not None


def test_scenario_sweep_writes_no_meta_and_bridge_refuses(tmp_path):
    cache = tmp_path / "cache"
    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile(betas=(1.0,), us=(0.1,))]))
    ctl = _controller(plan_path, cache, scenario_spec=ScenarioSpec(modifiers=("insurance_cap",)))
    snap = ctl.drain(timeout_s=600)
    ctl.close()
    assert snap["tiles_done"] == 1 and snap["counts"]["failed"] == 0
    assert cache.is_dir() and not list(cache.rglob("*.meta.json"))
    assert TileCacheBridge(cache).lookup(make_model_params(beta=1.0, u=0.1), CFG,
                                         "float64") is None


# ---------------------------------------------------------------------------
# The engine's wiring
# ---------------------------------------------------------------------------

_NOOP = r"""
import json, sys
from sbr_tpu_torch.models.params import SolverConfig, make_model_params
from sbr_tpu_torch.serve import Engine
cfg = SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False)
eng = Engine(config=cfg, device="cpu")
try:
    r = eng.query(make_model_params(beta=1.3, u=0.2))
    out = {"prewarm": eng.prewarm is None,
           "imported": "sbr_tpu_torch.serve.prewarm" in sys.modules,
           "metrics": "sbr_prewarm" in eng.prometheus(),
           "statz": "prewarm" in eng.statz(), "xi": r.xi.hex(), "status": r.status}
finally:
    eng.close()
print(json.dumps(out))
"""


@pytest.mark.parametrize("value", ["", "0"])
def test_off_is_a_structural_noop(value, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "SBR_TILE_CACHE_DIR": str(tmp_path / "cache")}
    env["SBR_PREWARM"] = value
    proc = subprocess.run([sys.executable, "-c", _NOOP], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["prewarm"] and not out["imported"] and not out["metrics"] and not out["statz"]
    env["SBR_PREWARM"] = "1"
    env["SBR_PREWARM_PLAN"] = str(tmp_path / "missing_plan.json")
    on = subprocess.run([sys.executable, "-c", _NOOP], capture_output=True, text=True,
                        timeout=TIMEOUT, cwd=str(REPO), env=env)
    assert on.returncode == 0, on.stderr
    on = json.loads(on.stdout.strip().splitlines()[-1])
    assert on["imported"] and on["metrics"] and on["statz"]
    assert (on["xi"], on["status"]) == (out["xi"], out["status"])  # bit-identical answers


def test_on_attaches_controller_on_the_engines_device(tmp_path, monkeypatch):
    from sbr_tpu_torch.serve import Engine

    monkeypatch.setenv("SBR_PREWARM", "1")
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("SBR_PREWARM_PLAN", str(tmp_path / "nope.json"))
    eng = Engine(config=SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False),
                 dtype=torch.float32, device=CPU)
    try:
        eng.start()
        assert eng.prewarm is not None and eng.prewarm._thread.is_alive()
        assert eng.prewarm._device == eng.device and eng.prewarm._dtype == torch.float32
        assert "sbr_prewarm_status" in eng.prometheus()
        assert set(eng.prewarm.heartbeat_block()) == {"status", "plan", "tiles_done",
                                                      "tiles_total", "abandoned"}
        assert eng.statz()["prewarm"]["status"] in ("idle", "no_cache")
    finally:
        eng.close()
    assert not eng.prewarm._thread.is_alive()


def test_embedded_tiles_hold_the_dispatch_lock(tmp_path, monkeypatch):
    """An embedded controller drains the plan on the engine's device, each
    tile under the engine's dispatch lock (no tile overlaps a capture or a
    replay), and only while the engine is idle."""
    from sbr_tpu_torch.serve import Engine

    plan_path = _write_plan(tmp_path / "plan.json", _plan([_hot_tile()]))
    monkeypatch.setenv("SBR_PREWARM", "1")
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("SBR_PREWARM_PLAN", str(plan_path))
    from sbr_tpu_torch.utils import checkpoint as ckpt

    eng = Engine(config=CFG, device=CPU)
    ctl = eng.prewarm
    lock_held = []
    produce = ckpt.TileRunner.produce

    def held_produce(self, *a, **kw):
        lock_held.append(eng._dispatch_lock.locked())
        return produce(self, *a, **kw)

    monkeypatch.setattr(ckpt.TileRunner, "produce", held_produce)
    try:
        eng.live.inflight = 1  # busy: not admissible
        assert ctl.run_cycle() is None and not lock_held
        eng.live.inflight = 0
        snap = ctl.drain(timeout_s=120)
    finally:
        eng.close()
    assert snap["status"] == "done" and snap["warm"] == 2
    assert lock_held == [True, True]
