"""The port's run log (sbr_tpu_torch.obs.runlog, timing, metrics) against
sbr_tpu.obs, on the CPU.

Mirrors the runlog tests of tests/test_obs.py (the event round trip, the
manifest while a run is going, nested runs, `suspended`, unique
directories, the env auto-start and an explicit run that supersedes it,
`run_context` enabling metrics, `jit_call` hit and miss and its
pass-through when off, no value change when telemetry toggles), then
holds the port's events to the reference's for the same calls
(`solve_equilibrium_baseline`, `u_sweep`, `beta_u_grid`,
`solve_equilibrium_social` at small sizes under `run_context`):

- the sequence of (kind, stage or name) equal, apart from the reference's
  JAX-only ``xla_compile`` events; the reference runs its calls once
  first, because its spans inside a jitted program fire only while JAX
  first traces the program in a process (its steady state has none, and
  that is what the port reproduces);
- the ``status`` events and the ``health`` censuses field for field (the
  suite pins fixed numerics, so the iteration counts are equal too), and
  the ``fixed_point`` event's integers and flags, its floats within 1e-12;
- the manifest's keys, and the ``jit`` event's keys apart from the
  reference's XLA cost and memory-analysis fields.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu import obs as jobs  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import runlog  # noqa: E402
from sbr_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from sbr_tpu_torch.obs.runlog import SCHEMA  # noqa: E402

CPU = "cpu"
FLOAT_TOL = 1e-12
# the reference's jit_call fields from XLA's cost and memory analyses
XLA_ONLY = {"flops", "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes", "code_bytes"}


def registry():
    return obs.metrics.metrics()


@pytest.fixture(autouse=True)
def _no_active_run():
    """Telemetry must never leak between tests (tests/test_obs.py's guard,
    for both packages)."""
    assert obs.current_run() is None and jobs.current_run() is None
    was_on, jwas_on = registry().enabled, jobs.metrics().enabled
    yield
    while obs.end_run() is not None:
        pass
    while jobs.end_run() is not None:
        pass
    (registry().enable if was_on else registry().disable)()
    (jobs.metrics().enable if jwas_on else jobs.metrics().disable)()


def _events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


# -- event log round trip ----------------------------------------------------


def test_event_log_round_trip(tmp_path):
    run_dir = tmp_path / "run0"
    with obs.run_context(run_dir=str(run_dir), label="trip") as run:
        obs.event("custom", foo=1, bar="x")
        with obs.span("stage_a", n=3) as sp:
            sp.sync(torch.arange(4.0))
        run.event("custom", arr=torch.arange(3))  # a tensor → JSON list
        run.event("custom", scalar=np.float32(2.5))

    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert manifest["schema"] == SCHEMA == jobs.runlog.SCHEMA
    assert manifest["label"] == "trip"
    assert manifest["status"] == "complete"
    assert manifest["stages"]["stage_a"]["count"] == 1
    assert manifest["stages"]["stage_a"]["total_s"] >= 0.0

    events = _events(run_dir)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "stage_start" in kinds and "stage_end" in kinds
    (custom_arr,) = [e for e in events if e["kind"] == "custom" and "arr" in e]
    assert custom_arr["arr"] == [0, 1, 2]
    assert [e["scalar"] for e in events if "scalar" in e] == [2.5]
    assert manifest["n_events"] == len(events)
    monos = [e["mono"] for e in events]
    assert monos == sorted(monos) and all("ts" in e for e in events)


def test_manifest_written_while_running(tmp_path):
    run = obs.start_run(run_dir=str(tmp_path / "r"), label="interrupted")
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["status"] == "running"
    obs.end_run()
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["status"] == "complete"


def test_interrupt_all_finalizes_as_interrupted(tmp_path):
    a = obs.start_run(run_dir=str(tmp_path / "a"))
    b = obs.start_run(run_dir=str(tmp_path / "b"))
    assert obs.interrupt_all() == 2
    assert obs.current_run() is None
    for run in (a, b):
        assert json.loads((run.run_dir / "manifest.json").read_text())["status"] == "interrupted"


def test_nested_runs_stack(tmp_path):
    outer = obs.start_run(run_dir=str(tmp_path / "outer"))
    inner = obs.start_run(run_dir=str(tmp_path / "inner"))
    assert obs.current_run() is inner
    obs.end_run()
    assert obs.current_run() is outer
    obs.end_run()
    assert obs.current_run() is None


def test_suspended_disables_and_restores(tmp_path):
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        assert obs.enabled()
        with obs.suspended():
            assert not obs.enabled()
            obs.event("dropped")  # must be a no-op
        assert obs.current_run() is run
        obs.event("kept")
    kinds = [e["kind"] for e in _events(run.run_dir)]
    assert "kept" in kinds and "dropped" not in kinds


def test_autogenerated_run_dirs_unique(tmp_path):
    dirs = []
    for _ in range(3):
        with obs.run_context(label="x", root=str(tmp_path)) as run:
            dirs.append(run.run_dir)
    assert len(set(dirs)) == 3
    for d in dirs:
        assert (d / "manifest.json").exists()


def test_suspended_blocks_env_autostart(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_OBS", "1")
    monkeypatch.setenv("SBR_OBS_DIR", str(tmp_path))
    monkeypatch.setenv("SBR_OBS_LABEL", "envrun")
    monkeypatch.setattr(runlog, "_ENV_CHECKED", False)
    with obs.suspended():
        assert not obs.enabled()
        assert obs.current_run() is None
    assert obs.enabled()  # the env-configured run exists outside the block
    assert obs.current_run().label == "envrun"
    assert obs.current_run().run_dir.parent == tmp_path


def test_explicit_run_supersedes_env_autostart(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_OBS", "1")
    monkeypatch.setenv("SBR_OBS_DIR", str(tmp_path))
    monkeypatch.setattr(runlog, "_ENV_CHECKED", False)
    run = obs.start_run(run_dir=str(tmp_path / "explicit"))
    with obs.suspended():
        assert obs.current_run() is None  # no env auto-start mid-section
    assert obs.current_run() is run
    obs.end_run()
    assert obs.current_run() is None  # nor after the explicit run ends


def test_env_autostart_keeps_its_retention_budget(tmp_path, monkeypatch):
    """Env-started runs prune their siblings to SBR_OBS_KEEP at finalize."""
    for i in range(3):
        with obs.run_context(label=f"old{i}", root=str(tmp_path)):
            pass
    monkeypatch.setenv("SBR_OBS", "1")
    monkeypatch.setenv("SBR_OBS_DIR", str(tmp_path))
    monkeypatch.setenv("SBR_OBS_KEEP", "1")
    monkeypatch.setattr(runlog, "_ENV_CHECKED", False)
    run = obs.current_run()
    obs.end_run()
    left = sorted(d for d in tmp_path.iterdir() if (d / "manifest.json").exists())
    assert run.run_dir in left and len(left) == 2  # the run itself plus the newest kept


def test_gc_runs_keeps_the_newest_and_live_runs(tmp_path):
    import os
    import time

    dirs = []
    for i in range(4):
        with obs.run_context(label=f"g{i}", root=str(tmp_path)) as run:
            dirs.append(run.run_dir)
        stamp = time.time() - 100 + i
        for p in (run.run_dir, run.run_dir / "events.jsonl", run.run_dir / "manifest.json"):
            os.utime(p, (stamp, stamp))
    live = obs.start_run(label="live", root=str(tmp_path))
    (tmp_path / "not_a_run").mkdir()
    removed = obs.gc_runs(tmp_path, keep=2)
    assert sorted(removed) == sorted(dirs[:2])
    assert live.run_dir.exists() and (tmp_path / "not_a_run").exists()
    obs.end_run()


# -- metrics registry --------------------------------------------------------


def test_metrics_registry_matches_reference():
    for reg, jreg in ((MetricsRegistry(), jobs.MetricsRegistry()),):
        for r in (reg, jreg):
            r.inc("a")  # disabled: no-ops
            r.enable()
            r.inc("a")
            r.inc("a", 2)
            r.gauge("g", 7.0)
            r.observe("t", 0.5)
            r.observe("t", 1.5)
            r.observe_value("h", 3.0)
        assert reg.summary() == jreg.summary()


def test_run_context_enables_metrics(tmp_path):
    reg = registry()
    assert not reg.enabled
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        assert reg.enabled
        reg.inc("during_run")
    assert not reg.enabled
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["metrics"]["counters"] == {"during_run": 1}


# -- jit_call ----------------------------------------------------------------


def test_jit_call_attribution_and_cache(tmp_path):
    def f(x):
        return (x * 2.0).sum()

    x = torch.arange(8.0)
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        y0 = obs.jit_call("f", f, x)
        y1 = obs.jit_call("f", f, x)
        y2 = obs.jit_call("f", f, torch.arange(9.0))  # a new signature
    assert float(y0) == float(y1) == float(f(x))
    jits = [e for e in _events(run.run_dir) if e["kind"] == "jit_call"]
    assert [e["cache"] for e in jits] == ["miss", "hit", "miss"]
    assert float(y2) == float(f(torch.arange(9.0)))
    assert all(e["trace_s"] == 0.0 and e["compile_s"] == 0.0 for e in jits)
    assert all(e["execute_s"] >= 0.0 for e in jits)
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["jit"]["calls"] == 3
    assert manifest["jit"]["cache_hits"] == 1
    assert manifest["device"]["platform"] == "cpu"
    assert manifest["device"]["torch_version"] == torch.__version__
    assert manifest["xla"]["monitoring"] is False


def test_jit_call_passthrough_when_disabled():
    calls = []

    def f(x):
        calls.append(1)
        return x + 1

    assert float(obs.jit_call("f", f, torch.zeros(()))) == 1.0
    assert calls == [1]


def test_program_region_silences_instrumentation(tmp_path):
    """Inside a jit_call program (and any `program()` block) spans and
    events are no-ops, as inside the reference's traced programs."""

    def g(x):
        with obs.span("inner"):
            obs.event("inner_event")
            return (x * 3.0).sum()

    x = torch.arange(4.0)
    y_off = float(g(x))
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        y_on = float(obs.jit_call("g", g, x))
        with obs.program():
            obs.event("also_silent")
        obs.event("heard")
    assert y_on == y_off == float(g(x))
    kinds = [e["kind"] for e in _events(run.run_dir)]
    assert "heard" in kinds
    assert not {"inner_event", "also_silent"} & set(kinds)
    assert not [e for e in _events(run.run_dir) if e.get("stage") == "inner"]


# -- the port's events against the reference's -------------------------------


def _solve_all(pkg, run_dir=None):
    """The same four calls in one package, under `run_context` when a
    ``run_dir`` is given. Returns the results."""
    if pkg == "ref":
        from sbr_tpu import make_model_params, solve_learning
        from sbr_tpu.baseline.solver import solve_equilibrium_baseline
        from sbr_tpu.models.params import SolverConfig
        from sbr_tpu.social.solver import solve_equilibrium_social
        from sbr_tpu.sweeps.baseline_sweeps import beta_u_grid, u_sweep

        run_ctx, dev = jobs.run_context, {}
    else:
        from sbr_tpu_torch.baseline import solve_equilibrium_baseline, solve_learning
        from sbr_tpu_torch.models.params import SolverConfig, make_model_params
        from sbr_tpu_torch.social.solver import solve_equilibrium_social
        from sbr_tpu_torch.sweeps import beta_u_grid, u_sweep

        run_ctx, dev = obs.run_context, {"device": CPU}
    m = make_model_params()
    m12 = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    cfg = SolverConfig(n_grid=128, bisect_iters=40)
    grid_cfg = SolverConfig(n_grid=96, bisect_iters=30, refine_crossings=False)
    ctx = run_ctx(run_dir=str(run_dir)) if run_dir is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        ls = solve_learning(m.learning, cfg, **dev)
        out = [solve_equilibrium_baseline(ls, m.economic, config=cfg)]
        out.append(u_sweep(ls, np.linspace(0.01, 0.3, 5), m.economic, cfg))
        out.append(beta_u_grid(np.array([0.5, 1.0]), np.array([0.05, 0.1, 0.5]), m,
                               config=grid_cfg, **dev))
        out.append(solve_equilibrium_social(m12, SolverConfig(n_grid=256, bisect_iters=40),
                                            max_iter=30, **dev))
        # a repeated call: the cache "hit" path
        out.append(solve_equilibrium_baseline(ls, m.economic, config=cfg))
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return out


@pytest.fixture(scope="module")
def paired_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("paired")
    # warm, under a run (the reference jits its baseline solve only then):
    # the reference's trace-time spans fire here, once
    _solve_all("ref", root / "warm")
    _solve_all("port", root / "port_warm")  # the port's programs traced once too
    _solve_all("ref", root / "ref")
    _solve_all("port", root / "port")
    return _events(root / "ref"), _events(root / "port"), root


def _sequence(events):
    return [(e["kind"], e.get("stage") or e.get("name") or e.get("where"))
            for e in events if e["kind"] != "xla_compile"]


def test_event_sequence_equals_reference(paired_runs):
    ref, port, _ = paired_runs
    assert _sequence(port) == _sequence(ref)


def test_status_and_health_events_equal_reference(paired_runs):
    ref, port, _ = paired_runs
    for kind in ("status", "health"):
        got = [e for e in port if e["kind"] == kind]
        want = [e for e in ref if e["kind"] == kind]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            g = {k: v for k, v in g.items() if k not in ("mono", "ts")}
            w = {k: v for k, v in w.items() if k not in ("mono", "ts")}
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], float):
                    assert abs(g[k] - w[k]) <= FLOAT_TOL, (kind, k)
                elif k == "worst_cells":
                    assert [c["index"] for c in g[k]] == [c["index"] for c in w[k]]
                    assert [c["flags"] for c in g[k]] == [c["flags"] for c in w[k]]
                else:
                    assert g[k] == w[k], (kind, k)


def test_fixed_point_event_equals_reference(paired_runs):
    ref, port, _ = paired_runs
    (g,) = [e for e in port if e["kind"] == "fixed_point"]
    (w,) = [e for e in ref if e["kind"] == "fixed_point"]
    assert set(g) == set(w)
    for k in ("stage", "iterations", "converged", "aborted", "bankrun"):
        assert g[k] == w[k]
    for k in ("error", "xi"):
        assert abs(g[k] - w[k]) <= FLOAT_TOL
    for k in ("history_err", "history_xi"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=FLOAT_TOL)


def test_jit_call_and_span_fields_equal_reference(paired_runs):
    ref, port, _ = paired_runs
    for kind in ("jit_call", "stage_start", "stage_end"):
        got = [e for e in port if e["kind"] == kind]
        want = [e for e in ref if e["kind"] == kind]
        assert [set(e) for e in got] == [set(e) - XLA_ONLY for e in want]
    got = [(e["name"], e["cache"]) for e in port if e["kind"] == "jit_call"]
    assert got == [(e["name"], e["cache"]) for e in ref if e["kind"] == "jit_call"]
    assert got[-1] == ("baseline.equilibrium", "hit")


def test_manifest_keys_equal_reference(paired_runs):
    _, _, root = paired_runs
    ref = json.loads((root / "ref" / "manifest.json").read_text())
    port = json.loads((root / "port" / "manifest.json").read_text())
    assert list(port) == list(ref)
    assert set(port["memory"]) == set(ref["memory"])
    assert set(port["jit"]) == set(ref["jit"])
    assert set(port["xla"]) == set(ref["xla"])
    assert port["health"].keys() == ref["health"].keys()
    assert port["stages"].keys() == ref["stages"].keys()
    for stage, agg in ref["stages"].items():
        assert port["stages"][stage]["count"] == agg["count"]
    assert port["retraces"] == ref["retraces"]  # None: every program traced while warm
    for name in ("sweeps.u_sweep.cells", "sweeps.beta_u_grid.cells",
                 "social.fixed_point.solves", "social.fixed_point.iterations"):
        assert port["metrics"]["counters"][name] == ref["metrics"]["counters"][name]


def test_telemetry_changes_no_value(tmp_path):
    """Each of the four calls gives the same bits with telemetry on."""
    from sbr_tpu_torch.obs.timing import tensor_leaves

    off = _solve_all("port")
    on = _solve_all("port", tmp_path / "on")
    for a, b in zip(off, on):
        la, lb = tensor_leaves(a), tensor_leaves(b)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
            assert torch.equal(torch.isnan(x), torch.isnan(y))


def test_hetero_and_interest_spans_equal_reference(tmp_path):
    """The eager extension solves' stage spans and health censuses."""
    from sbr_tpu.hetero import solve_equilibrium_hetero as jsolve_h
    from sbr_tpu.hetero import solve_learning_hetero as jlearn_h
    from sbr_tpu.interest import solve_equilibrium_interest as jsolve_i
    from sbr_tpu.models import params as jp
    from sbr_tpu_torch.hetero import solve_equilibrium_hetero, solve_learning_hetero
    from sbr_tpu_torch.interest import solve_equilibrium_interest
    from sbr_tpu_torch.models import params as tp
    from sbr_tpu_torch.baseline import solve_learning

    from sbr_tpu import solve_learning as jsolve_learning

    hkw = dict(betas=[0.125, 12.5], dist=[0.9, 0.1], eta_bar=30.0, u=0.1, p=0.9, kappa=0.3,
               lam=0.1)
    ikw = dict(u=0.0, r=0.06, delta=0.1)

    def run(pkg, run_dir):
        if pkg == "ref":
            jcfg = jp.SolverConfig(n_grid=256, bisect_iters=40)
            hm, im = jp.make_hetero_params(**hkw), jp.make_interest_params(**ikw)
            lsh = jlearn_h(hm.learning, jcfg)
            ils = jsolve_learning(im.learning, jcfg)
            with jobs.run_context(run_dir=str(run_dir)):
                jsolve_h(lsh, hm.economic, jcfg)
                jsolve_i(ils, im.economic, jcfg)
        else:
            tcfg = tp.SolverConfig(n_grid=256, bisect_iters=40)
            hm, im = tp.make_hetero_params(**hkw), tp.make_interest_params(**ikw)
            lsh = solve_learning_hetero(hm.learning, tcfg, device=CPU)
            ils = solve_learning(im.learning, tcfg, device=CPU)
            with obs.run_context(run_dir=str(run_dir)):
                solve_equilibrium_hetero(lsh, hm.economic, tcfg)
                solve_equilibrium_interest(ils, im.economic, tcfg)
        return _events(run_dir)

    ref, port = run("ref", tmp_path / "ref"), run("port", tmp_path / "port")
    # the eager solves run op by op in the reference too: no trace artifacts
    assert _sequence(port) == _sequence(ref)
    (gh, gi), (wh, wi) = ([e for e in evs if e["kind"] == "health"] for evs in (port, ref))
    for g, w in ((gh, wh), (gi, wi)):
        assert (g["stage"], g["cells"], g["divergent"], g["flag_counts"]) == (
            w["stage"], w["cells"], w["divergent"], w["flag_counts"])


def test_timing_primitives():
    timer = obs.StageTimer()
    with timer.stage("a"):
        timer.sync(torch.ones(3))
    with timer.stage("a"):
        pass
    assert set(timer.times) == {"a"} and timer.total() >= 0.0
    assert "total" in timer.report()
    obs.fence(torch.ones(2), [torch.zeros(1)], {"k": torch.ones(1)})  # CPU: nothing to wait on
