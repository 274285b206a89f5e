"""The port's run reader (sbr_tpu_torch.obs.report) against sbr_tpu's on
the same run directories.

Each subcommand (the bare render, diff and ``--json``, ``health``,
``resilience``, ``elastic``, ``infomodel``, ``grad``, ``memory``,
``serve``, ``fleet``, ``trace``, ``slo``, ``util``, ``demand``,
``prewarm``, ``audit``, ``summary``, ``gc`` with its ``--trace-keep``,
``--demand-keep``, ``--flight-keep``, ``--audit-keep`` and
``--prewarm-keep``) reads a passing and a failing run directory, written
once by each package's run log, and both packages' ``report.main`` give
the same exit code, the same ``--json`` document and the same rendered
lines. The program name is normalized (``sbr_tpu_torch`` → ``sbr_tpu``),
and so is the serve report's snapshot age, which is the reader's clock.
On a run the port wrote, two lines name the runtime and differ by
design: the device line's ``torch <version>`` (the reference prints the
``jax_version`` it does not find as ``jax ?``) and the reference's note
that ``jax.monitoring`` was unavailable, which the port omits for its own
runs; those two are dropped before the comparison.

Mirrors the report cases of tests/test_obs.py, test_mem.py,
test_resilience.py, test_elastic.py, test_serve.py (the gate, the cache
floor's scope and the torn event line), test_grad.py, test_infomodels.py
and test_diag.py's health gate, test_trace.py's ``trace`` / ``slo``,
test_flight.py's ``util`` and ``summary``, test_demand.py's ``demand``,
test_fleet.py's ``fleet`` and test_prewarm.py's ``prewarm`` and gc
retention: span files, ``flight.json``, ``demand.json``, ``fleet.json``
and the ``fleet`` and ``prewarm`` events written by each package's own
module from the same inputs. Then ``python -m`` for every subcommand (the
port's CLI loads no torch).
"""

import importlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sbr_tpu import obs as jobs  # noqa: E402
from sbr_tpu.obs import report as jreport  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import report  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120  # seconds: every subprocess in this file is bounded
WRITERS = ("ref", "port")


@pytest.fixture(autouse=True)
def _no_active_run(monkeypatch):
    for var in ("SBR_SERVE_SLO_MS", "SBR_SERVE_CACHE_FLOOR", "SBR_SERVE_WARMUP", "SBR_OBS",
                "SBR_FLIGHT_UTIL_FLOOR", "SBR_FLIGHT_MIN_DISPATCHES", "SBR_DEMAND_COVERAGE_FLOOR",
                "SBR_DEMAND_TOPK", "SBR_DEMAND_BINS", "SBR_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    assert obs.current_run() is None and jobs.current_run() is None
    yield
    while obs.end_run() is not None:
        pass
    while jobs.end_run() is not None:
        pass


# -- run directories, written by either package -------------------------------


def _health(writer, poisoned: bool):
    nan = float("nan")
    res, width, iters, flags = ([1e-9, nan], [1e-12, nan], [90, 0], [0, 1 << 6]) if poisoned \
        else ([1e-9, 2e-9], [1e-12, 1e-12], [90, 88], [0, 0])
    if writer == "ref":
        from sbr_tpu.diag import Health

        return Health(residual=jnp.asarray(res), bracket_width=jnp.asarray(width),
                      iterations=jnp.asarray(iters, jnp.int32),
                      flags=jnp.asarray(flags, jnp.int32)), jnp.zeros(2, jnp.int32)
    from sbr_tpu_torch.diag.health import Health

    return Health(residual=torch.tensor(res), bracket_width=torch.tensor(width),
                  iterations=torch.tensor(iters, dtype=torch.int32),
                  flags=torch.tensor(flags, dtype=torch.int32)), torch.zeros(2, dtype=torch.int32)


def _timing(writer, mod, run):
    with run.span("stage_x", n=4):
        pass
    if writer == "ref":
        import jax

        run.jit_call("fx", jax.jit(lambda x: x * 2), jnp.arange(4.0))
        mod.log_status("grid", jnp.asarray([0, 0, 1, 3], jnp.int32))
    else:
        run.jit_call("fx", lambda x: x * 2, torch.arange(4.0))
        mod.log_status("grid", torch.tensor([0, 0, 1, 3], dtype=torch.int32))


def _live_doc(writer, p99_ms: float, hits: int, queries: int) -> dict:
    if writer == "ref":
        from sbr_tpu.serve.live import LiveMetrics
    else:
        from sbr_tpu_torch.serve.live import LiveMetrics
    live = LiveMetrics()
    for i in range(queries):
        live.record_query(p99_ms / 1e3, "lru" if i < hits else "computed")
    live.record_batch(queries - hits, 8)
    return live.snapshot({"healthz": {"status": "ready", "reasons": []}})


def _emit_resilience(gave_up):
    def emit(writer, mod, run):
        if gave_up:
            run.log_retry("Tile (2,0)", "gave_up", attempt=3, error="dead backend")
            run.log_repair("degrade_ladder", "tile[0,1]", ok=False)
        else:
            run.log_fault("tile.compute", "transient", target="tile_b00000_u00000", rule=0)
            run.log_retry("Tile (0,0)", "retrying", attempt=1, backoff_s=0.1)
            run.log_retry("Tile (0,0)", "recovered", attempt=2)
            run.log_repair("quarantine", "tile_b00000_u00000.npz", reason="sha256-mismatch")
            run.log_repair("degrade_ladder", "tile[1,1]", ok=True, rung=0, flags=1)
    return emit


def _emit_elastic(writer, mod, run):
    run.log_scheduler("join", host="h1", tiles=4, seed_rate=None)
    run.log_scheduler("plan", host="h1", missing=2, shares={"h1": 2})
    run.log_scheduler("claim", host="h1", tile="tile_b00000_u00000")
    run.log_scheduler("done", host="h1", tile="tile_b00000_u00000", source="computed",
                      dur_s=2.0, cells=4)
    run.log_scheduler("reclaim", host="h1", tile="tile_b00000_u00002")
    run.log_scheduler("done", host="h1", tile="tile_b00000_u00002", source="cache",
                      dur_s=0.01, cells=4)
    run.log_cache("miss", tile="tile_b00000_u00000", key="0" * 12)
    run.log_cache("store", tile="tile_b00000_u00000", key="0" * 12)
    run.log_cache("hit", tile="tile_b00000_u00002", key="1" * 12)
    run.log_scheduler("leave", host="h1", tiles_done=2)


def _emit_grad(kind):
    def emit(writer, mod, run):
        flags = dict(stage="grad.sensitivity_surface", cells=4, run_cells=4,
                     at_nonequilibrium=0, ill_conditioned=1, nonfinite=0, nonfinite_run=0,
                     untrusted=1)
        if kind == "nonfinite":
            flags.update(nonfinite=1, nonfinite_run=1, untrusted=2)
        run.event("grad", action="flags", **flags)
        run.event("grad", action="calib_start", wrt=["beta", "u"], steps=30, lr=0.05,
                  n_obs=16, with_xi=True)
        for i in (0, 25):
            run.event("grad", action="calib_step", step=i, loss=0.1 / (i + 1))
        if kind != "running":
            run.event("grad", action="calib_done", steps=30, loss=1e-6,
                      converged=kind != "unconverged", fit_beta=1.01, fit_u=0.1)
        run.event("grad", action="stress_done", flipped=True, validated=True, margin0=0.02,
                  margin_final=-1e-6, steps=7, shock_norm=0.05, delta_kappa=0.05)
    return emit


def _emit_infomodel(bad):
    def emit(writer, mod, run):
        run.log_infomodel("fixed_point", channel="bayes", dynamics="static", groups=1,
                          converged=not bad, aborted=False, iterations=250 if bad else 20,
                          xi=0.9, bankrun=not bad)
        run.log_infomodel("closure", channel="gossip", dynamics="rewire", n_agents=100,
                          n_reps=1, err_aw_sup=0.9 if bad else 0.1, err_g_rms=0.02,
                          tolerance=0.25)
        run.log_infomodel("rewire_epoch", epoch=0, channel="bayes", steps=5, edges=10,
                          withdrawing=0)
        run.log_infomodel("belief_census", channel="bayes", dynamics="static", crossed=7,
                          mean_belief=0.5, max_belief=2.0)
        run.log_infomodel("population_query", channel="bayes", dynamics="static",
                          vary="sim", seeds=2, n_agents=400, run_probability=0.5)
    return emit


def _emit_memory(over):
    def emit(writer, mod, run):
        run.log_tile_mem("tile_b00000_u00000", peak_bytes_in_use=9_900 if over else 1_000,
                         bytes_limit=10_000)
        run.log_tile_mem("tile_b00000_u00004", peak_bytes_in_use=100, bytes_limit=10_000)
        run.log_preflight({"label": "tile[2x2]", "headroom": 0.8, "verdict": "ok",
                           "footprint_bytes": 500, "capacity_bytes": 10_000,
                           "budget_bytes": 8_000})
    return emit


def _emit_health(poisoned):
    def emit(writer, mod, run):
        health, status = _health(writer, poisoned)
        mod.log_health("grid", health, status)
    return emit


def _emit_serve(writer, mod, run):
    run.live_snapshot(_live_doc(writer, p99_ms=2.0, hits=10, queries=12))


def _emit_nothing(writer, mod, run):
    run.event("status", stage="x", counts={})


def _sub(mod, name):
    """The telemetry module ``name`` of the package whose obs is ``mod``."""
    return importlib.import_module(f"{mod.__name__}.{name}")


def _emit_trace(kind):
    """Span files: three traces (one an SLO exemplar) and, for ``orphan``,
    a span whose parent is nowhere; ``slo`` also writes a live.json whose
    resolved SLO every root breaches."""
    def emit(writer, mod, run):
        tr = _sub(mod, "trace")
        w = tr.TraceWriter(run.run_dir)
        for k in range(3):
            ctx = tr.TraceContext(f"{k:016x}", keep=k != 2, service="worker")
            t0 = 1_700_000_000.0 + k
            root = ctx.add("worker.request", t0, 0.004 + k * 1e-3, span_id=f"r{k:07d}",
                           status=200, source="lru")
            q = ctx.add("engine.query", t0 + 1e-4, 0.003, parent=root, span_id=f"q{k:07d}")
            for j, name in enumerate(("engine.admission", "engine.queue", "engine.cache")):
                ctx.add(name, t0 + 2e-4 + j * 5e-4, 4e-4, parent=q, span_id=f"s{k}{j:06d}",
                        lru="hit" if name == "engine.cache" else None)
            if kind == "orphan" and k == 0:
                ctx.add("engine.dispatch", t0 + 1e-3, 1e-3, parent="deadbeef",
                        span_id="o0000000", bucket=8)
            w.commit(ctx, exemplar=k == 2)
        w.close()
        if kind == "slo":
            run.live_snapshot({"slo": {"slo_ms": 4.5}})
    return emit


def _emit_flight(writer, mod, run):
    fl = _sub(mod, "flight")
    clock = iter(range(10**6))
    rec = fl.FlightRecorder(cap=256, time_fn=lambda: 100.0 + next(clock) * 1e-3)
    t = 100.0
    for k in range(6):
        rec.mark("engine", "admission", t, t + 1e-4)
        rec.mark("engine", "queue", t, t + 2e-4)
        rec.mark("engine", "cache", t + 2e-4, t + 3e-4, tag="miss")
        rec.mark("engine", "batch", t + 3e-4, t + 5e-4, tag="b8")
        rec.mark("engine", "dispatch", t + 5e-4, t + 2.5e-3, tag="b8")
        rec.point("engine", "occupancy", tag="b8", val=0.5)
        rec.point("engine", "queue_depth", val=k % 3)
        rec.mark("engine", "unpack", t + 2.5e-3, t + 2.6e-3, tag="b8")
        t += 4e-3
    rec.point("engine", "shed", tag="expired")
    rec.mark("sweeps", "compute", t, t + 0.01, tag="tile_b00000_u00000")
    rec.mark("collectives", "barrier_poll", t, t + 0.02, tag="missing=1")
    rec.close(run)


def _emit_demand(writer, mod, run):
    dm = _sub(mod, "demand")
    tr = dm.DemandTracker(bins=8, topk_n=6, time_fn=lambda: 1000.0)
    for k in range(40):
        tr.record(0.6 + (k % 5) * 0.7, 0.05 + (k % 3) * 0.2, scenario="mix",
                  source="lru" if k % 4 else "computed")
    tr.close(run)


def _emit_fleet(counters, workers=None, events=()):
    """A router run: its ``fleet`` events and its rolling fleet.json."""
    def emit(writer, mod, run):
        for action in events:
            run.log_fleet(action)
        run.live_snapshot({"schema": "sbr-fleet/1", "counters": counters,
                           "workers": workers or {},
                           "latency_ms": {"count": 3, "p50": 1.5, "p95": 2.0, "p99": 2.5}},
                          name="fleet.json")
    return emit


def _emit_prewarm(emits):
    def emit(writer, mod, run):
        for action, kw in emits:
            run.log_prewarm(action, **kw)
    return emit


_PREWARM_OK = [("plan", {"fingerprint": "f1", "tiles": 2}),
               ("tile", {"tile": "t00000_00000", "source": "computed", "fingerprint": "f1"}),
               ("adopt", {"tile": "t00001_00000", "fingerprint": "f1"}),
               ("tile", {"tile": "t00001_00000", "source": "cache", "fingerprint": "f1"}),
               ("plan_done", {"fingerprint": "f1", "tiles": 2, "warm": 2})]
_FLEET_CLEAN = ({"queries": 10, "completed": 10, "failed": 0, "failover": 1, "hedged": 1,
                 "hedge_wins": 1},
                {"w1": {"breaker": "closed", "breaker_age_s": None, "forwards": 7,
                        "failures": 0, "ewma_ms": 2.5, "healthz": "ready"}},
                ["failover", "worker_join", "hedge", "hedge_win"])


def _emit_summary(writer, mod, run):
    """One run with a fleet snapshot, a completed prewarm plan and a
    health census: some gates pass, the rest read no data."""
    _emit_fleet(*_FLEET_CLEAN)(writer, mod, run)
    _emit_prewarm(_PREWARM_OK)(writer, mod, run)
    _emit_health(False)(writer, mod, run)


# (subcommand, extra argv, emit, exit code, env)
CASES = {
    "render": ("", [], _timing, 0, {}),
    "render_json": ("", ["--json"], _timing, 0, {}),
    "render_events": ("", ["--events", "3"], _timing, 0, {}),
    "health_clean": ("health", [], _emit_health(False), 0, {}),
    "health_divergent": ("health", [], _emit_health(True), 1, {}),
    "health_no_data": ("health", [], _emit_nothing, 3, {}),
    "resilience_recovered": ("resilience", [], _emit_resilience(False), 0, {}),
    "resilience_gave_up": ("resilience", [], _emit_resilience(True), 1, {}),
    "resilience_clean": ("resilience", [], _emit_nothing, 0, {}),
    "elastic": ("elastic", [], _emit_elastic, 0, {}),
    "elastic_no_events": ("elastic", [], _emit_nothing, 3, {}),
    "grad_ok": ("grad", [], _emit_grad("ok"), 0, {}),
    "grad_running": ("grad", [], _emit_grad("running"), 0, {}),
    "grad_unconverged": ("grad", [], _emit_grad("unconverged"), 1, {}),
    "grad_nonfinite": ("grad", [], _emit_grad("nonfinite"), 1, {}),
    "grad_no_events": ("grad", [], _emit_nothing, 3, {}),
    "infomodel_ok": ("infomodel", [], _emit_infomodel(False), 0, {}),
    "infomodel_breach": ("infomodel", [], _emit_infomodel(True), 1, {}),
    "infomodel_no_data": ("infomodel", [], _emit_nothing, 3, {}),
    "memory_ok": ("memory", [], _emit_memory(False), 0, {}),
    "memory_over": ("memory", [], _emit_memory(True), 1, {}),
    "memory_over_loose": ("memory", ["--headroom", "0.999"], _emit_memory(True), 0, {}),
    "memory_no_data": ("memory", [], _emit_nothing, 3, {}),
    "serve_ok": ("serve", [], _emit_serve, 0, {}),
    "serve_slo_breach": ("serve", [], _emit_serve, 1, {"SBR_SERVE_SLO_MS": "0.000001"}),
    "serve_cache_floor": ("serve", ["--cache-floor", "1.1", "--warmup", "1"], _emit_serve, 1,
                          {}),
    "serve_no_data": ("serve", [], _emit_nothing, 3, {}),
    "trace_joined": ("trace", [], _emit_trace("ok"), 0, {}),
    "trace_waterfalls": ("trace", ["--max-waterfalls", "1"], _emit_trace("ok"), 0, {}),
    "trace_orphaned": ("trace", [], _emit_trace("orphan"), 1, {}),
    "trace_no_spans": ("trace", [], _emit_nothing, 3, {}),
    "slo_exemplar": ("slo", [], _emit_trace("ok"), 1, {}),
    "slo_breach": ("slo", ["--breach-limit", "2"], _emit_trace("slo"), 1, {}),
    "slo_no_data": ("slo", [], _emit_nothing, 3, {}),
    "util_ok": ("util", [], _emit_flight, 0, {}),
    "util_floor": ("util", [], _emit_flight, 1, {"SBR_FLIGHT_UTIL_FLOOR": "0.9"}),
    "util_disarmed": ("util", ["--floor", "0.9", "--min-dispatches", "50"], _emit_flight, 0,
                      {}),
    "util_no_data": ("util", [], _emit_nothing, 3, {}),
    "demand_ok": ("demand", [], _emit_demand, 0, {}),
    "demand_floor": ("demand", [], _emit_demand, 1, {"SBR_DEMAND_COVERAGE_FLOOR": "0.9"}),
    "demand_floor_met": ("demand", ["--floor", "0.5"], _emit_demand, 0, {}),
    "demand_no_data": ("demand", [], _emit_nothing, 3, {}),
    "fleet_clean": ("fleet", [], _emit_fleet(*_FLEET_CLEAN), 0, {}),
    "fleet_lost": ("fleet", [], _emit_fleet({"queries": 10, "completed": 9, "failed": 1},
                                            events=["lost"]), 1, {}),
    "fleet_lost_events_only": ("fleet", [], _emit_fleet({"failed": 0}, events=["lost"]), 1, {}),
    "fleet_stuck": ("fleet", ["--stuck-after-s", "60"],
                    _emit_fleet({"queries": 1, "completed": 1, "failed": 0},
                                {"w1": {"breaker": "open", "breaker_age_s": 120.0}},
                                ["breaker_open"]), 1, {}),
    "fleet_open_not_stuck": ("fleet", [], _emit_fleet(
        {"queries": 1, "completed": 1, "failed": 0},
        {"w1": {"breaker": "open", "breaker_age_s": 120.0}}, ["breaker_open"]), 0, {}),
    "fleet_no_data": ("fleet", [], _emit_nothing, 3, {}),
    "prewarm_ok": ("prewarm", [], _emit_prewarm(_PREWARM_OK), 0, {}),
    "prewarm_cold": ("prewarm", [], _emit_prewarm(
        [("plan", {"fingerprint": "f1", "tiles": 2}),
         ("plan_done", {"fingerprint": "f1", "tiles": 2, "warm": 1})]), 1, {}),
    "prewarm_budget": ("prewarm", [], _emit_prewarm(
        [("plan", {"fingerprint": "f2", "tiles": 3}),
         ("tile", {"tile": "t00000_00000", "source": "computed", "fingerprint": "f2"}),
         ("abandon", {"reason": "budget", "count": 2, "fingerprint": "f2"}),
         ("plan_reject", {"fingerprint": "f3", "reason": "program_version"})]), 1, {}),
    "prewarm_no_data": ("prewarm", [], _emit_nothing, 3, {}),
    "summary_mixed": ("summary", [], _emit_summary, 3, {}),
    "summary_breach": ("summary", [], _emit_prewarm(
        [("plan", {"fingerprint": "f1", "tiles": 2}),
         ("plan_done", {"fingerprint": "f1", "tiles": 2, "warm": 1})]), 3, {}),
    "summary_no_data": ("summary", [], _emit_nothing, 3, {}),
}


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Every case's run directory, written once by each package."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, (_, _, emit, _, _) in CASES.items():
        for writer in WRITERS:
            mod = jobs if writer == "ref" else obs
            d = root / writer / name
            with mod.run_context(run_dir=str(d), label=name) as run:
                emit(writer, mod, run)
            out[(name, writer)] = d
    return out


_AGE = re.compile(r"snapshot age [0-9.]+ m?s")


def _normalize(text: str, writer: str) -> list:
    lines = []
    for line in text.replace("sbr_tpu_torch", "sbr_tpu").splitlines():
        if writer == "port" and line.startswith("device   "):
            continue  # the runtime's name (module docstring)
        if writer == "port" and line.startswith("XLA COMPILES: jax.monitoring"):
            if lines and not lines[-1]:
                lines.pop()  # and the blank line that opens its section
            continue
        lines.append(_AGE.sub("snapshot age T", line))
    return lines


def _both(argv, capsys, monkeypatch, env=()):
    for k, v in dict(env).items():
        monkeypatch.setenv(k, v)
    out = []
    for main in (report.main, jreport.main):
        code = main(list(argv))
        cap = capsys.readouterr()
        out.append((code, cap.out, cap.err))
    return out


def _json_doc(text: str) -> dict:
    doc = json.loads(text.replace("sbr_tpu_torch", "sbr_tpu"))
    live = doc.get("live")
    if isinstance(live, dict):
        live.pop("ts", None)
    return doc


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_equals_reference(run_dirs, capsys, monkeypatch, case, writer):
    sub, args, _, code, env = CASES[case]
    argv = ([sub] if sub else []) + [str(run_dirs[(case, writer)])] + args
    (got, got_out, _), (want, want_out, _) = _both(argv, capsys, monkeypatch, env)
    assert got == want == code, (got_out, want_out)
    if "--json" in args or sub:
        # every subcommand's --json document equals the reference's
        (jgot, jgot_out, _), (jwant, jwant_out, _) = _both(
            argv if "--json" in args else argv + ["--json"], capsys, monkeypatch, env)
        assert jgot == jwant == code
        assert _json_doc(jgot_out) == _json_doc(jwant_out)
    if "--json" not in args:
        assert _normalize(got_out, writer) == _normalize(want_out, writer)
        assert got_out.strip()


@pytest.mark.parametrize("writer", WRITERS)
def test_diff_equals_reference(run_dirs, capsys, monkeypatch, writer):
    a, b = run_dirs[("render", writer)], run_dirs[("render_json", writer)]
    for extra in ([], ["--json"]):
        (got, got_out, _), (want, want_out, _) = _both([str(a), str(b)] + extra, capsys,
                                                      monkeypatch)
        assert got == want == 0
        if extra:
            doc = json.loads(got_out)
            assert doc == json.loads(want_out) and "stage_x" in doc["stages"]
        else:
            assert "STAGES (B vs A)" in got_out
            assert _normalize(got_out, writer) == _normalize(want_out, writer)


def test_not_a_run_directory(tmp_path, capsys, monkeypatch):
    (got, _, err), (want, _, _) = _both([str(tmp_path)], capsys, monkeypatch)
    assert got == want == 1 and "error" in err
    for sub in ("serve", "infomodel"):
        (got, _, _), (want, _, _) = _both([sub, str(tmp_path / "missing")], capsys,
                                          monkeypatch)
        assert got == want == 2


@pytest.mark.parametrize("writer", WRITERS)
def test_reports_survive_a_torn_event_line(run_dirs, capsys, monkeypatch, writer, tmp_path):
    """A process killed mid-write leaves a truncated last line, possibly cut
    inside a UTF-8 sequence: every report counts it and reads on."""
    import shutil

    d = tmp_path / "torn"
    shutil.copytree(run_dirs[("health_clean", writer)], d)
    with open(d / "events.jsonl", "ab") as fh:
        fh.write('{"kind": "health", "stage": "é'.encode()[:-1])
    assert report.load_run(d)["bad_event_lines"] == 1
    for argv in ([str(d)], ["health", str(d)], ["resilience", str(d)], [str(d), "--json"]):
        (got, got_out, _), (want, want_out, _) = _both(argv, capsys, monkeypatch)
        assert got == want == 0
        if "--json" in argv:
            assert json.loads(got_out)["bad_event_lines"] == 1
            assert json.loads(got_out) == json.loads(want_out)
        else:
            assert _normalize(got_out, writer) == _normalize(want_out, writer)
    (got, got_out, _), _ = _both([str(d)], capsys, monkeypatch)
    assert "1 unparseable event line(s) skipped" in got_out


def test_serve_cache_floor_scopes_consistently(tmp_path):
    """A quiet window holding two fresh queries on a long-warm server must
    not trip the floor gate: the rate and the arming count share a scope."""
    live = {
        "schema": "sbr-serve-live/1", "ts": 0, "uptime_s": 9999,
        "totals": {"queries": 10000, "cache_hits": 9500, "hit_rate": 0.95,
                   "latency_ms": {"p99": 1.0}},
        "window": {"queries": 2, "cache_hits": 0, "hit_rate": 0.0,
                   "latency_ms": {"p99": 1.0}},
    }
    (tmp_path / "live.json").write_text(json.dumps(live))
    got = report.serve_doc(tmp_path, cache_floor=0.5, warmup=50)
    assert got == jreport.serve_doc(tmp_path, cache_floor=0.5, warmup=50)
    assert got[1] == 0, got[0]["breaches"]


# -- the served run directory, end to end ------------------------------------


def test_engine_run_dir_reads_as_the_reference_reads_it(tmp_path, capsys, monkeypatch):
    """The port's Engine(run_dir=...) writes live.json and the fleet events
    the reference's report gates on; the ladder's events equal statz."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.serve import DeadlineExceeded, Engine, ServeConfig

    run_dir = tmp_path / "serve"
    cfg = SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False)
    engine = Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)), run_dir=str(run_dir),
                    device="cpu")
    p = make_model_params()
    try:
        engine.query_many([p, make_model_params(u=0.2)])
        engine.query(p)  # an LRU hit
        with pytest.raises(DeadlineExceeded):
            engine.query(p, deadline_ms=-1)
        # the solver path down: the ladder answers (here: exhausted)
        monkeypatch.setattr(engine, "_dispatch", lambda *a, **k: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            engine.query(make_model_params(u=0.3))
        ladder = engine.statz()["ladder"]
    finally:
        engine.close()
    events = [json.loads(x) for x in (run_dir / "events.jsonl").read_text().splitlines()]
    fleet = [(e["action"], e.get("reason")) for e in events if e["kind"] == "fleet"]
    assert fleet == [("shed", "expired"), ("ladder_exhausted", None)]
    assert ladder == {"tile_cache": False, "degraded": 0, "ladder_exhausted": 1}
    kinds = [e["kind"] for e in events]
    assert kinds.count("serve_exec") == 1 and kinds.count("serve_batch") == 1
    assert ("stage_start", "serve.compile[8]") in [(e["kind"], e.get("stage")) for e in events]
    assert kinds[-2:] == ["serve_summary", "run_end"]
    for sub_argv in (["serve", str(run_dir)], ["serve", str(run_dir), "--json"],
                     [str(run_dir), "--json"]):
        (got, got_out, _), (want, want_out, _) = _both(sub_argv, capsys, monkeypatch)
        assert got == want == 0
        if "--json" in sub_argv:
            assert _json_doc(got_out) == _json_doc(want_out)
        else:
            assert _normalize(got_out, "port") == _normalize(want_out, "port")
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert manifest["status"] == "complete"
    assert manifest["fleet"]["shed"] == 1 and manifest["fleet"]["ladder_exhausted"] == 1


# -- gc -----------------------------------------------------------------------


def _gc_tree(root: Path) -> None:
    old = time.time() - 40 * 86400
    for i in range(4):
        d = root / "runs" / f"run{i}"
        d.mkdir(parents=True)
        (d / "manifest.json").write_text(json.dumps({"status": "complete"}))
        os.utime(d, (old + i, old + i))
        os.utime(d / "manifest.json", (old + i, old + i))
    (root / "runs" / "ckpt" / "quarantine").mkdir(parents=True)
    (root / "runs" / "ckpt" / "tile_b00000_u00000.lease").write_text("{torn")
    entry = root / "cache" / "ab" / ("ab" * 32 + ".npz")
    entry.parent.mkdir(parents=True)
    entry.write_bytes(b"x")
    os.utime(entry, (old, old))


def test_gc_equals_reference(tmp_path, capsys, monkeypatch):
    outs = []
    for name, main in (("port", report.main), ("ref", jreport.main)):
        root = tmp_path / name
        _gc_tree(root)
        code = main(["gc", str(root / "runs"), "--keep", "2", "--tile-cache",
                     str(root / "cache"), "--keep-days", "30"])
        outs.append((code, capsys.readouterr().out.replace(str(root), "ROOT")))
        assert sorted(p.name for p in (root / "runs").iterdir()) == ["ckpt", "run2", "run3"]
        assert not (root / "runs" / "ckpt" / "quarantine").exists()
        assert not any((root / "cache").rglob("*.npz"))
    assert outs[0] == outs[1] and outs[0][0] == 0


def _gc_artifacts(root: Path) -> None:
    """A complete run and a live one, each with rotated trace, demand,
    advisor-plan and flight files beside the active ones."""
    for name, status in (("done", "complete"), ("live", "running")):
        d = root / "runs" / name
        d.mkdir(parents=True)
        (d / "manifest.json").write_text(json.dumps({"status": status}))
        for base, ext in (("trace", "jsonl"), ("demand", "json"), ("advisor_plan", "json"),
                          ("flight", "json")):
            (d / f"{base}.{ext}").write_text("{}\n")
            for k in range(1, 4):
                p = d / f"{base}.{k:03d}.{ext}"
                p.write_text("{}\n")
                os.utime(p, (1000 + k, 1000 + k))


@pytest.mark.parametrize("flags", [["--trace-keep", "1"], ["--demand-keep", "0"],
                                   ["--flight-keep", "2"],
                                   ["--trace-keep", "0", "--demand-keep", "2",
                                    "--flight-keep", "0"]])
def test_gc_keep_flags_equal_reference(tmp_path, capsys, flags):
    outs = []
    for name, main in (("port", report.main), ("ref", jreport.main)):
        root = tmp_path / name
        _gc_artifacts(root)
        code = main(["gc", str(root / "runs"), "--keep", "5", *flags])
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        outs.append((code, capsys.readouterr().out.replace(str(root), "ROOT"), left))
    assert outs[0] == outs[1] and outs[0][0] == 0
    live = [p for p in outs[0][2] if p.startswith("runs/live/")]
    assert len(live) == 1 + 4 * 4  # a live run is never pruned
    done = [p for p in outs[0][2] if p.startswith("runs/done/")]
    keep = dict(zip(flags[::2], map(int, flags[1::2])))
    want = 1 + 4 + sum(min(keep.get(f"--{k}-keep", 3), 3) * n
                       for k, n in (("trace", 1), ("demand", 2), ("flight", 1)))
    assert len(done) == want


# -- audit (ported with obs/audit, ROADMAP 1.A 9d) -----------------------------


@pytest.mark.parametrize("case", ["not_a_dir", "no_audit_data", "drift"])
def test_audit_subcommand_equals_reference(case, tmp_path, capsys):
    """``report audit``, which exited 2 as not ported: the reference's exit
    codes and output on the same directory (2 not a directory, 3 no audit
    data, 1 a drift verdict)."""
    d = tmp_path / "run"
    if case != "not_a_dir":
        d.mkdir()
        (d / "manifest.json").write_text(json.dumps({"status": "complete"}))
        if case == "drift":
            ev = {"mono": 1.0, "ts": 1.0, "kind": "audit", "action": "probe",
                  "probe": "grid.baseline", "tier": "bitwise", "verdict": "drift",
                  "detail": "fingerprint aaaa != golden bbbb", "duration_ms": 3.0, "cycle": 1}
            (d / "events.jsonl").write_text(json.dumps(ev) + "\n")
    outs = []
    for main in (report.main, jreport.main):
        code = main(["audit", str(d)])
        outs.append((code, capsys.readouterr().out.replace("sbr_tpu_torch.", "sbr_tpu.")))
    assert outs[0] == outs[1]
    assert outs[0][0] == {"not_a_dir": 2, "no_audit_data": 3, "drift": 1}[case]


@pytest.mark.parametrize("keep", ["0", "2"])
def test_gc_audit_keep_equals_reference(keep, tmp_path, capsys, monkeypatch):
    """gc's ``--audit-keep``, which exited 2 as not ported: battery
    artifacts of finished runs and archived goldens pruned as the
    reference prunes them, live runs and active goldens kept."""
    outs = []
    for name, main in (("port", report.main), ("ref", jreport.main)):
        root = tmp_path / name
        _gc_artifacts(root)
        for run in ("done", "live"):
            (root / "runs" / run / "audit").mkdir()
            for k in range(4):
                (root / "runs" / run / "audit" / f"battery_{k:04d}.json").write_text("{}")
        reg = root / "reg"
        reg.mkdir()
        (reg / "goldens_abc.json").write_text("{}")
        for k in range(3):
            (reg / f"goldens_abc.{k:03d}.json").write_text("{}")
        monkeypatch.setenv("SBR_AUDIT_REGISTRY_DIR", str(reg))
        code = main(["gc", str(root / "runs"), "--keep", "5", "--audit-keep", keep])
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        outs.append((code, capsys.readouterr().out.replace(str(root), "ROOT"), left))
    assert outs[0] == outs[1] and outs[0][0] == 0
    left = outs[0][2]
    assert "reg/goldens_abc.json" in left
    assert len([p for p in left if p.startswith("runs/live/audit/")]) == 4
    assert len([p for p in left if p.startswith("runs/done/audit/")]) == int(keep)
    assert len([p for p in left if p.startswith("reg/goldens_abc.0")]) == int(keep)


# -- fleet, prewarm and summary (ported with serve/, ROADMAP 1.A 10) ------------


@pytest.mark.parametrize("sub", ["fleet", "prewarm", "summary"])
def test_fleet_prewarm_summary_not_a_directory(sub, tmp_path, capsys, monkeypatch):
    """``report fleet|prewarm|summary``, which exited 2 as not ported: on a
    path that is not a directory, the reference's exit 2 and output."""
    (got, got_out, _), (want, want_out, _) = _both([sub, str(tmp_path / "nope"), "--json"],
                                                  capsys, monkeypatch)
    assert got == want == 2
    assert _json_doc(got_out) == _json_doc(want_out)


def test_summary_gates_fold_as_the_reference(run_dirs, capsys, monkeypatch):
    """The meta-gate's rows on a run with fleet, prewarm and health data:
    those three pass, and so does ``slo`` (it reads the fleet snapshot's
    latency against no SLO); the gates without data read 3, the merged
    exit is the worst."""
    d = str(run_dirs[("summary_mixed", "port")])
    (got, out, _), (want, wout, _) = _both(["summary", d, "--json"], capsys, monkeypatch)
    doc = json.loads(out)
    assert got == want == 3 and doc == json.loads(wout)
    assert {n: g["exit"] for n, g in doc["gates"].items()} == {
        "health": 0, "serve": 3, "fleet": 0, "trace": 3, "slo": 0, "audit": 3, "demand": 3,
        "prewarm": 0, "util": 3}


def _prewarm_state(root: Path, now: float):
    for i in range(5):
        (root / f"plan_{i:02d}").mkdir(parents=True)
    (root / "plan_00" / "tile_b00000_u00000.lease").write_text(
        json.dumps({"ts": now, "ttl_s": 600.0, "nonce": "n"}))
    (root / "plan_04" / "tile_b00001_u00000.lease").write_text(
        json.dumps({"ts": now - 9999, "ttl_s": 1.0}))
    (root / "plan_04" / "done_t00001_00000.json").write_text("{}")
    for i in range(5):
        os.utime(root / f"plan_{i:02d}", (now - 1000 + i, now - 1000 + i))


@pytest.mark.parametrize("keep", ["1", "2"])
def test_gc_prewarm_keep_equals_reference(keep, tmp_path, capsys, monkeypatch):
    """gc's ``--prewarm-keep``, which exited 2 as not ported: old plan
    epochs pruned unless a sweeper still holds a lease there, lease debris
    of done tiles removed, the active epoch kept, as the reference does."""
    now = time.time()
    outs = []
    for name, main in (("port", report.main), ("ref", jreport.main)):
        root = tmp_path / name
        _gc_tree(root)
        _prewarm_state(root / "state", now)
        monkeypatch.setenv("SBR_PREWARM_STATE_DIR", str(root / "state"))
        code = main(["gc", str(root / "runs"), "--keep", "2", "--prewarm-keep", keep])
        left = sorted(str(p.relative_to(root)) for p in (root / "state").rglob("*"))
        outs.append((code, capsys.readouterr().out.replace(str(root), "ROOT"), left))
    assert outs[0] == outs[1] and outs[0][0] == 0
    epochs = sorted({p.split("/")[1] for p in outs[0][2]})
    assert epochs == (["plan_00", "plan_04"] if keep == "1" else ["plan_00", "plan_03", "plan_04"])
    assert "state/plan_04/tile_b00001_u00000.lease" not in outs[0][2]


# -- python -m ---------------------------------------------------------------


def _cli(*argv, env=None):
    """The report in a process that exits 99 if it imported torch."""
    return subprocess.run(
        [sys.executable, "-c",
         "import sys; from sbr_tpu_torch.obs import report; code = report.main(sys.argv[1:]);"
         " sys.exit(99 if 'torch' in sys.modules else code)", *argv],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
    )


@pytest.mark.parametrize("case", ["render_json", "health_divergent", "resilience_gave_up",
                                  "elastic", "grad_nonfinite", "infomodel_breach",
                                  "memory_over", "serve_ok", "trace_orphaned", "slo_breach",
                                  "util_floor", "demand_ok", "fleet_lost", "prewarm_cold",
                                  "summary_mixed"])
def test_cli_as_a_module_loads_no_torch(run_dirs, case):
    sub, args, _, code, env = CASES[case]
    argv = ([sub] if sub else []) + [str(run_dirs[(case, "port")])] + args + (
        [] if "--json" in args else ["--json"])
    proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.obs.report", *argv],
                          capture_output=True, text=True, timeout=TIMEOUT, cwd=str(REPO),
                          env={**os.environ, "PYTHONPATH": str(REPO), **env})
    assert proc.returncode == code, proc.stderr
    assert json.loads(proc.stdout).get("exit", 0) == code
    # the same call in a process that then checks what it imported
    proc = _cli(*argv, env=env)
    assert proc.returncode == code, proc.stderr


def test_reference_cli_agrees_on_a_port_run(run_dirs):
    d = str(run_dirs[("resilience_gave_up", "port")])
    procs = [subprocess.run([sys.executable, "-m", f"{pkg}.obs.report", "resilience", d,
                             "--json"], capture_output=True, text=True, timeout=TIMEOUT,
                            cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)})
             for pkg in ("sbr_tpu_torch", "sbr_tpu")]
    assert [p.returncode for p in procs] == [1, 1]
    assert json.loads(procs[0].stdout) == json.loads(procs[1].stdout)
    assert json.loads(procs[0].stdout)["unrecovered"] == 2
