"""The port's serving engine (sbr_tpu_torch.serve) on the CPU, against
sbr_tpu.serve and against itself, at n_grid 128.

Contracts:

- against the reference engine on the same seeded pool (12 queries,
  buckets 1/8, float64, fixed and adaptive numerics): statuses and flags
  equal, floats within 1e-12 (the port's measured spread against XLA's
  ``exp`` is ~1e-14);
- against itself: a served answer equals the port's own solve_param_cell
  bit for bit, in every bucket, threaded or inline; duplicates coalesce
  into one lane;
- the result key differs from the reference's (the backend tag) while the
  params fingerprint equals it;
- the caches, admission, the breaker, /healthz and the HTTP routes (the
  scenario and population objects among them) behave as the reference's
  tests hold them; the audit and prewarm switches build their schedulers;
- the served program reads nothing from the host and makes no host
  tensor, so a CUDA graph can capture it; the adaptive root-find's
  whole-budget form equals its checked form bit for bit;
- the telemetry of the query path: with ``SBR_FLIGHT`` or ``SBR_DEMAND``
  off its module is never imported and ``/metrics`` carries none of its
  bytes; on, the engine constructs and its answers are the same bits; the
  endpoint's trace headers, echoes and ``trace_id`` fields, its
  ``worker.request`` spans against the reference endpoint's, and loadgen's
  ``--trace-out`` rows and spans against the reference loadgen's;
- a served run directory: the same query sequence (a first dispatch, a
  hit, an expired and an unmeetable deadline, then an outage through
  injected dispatch faults) logs the reference engine's ``fleet`` events
  (sheds, breaker transitions, the ladder), ``retry`` events, the
  bucket's ``serve.compile[...]`` span and its ``serve_exec`` and
  ``serve_batch`` events, and `report serve` gives the reference's
  verdict on both runs.

Every wait carries a timeout and every thread or server is closed in a
``finally``.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.serve import engine as jengine  # noqa: E402
from sbr_tpu.serve.loadgen import build_pool as ref_build_pool  # noqa: E402
from sbr_tpu.utils import checkpoint as jckpt  # noqa: E402
from sbr_tpu_torch.core import rootfind  # noqa: E402
from sbr_tpu_torch.diag.health import NAN_OUTPUT  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.serve import (  # noqa: E402
    DeadlineExceeded,
    Engine,
    LiveMetrics,
    ServeConfig,
    ServeEndpoint,
    SolverUnavailable,
)
from sbr_tpu_torch.serve import engine as tengine  # noqa: E402
from sbr_tpu_torch.serve import loadgen  # noqa: E402
from sbr_tpu_torch.serve.engine import BucketProgram, _query_columns  # noqa: E402
from sbr_tpu_torch.serve.live import GraphCounters  # noqa: E402
from sbr_tpu_torch.serve.loadgen import build_pool, http_request, params_doc, query_mix  # noqa: E402
from sbr_tpu_torch.sweeps.baseline_sweeps import solve_param_cell  # noqa: E402
from sbr_tpu_torch.utils.checkpoint import params_fingerprint  # noqa: E402
from torch_events import assert_same_events, events  # noqa: E402

CPU = "cpu"
WAIT = 120  # seconds: every wait in this file is bounded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, numerics="fixed", **kw):
    return mod.SolverConfig(n_grid=128, bisect_iters=40, refine_crossings=False,
                            numerics=numerics, **kw)


def _engine(numerics="fixed", buckets=(1, 8), dtype=torch.float64, **serve_kw):
    return Engine(config=_cfg(tparams, numerics), dtype=dtype,
                  serve=ServeConfig(buckets=buckets, **serve_kw), device=CPU)


def _bits(results):
    """Bitwise signature of per-query outputs (NaN-safe)."""
    return [(np.float64(r.xi).tobytes(), np.float64(r.tau_bar_in).tobytes(),
             np.float64(r.aw_max).tobytes(), np.float64(r.residual).tobytes(),
             r.status, r.flags) for r in results]


def _served(pool, numerics="fixed", buckets=(1, 8), start=False, **kw):
    engine = _engine(numerics, buckets, **kw)
    try:
        if start:
            engine.start()
        return engine.query_many(pool, timeout=WAIT), engine
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# Against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_engine_matches_the_reference_engine(numerics):
    pool = build_pool(11, 12)
    ref = jengine.Engine(config=_cfg(jparams, numerics),
                         serve=jengine.ServeConfig(buckets=(1, 8)))
    try:
        want = ref.query_many(ref_build_pool(11, 12), timeout=WAIT)
    finally:
        ref.close()
    got, _ = _served(pool, numerics)
    assert [r.status for r in got] == [int(r.status) for r in want]
    assert [r.flags for r in got] == [int(r.flags) for r in want]
    assert {r.status for r in got} >= {0, 1}  # runs and no-crossing cells both served
    for f in ("xi", "tau_bar_in", "aw_max", "residual"):
        a = np.array([getattr(r, f) for r in got])
        b = np.array([getattr(r, f) for r in want])
        assert np.array_equal(np.isnan(a), np.isnan(b)), f
        ok = ~np.isnan(a)
        assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= 1e-12, f


def test_result_key_carries_the_backend_tag():
    params = tparams.make_model_params(beta=1.5, u=0.2)
    ref = jengine.Engine(config=_cfg(jparams), serve=jengine.ServeConfig(buckets=(1,)))
    engine = _engine()
    try:
        assert params_fingerprint(params) == jckpt.params_fingerprint(
            jparams.make_model_params(beta=1.5, u=0.2))
        assert engine._result_key(params) != ref._result_key(
            jparams.make_model_params(beta=1.5, u=0.2))
        assert engine._cfg_tag.endswith("'torch']")
        assert engine._cfg_tag.replace(",'torch']", "]") == ref._cfg_tag
    finally:
        engine.close()
        ref.close()


# ---------------------------------------------------------------------------
# Against itself
# ---------------------------------------------------------------------------

def _eager(pool, numerics, dtype=torch.float64):
    cols = torch.from_numpy(_query_columns(pool, np.dtype(str(dtype)[6:])))
    xi, tau, aw, status, health = solve_param_cell(*cols, _cfg(tparams, numerics), dtype, CPU)
    return [(np.float64(float(a)).tobytes(), np.float64(float(b)).tobytes(),
             np.float64(float(c)).tobytes(), np.float64(float(r)).tobytes(), int(s), int(f))
            for a, b, c, r, s, f in zip(xi, tau, aw, health.residual, status, health.flags)]


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_served_answers_equal_solve_param_cell_bitwise(numerics, dtype):
    pool = build_pool(3, 10)
    got, engine = _served(pool, numerics, dtype=dtype)
    assert _bits(got) == _eager(pool, numerics, dtype)
    assert engine.graphs.eager_runs == 2 and engine.graphs.captures == 0


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_answers_bitwise_equal_across_buckets(numerics):
    pool = build_pool(3, 10)
    stream = [pool[i] for i in query_mix(3, len(pool), 24)]
    signatures = [_bits(_served(stream, numerics, buckets=(b,))[0]) for b in (1, 8, 64)]
    assert signatures[0] == signatures[1] == signatures[2]


def test_threaded_path_matches_direct():
    pool = build_pool(5, 6)
    direct, _ = _served(pool)
    threaded, engine = _served(pool, start=True)
    assert _bits(direct) == _bits(threaded)
    assert not engine._thread.is_alive()


def test_duplicates_coalesce_into_one_lane():
    p = tparams.make_model_params(beta=1.7, u=0.3)
    other = tparams.make_model_params(beta=0.8, u=0.05)
    got, engine = _served([p, other, p, p], buckets=(1, 8))
    assert [r.source for r in got] == ["computed", "computed", "coalesced", "coalesced"]
    assert engine.live.totals["batch_queries"] == 2 and engine.live.totals["padded_lanes"] == 6
    assert _bits(got[:1]) == _bits(got[2:3]) == _bits(got[3:])
    assert engine.live.totals["cache_hits"] == 2


def test_scalar_query_and_scenario_accounting():
    engine = _engine(buckets=(1,))
    try:
        r = engine.query(tparams.make_model_params(beta=1.0, u=0.1), scenario="fig4")
        assert r.source == "computed" and r.scenario == "fig4"
        r2 = engine.query(tparams.make_model_params(beta=1.0, u=0.1), scenario="fig4")
        assert r2.source == "lru" and _bits([r]) == _bits([r2])
        assert engine.live.scenarios == {"fig4": 2}
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def test_lru_eviction_bounded():
    _, engine = _served(build_pool(9, 6), lru_max=3)
    assert len(engine._lru) == 3


def test_disk_cache_survives_restart_and_verifies(tmp_path):
    pool = build_pool(6, 4)
    want, _ = _served(pool, cache_dir=str(tmp_path))
    files = sorted((tmp_path / "results").rglob("*.json"))
    assert len(files) == 4 and all((f.parent / (f.name + ".sha256")).exists() for f in files)
    got, _ = _served(pool, cache_dir=str(tmp_path))
    assert all(r.source == "disk" for r in got) and _bits(want) == _bits(got)
    # a corrupted entry is quarantined and recomputed
    files[0].write_text(files[0].read_text().replace("status", "status "))
    again, _ = _served(pool, cache_dir=str(tmp_path))
    assert sorted(r.source for r in again) == ["computed", "disk", "disk", "disk"]
    assert list((tmp_path / "results").rglob("quarantine/*.json"))
    assert _bits(again) == _bits(want)


def test_non_dict_disk_entry_recomputes(tmp_path):
    pool = build_pool(13, 2)
    want, _ = _served(pool, cache_dir=str(tmp_path))
    for f in (tmp_path / "results").rglob("*.json"):
        f.write_text("[1, 2, 3]")
        (f.parent / (f.name + ".sha256")).unlink()
    got, _ = _served(pool, cache_dir=str(tmp_path), start=True)
    assert all(r.source == "computed" for r in got) and _bits(want) == _bits(got)


def test_disk_cache_prune_bounded(tmp_path):
    engine = _engine(cache_dir=str(tmp_path), disk_cap=3)
    try:
        engine.query_many(build_pool(14, 6), timeout=WAIT)
        engine._prune_disk_cache()  # the cadence is every 512 writes
        assert len(list((tmp_path / "results").rglob("*.json"))) == 3
        assert len(list((tmp_path / "results").rglob("*.sha256"))) == 3
    finally:
        engine.close()


def test_divergent_results_served_but_never_cached(tmp_path, monkeypatch):
    engine = _engine(buckets=(1,), cache_dir=str(tmp_path))
    rec = {"xi": float("nan"), "tau_bar_in": 0.0, "aw_max": float("nan"),
           "status": 0, "flags": int(NAN_OUTPUT), "residual": float("nan")}
    monkeypatch.setattr(engine, "_dispatch", lambda params: [dict(rec) for _ in params])
    try:
        r1 = engine.query(tparams.make_model_params())
        assert r1.divergent and r1.source == "computed"
        assert engine.query(tparams.make_model_params()).source == "computed"
        assert len(engine._lru) == 0 and not list((tmp_path / "results").rglob("*.json"))
        assert engine.live.totals["divergent_cells"] == 2
        assert engine.healthz()["status"] == "degraded"
    finally:
        engine.close()


def test_serveconfig_normalizes_buckets(monkeypatch):
    assert ServeConfig(buckets=(64, 8, 1)).buckets == (1, 8, 64)
    with pytest.raises(ValueError):
        ServeConfig(buckets=(0, 8))
    monkeypatch.setenv("SBR_SERVE_BUCKETS", "16,2")
    assert tengine.default_buckets() == (2, 16) == jengine.default_buckets()
    monkeypatch.setenv("SBR_SERVE_BUCKETS", "x")
    assert tengine.default_buckets() == (1, 8, 64, 512)
    monkeypatch.setenv("SBR_SERVE_LRU", "7")
    monkeypatch.setenv("SBR_SERVE_DISK_CAP", "9")
    assert (ServeConfig.from_env().lru_max, ServeConfig.from_env().disk_cap) == (7, 9)


# ---------------------------------------------------------------------------
# Admission, failure, health
# ---------------------------------------------------------------------------

def test_expired_and_unmeetable_deadlines_are_shed():
    engine = _engine(buckets=(1,))
    try:
        with pytest.raises(DeadlineExceeded) as err:
            engine.query(tparams.make_model_params(), deadline_ms=-1)
        assert err.value.retry_after_s == 0.05
        engine.query(tparams.make_model_params(), deadline_ms=60_000)
        engine._service_ewma_s = 5.0
        with pytest.raises(DeadlineExceeded, match="service time"):
            engine.query_many([tparams.make_model_params(u=0.3)], deadline_ms=10)
        # a ticket that expired while queued is shed at batch formation
        ticket = tengine._Ticket(tparams.make_model_params(u=0.4), "q",
                                 engine._result_key(tparams.make_model_params(u=0.4)),
                                 deadline=0.0)
        engine._process([ticket])
        with pytest.raises(DeadlineExceeded, match="queued"):
            ticket.wait(1.0)
        assert engine.live.totals["shed"] == 3
        assert engine.healthz()["status"] == "degraded"
    finally:
        engine.close()


def test_service_estimate_is_none_until_a_dispatch():
    """`service_estimate_s` as the reference engine's: None before any
    dispatch, then the dispatch durations' EWMA, a positive float."""
    ref = jengine.Engine(config=_cfg(jparams), serve=jengine.ServeConfig(buckets=(1,)))
    engine = _engine(buckets=(1,))
    try:
        assert ref.service_estimate_s() is None and engine.service_estimate_s() is None
        ref.query(jparams.make_model_params(), timeout=WAIT)
        engine.query(tparams.make_model_params(), timeout=WAIT)
        for e in (ref, engine):
            est = e.service_estimate_s()
            assert isinstance(est, float) and est > 0.0 and est == e._service_ewma_s
        first = engine.service_estimate_s()
        engine.query(tparams.make_model_params(u=0.3), timeout=WAIT)
        # 0.3 of the second dispatch's duration over 0.7 of the first estimate
        assert engine.service_estimate_s() > 0.7 * first
    finally:
        ref.close()
        engine.close()


def test_dispatch_failure_fails_tickets_and_counts_errors(monkeypatch):
    engine = _engine(buckets=(1,))
    try:
        monkeypatch.setattr(engine, "_dispatch",
                            lambda params: (_ for _ in ()).throw(RuntimeError("boom")))
        with pytest.raises(RuntimeError, match="boom"):
            engine.query(tparams.make_model_params())
        assert engine.live.totals["errors"] == 1
        assert engine.healthz()["status"] == "degraded"
    finally:
        engine.close()


def test_breaker_opens_after_failed_dispatches(monkeypatch):
    monkeypatch.setenv("SBR_SERVE_RETRY_BASE_DELAY_S", "0")
    monkeypatch.setenv("SBR_BREAKER_COOLDOWN_S", "3600")
    engine = _engine(buckets=(1,))

    def broken(bucket, cols):
        def run(cols):
            raise RuntimeError("device lost")
        return run

    monkeypatch.setattr(engine, "_program", broken)
    try:
        for i in range(3):  # threshold 3: each dispatch retries once
            with pytest.raises(RuntimeError):
                engine.query(tparams.make_model_params(u=0.1 + i / 10))
        assert engine.breaker.state == "open" and engine.retry_budget.used == 3
        with pytest.raises(SolverUnavailable):
            engine.query(tparams.make_model_params(u=0.9))
        doc = engine.healthz()
        assert doc["status"] == "degraded" and any("breaker open" in r for r in doc["reasons"])
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# The degradation ladder's tile-cache rung
# ---------------------------------------------------------------------------

LADDER_BETAS = np.linspace(0.5, 2.0, 4)
LADDER_US = np.linspace(0.05, 0.5, 4)


@pytest.fixture(scope="module")
def swept_cache(tmp_path_factory):
    """One small tiled sweep whose tiles land in a tile cache, at the
    engine's config."""
    from sbr_tpu_torch.resilience import TileCache
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    root = tmp_path_factory.mktemp("swept_cache")
    base = tparams.make_model_params()
    grid = run_tiled_grid(LADDER_BETAS, LADDER_US, base, config=_cfg(tparams),
                          tile_shape=(2, 2), checkpoint_dir=root / "ckpt",
                          tile_cache=TileCache(root / "tile_cache"), device=CPU)
    return base, root / "tile_cache", grid


def _cell_params(base, beta, u):
    """The params whose solve is sweep cell (β, u): the swept β and u with
    the base's pinned η, tspan and x0."""
    return tparams.make_model_params(beta=float(beta), u=float(u), eta=base.economic.eta,
                                     tspan=base.learning.tspan, x0=base.learning.x0)


def _open_breaker(engine):
    for _ in range(engine.breaker.threshold):
        engine.breaker.record_failure()
    assert engine.breaker.state == "open"


def test_store_writes_meta_and_bridge_finds_cell(swept_cache):
    from sbr_tpu_torch.serve.fleet import TileCacheBridge

    base, cache_dir, grid = swept_cache
    metas = list(cache_dir.rglob("*.meta.json"))
    assert len(metas) == 4
    assert set(json.loads(metas[0].read_text())) == {"key", "cell_tag", "betas", "us"}
    bridge = TileCacheBridge(cache_dir)
    q = _cell_params(base, LADDER_BETAS[1], LADDER_US[2])
    rec = bridge.lookup(q, _cfg(tparams), "float64")
    assert np.float64(rec["xi"]).tobytes() == grid.xi.numpy()[1, 2].tobytes()
    assert rec["status"] == int(grid.status[1, 2]) and rec["flags"] == 0
    other = tparams.SolverConfig(n_grid=128, bisect_iters=31, refine_crossings=False,
                                 numerics="fixed")
    assert bridge.lookup(q, other, "float64") is None  # another config: another tag
    assert bridge.lookup(q, _cfg(tparams), "float32") is None
    assert bridge.lookup(_cell_params(base, 1.2345, LADDER_US[2]), _cfg(tparams),
                         "float64") is None  # off the swept axes
    assert TileCacheBridge(cache_dir / "missing").lookup(q, _cfg(tparams), "float64") is None


def test_solver_outage_answered_from_tile_cache(swept_cache, monkeypatch):
    base, cache_dir, grid = swept_cache
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(cache_dir))
    monkeypatch.setenv("SBR_BREAKER_COOLDOWN_S", "3600")
    engine = _engine(buckets=(1, 8))
    try:
        _open_breaker(engine)  # the solver path is down
        qs = [_cell_params(base, b, u) for b in LADDER_BETAS for u in LADDER_US]
        res = engine.query_many(qs, timeout=WAIT)
        assert all(r.degraded and r.source == "tilecache" for r in res)
        assert np.array([r.xi for r in res]).tobytes() == grid.xi.numpy().tobytes()
        assert np.array([r.aw_max for r in res]).tobytes() == grid.max_aw.numpy().tobytes()
        assert [r.status for r in res] == grid.status.numpy().ravel().tolist()
        assert all(np.isnan(r.tau_bar_in) for r in res)  # tiles do not store it
        snap = engine.statz()
        assert snap["totals"]["degraded"] == 16 and snap["window"]["degraded"] == 16
        assert snap["ladder"] == {"tile_cache": True, "degraded": 16, "ladder_exhausted": 0}
        assert any("degraded-ladder" in r for r in snap["healthz"]["reasons"])
        assert engine.healthz()["status"] == "degraded"
        assert len(engine._lru) == 0  # degraded answers are never cached
    finally:
        engine.close()


def test_outage_without_matching_tile_fails_and_counts_ladder_exhausted(swept_cache,
                                                                      monkeypatch):
    _, cache_dir, _ = swept_cache
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(cache_dir))
    monkeypatch.setenv("SBR_BREAKER_COOLDOWN_S", "3600")
    engine = _engine(buckets=(1,))
    try:
        _open_breaker(engine)
        with pytest.raises(SolverUnavailable):
            engine.query(tparams.make_model_params(beta=1.27, u=0.33))
        assert engine.statz()["ladder"]["ladder_exhausted"] == 1
        assert engine.live.totals["errors"] == 1 and engine.live.totals["degraded"] == 0
    finally:
        engine.close()


def test_serve_dispatch_fault_drives_the_ladder(swept_cache, monkeypatch):
    """``serve.dispatch`` failing at p = 1: the retried dispatch exhausts
    into an outage; grid points answer from the tile cache bit for bit, a
    point off the grid fails."""
    from sbr_tpu_torch.resilience import FaultPlan, faults

    base, cache_dir, grid = swept_cache
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(cache_dir))
    monkeypatch.setenv("SBR_SERVE_RETRY_BASE_DELAY_S", "0")
    faults.install(FaultPlan({"seed": 0, "rules": [
        {"point": "serve.dispatch", "kind": "transient", "p": 1.0}]}))
    engine = _engine(buckets=(1, 8))
    try:
        qs = [_cell_params(base, LADDER_BETAS[i], LADDER_US[j]) for i, j in ((0, 1), (3, 3))]
        res = engine.query_many(qs, timeout=WAIT)
        assert [r.degraded for r in res] == [True, True]
        assert np.float64(res[0].xi).tobytes() == grid.xi.numpy()[0, 1].tobytes()
        assert np.float64(res[1].xi).tobytes() == grid.xi.numpy()[3, 3].tobytes()
        with pytest.raises(RuntimeError):
            engine.query(tparams.make_model_params(beta=1.27, u=0.33))
        assert engine.statz()["ladder"]["ladder_exhausted"] == 1
        assert faults.plan().firings[0]["target"] == "bucket8"
    finally:
        engine.close()
        faults.install(None)


def test_healthz_degraded_and_unhealthy_and_refill(monkeypatch):
    monkeypatch.setenv("SBR_SERVE_RETRY_REFILL_S", "3600")
    engine = _engine(buckets=(1,))
    try:
        assert engine.healthz() == {"status": "ready", "reasons": []}
        engine.live.record_query(0.001, "computed", divergent=True)
        assert engine.healthz()["status"] == "degraded"
        while engine.retry_budget.take():
            pass
        doc = engine.healthz()
        assert doc["status"] == "unhealthy" and any("budget" in r for r in doc["reasons"])
        engine.retry_budget._epoch -= 3600  # the refill period lapses
        assert engine.healthz()["status"] == "degraded"  # the divergent cell stays
    finally:
        engine.close()


def test_submit_after_close_raises():
    engine = _engine(buckets=(1,)).start()
    engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(tparams.make_model_params())
    with pytest.raises(RuntimeError, match="closed"):
        engine.query_many([tparams.make_model_params()])
    engine.close()  # idempotent


def test_statz_and_prometheus_carry_the_graph_counters():
    pool = build_pool(2, 3)
    engine = _engine(buckets=(1, 8))
    try:
        engine.query_many(pool + pool, timeout=WAIT)
        doc = engine.statz()
        assert doc["totals"]["queries"] == 6 and doc["window"]["hit_rate"] == 0.5
        assert doc["graphs"] == {"captured": {}, "captured_grads": {}, "captures": 0,
                                 "replays": 0, "capture_s": 0.0, "eager_runs": 1}
        assert doc["engine"]["aot"] == "unsupported (CUDA graphs are per-process)"
        assert doc["engine"]["backend"] == "torch" and doc["healthz"]["status"] == "ready"
        text = engine.prometheus()
        for line in ("sbr_serve_queries_total 6", "sbr_serve_cache_hits_total 3",
                     "sbr_serve_graph_captures_total 0", "sbr_serve_eager_runs_total 1",
                     "sbr_serve_lru_entries 3", 'le="+Inf"'):
            assert line in text, line
    finally:
        engine.close()


def test_live_metrics_window_and_graph_lines():
    clock = [0.0]
    graphs = GraphCounters()
    live = LiveMetrics(window_s=12.0, time_fn=lambda: clock[0], graphs=graphs)
    live.record_query(0.001, "computed")
    live.record_batch(1, 8)
    assert live.window()["queries"] == 1 and live.window()["occupancy"] == 0.125
    clock[0] += 100.0
    assert live.window()["queries"] == 0 and live.totals["queries"] == 1
    for i in range(200):
        live.record_query(0.001, "lru", scenario=f"tag{i}")
    assert live.scenarios["_other"] == 201 - LiveMetrics._MAX_SCENARIOS
    graphs.captured.update({8: 1, 64: 1})
    graphs.replays = 5
    text = live.to_prometheus()
    assert "sbr_serve_graph_captures_total 2" in text
    assert "sbr_serve_graph_replays_total 5" in text
    assert 'sbr_serve_bucket_graphs{bucket="64"} 1' in text
    assert live.maybe_write(None) is False

    class _Run:  # records what the engine's run would write as live.json
        def __init__(self):
            self.docs = []

        def live_snapshot(self, doc):
            self.docs.append(doc)

    run = _Run()
    assert live.write_due() and live.maybe_write(run) is True
    assert run.docs[-1]["totals"]["queries"] == 201 and run.docs[-1]["graphs"]
    assert not live.write_due() and live.maybe_write(run) is False  # throttled
    assert live.maybe_write(run, force=True) is True and len(run.docs) == 2
    clock[0] += 1.0
    assert live.maybe_write(object()) is False  # a failed write never raises


# ---------------------------------------------------------------------------
# The endpoint
# ---------------------------------------------------------------------------

def test_endpoint_routes_and_status_codes():
    engine = _engine(buckets=(1, 8)).start()
    endpoint = None
    try:
        endpoint = ServeEndpoint(engine).start()
        port = endpoint.port
        pool = build_pool(11, 3)
        for p in pool:
            code, body, _ = http_request(port, "/query", params_doc(p))
            assert code == 200, body
            doc = json.loads(body)
            direct = engine.query(p, timeout=WAIT)
            assert (doc["status"], doc["flags"]) == (direct.status, direct.flags)
            assert doc["xi"] == (None if np.isnan(direct.xi) else direct.xi)
        code, body, hdrs = http_request(port, "/query", params_doc(pool[0]),
                                        {"X-SBR-Deadline-Ms": "-1"})
        assert code == 429 and float(hdrs["Retry-After"]) > 0
        assert json.loads(body)["error"] == "deadline"
        assert http_request(port, "/query", {"bta": 1.0})[0] == 400
        assert http_request(port, "/query", {"beta": -1.0})[0] == 400
        assert http_request(port, "/query", {"beta": 1.0, "r": 0.02})[0] == 400
        assert http_request(port, "/query", {"beta": 1.0}, {"X-SBR-Deadline-Ms": "x"})[0] == 400
        # the scenario and population routes answer: a spec the params cannot
        # serve (interest without r/delta) and a population without a graph
        # are the client's errors; a grads query answers with its partials
        for doc, reason in (({"scenario": {"modifiers": ["interest"]}}, "unservable scenario"),
                            ({"population": {"seeds": 2}}, "bad population")):
            code, body, _ = http_request(port, "/query", doc)
            assert code == 400 and reason in json.loads(body)["error"], doc
        code, body, _ = http_request(port, "/query", {"grads": True})
        assert code == 200 and set(json.loads(body)["grads"]) == {"beta", "u", "kappa"}
        code, body, _ = http_request(port, "/query", {"u": 0.08, "lolr_rate": 0.1,
                                                      "scenario": {"modifiers": ["lolr"]}})
        assert code == 200 and json.loads(body)["source"] == "computed"
        code, metrics, _ = http_request(port, "/metrics")
        assert code == 200 and "sbr_serve_queries_total 8" in metrics
        code, health, _ = http_request(port, "/healthz")
        assert code == 200 and json.loads(health)["status"] == "degraded"  # the 429 shed
        code, statz, _ = http_request(port, "/statz")
        assert code == 200 and json.loads(statz)["totals"]["queries"] == 8
        assert http_request(port, "/nope")[0] == 404
        assert http_request(port, "/nope", {})[0] == 404
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()


def test_endpoint_close_without_start_returns():
    engine = _engine(buckets=(1,))
    try:
        ServeEndpoint(engine).close()  # must return, not deadlock
    finally:
        engine.close()


def test_endpoint_answers_503_on_a_failed_dispatch(monkeypatch):
    engine = _engine(buckets=(1,))
    monkeypatch.setattr(engine, "_dispatch",
                        lambda params: (_ for _ in ()).throw(RuntimeError("boom")))
    endpoint = ServeEndpoint(engine).start()
    try:
        code, body, _ = http_request(endpoint.port, "/query", {"beta": 1.0})
        assert code == 503 and "boom" in body
    finally:
        endpoint.close()
        engine.close()


# ---------------------------------------------------------------------------
# The load generator
# ---------------------------------------------------------------------------

def test_loadgen_assert_warm_on_the_cpu(capsys):
    rc = loadgen.main(["--queries", "40", "--pool", "6", "--n-grid", "96", "--bisect-iters",
                       "30", "--buckets", "1,8", "--device", "cpu", "--assert-warm"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert summary["cache_hit_rate"] == 1.0 and summary["post_warmup_graph_captures"] == 0
    assert summary["healthz"]["status"] == "ready" and summary["statz_ok"]
    assert summary["queries"] == 40 and summary["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--buckets", "-4"], ["--buckets", "x"], ["--buckets", ",,"]])
def test_loadgen_setup_errors_exit_2(argv, capsys):
    assert loadgen.main(argv + ["--device", "cpu"]) == 2
    assert "bad --buckets" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The captured program: no host reads, and the whole-budget root-find
# ---------------------------------------------------------------------------

class _HostTouches(TorchDispatchMode):
    """Counts the ops a CUDA graph cannot capture: host reads of a tensor
    (``_local_scalar_dense``) and tensors made from host data
    (``lift_fresh``, a host-to-device copy on the card)."""

    def __init__(self):
        super().__init__()
        self.touches = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = str(func)
        if "_local_scalar_dense" in name or "lift_fresh" in name:
            self.touches.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("refine", [False, True])
def test_served_program_is_capturable(numerics, refine):
    cfg = tparams.SolverConfig(n_grid=128, bisect_iters=30, refine_crossings=refine,
                               numerics=numerics)
    program = BucketProgram(8, cfg, torch.float64, torch.device(CPU), GraphCounters(),
                            _query_columns(build_pool(4, 8), np.float64))
    mode = _HostTouches()
    with mode:
        out = program.solve()
    assert mode.touches == [] and mode.ops > 1000
    assert out.shape == (6, 8)
    # outside no_host_reads the adaptive loop checks the host
    if numerics == "adaptive":
        mode = _HostTouches()
        with mode:
            solve_param_cell(*program.inputs, cfg, torch.float64, CPU)
        assert "aten._local_scalar_dense.default" in mode.touches


def _health_bits(x, h):
    return [t.numpy().tobytes() for t in (x, h.residual, h.bracket_width, h.iterations, h.flags)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_x0", [False, True])
@pytest.mark.parametrize("nan_lanes", [False, True])
def test_chandrupatla_whole_budget_equals_checked_form(dtype, with_x0, nan_lanes):
    g = np.random.default_rng(7)
    n = 257
    lo = torch.tensor(g.uniform(-3, 0, n), dtype=dtype)
    hi = torch.tensor(g.uniform(0.5, 4, n), dtype=dtype)
    hi[:9] = lo[:9] - 1.0  # lanes that do not bracket
    if nan_lanes:
        lo[9:12] = float("nan")  # they never converge: the whole budget
    shift = torch.tensor(g.uniform(-0.5, 0.5, n), dtype=dtype)

    def f(x):
        return torch.tanh(3 * (x - shift)) + 0.1 * (x - shift) ** 3

    kw = dict(budget=60, with_health=True, x0=(shift + 0.1) if with_x0 else None)
    checked = rootfind.chandrupatla(f, lo, hi, **kw)
    with rootfind.no_host_reads():
        whole = rootfind.chandrupatla(f, lo, hi, **kw)
    assert _health_bits(*checked) == _health_bits(*whole)
    # without NaN lanes the checked form stops early, yet agrees
    assert (int(checked[1].iterations.max()) == 60) == nan_lanes


def test_prefix_sum_is_row_independent_and_accurate():
    """The card's cumulative integrals use `prefix_sum` (see its module):
    a row's bits depend on that row alone, its error is within a few ulp
    of the exact sum, and on the CPU the integrals keep torch.cumsum."""
    import math

    from sbr_tpu_torch.core import integrate

    g = np.random.default_rng(2)
    for dtype, tol in ((torch.float64, 4e-16), (torch.float32, 2e-7)):
        x = torch.tensor(g.random((33, 1000)), dtype=dtype)
        full = integrate.prefix_sum(x)
        for rows in (1, 2, 7):
            assert torch.equal(integrate.prefix_sum(x[:rows].clone()), full[:rows])
        exact = np.array([[math.fsum(r[: j + 1]) for j in range(0, 1000, 37)]
                          for r in x.double().numpy()])
        err = np.abs(full.double().numpy()[:, ::37] - exact).max() / exact.max()
        assert err < tol, err
    y = torch.tensor(g.random((3, 50)))
    assert torch.equal(integrate._cum_from_zero(y)[:, 1:], torch.cumsum(y, -1))


# ---------------------------------------------------------------------------
# Not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["grads_query", "grads_many", "grads_submit"])
def test_unported_queries_raise(call):
    """Grads queries raised before the gradient layer was ported; each way
    in now answers with dξ/d{β, u, κ} beside the plain answer's ξ (their
    values are held to grad.api in tests/test_torch_grad.py)."""
    engine = _engine(buckets=(1,))
    if call == "grads_submit":
        engine.start()
    p = tparams.make_model_params()
    try:
        res = {
            "grads_query": lambda: engine.query(p, grads=True),
            "grads_many": lambda: engine.query_many([p], grads=True)[0],
            "grads_submit": lambda: engine.submit(p, grads=True).wait(WAIT),
        }[call]()
        plain = engine.query(p, timeout=WAIT)
    finally:
        engine.close()
    assert set(res.grads) == {"beta", "u", "kappa"} and res.grad_flags == 0
    assert plain.grads is None and plain.grad_flags is None
    assert np.float64(res.xi).tobytes() == np.float64(plain.xi).tobytes()


@pytest.mark.parametrize("call", ["scenario", "population"])
def test_scenario_and_population_queries_are_served(call):
    """The two routes that raised before they were ported: each answers,
    a second time from the LRU, under the engine's admission control, and
    a malformed query is the caller's ValueError."""
    from sbr_tpu_torch.scenario import ScenarioSpec

    engine = _engine(buckets=(1,))
    p = tparams.make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    pop = {"graph": {"n": 400, "avg_degree": 8}, "infomodel": {"channel": "bayes"},
           "seeds": 2}
    ask, bad = {
        "scenario": (lambda: engine.query_scenario(p, ScenarioSpec(modifiers=("lolr",))),
                     lambda: engine.query_scenario(p, ScenarioSpec(modifiers=("interest",)))),
        "population": (lambda: engine.query_population(p, pop),
                       lambda: engine.query_population(p, {})),
    }[call]
    try:
        first, again = ask(), ask()
        with pytest.raises(ValueError):
            bad()
        with pytest.raises(DeadlineExceeded):
            (engine.query_scenario(p, ScenarioSpec(), deadline_ms=-1) if call == "scenario"
             else engine.query_population(p, pop, deadline_ms=-1))
    finally:
        engine.close()
    assert (first["source"], again["source"]) == ("computed", "lru")
    key = f"{call}_fingerprint"
    assert first[key] == again[key] and len(first[key]) == 64


@pytest.mark.parametrize("kw", [{"run": object()}, {"run_dir": "runs/x"}])
def test_run_directories_raise(kw, tmp_path):
    """Run directories raised before the run log's wiring was ported; an
    engine given ``run=`` now logs onto that run, and one given ``run_dir``
    owns a run there, finalized with ``live.json`` at close."""
    from sbr_tpu_torch import obs

    p = tparams.make_model_params()
    if "run" in kw:
        with obs.run_context(run_dir=str(tmp_path / "outer")) as run:
            engine = Engine(device=CPU, run=run, serve=ServeConfig(buckets=(1,)))
            engine.query(p)
            engine.close()
        run_dir = run.run_dir
    else:
        run_dir = tmp_path / kw["run_dir"]
        engine = Engine(device=CPU, run_dir=str(run_dir), serve=ServeConfig(buckets=(1,)))
        engine.query(p)
        engine.close()
        assert obs.current_run() is None  # the engine's own run is finalized
    live = json.loads((run_dir / "live.json").read_text())
    assert live["totals"]["queries"] == 1
    kinds = [json.loads(line)["kind"] for line in
             (run_dir / "events.jsonl").read_text().splitlines()]
    assert "serve_batch" in kinds and kinds.count("serve_summary") == 1


@pytest.mark.parametrize("value", ["0", "1"])
def test_prewarm_switch_builds_a_controller(value, monkeypatch, tmp_path):
    """``SBR_PREWARM``, which raised as not ported: off builds no
    controller, on builds one on the engine's device and dtype (started
    with the engine, closed with it), and neither changes an answer."""
    monkeypatch.setenv("SBR_PREWARM", value)
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("SBR_PREWARM_PLAN", str(tmp_path / "no_plan.json"))
    engine = Engine(config=tparams.SolverConfig(n_grid=64, bisect_iters=20,
                                                refine_crossings=False),
                    dtype=torch.float32, device=CPU)
    try:
        engine.start()
        res = engine.query(tparams.make_model_params())
        if value == "0":
            assert engine.prewarm is None and "sbr_prewarm" not in engine.prometheus()
        else:
            assert (engine.prewarm._device, engine.prewarm._dtype) == (engine.device,
                                                                     torch.float32)
            assert engine.prewarm._thread.is_alive()
            assert engine.statz()["prewarm"]["status"] in ("idle", "no_cache")
    finally:
        engine.close()
    if value == "1":
        assert not engine.prewarm._thread.is_alive()
    assert res.status == 0 and np.isfinite(res.xi)


@pytest.mark.parametrize("value", ["0", "1"])
def test_audit_switch_builds_a_scheduler(value, monkeypatch, tmp_path):
    """``SBR_AUDIT``, which raised as not ported: off builds no scheduler,
    on builds one on the engine's device and dtype (started with the
    engine, closed with it), and neither changes an answer."""
    monkeypatch.setenv("SBR_AUDIT", value)
    monkeypatch.setenv("SBR_AUDIT_INTERVAL_S", "3600")
    monkeypatch.setenv("SBR_AUDIT_REGISTRY_DIR", str(tmp_path))
    engine = Engine(config=tparams.SolverConfig(n_grid=64, bisect_iters=20,
                                                refine_crossings=False),
                    dtype=torch.float32, device=CPU)
    try:
        engine.start()
        res = engine.query(tparams.make_model_params())
        if value == "0":
            assert engine.audit is None and "sbr_audit" not in engine.prometheus()
        else:
            assert (engine.audit.device, engine.audit.dtype) == (engine.device, torch.float32)
            assert engine.audit._thread.is_alive()
            assert engine.statz()["audit"]["status"] == "pending"
    finally:
        engine.close()
    if value == "1":
        assert not engine.audit._thread.is_alive()
    assert res.status == 0 and np.isfinite(res.xi)


def test_engine_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()


# ---------------------------------------------------------------------------
# The served run directory
# ---------------------------------------------------------------------------


def _served_run(pkg, run_dir):
    """One query sequence through an engine that owns ``run_dir``."""
    from sbr_tpu.resilience import faults as jfaults
    from sbr_tpu_torch.resilience import faults as tfaults

    if pkg == "ref":
        mod, faults_mod, P = jengine, jfaults, jparams
        engine = jengine.Engine(config=_cfg(jparams), serve=jengine.ServeConfig(buckets=(1, 8)),
                                run_dir=str(run_dir))
    else:
        mod, faults_mod, P = tengine, tfaults, tparams
        engine = Engine(config=_cfg(tparams), serve=ServeConfig(buckets=(1, 8)),
                        run_dir=str(run_dir), device=CPU)
    try:
        engine.query_many([P.make_model_params(), P.make_model_params(u=0.2)])
        engine.query(P.make_model_params())  # an LRU hit
        for deadline_ms in (-1.0, 1e-9):  # expired, then under the service estimate
            with pytest.raises(mod.DeadlineExceeded):
                engine.query(P.make_model_params(u=0.3), deadline_ms=deadline_ms)
        faults_mod.install(faults_mod.FaultPlan({"seed": 0, "rules": [
            {"point": "serve.dispatch", "kind": "transient"}]}))
        for u in (0.3, 0.4):  # the second finds the breaker open
            with pytest.raises(Exception):
                engine.query(P.make_model_params(u=u))
        ladder = engine.statz().get("ladder")
    finally:
        faults_mod.install(None)
        engine.close()
    return events(run_dir), ladder


def test_served_run_events_equal_the_reference(tmp_path, monkeypatch):
    from sbr_tpu.obs import report as jreport
    from sbr_tpu_torch.obs import report

    for var in ("SBR_SERVE_SLO_MS", "SBR_SERVE_CACHE_FLOOR", "SBR_SERVE_WARMUP",
                "SBR_TILE_CACHE_DIR", "SBR_SERVE_DEADLINE_MS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SBR_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("SBR_BREAKER_COOLDOWN_S", "600")
    monkeypatch.setenv("SBR_SERVE_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("SBR_SERVE_RETRY_BASE_DELAY_S", "0.001")
    _served_run("ref", tmp_path / "warm")  # the reference traces its batch program once
    want, _ = _served_run("ref", tmp_path / "ref")
    got, ladder = _served_run("port", tmp_path / "port")
    assert_same_events(got, want, {"fleet", "retry", "serve_exec", "serve_batch",
                                   "stage_start", "stage_end", "serve_summary"},
                       # times, and the backend's own counters: XLA compiles in the
                       # reference's summary, CUDA-graph counts in the port's
                       dropped=("error", "uptime_s", "started_at", "latency_ms", "window",
                                "totals", "graphs", "compile", "service_est_s"))
    fleet = [(e["action"], e.get("reason")) for e in got if e["kind"] == "fleet"]
    assert fleet == [("shed", "expired"), ("shed", "unmeetable"), ("breaker_open", None),
                     ("ladder_exhausted", None), ("ladder_exhausted", None)]
    assert ladder == {"tile_cache": False, "degraded": 0, "ladder_exhausted": 2}
    for mod, d in ((report, tmp_path / "port"), (jreport, tmp_path / "ref")):
        doc, code = mod.serve_doc(d)
        assert code == 0 and doc["live"]["totals"]["queries"] == 3


# ---------------------------------------------------------------------------
# Telemetry of the query path: tracing, the flight recorder, demand
# ---------------------------------------------------------------------------

_NO_OP_PROBE = r"""
import json, os, sys
import numpy as np
from sbr_tpu_torch.models.params import SolverConfig, make_model_params
from sbr_tpu_torch.serve import Engine, ServeConfig
out = {}
for var in ("", "SBR_FLIGHT", "SBR_DEMAND"):
    if var:
        os.environ[var] = "1"
    engine = Engine(config=SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False),
                    serve=ServeConfig(buckets=(1, 8)), device="cpu")
    try:
        res = engine.query_many([make_model_params(), make_model_params(u=0.2)])
        text = engine.prometheus()
        statz = json.dumps(engine.statz())
    finally:
        engine.close()
    out[var or "off"] = {
        "modules": sorted(m for m in ("sbr_tpu_torch.obs.flight", "sbr_tpu_torch.obs.demand")
                          if m in sys.modules),
        "metrics": [w for w in ("sbr_flight", "sbr_demand") if w in text],
        "statz": [w for w in ('"flight"', '"demand"') if w in statz],
        "bits": [np.float64(r.xi).tobytes().hex() for r in res],
    }
    if var:
        del os.environ[var]
print(json.dumps(out))
"""


def test_switches_off_are_structural_no_ops():
    """In a fresh process: with both switches off neither module is
    imported and neither shows on /metrics or /statz; each switch on
    imports its own module only and adds its own lines; the answers are
    the same bits throughout."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("SBR_FLIGHT", "SBR_DEMAND", "SBR_TRACE_SAMPLE")}
    proc = subprocess.run([sys.executable, "-c", _NO_OP_PROBE], capture_output=True, text=True,
                          timeout=WAIT, cwd=str(repo), env={**env, "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["off"]["modules"] == [] and out["off"]["metrics"] == [] == out["off"]["statz"]
    assert out["SBR_FLIGHT"]["modules"] == ["sbr_tpu_torch.obs.flight"]
    assert out["SBR_FLIGHT"]["metrics"] == ["sbr_flight"]
    assert out["SBR_FLIGHT"]["statz"] == ['"flight"']
    assert out["SBR_DEMAND"]["metrics"] == ["sbr_demand"]
    assert out["SBR_DEMAND"]["statz"] == ['"demand"']
    assert out["off"]["bits"] == out["SBR_FLIGHT"]["bits"] == out["SBR_DEMAND"]["bits"]


@pytest.mark.parametrize("switches", [("SBR_FLIGHT",), ("SBR_DEMAND",),
                                      ("SBR_FLIGHT", "SBR_DEMAND", "SBR_TRACE_SAMPLE")])
def test_answers_are_bitwise_equal_with_recorders_on(switches, monkeypatch, tmp_path):
    from sbr_tpu_torch.obs import flight, trace

    for var in ("SBR_FLIGHT", "SBR_DEMAND", "SBR_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    pool = build_pool(3, 10)
    mix = [pool[i] for i in query_mix(3, 10, 24)]
    off, _ = _served(mix, start=True)
    for var in switches:
        monkeypatch.setenv(var, "1")
    flight.reset_shared()
    engine = Engine(config=_cfg(tparams), serve=ServeConfig(buckets=(1, 8)),
                    run_dir=str(tmp_path / "run"), device=CPU).start()
    try:
        traces = [trace.mint("loadgen") for _ in mix]
        on = engine.query_many(mix, timeout=WAIT, traces=traces)
        for c in traces:
            engine.trace_writer().commit(c)
    finally:
        engine.close()
    assert _bits(on) == _bits(off)
    written = {f.name for f in (tmp_path / "run").iterdir()}
    assert ("flight.json" in written) == ("SBR_FLIGHT" in switches)
    assert ({"demand.json", "advisor_plan.json"} <= written) == ("SBR_DEMAND" in switches)
    assert ("trace.jsonl" in written) == ("SBR_TRACE_SAMPLE" in switches)


def _traced_endpoint_run(pkg, monkeypatch):
    """Three POSTs carrying a trace header (a miss, a hit, a shed) through
    ``pkg``'s endpoint; returns (codes, echoed ids, body ids, spans)."""
    if pkg == "ref":
        from sbr_tpu.obs import trace as tr
        from sbr_tpu.serve.endpoint import ServeEndpoint as EP

        engine = jengine.Engine(config=_cfg(jparams), serve=jengine.ServeConfig(buckets=(1,)))
    else:
        from sbr_tpu_torch.obs import trace as tr

        EP = ServeEndpoint
        engine = _engine(buckets=(1,))
    ctxs = []
    real = tr.from_headers

    def keep(*a, **k):
        ctxs.append(real(*a, **k))
        return ctxs[-1]

    monkeypatch.setattr(tr, "from_headers", keep)
    engine.start()
    endpoint, out = None, []
    try:
        endpoint = EP(engine).start()
        for k, deadline in enumerate((None, None, "-1")):
            hdrs = {"X-SBR-Trace-Id": f"{k:016x}", "X-SBR-Parent-Span": "0000feed"}
            if deadline:
                hdrs["X-SBR-Deadline-Ms"] = deadline
            code, body, got = http_request(endpoint.port, "/query", {"beta": 1.5, "u": 0.3},
                                           hdrs)
            out.append((code, got.get("X-SBR-Trace-Id"), json.loads(body).get("trace_id")))
        # the handler adds its root span after the response has gone out
        deadline = time.monotonic() + WAIT
        while not all(any(sp["name"] == "worker.request" for sp in c.spans) for c in ctxs):
            assert time.monotonic() < deadline, "a request's root span never landed"
            time.sleep(0.01)
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()
    return out, [c.spans for c in ctxs]


def test_endpoint_spans_and_echoes_equal_the_reference(monkeypatch):
    from torch_telemetry import span_structure

    monkeypatch.delenv("SBR_TRACE_SAMPLE", raising=False)
    want, want_spans = _traced_endpoint_run("ref", monkeypatch)
    got, got_spans = _traced_endpoint_run("port", monkeypatch)
    assert got == want == [(200, f"{k:016x}", f"{k:016x}") for k in range(2)] + [
        (429, f"{2:016x}", None)]
    assert [span_structure(s) for s in got_spans] == [span_structure(s) for s in want_spans]
    roots = [s[-1] for s in got_spans]
    assert [r["name"] for r in roots] == ["worker.request"] * 3
    assert [r["parent"] for r in roots] == ["0000feed"] * 3
    assert [(r.get("source"), r.get("status"), r.get("shed")) for r in roots] == [
        ("computed", 200, None), ("lru", 200, None), (None, 429, True)]


def test_endpoint_trace_ids_on_every_route_and_code(monkeypatch, tmp_path):
    """Minted traces: the id is echoed on 200, 400, 429 and 503 and rides
    the plain, scenario and population records; the committed file joins
    into one waterfall a request; an SLO breach is kept as an exemplar
    when sampling would drop it."""
    from sbr_tpu_torch.obs import report

    monkeypatch.setenv("SBR_TRACE_SAMPLE", "1")
    engine = Engine(config=_cfg(tparams), serve=ServeConfig(buckets=(1,)),
                    run_dir=str(tmp_path / "run"), device=CPU).start()
    endpoint = None
    pop = {"graph": {"n": 400, "avg_degree": 8}, "infomodel": {"channel": "bayes"},
           "seeds": 2}
    fig12 = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25}
    try:
        endpoint = ServeEndpoint(engine).start()
        port = endpoint.port
        answers = {}
        for name, doc, hdrs in (
                ("plain", {"beta": 1.2, "u": 0.3}, {}),
                ("scenario", {"u": 0.08, "lolr_rate": 0.1, "scenario": {"modifiers": ["lolr"]}},
                 {}),
                ("population", {**fig12, "population": pop}, {}),
                ("shed", {"beta": 1.2}, {"X-SBR-Deadline-Ms": "-1"}),
                ("bad", {"bta": 1.0}, {})):
            code, body, got = http_request(port, "/query", doc, hdrs)
            answers[name] = (code, got.get("X-SBR-Trace-Id"), json.loads(body))
        for name, code in (("plain", 200), ("scenario", 200), ("population", 200),
                           ("shed", 429), ("bad", 400)):
            assert answers[name][0] == code and len(answers[name][1]) == 16, name
        for name in ("plain", "scenario", "population"):
            assert answers[name][2]["trace_id"] == answers[name][1], name
        _open_breaker(engine)
        code, body, got = http_request(port, "/query", {"beta": 2.2, "u": 0.4})
        assert code == 503 and len(got["X-SBR-Trace-Id"]) == 16
        monkeypatch.setenv("SBR_TRACE_SAMPLE", "0.000000001")
        monkeypatch.setenv("SBR_SERVE_SLO_MS", "0.000001")
        code, _, got = http_request(port, "/query", {"beta": 1.2, "u": 0.3})
        assert code == 200 and got.get("X-SBR-Trace-Id")
        # each handler commits its trace after its response has gone out
        deadline = time.monotonic() + WAIT
        while engine.trace_writer().counters["traces"] < 7:
            assert time.monotonic() < deadline, engine.trace_writer().counters
            time.sleep(0.01)
        assert http_request(port, "/metrics")[1].count("sbr_trace_span_ms_count") >= 5
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()
    doc, code = report.trace_doc([tmp_path / "run"])
    assert code == 0 and doc["traces"] == 7 and doc["joined"] == 7
    assert doc["exemplar_traces"] == 1
    roots = {e["trace"]: e["root"] for e in doc["trace_table"]}
    assert set(roots.values()) == {"worker.request"}
    manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
    assert manifest["trace"]["traces"] == 7 and manifest["trace"]["exemplars"] == 1


def _ids(pkg, monkeypatch):
    """Deterministic trace ids in ``pkg``'s trace module."""
    mod = __import__(f"{pkg}.obs.trace", fromlist=["trace"])
    counter = iter(range(10**6))
    monkeypatch.setattr(mod, "new_trace_id", lambda: f"{next(counter):016x}")


def test_loadgen_trace_out_equals_the_reference(tmp_path, monkeypatch, capsys):
    from sbr_tpu.serve import loadgen as jloadgen
    from sbr_tpu_torch.obs import trace
    from torch_telemetry import span_structure

    for var in ("SBR_FLIGHT", "SBR_DEMAND", "SBR_SERVE_SLO_MS"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--queries", "24", "--pool", "5", "--n-grid", "64", "--bisect-iters", "20",
            "--buckets", "1,8", "--group", "8"]
    monkeypatch.delenv("SBR_TRACE_SAMPLE", raising=False)
    assert loadgen.main(argv + ["--device", "cpu", "--trace-out", str(tmp_path / "u.jsonl")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["traced_queries"] == 0
    untraced = [json.loads(line) for line in (tmp_path / "u.jsonl").read_text().splitlines()]
    assert len(untraced) == 24 and {r["trace_id"] for r in untraced} == {None}
    monkeypatch.setenv("SBR_TRACE_SAMPLE", "1")
    out = {}
    for pkg, main, extra in (("sbr_tpu", jloadgen.main, []),
                             ("sbr_tpu_torch", loadgen.main, ["--device", "cpu"])):
        _ids(pkg, monkeypatch)
        d = tmp_path / pkg
        assert main(argv + extra + ["--trace-out", str(d / "rows.jsonl"), "--run-dir",
                                    str(d / "run")]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rows = [json.loads(line) for line in (d / "rows.jsonl").read_text().splitlines()]
        spans, bad = trace.load_spans(d / "run")
        by_trace = {}
        for sp in spans:
            by_trace.setdefault(sp["trace"], []).append(sp)
        out[pkg] = (summary["traced_queries"],
                    [{k: v for k, v in r.items() if k != "latency_ms"} for r in rows],
                    {t: span_structure(v) for t, v in by_trace.items()}, bad)
    assert out["sbr_tpu_torch"] == out["sbr_tpu"]
    assert out["sbr_tpu_torch"][0] == 24
    roots = {t: [n for n, parent, _ in v if parent is None] for t, v in out["sbr_tpu"][2].items()}
    assert set(map(tuple, roots.values())) == {("loadgen.query",)}
