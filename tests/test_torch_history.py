"""The port's perf history (sbr_tpu_torch.obs.history and `report trend`)
against sbr_tpu.obs.history on the same records.

Mirrors tests/test_history.py: the append/load round trip with its torn
tail, the schema, the path resolution (the port's own default file, never
the reference's), polarity, the rolling-median gate with its platform
isolation and zero-baseline rule, sparklines, `bench_metrics`, and the
`trend` CLI's exit codes, JSON documents and rendered tables, each held to
the reference's output on the same history file. Then the elastic
scheduler's throughput seed, which reads only its own platform's records
of the sidecar history.
"""

import json

import pytest

pytest.importorskip("torch")

from sbr_tpu.obs import history as jhistory  # noqa: E402
from sbr_tpu.obs import report as jreport  # noqa: E402
from sbr_tpu_torch.obs import history, report  # noqa: E402
from sbr_tpu_torch.resilience import elastic  # noqa: E402


def _rec(ts, platform="cpu", **metrics):
    return {"schema": 1, "ts": ts, "label": "bench", "platform": platform, "metrics": metrics}


def _write(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return path


# -- append / load -----------------------------------------------------------


def test_append_load_round_trip(tmp_path):
    for mod, name in ((history, "port"), (jhistory, "ref")):
        p = tmp_path / f"{name}.jsonl"
        out = mod.append({"eq_per_sec": 10.0, "nan_metric": float("nan"), "text": "no",
                          "flag": True}, label="x", platform="cpu", path=p,
                          meta={"note": "fixture"})
        assert out == p
        with open(p, "a") as fh:
            fh.write('{"trunc')  # a torn tail write must not poison the log
    (got,), (want,) = history.load(tmp_path / "port.jsonl"), jhistory.load(tmp_path / "ref.jsonl")
    got.pop("ts"), want.pop("ts")
    assert got == want
    assert got["schema"] == history.SCHEMA == jhistory.SCHEMA == 14
    assert got["metrics"] == {"eq_per_sec": 10.0, "flag": 1}
    # each package loads the other's file the same way
    assert history.load(tmp_path / "ref.jsonl") == jhistory.load(tmp_path / "ref.jsonl")


def test_load_missing_file_is_empty(tmp_path):
    assert history.load(tmp_path / "nope.jsonl") == jhistory.load(tmp_path / "nope.jsonl") == []


def test_history_path_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_OBS_HISTORY", str(tmp_path / "env.jsonl"))
    assert history.history_path() == tmp_path / "env.jsonl"
    assert history.history_path(tmp_path / "arg.jsonl") == tmp_path / "arg.jsonl"
    monkeypatch.delenv("SBR_OBS_HISTORY")
    # the port's own file: it never appends to the reference's history
    assert str(history.history_path()) == "output_torch/bench_history.jsonl"
    assert history.history_path() != jhistory.history_path()


# -- polarity + check --------------------------------------------------------


@pytest.mark.parametrize("metric", [
    "beta_u_grid_equilibria_per_sec", "agent_steps_per_sec", "grid_dispatch_s",
    "obs_compile_s", "memory_peak_bytes", "health_divergent", "mystery_metric",
    "serve_p99_ms", "serve_cache_hit_rate", "grid_adaptive_speedup",
    "grid_mean_effective_iters", "fleet_failover_count", "fleet_shed_rate",
    "scenario_overhead_ratio", "flight_host_gap_frac", "flight_device_busy_frac",
    "elastic_cells_per_sec",
])
def test_polarity_rules(metric):
    assert history.polarity(metric) == jhistory.polarity(metric)


def _same_check(records, **kw):
    got = history.check(records, **kw)
    assert got == jhistory.check(records, **kw)
    return got


CHECK_CASES = {
    "flat": [_rec(f"t{i}", eq_per_sec=1000.0, grid_dispatch_s=0.5) for i in range(4)],
    "throughput_regression": [_rec(f"t{i}", eq_per_sec=1000.0) for i in range(3)]
    + [_rec("t3", eq_per_sec=700.0)],
    "duration_regression": [_rec(f"t{i}", obs_compile_s=1.0) for i in range(3)]
    + [_rec("t3", obs_compile_s=1.5)],
    "improvement": [_rec(f"t{i}", eq_per_sec=1000.0, grid_dispatch_s=0.5) for i in range(3)]
    + [_rec("t3", eq_per_sec=1500.0, grid_dispatch_s=0.3)],
    "within_tolerance": [_rec(f"t{i}", eq_per_sec=1000.0) for i in range(3)]
    + [_rec("t3", eq_per_sec=900.0)],
    "short": [_rec("t0", eq_per_sec=1000.0), _rec("t1", eq_per_sec=500.0)],
    "platform_isolation": [_rec(f"t{i}", platform="gpu", eq_per_sec=100_000.0) for i in range(3)]
    + [_rec(f"c{i}", platform="cpu", eq_per_sec=1000.0) for i in range(3)],
    "platform_regression": [_rec(f"t{i}", platform="gpu", eq_per_sec=100_000.0)
                            for i in range(3)]
    + [_rec(f"c{i}", platform="cpu", eq_per_sec=1000.0) for i in range(3)]
    + [_rec("c3", platform="cpu", eq_per_sec=500.0)],
    "zero_baseline": [_rec(f"t{i}", health_divergent=0) for i in range(3)]
    + [_rec("t3", health_divergent=2)],
    "rolling_window": [_rec(f"old{i}", eq_per_sec=100.0) for i in range(10)]
    + [_rec(f"new{i}", eq_per_sec=1000.0) for i in range(5)] + [_rec("now", eq_per_sec=700.0)],
    "empty": [],
}
CHECK_STATUS = {
    "flat": "ok", "throughput_regression": "regression", "duration_regression": "regression",
    "improvement": "ok", "within_tolerance": "ok", "short": "short",
    "platform_isolation": "ok", "platform_regression": "regression",
    "zero_baseline": "regression", "rolling_window": "regression", "empty": "short",
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_equals_reference(case):
    verdicts, status = _same_check(CHECK_CASES[case], tolerance=0.15, window=5)
    assert status == CHECK_STATUS[case]
    if case == "throughput_regression":
        assert verdicts["eq_per_sec"]["change"] == pytest.approx(-0.3)
    if case == "zero_baseline":
        assert verdicts["health_divergent"]["change"] is None
    if case == "rolling_window":
        assert verdicts["eq_per_sec"]["baseline"] == 1000.0


def test_check_min_points_and_metric_filter():
    recs = CHECK_CASES["throughput_regression"]
    assert _same_check(recs, min_points=5)[1] == "short"
    assert _same_check(recs, metrics_filter={"other"})[1] == "short"


@pytest.mark.parametrize("values,width", [([1.0, 1.0, 1.0], 24), ([0.0, 1.0, 2.0, 3.0], 24),
                                          (list(range(100)), 24), ([], 24),
                                          ([3.0, float("nan"), 1.0], 8)])
def test_sparkline(values, width):
    assert history.sparkline(values, width) == jhistory.sparkline(values, width)


@pytest.mark.parametrize("result", [
    {"metric": "m_per_sec", "value": 2.0, "extra": {}},
    {},
    {"metric": "beta_u_grid_equilibria_per_sec", "value": 100.0,
     "extra": {"agent_steps_per_sec": 5.0, "grid_dispatch_s": 0.1, "grid_mem_peak_bytes": 0,
               "serve_p99_ms": 2.5, "obs": {"compile_s": 1.0, "execute_s": 0.5,
                                           "memory_peak_bytes": -1}}},
])
def test_bench_metrics_equal_reference(result):
    assert history.bench_metrics(result) == jhistory.bench_metrics(result)


def test_recent_median_equals_reference(tmp_path):
    p = _write(tmp_path / "h.jsonl", [_rec(f"t{i}", platform="gpu" if i % 2 else "cpu",
                                           elastic_cells_per_sec=float(10 * i))
                                      for i in range(12)])
    for platform in (None, "cpu", "gpu", "tpu"):
        for window in (1, 3, 8):
            assert history.recent_median("elastic_cells_per_sec", p, platform, window) == \
                jhistory.recent_median("elastic_cells_per_sec", p, platform, window)
    assert history.recent_median("missing", p) is None


# -- CLI (report trend) ------------------------------------------------------


def _both(argv, capsys):
    """Run ``argv`` through both packages' report; return (code, output)
    per package, the program name normalized."""
    out = []
    for main in (report.main, jreport.main):
        code = main(list(argv))
        text = capsys.readouterr().out.replace("sbr_tpu_torch", "sbr_tpu")
        out.append((code, text))
    return out


@pytest.fixture
def histories(tmp_path):
    return {
        "flat": _write(tmp_path / "flat.jsonl",
                       [_rec(f"t{i}", eq_per_sec=1000.0) for i in range(4)]),
        "reg": _write(tmp_path / "reg.jsonl",
                      [_rec(f"t{i}", eq_per_sec=1000.0) for i in range(3)]
                      + [_rec("t3", eq_per_sec=700.0)]),
        "short": _write(tmp_path / "short.jsonl", [_rec("t0", eq_per_sec=1000.0)]),
        "missing": tmp_path / "missing.jsonl",
        "table": _write(tmp_path / "h.jsonl",
                        [_rec(f"t{i}", eq_per_sec=1000.0 + i, grid_dispatch_s=0.5)
                         for i in range(5)]),
        "filter": _write(tmp_path / "f.jsonl",
                         [_rec(f"t{i}", eq_per_sec=1000.0, obs_compile_s=1.0) for i in range(3)]
                         + [_rec("t3", eq_per_sec=1000.0, obs_compile_s=9.0)]),
    }


TREND_CASES = [
    ("flat", ["--check"], 0),
    ("reg", ["--check", "--tolerance", "0.15"], 1),
    ("missing", ["--check"], 3),
    ("short", ["--check"], 3),
    ("missing", [], 0),
    ("reg", ["--check", "--tolerance", "0.5"], 0),
    ("reg", [], 0),
    ("reg", ["--check", "--json"], 1),
    ("missing", ["--check", "--json"], 3),
    ("table", [], 0),
    ("filter", ["--check", "--metric", "eq_per_sec"], 0),
    ("filter", ["--check"], 1),
    ("table", ["--platform", "gpu", "--check", "--json"], 3),
]


@pytest.mark.parametrize("name,args,code", TREND_CASES)
def test_trend_cli_equals_reference(histories, capsys, name, args, code):
    (got, got_out), (want, want_out) = _both(["trend", str(histories[name])] + args, capsys)
    assert got == want == code
    if "--json" in args:
        assert json.loads(got_out) == json.loads(want_out)
    else:
        assert got_out == want_out
    if name == "reg" and not args:
        assert "REGRESSION" not in got_out and "eq_per_sec" in got_out
    if name == "table":
        assert "PLATFORM cpu" in got_out or "--platform" in args


def test_trend_default_path_is_the_ports(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("SBR_OBS_HISTORY", raising=False)
    monkeypatch.chdir(tmp_path)
    assert report.main(["trend", "--check", "--json"]) == 3
    assert json.loads(capsys.readouterr().out)["history"] == "output_torch/bench_history.jsonl"


# -- the elastic scheduler's throughput seed ---------------------------------


def test_elastic_seed_reads_only_its_platform(tmp_path, monkeypatch):
    """A CPU rate never seeds the card, nor the other way round: the seed
    is the median of the device's own platform records in the sidecar."""
    monkeypatch.setenv("SBR_OBS_HISTORY", str(tmp_path / "h.jsonl"))
    side = elastic._rate_history_path()
    assert side == tmp_path / "h.jsonl.elastic.jsonl"
    assert elastic.seed_rate_from_history(device="cpu") is None
    _write(side, [_rec("g0", platform="gpu", elastic_cells_per_sec=5000.0),
                  _rec("g1", platform="gpu", elastic_cells_per_sec=7000.0),
                  _rec("c0", platform="cpu", elastic_cells_per_sec=20.0)])
    assert elastic.seed_rate_from_history(device="cpu") == 20.0
    assert elastic.seed_rate_from_history(device=None) == 6000.0  # the card's
    assert elastic._platform("cpu") == "cpu" and elastic._platform(None) == "gpu"


def test_elastic_rate_append_needs_history_and_computed_tiles(tmp_path, monkeypatch):
    monkeypatch.delenv("SBR_OBS_HISTORY", raising=False)
    monkeypatch.chdir(tmp_path)
    elastic._append_rate_history(12.5, 3, "cpu")  # no SBR_OBS_HISTORY: nothing written
    assert not (tmp_path / "output_torch").exists()
    monkeypatch.setenv("SBR_OBS_HISTORY", str(tmp_path / "h.jsonl"))
    elastic._append_rate_history(12.5, 0, "cpu")  # an all-hit sweep measured nothing
    elastic._append_rate_history(None, 3, "cpu")
    assert history.load(elastic._rate_history_path()) == []
    elastic._append_rate_history(12.5, 3, "cpu")
    (rec,) = history.load(elastic._rate_history_path())
    assert (rec["label"], rec["platform"], rec["metrics"]) == (
        "elastic_sweep", "cpu", {"elastic_cells_per_sec": 12.5})
    assert rec["meta"]["tiles"] == 3
    assert not (tmp_path / "h.jsonl").exists()  # the gated history stays clean
