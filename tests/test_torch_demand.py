"""The port's demand observatory (sbr_tpu_torch.obs.demand) against
sbr_tpu.obs.demand, on the CPU.

Contracts, each on the same inputs in both packages, integers and
documents exactly:

- `query_fingerprint` hex, `bin_of` / `bin_bounds` on seeded points (out
  of range included), the knobs;
- `MisraGries`: the docs after the same seeded skewed stream at several
  capacities, `merge` equal and symmetric, `from_doc` round trips;
- `merge_surfaces`, `hot_bins`, `advisor_plan` → `plan_bytes` byte for
  byte, `write_plan`;
- `coverage_from_cache_dir` on the port's own tile-cache sidecars equals
  the reference's on the same cells, and skips a sidecar ``sbr_tpu``
  wrote;
- `DemandTracker`: window and lifetime surfaces, the ``sbr_demand_*``
  lines, ``demand.json`` / ``advisor_plan.json``, rotation,
  `gc_demand_files`;
- ``replay`` (`replay_rows` and the CLI) over the same ``--trace-out``
  rows, its plan bytes and exit codes;
- the engine's surface after the seeded telemetry drive
  (tests/torch_telemetry.py), and loadgen's: its ``--trace-out`` rows
  replay into the engine's surface bin for bin once the warm-up is taken
  out.
"""

import json
import os
import random

import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.obs import demand as jdemand  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import demand  # noqa: E402
from torch_telemetry import drive  # noqa: E402

MODS = (jdemand, demand)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SBR_DEMAND", "SBR_DEMAND_TOPK", "SBR_DEMAND_BINS", "SBR_DEMAND_ROTATE_S",
                "SBR_DEMAND_COVERAGE_FLOOR", "SBR_FLIGHT", "SBR_TRACE_SAMPLE", "SBR_OBS",
                "SBR_TILE_CACHE_DIR", "SBR_SERVE_DEADLINE_MS", "SBR_SERVE_WINDOW_S"):
        monkeypatch.delenv(var, raising=False)


def _points(seed, n=400):
    rng = random.Random(seed)
    return [(rng.uniform(0.0, 4.6), rng.uniform(-0.1, 1.0)) for _ in range(n)]


def _stream(seed, n=600, hot=5, pool=40):
    """A skewed query stream: a few hot points and a long tail."""
    rng = random.Random(seed)
    pts = _points(seed + 1, pool)
    out = []
    for _ in range(n):
        k = rng.randrange(hot) if rng.random() < 0.7 else rng.randrange(pool)
        b, u = pts[k]
        out.append((round(b, 6), round(u, 6), rng.choice(["mix", "default"]),
                    rng.choice(["plain", "plain", "grads"]),
                    rng.choice(["lru", "computed", "coalesced", "disk"])))
    return out


def test_fingerprints_and_bins_equal_the_reference():
    for b, u in _points(3):
        for nb in (1, 7, 16):
            assert demand.bin_of(b, u, nb) == jdemand.bin_of(b, u, nb)
            i, j = demand.bin_of(b, u, nb)
            assert demand.bin_bounds(i, j, nb) == jdemand.bin_bounds(i, j, nb)
        for scen, kind in (("default", "plain"), ("mix", "grads"), ("pop:abc", "population")):
            assert demand.query_fingerprint(b, u, scen, kind) == \
                jdemand.query_fingerprint(b, u, scen, kind)
    assert demand.query_fingerprint(1, 0.5) == jdemand.query_fingerprint(1.0, 0.5)


@pytest.mark.parametrize("raw", ["", "0", "3", "0.4"])
def test_knobs_equal_the_reference(raw, monkeypatch):
    for var in ("SBR_DEMAND", "SBR_DEMAND_COVERAGE_FLOOR"):
        monkeypatch.setenv(var, raw)
    if raw != "0.4":
        for var in ("SBR_DEMAND_TOPK", "SBR_DEMAND_BINS"):
            monkeypatch.setenv(var, raw)
    for fn in ("enabled", "topk", "bins_n", "coverage_floor"):
        assert getattr(demand, fn)() == getattr(jdemand, fn)(), fn


def _sketch(mod, stream, k):
    s = mod.MisraGries(k)
    for b, u, scen, kind, _ in stream:
        s.update(mod.query_fingerprint(b, u, scen, kind),
                 {"beta": b, "u": u, "scenario": scen, "kind": kind})
    s.update("ignored", n=0)
    return s


@pytest.mark.parametrize("k", [1, 4, 16, 64])
def test_misra_gries_docs_and_merge_equal_the_reference(k):
    a, b = _stream(5), _stream(6)
    got_a, got_b = _sketch(demand, a, k), _sketch(demand, b, k)
    want_a, want_b = _sketch(jdemand, a, k), _sketch(jdemand, b, k)
    assert got_a.to_doc() == want_a.to_doc() and got_b.to_doc() == want_b.to_doc()
    merged = got_a.merge(got_b)
    assert merged.to_doc() == want_a.merge(want_b).to_doc()
    assert merged.to_doc() == got_b.merge(got_a).to_doc()  # symmetric
    assert demand.MisraGries.from_doc(merged.to_doc()).to_doc() == merged.to_doc()
    assert got_a.top(3) == want_a.top(3)
    bad = {"k": k, "items": [["x", "nan"], ["y"], ["z", 2, "not a payload"], ["w", 0]]}
    assert demand.MisraGries.from_doc(bad).to_doc() == jdemand.MisraGries.from_doc(bad).to_doc()


def _tracker(mod, stream, clock, **kw):
    tr = mod.DemandTracker(window_s=12.0, bins=8, topk_n=6, time_fn=clock, **kw)
    for k, (b, u, scen, kind, src) in enumerate(stream):
        if k % 100 == 0:
            clock.t += 3.0  # a slot and a half: old slots roll out of the window
        tr.record(b, u, scenario=scen, kind=kind, source=src)
    return tr


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_tracker_surfaces_and_lines_equal_the_reference():
    stream = _stream(9)
    got, want = _tracker(demand, stream, _Clock()), _tracker(jdemand, stream, _Clock())
    assert got.snapshot() == want.snapshot()
    assert got.heartbeat_block() == want.heartbeat_block()
    assert got.prometheus_lines() == want.prometheus_lines()
    snap = got.snapshot()
    assert snap["queries_total"] == 600 and snap["totals"]["queries"] == 600
    assert snap["window"]["queries"] < 600  # the window rolled
    got.record("nan", 0.5)  # never raises, records nothing
    assert got.queries_total == 600


@pytest.mark.parametrize("mass", [0.1, 0.5, 0.9, 1.0])
def test_merge_hot_bins_and_plan_bytes_equal_the_reference(mass):
    clock = _Clock()
    surfaces = {mod: [_tracker(mod, _stream(s), clock).totals_surface() for s in (11, 12)]
                for mod in MODS}
    alien = {"bins": 3, "cells": {"0,0": {"count": 5}}, "sketch": {}}
    got = demand.merge_surfaces(surfaces[demand] + [alien, "junk"])
    want = jdemand.merge_surfaces(surfaces[jdemand] + [alien, "junk"])
    assert got == want and got["skipped_surfaces"] == 1
    assert demand.hot_bins(got, mass) == jdemand.hot_bins(want, mass)
    pairs = sorted({(b, u) for b, u, *_ in _stream(11)[:30]})
    coverage = {"entries": 2, "pairs": [list(p) for p in pairs]}
    for cov in (None, coverage):
        plan = demand.advisor_plan(got, cov, max_tiles=4, floor=0.5)
        assert demand.plan_bytes(plan) == jdemand.plan_bytes(jdemand.advisor_plan(
            want, cov, max_tiles=4, floor=0.5))
    assert demand.hot_bins({"cells": {}}) == []


def _write_sidecar(root, name, tag, betas, us):
    d = root / name[:2]
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.meta.json").write_text(json.dumps(
        {"key": name, "cell_tag": tag, "betas": betas, "us": us}))


def test_coverage_reads_the_ports_sidecars_and_skips_the_references(tmp_path):
    from sbr_tpu.models import params as jparams
    from sbr_tpu.resilience.elastic import cell_tag as jcell_tag
    from sbr_tpu_torch.models import params as tparams
    from sbr_tpu_torch.resilience.elastic import cell_tag

    port_tag = cell_tag(tparams.make_model_params(), tparams.SolverConfig(), "float64")
    ref_tag = jcell_tag(jparams.make_model_params(), jparams.SolverConfig(), "float64")
    cells = [("aa11", [0.5, 1.0], [0.1, 0.2]), ("bb22", [1.0, 2.5], [0.2])]
    for name, betas, us in cells:
        _write_sidecar(tmp_path / "port", name, port_tag, betas, us)
        _write_sidecar(tmp_path / "ref", name, ref_tag, betas, us)
        _write_sidecar(tmp_path / "mixed", name, port_tag, betas, us)
    _write_sidecar(tmp_path / "mixed", "cc33", ref_tag, [3.0], [0.7])
    (tmp_path / "mixed" / "cc" / "torn.meta.json").write_text("{not json")
    got = demand.coverage_from_cache_dir(tmp_path / "port")
    assert got == jdemand.coverage_from_cache_dir(tmp_path / "ref")
    assert got == {"entries": 2, "pairs": [[0.5, 0.1], [0.5, 0.2], [1.0, 0.1], [1.0, 0.2],
                                           [2.5, 0.2]]}
    assert demand.coverage_from_cache_dir(tmp_path / "mixed") == got
    assert demand.coverage_from_cache_dir(tmp_path / "ref")["entries"] == 0
    assert demand.coverage_from_cache_dir(tmp_path / "none") is None
    surface = _tracker(demand, _stream(2), _Clock()).totals_surface()
    assert demand.plan_bytes(demand.advisor_plan(surface, got)) == jdemand.plan_bytes(
        jdemand.advisor_plan(surface, jdemand.coverage_from_cache_dir(tmp_path / "ref")))


def test_tracker_writes_snapshot_plan_and_rotations(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_DEMAND_ROTATE_S", "1")
    clock = _Clock()
    tr = demand.DemandTracker(bins=8, topk_n=6, time_fn=clock,
                              coverage_fn=lambda: {"entries": 0, "pairs": []})
    run = obs.start_run(label="demand", run_dir=tmp_path / "run")
    try:
        for k in range(3):
            tr.record(1.0 + k, 0.3, source="computed")
            clock.t += 2.0
            assert tr.maybe_write(run) is True
        assert tr.maybe_write(run) is False and tr.maybe_write(None) is False
        tr.close(run)
    finally:
        obs.end_run()
    d = tmp_path / "run"
    snap = json.loads((d / "demand.json").read_text())
    assert snap["schema"] == demand.LIVE_SCHEMA and snap["queries_total"] == 3
    plan = json.loads((d / "advisor_plan.json").read_text())
    assert (d / "advisor_plan.json").read_bytes() == demand.plan_bytes(plan)
    assert plan["cache_entries"] == 0 and plan["surface_queries"] == 3
    assert sorted(p.name for p in d.glob("demand.*.json")) == ["demand.000.json",
                                                               "demand.001.json"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["demand"]["plan"] == 1 and manifest["demand"]["last_plan"] == \
        plan["plan_fingerprint"]


@pytest.mark.parametrize("keep", [0, 1, 4])
def test_gc_demand_files_equals_the_reference(tmp_path, keep):
    got = {}
    for mod, name in ((jdemand, "ref"), (demand, "port")):
        root = tmp_path / name
        for run, status in (("done", "complete"), ("live", "running")):
            d = root / run
            d.mkdir(parents=True)
            (d / "manifest.json").write_text(json.dumps({"status": status}))
            for f in ["demand.json", "advisor_plan.json"] + [
                    f"{s}.{k:03d}.json" for s in ("demand", "advisor_plan") for k in range(3)]:
                (d / f).write_text("{}")
        removed = mod.gc_demand_files(root, keep=keep)
        got[name] = (sorted(os.path.relpath(p, root) for p in removed),
                     sorted(str(p.relative_to(root)) for p in root.rglob("*")))
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 2 * max(3 - keep, 0)


# -- replay ------------------------------------------------------------------------


def _rows(path):
    rows = [{"beta": b, "u": u, "scenario": s, "kind": k, "source": src, "trace_id": None}
            for b, u, s, k, src in _stream(21, n=300)]
    rows += [{"trace_id": "legacy"}, {"beta": float("nan"), "u": 0.2}, ["not", "a", "dict"]]
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
        fh.write('{"beta": 1.0, "u": \n')  # a torn last line
    return path


def test_replay_rows_equal_the_reference(tmp_path):
    path = _rows(tmp_path / "t.jsonl")
    got = demand.replay_rows(demand._iter_trace_rows([path]), bins=8, topk_n=6)
    want = jdemand.replay_rows(jdemand._iter_trace_rows([path]), bins=8, topk_n=6)
    assert got == want
    assert got[1] == {"rows": 304, "replayed": 300, "legacy_rows": 2, "bad_rows": 2}


@pytest.mark.parametrize("extra", [[], ["--json"], ["--floor", "0.99"], ["--bins", "4",
                                                                        "--topk", "3"]])
def test_replay_cli_equals_the_reference(tmp_path, extra, capsys):
    path = _rows(tmp_path / "t.jsonl")
    out = {}
    for mod, name in ((jdemand, "ref"), (demand, "port")):
        plan = tmp_path / f"{name}_plan.json"
        surf = tmp_path / f"{name}_surface.json"
        code = mod.main(["replay", str(path), "--plan-out", str(plan), "--out", str(surf)]
                        + extra)
        cap = capsys.readouterr()
        out[name] = (code, cap.out, cap.err, plan.read_bytes(), surf.read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][0] == (1 if "--floor" in extra else 0)


def test_replay_cli_exit_codes(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text('{"trace_id": "legacy"}\n')
    for mod in MODS:
        assert mod.main(["replay", str(tmp_path / "missing.jsonl")]) == 2
        assert mod.main(["replay", str(empty)]) == 3
        assert mod.main([]) == 2 and mod.main(["nope"]) == 2
    capsys.readouterr()


# -- the engine ----------------------------------------------------------------------


def test_engine_surface_equals_the_reference(monkeypatch):
    monkeypatch.setenv("SBR_DEMAND", "1")
    want = drive("ref")["demand"]
    got = drive("port")["demand"]
    assert got == want
    cells = got["totals"]["cells"]
    assert sum(c["count"] for c in cells.values()) == 5  # sheds and failures never count
    sources = {}
    for c in cells.values():
        for s, v in c["sources"].items():
            sources[s] = sources.get(s, 0) + v
    assert sources == {"computed": 2, "coalesced": 1, "lru": 1, "tilecache": 1}


def test_loadgen_trace_rows_replay_into_the_engine_surface(tmp_path, monkeypatch, capsys):
    from sbr_tpu_torch.serve import loadgen

    monkeypatch.setenv("SBR_DEMAND", "1")
    monkeypatch.setenv("SBR_TRACE_SAMPLE", "1")
    rows_path = tmp_path / "rows.jsonl"
    rc = loadgen.main(["--queries", "40", "--pool", "6", "--n-grid", "64", "--bisect-iters",
                       "20", "--buckets", "1,8", "--device", "cpu", "--run-dir",
                       str(tmp_path / "run"), "--trace-out", str(rows_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["traced_queries"] == 40
    engine_surface = json.loads((tmp_path / "run" / "demand.json").read_text())["totals"]
    replayed, stats = demand.replay_rows(demand._iter_trace_rows([rows_path]))
    assert stats == {"rows": 40, "replayed": 40, "legacy_rows": 0, "bad_rows": 0}
    # the warm-up asked every pool member once, each a computed miss
    warm = {}
    for p in loadgen.build_pool(0, 6):
        i, j = demand.bin_of(p.learning.beta, p.economic.u, demand.bins_n())
        warm[f"{i},{j}"] = warm.get(f"{i},{j}", 0) + 1
    for key, cell in engine_surface["cells"].items():
        want = replayed["cells"].get(key, {"count": 0, "sources": {}})
        assert cell["count"] - warm.get(key, 0) == want["count"], key
        srcs = dict(cell["sources"])
        srcs["computed"] = srcs.get("computed", 0) - warm.get(key, 0)
        assert {s: v for s, v in srcs.items() if v} == want["sources"], key
    assert set(replayed["cells"]) <= set(engine_surface["cells"])


def test_replay_as_a_module_loads_no_torch(tmp_path):
    """``python -m sbr_tpu_torch.obs.demand replay`` answers as the reference's
    replay does, in a process that imports no torch."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    path = _rows(tmp_path / "t.jsonl")
    code = ("import sys;"
            " from sbr_tpu_torch.obs import demand; rc = demand.main(sys.argv[1:]);"
            " sys.exit(99 if 'torch' in sys.modules else rc)")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SBR_DEMAND")}
    procs = [subprocess.run([sys.executable, *argv, "replay", str(path), "--json"],
                            capture_output=True, text=True, timeout=120, cwd=str(repo),
                            env={**env, "PYTHONPATH": str(repo)})
             for argv in (["-c", code], ["-m", "sbr_tpu.obs.demand"])]
    assert [p.returncode for p in procs] == [0, 0], procs[0].stderr
    assert json.loads(procs[0].stdout) == json.loads(procs[1].stdout)
