"""The port's flight recorder (sbr_tpu_torch.obs.flight) against
sbr_tpu.obs.flight, on the CPU.

Contracts, each on the same inputs in both packages:

- `derive_utilization`, the pure fold, on synthetic snapshots with fixed
  nanosecond stamps (overlapping dispatches, every gap cause, queue depth,
  occupancy, sheds, sweeps and collectives, torn pairs, malformed rows):
  equal dict for dict;
- the ring: overflow overwrites the oldest and counts the dropped
  records; snapshots, heartbeat blocks and the ``sbr_flight_*`` lines are
  equal; ``flight.json`` with its ``final`` event, rotation and
  `gc_flight_files`;
- the engine's records (tests/torch_telemetry.py drives both engines):
  streams, kinds, tags, pairing and values equal with times dropped;
- the tiled sweep: per tile ``compute``, ``ckpt_save`` and ``cache_io``
  records equal to the reference's, the tile bytes the same
  with the recorder on and off; the elastic scheduler's ``barrier_poll``
  points.
"""

import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.obs import flight as jflight  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import flight  # noqa: E402
from torch_telemetry import drive, flight_structure  # noqa: E402

MODS = (jflight, flight)
MS = 1_000_000  # ns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_flight():
    """The reference's flight module as imported now: tests/test_flight.py
    drops it from sys.modules and imports it anew, so a binding made at
    import time may hold a stale copy whose recorder no sweep writes to."""
    return importlib.import_module("sbr_tpu.obs.flight")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SBR_FLIGHT", "SBR_FLIGHT_CAP", "SBR_FLIGHT_ROTATE_S", "SBR_FLIGHT_UTIL_FLOOR",
                "SBR_FLIGHT_MIN_DISPATCHES", "SBR_DEMAND", "SBR_TRACE_SAMPLE", "SBR_OBS",
                "SBR_TILE_CACHE_DIR", "SBR_SERVE_DEADLINE_MS"):
        monkeypatch.delenv(var, raising=False)
    for mod in (_ref_flight(), flight):
        mod.reset_shared()
    yield
    for mod in (_ref_flight(), flight):
        mod.reset_shared()


def _span(t0, t1, stream, kind, seq, tag=""):
    return [[t0, stream, kind, tag, seq, "b", None], [t1, stream, kind, tag, seq, "e", None]]


def _point(t, stream, kind, seq, tag="", val=None):
    return [[t, stream, kind, tag, seq, "p", val]]


SNAPSHOTS = {
    "empty": {"records": []},
    "one_dispatch": {"records": _span(0, 5 * MS, "engine", "dispatch", 1, "b8")},
    "busy_and_gaps": {"dropped_records": 3, "records": (
        _span(0, 2 * MS, "engine", "admission", 1)
        + _span(1 * MS, 3 * MS, "engine", "queue", 2)
        + _span(3 * MS, 4 * MS, "engine", "cache", 3, "miss")
        + _span(4 * MS, 6 * MS, "engine", "batch", 4, "b8")
        + _span(6 * MS, 16 * MS, "engine", "dispatch", 5, "b8")
        + _span(12 * MS, 20 * MS, "engine", "dispatch", 6, "b64")  # overlaps the first
        + _span(20 * MS, 21 * MS, "engine", "unpack", 7, "b64")
        + _point(24 * MS, "engine", "shed", 8, "expired")
        + _point(25 * MS, "engine", "queue_depth", 9, val=3)
        + _point(26 * MS, "engine", "queue_depth", 10, val=0)
        + _point(27 * MS, "engine", "occupancy", 11, "b8", 0.25)
        + _point(28 * MS, "engine", "occupancy", 12, "b64", 0.5)
        + _point(29 * MS, "engine", "shed", 13, "unmeetable")
        + _span(30 * MS, 40 * MS, "engine", "dispatch", 14, "b1")
        + _point(50 * MS, "engine", "queue_depth", 15, val=7))},
    "torn_and_malformed": {"records": (
        [[5 * MS, "engine", "dispatch", "b8", 1, "e", None]]  # its begin was overwritten
        + _span(6 * MS, 9 * MS, "engine", "dispatch", 2, "b8")
        + [[10 * MS, "engine", "batch", "", 3, "b", None]]  # its end never came
        + [["x", "engine"], None, [1, 2, 3, 4, 5, 6, 7, 8]]
        + _span(12 * MS, 14 * MS, "engine", "cache", 4, "lru"))},
    "sweeps_and_collectives": {"records": (
        _span(0, 1 * MS, "sweeps", "ckpt_load", 1, "tile_b00000_u00000")
        + _span(1 * MS, 9 * MS, "sweeps", "compute", 2, "tile_b00000_u00000")
        + _span(9 * MS, 10 * MS, "sweeps", "ckpt_save", 3, "tile_b00000_u00000")
        + _span(13 * MS, 20 * MS, "sweeps", "compute", 4, "tile_b00000_u00002")
        + _span(20 * MS, 21 * MS, "sweeps", "cache_io", 5, "tile_b00000_u00002")
        + _span(21 * MS, 30 * MS, "collectives", "barrier_poll", 1, "missing=2")
        + _point(31 * MS, "collectives", "barrier_poll", 2, "missing=1"))},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_derive_utilization_equals_the_reference(name):
    snap = json.loads(json.dumps(SNAPSHOTS[name]))
    want = jflight.derive_utilization(snap)
    assert flight.derive_utilization(snap) == want
    assert flight.derive_utilization(json.loads(json.dumps(snap))) == want  # pure


def test_derive_utilization_surface():
    u = flight.derive_utilization(SNAPSHOTS["busy_and_gaps"])
    assert u["dispatches"] == 3 and u["window_s"] == 0.05
    assert u["device_busy_frac"] == 0.48 and u["host_gap_frac"] == 0.52
    assert set(u["gap_causes"]) == {"batch_formation", "cache_io", "admission_shed",
                                    "queue_starvation"}
    assert u["queue_depth"]["max"] == 7.0 and u["occupancy"]["by_bucket"] == {"b64": 0.5,
                                                                            "b8": 0.25}
    assert u["sheds"] == {"expired": 1, "unmeetable": 1} and u["dropped_records"] == 3
    t = flight.derive_utilization(SNAPSHOTS["torn_and_malformed"])
    assert t["unpaired"] == 2 and t["dispatches"] == 1 and t["records"] == 6
    s = flight.derive_utilization(SNAPSHOTS["sweeps_and_collectives"])
    assert s["sweeps"]["tiles"] == 2 and s["sweeps"]["bubbles_ms"] == [3.0]
    assert s["collectives"]["barrier_poll"] == {"count": 2, "total_ms": 9.0}


@pytest.mark.parametrize("raw", ["", "0", "1", "5", "12"])
def test_knobs_equal_the_reference(raw, monkeypatch):
    for var in ("SBR_FLIGHT", "SBR_FLIGHT_CAP", "SBR_FLIGHT_UTIL_FLOOR",
                "SBR_FLIGHT_MIN_DISPATCHES"):
        monkeypatch.setenv(var, raw)
    for fn in ("enabled", "cap_n", "util_floor", "min_dispatches"):
        assert getattr(flight, fn)() == getattr(jflight, fn)(), fn


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _fill(mod, cap, n):
    rec = mod.FlightRecorder(cap=cap, time_fn=_Clock())
    for k in range(n):
        rec.mark("engine", "dispatch" if k % 3 else "batch", 1.0 + k * 0.01, 1.005 + k * 0.01,
                 tag=f"b{k % 2}")
        rec.point("engine", "queue_depth", val=k)
    with rec.span("sweeps", "compute", tag="tile_b00000_u00000"):
        pass
    rec.mark("engine", "cache", 9.0, 8.0)  # an end before its begin is clamped
    return rec


@pytest.mark.parametrize("cap,n", [(8, 2), (8, 20), (64, 40), (None, 5)])
def test_ring_snapshot_heartbeat_and_lines_equal_the_reference(cap, n):
    got, want = _fill(flight, cap, n), _fill(jflight, cap, n)
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert got.heartbeat_block() == want.heartbeat_block()
    assert got.prometheus_lines() == want.prometheus_lines()
    assert snap["writes_total"] == 3 * n + 4
    assert snap["dropped_records"] == max(0, 3 * n + 4 - got.cap)
    assert len(snap["records"]) == min(3 * n + 4, got.cap)
    got.reset()
    assert got.snapshot()["records"] == [] and got.heartbeat_block()["records"] == 0


def test_shared_recorder_is_process_wide():
    assert flight.shared() is flight.shared()
    first = flight.shared()
    flight.reset_shared()
    assert flight.shared() is not first


def test_flight_json_final_event_and_rotation(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_FLIGHT_ROTATE_S", "0.5")
    clock = _Clock()
    rec = flight.FlightRecorder(cap=64, time_fn=clock)
    run = obs.start_run(label="flight", run_dir=tmp_path / "run")
    try:
        for k in range(3):
            rec.mark("engine", "dispatch", clock(), clock(), tag="b8")
            clock.t += 1.0
            assert rec.maybe_write(run) is True
        assert rec.maybe_write(run) is False  # inside the write interval
        assert rec.maybe_write(None) is False
        rec.close(run)
    finally:
        obs.end_run()
    doc = json.loads((tmp_path / "run" / "flight.json").read_text())
    assert doc["schema"] == flight.LIVE_SCHEMA and doc["util"]["dispatches"] == 3
    assert doc["util"] == flight.derive_utilization(doc)
    assert sorted(p.name for p in (tmp_path / "run").glob("flight.*.json")) == [
        "flight.000.json", "flight.001.json"]
    kinds = [json.loads(line) for line in (tmp_path / "run" / "events.jsonl").read_text()
             .splitlines()]
    flights = [e for e in kinds if e["kind"] == "flight"]
    assert [e["action"] for e in flights] == ["rotate", "rotate", "final"]
    assert flights[-1]["dispatches"] == 3
    manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
    assert manifest["flight"]["final"] == 1 and manifest["flight"]["last_dispatches"] == 3


@pytest.mark.parametrize("keep", [0, 2, 5])
def test_gc_flight_files_equals_the_reference(tmp_path, keep):
    got = {}
    for mod, name in ((jflight, "ref"), (flight, "port")):
        root = tmp_path / name
        for run, status in (("done", "complete"), ("live", "running")):
            d = root / run
            d.mkdir(parents=True)
            (d / "manifest.json").write_text(json.dumps({"status": status}))
            for f in ["flight.json"] + [f"flight.{k:03d}.json" for k in range(4)]:
                (d / f).write_text("{}")
        removed = mod.gc_flight_files(root, keep=keep)
        got[name] = (sorted(os.path.relpath(p, root) for p in removed),
                     sorted(str(p.relative_to(root)) for p in root.rglob("*")))
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == max(4 - keep, 0)


# -- the engine ------------------------------------------------------------------


def test_engine_records_equal_the_reference(monkeypatch):
    monkeypatch.setenv("SBR_FLIGHT", "1")
    want = flight_structure(drive("ref")["flight"])
    got = flight_structure(drive("port")["flight"])
    assert got == want
    kinds = {(k, tag) for _, k, tag, _, _, _ in got}
    assert {("admission", ""), ("queue", ""), ("cache", "miss"), ("cache", "lru"),
            ("batch", "b8"), ("dispatch", "b8"), ("unpack", "b8"), ("occupancy", "b8"),
            ("shed", "expired"), ("shed", "unmeetable"), ("shed", "queue-expired"),
            ("batch", "b1")} <= kinds
    assert [r[5] for r in got if r[1] == "occupancy"] == [0.25]  # 2 of the 8 lanes


def test_started_engine_records_queue_depth(monkeypatch):
    from sbr_tpu_torch.models import params as P
    from torch_telemetry import make_engine

    monkeypatch.setenv("SBR_FLIGHT", "1")
    engine = make_engine("port").start()
    try:
        engine.query_many([P.make_model_params(u=u) for u in (0.1, 0.2)], timeout=120)
        block = engine.statz()["flight"]
        text = engine.prometheus()
    finally:
        engine.close()
    snap = flight.shared().snapshot()
    depth = [r for r in snap["records"] if r[2] == "queue_depth"]
    assert depth and all(r[6] is not None for r in depth)
    assert block["dispatches"] >= 1 and "sbr_flight_device_busy_frac" in text


# -- the tiled sweep and the barriers --------------------------------------------


BETAS = np.linspace(0.5, 2.0, 3)
US = np.linspace(0.05, 0.5, 4)


def _tiled(pkg, ckpt, cache):
    if pkg == "ref":
        from sbr_tpu.models import params as P
        from sbr_tpu.resilience.elastic import TileCache
        from sbr_tpu.utils.checkpoint import run_tiled_grid
        kw = {}
    else:
        from sbr_tpu_torch.models import params as P
        from sbr_tpu_torch.resilience.elastic import TileCache
        from sbr_tpu_torch.utils.checkpoint import run_tiled_grid
        kw = {"device": "cpu"}
    cfg = P.SolverConfig(n_grid=64, bisect_iters=30, refine_crossings=False, numerics="fixed")
    return run_tiled_grid(BETAS, US, P.make_model_params(), config=cfg, tile_shape=(2, 2),
                          checkpoint_dir=ckpt, tile_cache=TileCache(cache), **kw)


def _sweep_records(mod):
    return [(r[2], r[3]) for r in sorted(mod.shared().snapshot()["records"],
                                         key=lambda r: (r[4], r[5] == "e"))
            if r[1] == "sweeps" and r[5] == "b"]


def test_tiled_sweep_records_equal_the_reference(tmp_path, monkeypatch):
    off = _tiled("port", tmp_path / "off", tmp_path / "off_cache")
    assert flight.shared().snapshot()["records"] == []  # off: no marks
    monkeypatch.setenv("SBR_FLIGHT", "1")
    got = {}
    for pkg, mod in (("ref", _ref_flight()), ("port", flight)):
        ckpt, cache = tmp_path / f"{pkg}_ckpt", tmp_path / f"{pkg}_cache"
        grid = _tiled(pkg, ckpt, cache)  # computes every tile
        _tiled(pkg, ckpt, cache)  # every tile from its checkpoint
        _tiled(pkg, tmp_path / f"{pkg}_ckpt2", cache)  # every tile from the tile cache
        got[pkg] = _sweep_records(mod)
        if pkg == "port":
            on = grid
    assert got["port"] == got["ref"]
    tiles = {tag for _, tag in got["port"]}
    assert len(tiles) == 4
    for tag in tiles:
        kinds = [k for k, t in got["port"] if t == tag]
        # computed: a cache miss, the compute, its save and its store; then
        # from the tile cache: a hit and its save (the sweep loop reads its
        # own checkpoints before it calls produce)
        assert kinds == ["cache_io", "compute", "ckpt_save", "cache_io", "cache_io",
                         "ckpt_save"]
    for f in ("xi", "max_aw", "status"):
        assert getattr(on, f).numpy().tobytes() == getattr(off, f).numpy().tobytes()
    for name in ("off", "port_ckpt"):
        files = sorted((tmp_path / name).glob("tile_*.npz"))
        assert len(files) == 4
    for a, b in zip(sorted((tmp_path / "off").glob("tile_*.npz")),
                    sorted((tmp_path / "port_ckpt").glob("tile_*.npz"))):
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files)
            assert all(x[k].tobytes() == y[k].tobytes() for k in x.files)


def test_elastic_loop_points_barrier_polls(tmp_path, monkeypatch):
    from sbr_tpu_torch.models import params as P
    from sbr_tpu_torch.parallel import run_tiled_grid_multihost

    monkeypatch.setenv("SBR_FLIGHT", "1")
    cfg = P.SolverConfig(n_grid=64, bisect_iters=30, refine_crossings=False, numerics="fixed")
    run_tiled_grid_multihost(BETAS, US, P.make_model_params(), str(tmp_path / "ckpt"),
                             config=cfg, tile_shape=(2, 2), process_id=0, num_processes=1,
                             elastic=True, device="cpu")
    polls = [r for r in flight.shared().snapshot()["records"] if r[1] == "collectives"]
    assert polls and {r[2] for r in polls} == {"barrier_poll"}
    assert {r[5] for r in polls} == {"p"} and polls[0][3] == "missing=4"
    u = flight.derive_utilization(flight.shared().snapshot())
    assert u["collectives"]["barrier_poll"]["count"] == len(polls)
    assert u["sweeps"]["tiles"] == 4


def test_static_barrier_marks_its_polls(tmp_path, monkeypatch):
    from sbr_tpu_torch.models import params as P
    from sbr_tpu_torch.parallel import run_tiled_grid_multihost

    monkeypatch.setenv("SBR_FLIGHT", "1")
    cfg = P.SolverConfig(n_grid=64, bisect_iters=30, refine_crossings=False, numerics="fixed")
    with pytest.raises(TimeoutError):  # the peer (process 1) never comes
        run_tiled_grid_multihost(BETAS, US, P.make_model_params(), str(tmp_path / "ckpt"),
                                 config=cfg, tile_shape=(2, 2), process_id=0, num_processes=2,
                                 elastic=False, poll_s=0.01, timeout_s=0.2, steal_grace_s=600,
                                 device="cpu")
    polls = [r for r in flight.shared().snapshot()["records"] if r[1] == "collectives"]
    assert polls and {(r[2], r[3]) for r in polls} == {("barrier_poll", "missing=2")}
    assert len(polls) % 2 == 0 and {r[5] for r in polls} == {"b", "e"}
