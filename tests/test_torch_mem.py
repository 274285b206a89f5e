"""The port's memory observatory (sbr_tpu_torch.obs.mem) against
sbr_tpu.obs.mem, on the CPU.

- The planner and preflight functions are the reference's: the same
  inputs give equal outputs (the cases of tests/test_mem.py and more).
- Snapshots on the CPU carry only ``live_buffer_bytes`` (the live CPU
  tensors' storages), the live gate and the headroom env are the
  reference's.
- The ``mem`` event schema and the manifest's ``memory`` roll-up.
- The preflight skips on the CPU (no capacity) and fails closed under a
  synthetic capacity (``device_capacity`` patched), before any tile runs.
- ``run_tiled_grid(tile_shape="auto")`` resolves to the reference's shape
  and plan record on the CPU, and the manifest records the plan; with a
  synthetic capacity the plan comes from two measured probes and the
  preflight reads the planner's model.
- The measured footprint grows with the cells (a dispatch-mode tally of
  storages on the CPU; the allocator's peak on the card, tested in
  tests/test_torch_cuda.py).
- `gc_debris` prunes what the reference's prunes.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu import obs as jobs  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.obs import mem as jmem  # noqa: E402
from sbr_tpu.utils import checkpoint as jckpt  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig, make_model_params  # noqa: E402
from sbr_tpu_torch.obs import mem  # noqa: E402
from sbr_tpu_torch.utils import checkpoint  # noqa: E402

CPU = "cpu"
_TINY = SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False)
_JTINY = jparams.SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False)


@pytest.fixture(autouse=True)
def _no_active_run():
    assert obs.current_run() is None and jobs.current_run() is None
    was_on = obs.metrics.metrics().enabled
    yield
    while obs.end_run() is not None:
        pass
    while jobs.end_run() is not None:
        pass
    (obs.metrics.metrics().enable if was_on else obs.metrics.metrics().disable)()


def _events(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


# -- the pure functions, against the reference -------------------------------

PLAN_CASES = [
    dict(n_b=5000, n_u=5000, model=(10_000.0, 400.0), capacity=16 * 2**30),
    dict(n_b=5000, n_u=5000, model=(0.0, 1024.0), capacity=128 * 2**20),
    dict(n_b=5000, n_u=5000, model=(0.0, 1024.0), capacity=512 * 2**20),
    dict(n_b=5000, n_u=5000, model=(0.0, 0.0), capacity=None),
    dict(n_b=100, n_u=100, model=(0.0, 0.0), capacity=None),
    dict(n_b=100, n_u=37, model=(5e6, 3000.0), capacity=2**30, headroom_frac=0.5),
    dict(n_b=5000, n_u=5000, model=(0.0, 1024.0), capacity=128 * 2**20, multiple_of=(4, 4)),
    dict(n_b=5000, n_u=5000, model=(0.0, 1024.0), capacity=128 * 2**20, per_device_divisor=4),
    dict(n_b=24, n_u=24, model=(1e5, 64.0), capacity=80 * 2**30, max_tile=16),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_tile_shape_equals_reference(case):
    assert mem.plan_tile_shape(**case) == jmem.plan_tile_shape(**case)


def test_planner_raises_when_nothing_fits_as_the_reference():
    for m in (mem, jmem):
        with pytest.raises(m.MemoryPreflightError, match="no power-of-two tile"):
            m.plan_tile_shape(100, 100, (10**12, 10**9), capacity=2**20)


@pytest.mark.parametrize("points", [
    [(64, 10_000 + 64 * 100), (256, 10_000 + 256 * 100)],
    [(64, 5000.0)],
    [(64, 5000.0), (64, 7000.0)],
    [(1, 10.0), (2, 8.0), (4, 30.0)],
    [(10, 100.0), (20, 50.0)],
])
def test_fit_linear_model_equals_reference(points):
    assert mem.fit_linear_model(points) == jmem.fit_linear_model(points)


def test_plan_from_probes_equals_reference():
    def probe(tb, tu):
        return {"total_bytes": 4096 + 512 * tb * tu}

    for capacity in (None, 64 * 2**20, 2**30):
        assert mem.plan_from_probes(5000, 5000, probe, capacity=capacity) == \
            jmem.plan_from_probes(5000, 5000, probe, capacity=capacity)


@pytest.mark.parametrize("fp, capacity, headroom_frac, skip", [
    ({"total_bytes": 2 * 2**30, "arg_bytes": 0, "out_bytes": 0, "temp_bytes": 2 * 2**30},
     2**30, 0.8, None),
    ({"total_bytes": 100}, 2**30, None, None),
    ({"total_bytes": 10**18}, None, None, None),
    (None, 2**30, None, None),
    (None, None, None, "sharded"),
    ({"total_bytes": 800, "source": "planner-model"}, 1000, 0.8, None),
])
def test_preflight_and_check_equal_reference(fp, capacity, headroom_frac, skip):
    kw = dict(capacity=capacity, headroom_frac=headroom_frac, skip_reason=skip)
    got, want = mem.preflight("tile[x]", fp, **kw), jmem.preflight("tile[x]", fp, **kw)
    if fp and "source" not in fp and got.get("source"):
        # an unsourced footprint: the reference's default names its AOT
        # analysis, the port's its measurement
        assert (got.pop("source"), want.pop("source")) == ("measured", "aot")
    assert got == want
    if got["verdict"] == "exceeds":
        with pytest.raises(mem.MemoryPreflightError, match="exceeds the memory budget"):
            mem.check_preflight(got)
    else:
        assert mem.check_preflight(got) is got


@pytest.mark.parametrize("v", [None, 0, 512, 2048, 5 * 2**20, 3 * 2**30, 7 * 2**40, "x", 1.5e3])
def test_fmt_bytes_equals_reference(v):
    assert mem.fmt_bytes(v) == jmem.fmt_bytes(v)


@pytest.mark.parametrize("snap", [
    {"bytes_in_use": 5, "live_buffer_bytes": 7, "peak_bytes_in_use": 9},
    {"live_buffer_bytes": 7, "peak_bytes_in_use": 9},
    {"peak_bytes_in_use": 9},
    {},
])
def test_tile_peak_equals_reference(snap):
    assert mem.tile_peak(snap) == jmem.tile_peak(snap)


def test_host_available_bytes_equals_reference():
    a, b = mem.host_available_bytes(), jmem.host_available_bytes()
    assert (a is None) == (b is None)
    if a is not None:
        assert abs(a - b) < 2**30  # read a moment apart


def test_device_capacity_from_stats_equals_reference():
    for stats in ({"bytes_limit": 80 * 2**30}, {"pool_bytes": 100}, {},
                  {"bytes_limit": 0, "bytes_reservable_limit": 5}):
        assert mem.device_capacity(stats) == jmem.device_capacity(stats)


# -- snapshots, the live gate, the headroom env ------------------------------


def test_snapshot_on_cpu_carries_live_bytes_only():
    keep = torch.arange(1024.0, dtype=torch.float64)
    snap = mem.snapshot()
    assert snap.get("live_buffer_bytes", 0) >= keep.untyped_storage().nbytes()
    assert "bytes_in_use" not in snap and "bytes_limit" not in snap
    assert mem.allocator_stats() is None and mem.device_capacity() is None


def test_live_gate_env_and_context(monkeypatch):
    assert mem.live_enabled()
    monkeypatch.setenv("SBR_OBS_MEM_LIVE", "0")
    assert not mem.live_enabled() and mem.live_bytes() is None
    monkeypatch.setenv("SBR_OBS_MEM_LIVE", "1")
    with mem.live_disabled():
        assert not mem.live_enabled()
        assert mem.snapshot() == {}
    assert mem.live_enabled()


def test_headroom_and_preflight_env(monkeypatch):
    assert mem.headroom() == pytest.approx(0.8) == jmem.headroom()
    for value in ("0.5", "nonsense", "1.5", "0"):
        monkeypatch.setenv("SBR_MEM_HEADROOM", value)
        assert mem.headroom() == jmem.headroom()
    monkeypatch.setenv("SBR_MEM_PREFLIGHT", "0")
    assert not mem.preflight_enabled() and not jmem.preflight_enabled()


# -- the mem event and the manifest roll-up -----------------------------------


def test_mem_event_schema_and_manifest_rollup(tmp_path):
    run_dir = tmp_path / "run"
    with obs.run_context(run_dir=str(run_dir)) as run:
        with obs.span("stage_m") as sp:
            y = obs.jit_call("prog_m", lambda x: (x * 2.0).sum(), torch.arange(256.0))
            sp.sync(y)
        obs.log_tile_mem("tile_b00000_u00000")
        run._note_program_mem("prog_m", {"arg_bytes": 8, "out_bytes": 8, "temp_bytes": 64})
    mem_events = [e for e in _events(run_dir) if e["kind"] == "mem"]
    assert mem_events, "span end + program call must land mem events"
    for ev in mem_events:
        assert "where" in ev and "span" in ev
        assert isinstance(ev.get("live_buffer_bytes"), int)
    tile_events = [e for e in mem_events if e.get("tile")]
    assert tile_events and tile_events[0]["where"] == "tile"
    block = json.loads((run_dir / "manifest.json").read_text())["memory"]
    assert block["peak_bytes"] == block["peak_live_buffer_bytes"] > 0
    assert block["peak_span"] is not None
    assert "tile_b00000_u00000" in (block["tiles"] or {})
    assert block["top_programs"][0]["name"] == "prog_m"
    jblock_keys = {"peak_live_buffer_bytes", "peak_device_bytes", "peak_bytes", "peak_span",
                   "capacity_bytes", "headroom", "top_programs", "tiles", "plan", "preflight"}
    assert set(block) == jblock_keys


# -- measured footprints and the preflight ------------------------------------


def test_measure_footprint_counts_what_lives_at_the_peak():
    def f(x):
        a = x * 2.0  # 8 KiB
        b = a + 1.0  # 8 KiB, with a still alive
        del a
        return b.sum()

    fp = mem.measure_footprint(f, torch.ones(1024, dtype=torch.float64))
    assert fp["arg_bytes"] == 8192 and fp["out_bytes"] == 8
    assert fp["temp_bytes"] + fp["out_bytes"] >= 2 * 8192  # a and b live together
    assert fp["total_bytes"] == fp["arg_bytes"] + fp["out_bytes"] + fp["temp_bytes"]
    assert fp["source"] == "measured"


def test_grid_tile_footprint_scales_with_cells():
    from sbr_tpu_torch.sweeps.baseline_sweeps import grid_tile_footprint

    fp8 = grid_tile_footprint(8, 8, _TINY, device=CPU)
    fp16 = grid_tile_footprint(16, 16, _TINY, device=CPU)
    assert fp8["total_bytes"] > 0
    assert fp16["total_bytes"] > fp8["total_bytes"]
    assert fp16["out_bytes"] > fp8["out_bytes"]
    assert grid_tile_footprint(8, 8, _TINY, device=CPU) == fp8  # cached


def test_preflight_graceful_skip_on_cpu(tmp_path):
    run_dir = tmp_path / "run"
    with obs.run_context(run_dir=str(run_dir)):
        rec = mem.preflight("tile[8x8]", {"total_bytes": 10**18})
        assert rec["verdict"] == "skipped" and rec["reason"] == "no-capacity"
        mem.check_preflight(rec)  # must not raise
    (pf,) = [e for e in _events(run_dir) if e["kind"] == "preflight"]
    assert pf["verdict"] == "skipped"
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert manifest["memory"]["preflight"][0]["verdict"] == "skipped"


def test_tiled_sweep_preflight_fails_closed_with_synthetic_capacity(monkeypatch, tmp_path):
    """A tiny (patched) capacity: run_tiled_grid refuses before any tile
    runs or lands on disk, as the reference does."""
    computed = []
    grid = checkpoint.TileRunner._grid
    monkeypatch.setattr(checkpoint.TileRunner, "_grid",
                        lambda self, *a: computed.append(a) or grid(self, *a))
    monkeypatch.setattr(mem, "device_capacity", lambda stats=None: 4096)
    monkeypatch.setattr(jmem, "device_capacity", lambda stats=None: 4096)
    args = (np.linspace(0.5, 1.0, 4), np.linspace(0.05, 0.5, 4))
    with pytest.raises(jmem.MemoryPreflightError):
        jckpt.run_tiled_grid(*args, jparams.make_model_params(), config=_JTINY, tile_shape=(4, 4))
    with pytest.raises(mem.MemoryPreflightError, match="exceeds the memory budget"):
        checkpoint.run_tiled_grid(*args, make_model_params(), config=_TINY, tile_shape=(4, 4),
                                  checkpoint_dir=str(tmp_path / "ck"), device=CPU)
    assert computed == [] and not list((tmp_path / "ck").glob("tile_*.npz"))


def test_preflight_can_be_switched_off(monkeypatch):
    monkeypatch.setattr(mem, "device_capacity", lambda stats=None: 4096)
    monkeypatch.setenv("SBR_MEM_PREFLIGHT", "0")
    grid = checkpoint.run_tiled_grid(np.linspace(0.5, 1.0, 4), np.linspace(0.05, 0.5, 4),
                                     make_model_params(), config=_TINY, tile_shape=(4, 4),
                                     device=CPU)
    assert grid.xi.shape == (4, 4)


# -- tile_shape="auto" ---------------------------------------------------------


def test_auto_tile_shape_records_plan_and_preflight_as_the_reference(tmp_path):
    """On the CPU both packages plan without a capacity: the same shape and
    plan record, a skipped preflight, per-tile peaks in the manifest."""
    args = (np.linspace(0.5, 1.0, 4), np.linspace(0.05, 0.5, 4))
    with jobs.run_context(run_dir=str(tmp_path / "ref")):
        jckpt.run_tiled_grid(*args, jparams.make_model_params(), config=_JTINY,
                             tile_shape="auto")
    with obs.run_context(run_dir=str(tmp_path / "port")):
        grid = checkpoint.run_tiled_grid(*args, make_model_params(), config=_TINY,
                                         tile_shape="auto", device=CPU)
    assert grid.xi.shape == (4, 4)
    want = json.loads((tmp_path / "ref" / "manifest.json").read_text())["memory"]
    got = json.loads((tmp_path / "port" / "manifest.json").read_text())["memory"]
    assert got["plan"] == want["plan"]
    assert tuple(got["plan"]["tile_shape"]) == (4, 4)  # the power-of-two cover
    assert got["plan"]["verdict"] == "skipped"
    assert got["preflight"] == want["preflight"]
    assert got["preflight"][0]["verdict"] == "skipped"
    assert got["tiles"] and set(got["tiles"]) == set(want["tiles"])
    plan_ev = [e for e in _events(tmp_path / "port") if e["kind"] == "plan"]
    assert len(plan_ev) == 1 and plan_ev[0]["requested"] == "auto"


def test_resolve_tile_shape_passthrough_and_determinism():
    shape, rec = checkpoint.resolve_tile_shape(100, 100, (32, 16), _TINY, None)
    assert shape == (32, 16) and rec is None
    a = checkpoint.resolve_tile_shape(100, 100, "auto", _TINY, None, device=CPU)
    b = checkpoint.resolve_tile_shape(100, 100, "auto", _TINY, None, device=CPU)
    assert a == b == jckpt.resolve_tile_shape(100, 100, "auto", _JTINY, None)


def test_auto_plan_with_synthetic_capacity_uses_probes_and_the_model(monkeypatch, tmp_path):
    """With a capacity (patched) the planner measures two probes, picks a
    tile that covers the grid, and the preflight reads its model (source
    "planner-model") rather than a third probe."""
    from sbr_tpu_torch.sweeps import baseline_sweeps

    probes = []
    footprint = baseline_sweeps.grid_tile_footprint
    monkeypatch.setattr(baseline_sweeps, "grid_tile_footprint",
                        lambda tb, tu, **kw: probes.append((tb, tu)) or footprint(tb, tu, **kw))
    monkeypatch.setattr(mem, "allocator_stats", lambda: {"bytes_limit": 64 * 2**20})
    with obs.run_context(run_dir=str(tmp_path / "r")):
        checkpoint.run_tiled_grid(np.linspace(0.5, 1.0, 4), np.linspace(0.05, 0.5, 4),
                                  make_model_params(), config=_TINY, tile_shape="auto",
                                  device=CPU)
    block = json.loads((tmp_path / "r" / "manifest.json").read_text())["memory"]
    assert probes == [(8, 8), (16, 16)]
    assert block["plan"]["verdict"] == "ok" and block["plan"]["probe_shapes"] == [[8, 8], [16, 16]]
    (pf,) = block["preflight"]
    assert pf["verdict"] == "ok" and pf["source"] == "planner-model"
    assert block["capacity_bytes"] == 64 * 2**20  # the patched allocator's


# -- gc_debris -----------------------------------------------------------------


def _debris(root):
    root.mkdir()
    (root / "quarantine").mkdir()
    (root / "quarantine" / "tile_b00000_u00000.npz").write_bytes(b"bad")
    (root / "tile_b00000_u00008.npz").write_bytes(b"")
    (root / "tile_b00000_u00008.lease").write_text(json.dumps({"ts": time.time(), "ttl_s": 900}))
    (root / "tile_b00008_u00000.lease").write_text(json.dumps({"ts": time.time(), "ttl_s": 900}))
    (root / "tile_b00008_u00008.lease").write_text(json.dumps({"ts": time.time() - 10_000,
                                                               "ttl_s": 900}))
    (root / "tile_b00016_u00000.lease").write_text("{torn")
    (root / "host_a.hb").write_text(json.dumps({"ts": time.time(), "ttl_s": 300}))
    (root / "host_b.hb").write_text(json.dumps({"ts": time.time() - 1000, "ttl_s": 300}))
    (root / "tile_b00000_u00000.lease.123.tmp").write_text("")
    (root / "host_c.hb.9.tmp").write_text("")
    old = time.time() - 10_000
    os.utime(root / "tile_b00008_u00008.lease", (old, old))


def test_gc_debris_prunes_what_the_reference_prunes(tmp_path):
    _debris(tmp_path / "a")
    _debris(tmp_path / "b")
    got = sorted(p.relative_to(tmp_path / "a") for p in mem.gc_debris(tmp_path / "a"))
    want = sorted(p.relative_to(tmp_path / "b") for p in jmem.gc_debris(tmp_path / "b"))
    assert got == want
    left = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert left == ["host_a.hb", "tile_b00000_u00008.npz", "tile_b00008_u00000.lease"]
    assert mem.gc_debris(tmp_path / "missing") == []
