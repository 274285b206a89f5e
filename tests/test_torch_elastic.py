"""The port's elastic sweep scheduler and cross-run tile cache
(sbr_tpu_torch.resilience.elastic) on the CPU, against sbr_tpu's and
against the port itself.

Contracts:

- heartbeats: announce, TTL expiry at exactly the TTL, torn writes dead,
  handed back by a graceful shutdown;
- `plan_claims` gives the reference's plan on the same tiles and rates;
- `TileCache`: entries round-trip byte for byte, corrupt ones are
  quarantined, cold ones collected; its key and the cell tag carry the
  backend tag, so they differ from the reference's on the same sweep;
- the elastic driver, bit for bit against the port's own direct
  `run_tiled_grid`: a single host, a joiner that adopts the remainder, a
  live lease respected and then reclaimed after its TTL, a warm cache
  that computes 0 tiles (counted by the runner's ``counts``), and a
  two-process farm with a subprocess;
- telemetry: a cold and a warm elastic sweep under a run log the
  reference's ``scheduler`` and ``cache`` events (hosts aside: each
  process names itself), and `report elastic` folds them as the
  reference's does, its tile counts equal to the runner's ``counts``.

Every subprocess wait carries a timeout and every process is killed in a
``finally``.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu import obs as jobs  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.resilience import elastic as jelastic  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.parallel import run_tiled_grid_multihost  # noqa: E402
from sbr_tpu_torch.parallel.distributed import _try_lease  # noqa: E402
from sbr_tpu_torch.resilience import elastic, faults, shutdown  # noqa: E402
from sbr_tpu_torch.utils.checkpoint import run_tiled_grid  # noqa: E402
from torch_events import assert_same_events, events  # noqa: E402

CPU = "cpu"
CFG_KW = dict(n_grid=96, bisect_iters=40, numerics="fixed")
CFG = tparams.SolverConfig(**CFG_KW)
BETAS = np.linspace(0.5, 2.0, 4)
US = np.linspace(0.05, 0.5, 4)
REPO = Path(__file__).resolve().parent.parent
FIELDS = ("max_aw", "xi", "status")


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
    monkeypatch.delenv("SBR_TILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("SBR_ELASTIC", raising=False)
    faults.install(None)
    yield
    faults.install(None)


def _base():
    return tparams.make_model_params()


def _bits(x) -> bytes:
    return np.ascontiguousarray(x.detach().cpu().numpy()).tobytes()


def _same_grid(a, b) -> bool:
    return all(_bits(getattr(a, f)) == _bits(getattr(b, f)) for f in FIELDS)


def _direct():
    return run_tiled_grid(BETAS, US, _base(), config=CFG, tile_shape=(2, 2), device=CPU)


def _elastic(ck, **kw):
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("timeout_s", 60.0)
    return run_tiled_grid_multihost(BETAS, US, _base(), str(ck), config=CFG,
                                    tile_shape=(2, 2), elastic=True, device=CPU, **kw)


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

def test_announce_live_withdraw(tmp_path):
    hb = elastic.Heartbeat(tmp_path, host="h1", ttl_s=60.0)
    hb.beat(tiles_done=3, cells_per_sec=12.5)
    hosts = elastic.live_hosts(tmp_path)
    assert hosts["h1"]["tiles_done"] == 3 and hosts["h1"]["cells_per_sec"] == 12.5
    hb.withdraw()
    assert elastic.live_hosts(tmp_path) == {}
    assert str(hb.path) not in shutdown._RELEASE_REGISTRY


def test_ttl_expiry_and_torn_write(tmp_path):
    hb = elastic.Heartbeat(tmp_path, host="h1", ttl_s=10.0)
    hb.beat()
    rec = json.loads(hb.path.read_text())
    assert elastic.live_hosts(tmp_path, now=rec["ts"] + 10.0) == {}
    assert "h1" in elastic.live_hosts(tmp_path, now=rec["ts"] + 9.999)
    hb.path.write_text("{torn")
    assert elastic.live_hosts(tmp_path) == {}
    hb.withdraw()


def test_heartbeat_released_on_graceful_shutdown(tmp_path):
    hb = elastic.Heartbeat(tmp_path, host="h1", ttl_s=600.0)
    hb.beat()
    lease = tmp_path / "tile_b00000_u00000.lease"
    lease.write_text("{}")
    shutdown.release_on_exit(lease)
    with pytest.raises(SystemExit) as exc:
        with shutdown.graceful_shutdown(label="t"):
            raise shutdown.Interrupted(signal.SIGTERM)
    assert exc.value.code == 128 + signal.SIGTERM
    assert not hb.path.exists() and not lease.exists()


def test_heartbeat_survives_transient_write_failure(tmp_path, monkeypatch):
    hb = elastic.Heartbeat(tmp_path, host="h1", ttl_s=60.0)
    real_replace = os.replace

    def fail(*a):
        raise OSError("ESTALE")

    monkeypatch.setattr(elastic.os, "replace", fail)
    hb.beat()  # best effort: must not raise
    monkeypatch.setattr(elastic.os, "replace", real_replace)
    hb.beat(tiles_done=1)
    assert elastic.live_hosts(tmp_path)["h1"]["tiles_done"] == 1
    hb.withdraw()


def test_host_identity_and_knobs(monkeypatch):
    hid = elastic.host_identity()
    assert hid == elastic.host_identity() and f"-p{os.getpid()}-" in hid
    assert elastic.elastic_enabled() is True
    monkeypatch.setenv("SBR_ELASTIC", "0")
    assert elastic.elastic_enabled() is False and elastic.elastic_enabled(True) is True
    monkeypatch.setenv("SBR_HEARTBEAT_TTL_S", "12.5")
    assert elastic.heartbeat_ttl_s() == 12.5 and elastic.heartbeat_ttl_s(3) == 3.0


# ---------------------------------------------------------------------------
# The claim plan
# ---------------------------------------------------------------------------

TILES = [((b, u), 16.0) for b in (0, 4, 8, 12) for u in (0, 4)]
RAGGED = [((b, u), float((b + 3) * (u + 1))) for b in range(0, 10, 2) for u in range(0, 7, 3)]
RATES = {
    "equal": {"b": 1.0, "a": 1.0, "c": 1.0},
    "skewed": {"fast": 3.0, "slow": 1.0},
    "degenerate": {"a": 0.0, "b": -3.0},
    "three": {"x": 2.5, "y": 1.0, "z": 0.5},
}


@pytest.mark.parametrize("tiles", [TILES, RAGGED], ids=["square", "ragged"])
@pytest.mark.parametrize("rates", sorted(RATES))
def test_plan_claims_equals_reference(tiles, rates):
    ours = elastic.plan_claims(tiles, RATES[rates])
    assert ours == jelastic.plan_claims(tiles, RATES[rates])
    assert ours == elastic.plan_claims(list(reversed(tiles)), dict(RATES[rates]))
    assert sorted(t for ts in ours.values() for t in ts) == sorted(t for t, _ in tiles)


def test_throughput_shares_lpt_order_and_degenerate_inputs():
    plan = elastic.plan_claims(TILES, {"fast": 3.0, "slow": 1.0})
    assert len(plan["fast"]) == 6 and len(plan["slow"]) == 2
    plan = elastic.plan_claims([((0, 0), 4.0), ((0, 2), 16.0), ((2, 0), 16.0)], {"only": 1.0})
    assert plan["only"][0] in ((0, 2), (2, 0)) and plan["only"][-1] == (0, 0)
    assert elastic.plan_claims([], {"a": 1.0}) == {"a": []}
    assert elastic.plan_claims(TILES, {}) == {}


def test_tracker_ewma_and_tile_cells():
    tr = elastic.ThroughputTracker()
    assert tr.rate is None
    tr.update(100, 2.0)
    assert tr.rate == 50.0
    tr.update(100, 1.0)
    assert 50.0 < tr.rate < 100.0
    tr.update(0, 1.0)
    tr.update(10, 0.0)
    assert 50.0 < tr.rate < 100.0
    for origin in ((0, 0), (4, 3), (6, 6)):
        assert elastic.tile_cells(origin, 6, 7, (4, 3)) == jelastic.tile_cells(origin, 6, 7, (4, 3))


# ---------------------------------------------------------------------------
# The cross-run tile cache
# ---------------------------------------------------------------------------

def _arrays(seed=0.0):
    return {
        "max_aw": np.full((2, 2), 1.5 + seed),
        "xi": np.full((2, 2), 2.5 + seed),
        "status": np.zeros((2, 2), np.int32),
    }


def test_roundtrip_byte_identical(tmp_path):
    cache = elastic.TileCache(tmp_path / "cache")
    key = cache.key(_base(), CFG, None, BETAS[:2], US[:2])
    assert cache.load(key) is None
    cache.store(key, _arrays())
    got = cache.load(key)
    assert all(got[f].tobytes() == _arrays()[f].tobytes() for f in FIELDS)


def test_key_distinguishes_sweeps_and_the_backend():
    cache = elastic.TileCache("/nonexistent")
    base = _base()
    k = cache.key(base, CFG, None, BETAS[:2], US[:2])
    assert k != cache.key(base, CFG, None, BETAS[:2], US[2:])
    assert k != cache.key(base, tparams.SolverConfig(n_grid=128), None, BETAS[:2], US[:2])
    assert k != cache.key(base, CFG, torch.float32, BETAS[:2], US[:2])
    assert k == cache.key(base, CFG, torch.float64, BETAS[:2], US[:2])  # None is float64
    assert k == cache.key(base, CFG, None, BETAS[:2], US[:2])
    jbase, jcfg = jparams.make_model_params(), jparams.SolverConfig(**CFG_KW)
    jcache = jelastic.TileCache("/nonexistent")
    for jdtype in (None, "float64"):
        assert k != jcache.key(jbase, jcfg, jdtype, BETAS[:2], US[:2])


def test_cell_tag_carries_the_backend_tag():
    tag = elastic.cell_tag(_base(), CFG, "float64")
    assert "'torch'" in tag
    assert tag != jelastic.cell_tag(jparams.make_model_params(),
                                    jparams.SolverConfig(**CFG_KW), "float64")
    meta = elastic.tile_meta(_base(), CFG, None, BETAS[:2], US[:2], "k")
    assert meta == {"key": "k", "cell_tag": tag, "betas": list(BETAS[:2]), "us": list(US[:2])}


def test_corrupt_entry_quarantined_not_served(tmp_path):
    cache = elastic.TileCache(tmp_path / "cache")
    key = cache.key(_base(), CFG, None, BETAS[:2], US[:2])
    cache.store(key, _arrays())
    faults.corrupt_file(cache.path(key))
    assert cache.load(key) is None
    assert not cache.path(key).exists()
    assert list((cache.path(key).parent / "quarantine").glob("*.npz"))


def test_injected_load_fault_is_a_miss_not_a_quarantine(tmp_path):
    cache = elastic.TileCache(tmp_path / "cache")
    key = cache.key(_base(), CFG, None, BETAS[:2], US[:2])
    cache.store(key, _arrays())
    faults.install(faults.FaultPlan({"seed": 0, "rules": [
        {"point": "tilecache.load", "kind": "transient", "max_fires": 1}]}))
    assert cache.load(key) is None
    assert cache.path(key).exists() and cache.load(key) is not None


def test_gc_prunes_cold_keeps_warm(tmp_path):
    cache = elastic.TileCache(tmp_path / "cache")
    k_cold = cache.key(_base(), CFG, None, BETAS[:2], US[:2])
    k_warm = cache.key(_base(), CFG, None, BETAS[2:], US[2:])
    cache.store(k_cold, _arrays(), meta={"key": k_cold})
    cache.store(k_warm, _arrays(1.0))
    old = time.time() - 40 * 86400
    os.utime(cache.path(k_cold), (old, old))
    orphan = cache.path(k_warm).parent / "tmpdead.tmp"
    orphan.write_bytes(b"partial")
    os.utime(orphan, (time.time() - 7200, time.time() - 7200))
    removed = elastic.gc_tile_cache(tmp_path / "cache", keep_days=30.0)
    assert cache.path(k_cold) in removed and not cache.path(k_cold).exists()
    assert not Path(str(cache.path(k_cold))[:-4] + ".meta.json").exists()
    assert orphan in removed and not orphan.exists()
    assert cache.load(k_warm) is not None
    assert elastic.gc_tile_cache(tmp_path / "missing") == []


def test_recorded_tile_shape(tmp_path):
    ck = tmp_path / "ck"
    run_tiled_grid(BETAS, US, _base(), config=CFG, tile_shape=(2, 2), checkpoint_dir=ck,
                   tile_owner=lambda b, u: False, device=CPU)
    assert elastic.recorded_tile_shape(ck) == (2, 2)
    assert elastic.recorded_tile_shape(tmp_path / "nope") is None


def test_default_tile_cache_from_env(tmp_path, monkeypatch):
    assert elastic.default_tile_cache() is None
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path))
    assert elastic.default_tile_cache().root == tmp_path
    assert elastic.default_tile_cache(tmp_path / "x").root == tmp_path / "x"


# ---------------------------------------------------------------------------
# The elastic driver
# ---------------------------------------------------------------------------

def test_single_host_matches_direct_run(tmp_path):
    report = {}
    full = _elastic(tmp_path / "ck", report=report)
    assert _same_grid(full, _direct())
    assert report["counts"] == {"local": 0, "cache": 0, "computed": 4}
    assert len(report["claimed"]) == 4 and report["host"] == elastic.host_identity()
    assert not list((tmp_path / "ck").glob("*.lease"))
    assert not list((tmp_path / "ck").glob("host_*.hb"))


def test_joiner_adopts_mid_sweep_remainder(tmp_path):
    ck = tmp_path / "ck"
    run_tiled_grid(BETAS, US, _base(), config=CFG, tile_shape=(2, 2), checkpoint_dir=ck,
                   tile_owner=lambda b, u: b == 0, device=CPU)
    assert len(list(ck.glob("tile_*.npz"))) == 2
    report = {}
    full = _elastic(ck, report=report)
    assert report["counts"]["computed"] == 2
    assert sorted(report["claimed"]) == ["tile_b00002_u00000", "tile_b00002_u00002"]
    assert _same_grid(full, _direct())


def test_live_peer_lease_respected_then_reclaimed_after_ttl(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    assert _try_lease(ck, 0, 0, ttl_s=1.5)  # a "peer" holds tile (0, 0)
    t0 = time.monotonic()
    report = {}
    full = _elastic(ck, poll_s=0.1, report=report)
    assert time.monotonic() - t0 >= 1.0  # waited the lease out
    assert report["claimed"][-1] == "tile_b00000_u00000"
    assert _same_grid(full, _direct())


def test_warm_global_cache_computes_zero_tiles(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path / "cache"))
    cold_report, warm_report = {}, {}
    cold = _elastic(tmp_path / "ck1", report=cold_report)
    warm = _elastic(tmp_path / "ck2", report=warm_report)
    assert cold_report["counts"]["computed"] == 4
    assert warm_report["counts"] == {"local": 0, "cache": 4, "computed": 0}
    assert _same_grid(warm, cold) and _same_grid(warm, _direct())
    assert len(list((tmp_path / "cache").rglob("*.meta.json"))) == 4


def _elastic_runs(pkg, root):
    """A cold and then a warm elastic sweep over one tile cache, each under
    its own run; returns the two run directories and the runner reports."""
    reports = []
    for name in ("cold", "warm"):
        if pkg == "ref":
            with jobs.run_context(run_dir=str(root / name)):
                jelastic.run_elastic_grid(BETAS, US, jparams.make_model_params(),
                                          str(root / f"ck_{name}"),
                                          config=jparams.SolverConfig(**CFG_KW),
                                          tile_shape=(2, 2), poll_s=0.05, timeout_s=60.0,
                                          tile_cache_dir=str(root / "cache"))
        else:
            rep = {}
            with obs.run_context(run_dir=str(root / name)):
                elastic.run_elastic_grid(BETAS, US, _base(), str(root / f"ck_{name}"),
                                         config=CFG, tile_shape=(2, 2), poll_s=0.05,
                                         timeout_s=60.0, tile_cache_dir=str(root / "cache"),
                                         device=CPU, report=rep)
            reports.append(rep)
    return root / "cold", root / "warm", reports


def test_scheduler_and_cache_events_equal_reference(tmp_path):
    from sbr_tpu.obs import report as jreport
    from sbr_tpu_torch.obs import report

    *ref, _ = _elastic_runs("ref", tmp_path / "ref")
    *port, reports = _elastic_runs("port", tmp_path / "port")
    for got_dir, want_dir, rep in zip(port, ref, reports):
        got, want = events(got_dir), events(want_dir)
        assert_same_events(got, want, {"scheduler", "cache"}, dropped=("host", "shares"))
        plans = [[sorted(e["shares"].values()) for e in evs if e.get("action") == "plan"]
                 for evs in (got, want)]
        assert plans[0] == plans[1]
        (doc, code), (jdoc, jcode) = (mod.elastic_doc(mod.load_run(d))
                                      for mod, d in ((report, got_dir), (jreport, want_dir)))
        assert code == jcode == 0
        for key in ("tiles_computed", "tiles_from_cache", "cache", "scheduler", "tiles"):
            assert doc[key] == jdoc[key], key
        assert doc["tiles_computed"] == rep["counts"]["computed"]
        assert doc["tiles_from_cache"] == rep["counts"]["cache"] + rep["counts"]["local"]
    assert [e["action"] for e in events(port[1]) if e["kind"] == "cache"] == ["hit"] * 4


def test_wait_false_returns_none_after_claiming(tmp_path):
    assert _elastic(tmp_path / "ck", wait=False) is None
    assert len(list((tmp_path / "ck").glob("tile_*.npz"))) == 4


def test_elastic_grid_needs_a_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        elastic.run_elastic_grid(BETAS, US, _base(), None, device=CPU)


FARM_WORKER = """
import sys
import numpy as np
import torch
from sbr_tpu_torch.models.params import SolverConfig, make_model_params
from sbr_tpu_torch.parallel import run_tiled_grid_multihost

torch.set_num_threads(1)
report = {}
run_tiled_grid_multihost(np.linspace(0.5, 3.0, 6), np.linspace(0.02, 0.3, 8),
                         make_model_params(),
                         sys.argv[1], config=SolverConfig(**CFG_KW), tile_shape=(2, 2),
                         poll_s=0.05, timeout_s=120.0, wait=False, device="cpu",
                         report=report)
print("CLAIMED", len(report["claimed"]), flush=True)
"""


def test_two_process_farm_with_a_subprocess(tmp_path):
    """Two processes claim tiles of one sweep concurrently (12 tiles); the
    grid is the direct run's bit for bit and every tile was claimed once
    or, in a lease race, computed the same by both."""
    script = tmp_path / "worker.py"
    script.write_text(FARM_WORKER.replace("CFG_KW", repr(CFG_KW)))
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": str(REPO), "SBR_FAULT_PLAN": ""}
    proc = subprocess.Popen([sys.executable, str(script), str(ck)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    betas, us = np.linspace(0.5, 3.0, 6), np.linspace(0.02, 0.3, 8)
    try:
        deadline = time.monotonic() + 120.0
        while not list(ck.glob("host_*.hb")) and proc.poll() is None:
            assert time.monotonic() < deadline, "the worker never joined"
            time.sleep(0.02)
        report = {}
        full = run_tiled_grid_multihost(betas, us, _base(), str(ck), config=CFG,
                                        tile_shape=(2, 2), poll_s=0.05, timeout_s=120.0,
                                        device=CPU, report=report)
        out, _ = proc.communicate(timeout=120.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    assert proc.returncode == 0, out
    theirs = int(out.split("CLAIMED")[1].split()[0])
    assert len(report["claimed"]) + theirs >= 12
    direct = run_tiled_grid(betas, us, _base(), config=CFG, tile_shape=(2, 2), device=CPU)
    assert _same_grid(full, direct)
    assert not list(ck.glob("*.lease")) and not list(ck.glob("host_*.hb"))
