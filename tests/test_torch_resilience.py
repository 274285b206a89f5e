"""The port's resilience layer and tiled sweep (sbr_tpu_torch.resilience,
sbr_tpu_torch.utils.checkpoint, sbr_tpu_torch.parallel) on the CPU,
against sbr_tpu's and against the port itself.

Contracts, in float64 at fixed numerics (n_grid 96, bisect_iters 40):

- `FaultPlan` fires the same sequence as the reference's from the same
  spec and seed; `tile_origins` and `tile_assignment` are the reference's;
- `run_tiled_grid` on a ragged grid: statuses exactly the reference's,
  ξ and AW_max within 1e-12; a NaN-poisoned tile gets the reference's
  repairs report, its repaired values within 1e-12;
- against the port itself, bit for bit: a tiled grid and the monolithic
  `beta_u_grid`; a faulted and resumed grid and the fault-free one; a
  resume after SIGKILL mid-tile (a subprocess); the static multi-process
  split and its work stealing;
- keys: the sweep fingerprint carries the backend tag, so the port
  refuses a checkpoint directory that sbr_tpu wrote.

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

from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.parallel import distributed as jdist  # noqa: E402
from sbr_tpu.resilience import faults as jfaults  # noqa: E402
from sbr_tpu.utils import checkpoint as jckpt  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.parallel import distributed as tdist  # noqa: E402
from sbr_tpu_torch.parallel import run_tiled_grid_multihost  # noqa: E402
from sbr_tpu_torch.resilience import (  # noqa: E402
    FaultPlan,
    InjectedFault,
    faults,
    heal,
    shutdown,
)
from sbr_tpu_torch.sweeps import baseline_sweeps, beta_u_grid, policy_sweep_interest, u_sweep  # noqa: E402
from sbr_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from sbr_tpu_torch.utils.checkpoint import run_tiled_grid  # noqa: E402

CPU = "cpu"
CFG_KW = dict(n_grid=96, bisect_iters=40, numerics="fixed")
CFG = tparams.SolverConfig(**CFG_KW)
BETAS = np.linspace(0.5, 2.0, 4)
US = np.linspace(0.05, 0.5, 4)
# a ragged grid: 6×7 cells in 4×3 tiles (edge tiles 2×3 and 4×1)
RB = np.linspace(0.5, 2.0, 6)
RU = np.linspace(0.02, 1.0, 7)
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
def _clean_faults(monkeypatch):
    """No fault plan in either package before or after a test, and short
    retry backoffs."""
    monkeypatch.setenv("SBR_RETRY_BASE_DELAY_S", "0.01")
    monkeypatch.delenv("SBR_TILE_CACHE_DIR", raising=False)
    faults.install(None)
    jfaults.install(None)
    yield
    faults.install(None)
    jfaults.install(None)


def _base():
    return tparams.make_model_params()


def _tiled(betas=BETAS, us=US, tile_shape=(2, 2), **kw):
    return run_tiled_grid(betas, us, _base(), config=CFG, tile_shape=tile_shape, device=CPU, **kw)


def _mono(betas=BETAS, us=US, dtype=None):
    return beta_u_grid(betas, us, _base(), config=CFG, dtype=dtype, device=CPU)


def _bits(x) -> bytes:
    return np.ascontiguousarray(x.detach().cpu().numpy()).tobytes()


def _same_grid(a, b) -> bool:
    return all(_bits(getattr(a, f)) == _bits(getattr(b, f)) for f in FIELDS)


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def _plan(rules, seed=0):
    return {"seed": seed, "rules": rules}


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

PLAN_SPECS = {
    "probabilistic": _plan([
        {"point": "a", "kind": "nan", "p": 0.5},
        {"point": "b", "kind": "corrupt", "p": 0.3, "max_fires": 4},
    ], seed=7),
    "at_hits_match": _plan([
        {"point": "a", "kind": "nan", "at_hits": [2, 5], "match": "t1"},
        {"point": "a", "kind": "corrupt", "p": 0.7, "max_fires": 3},
    ], seed=3),
    "shared_point": _plan([
        {"point": "b", "kind": "nan", "p": 0.4, "cells": 3},
        {"point": "b", "kind": "corrupt", "p": 0.9},
    ], seed=11),
}


@pytest.mark.parametrize("name", sorted(PLAN_SPECS))
def test_fault_plan_fires_the_reference_sequence(name):
    spec = PLAN_SPECS[name]

    def replay(plan):
        for i in range(60):
            plan.fire("a", target=f"t{i}")
            plan.fire("b", target=f"t{i}")
        return plan.firings

    ours, ref = replay(FaultPlan(spec)), replay(jfaults.FaultPlan(spec))
    assert ours == ref and len(ours) > 0
    assert replay(FaultPlan({**spec, "seed": spec["seed"] + 1})) != ours


def test_at_hits_match_and_max_fires():
    plan = FaultPlan(_plan([{"point": "p", "kind": "nan", "at_hits": [2], "match": "yes"}]))
    assert plan.fire("p", "yes-1") is None
    assert plan.fire("p", "no") is None  # no match: not even a hit
    rule = plan.fire("p", "yes-2")
    assert rule is not None and rule.kind == "nan"
    assert plan.fire("p", "yes-3") is None


def test_alignment_does_not_spend_other_rules_budget():
    plan = FaultPlan(_plan([
        {"point": "p", "kind": "nan", "at_hits": [1]},
        {"point": "p", "kind": "corrupt", "p": 1.0, "max_fires": 1},
    ]))
    assert plan.fire("p").kind == "nan"
    assert plan.rules[1].fires == 0
    assert plan.fire("p").kind == "corrupt"


def test_transient_raises_and_bad_rules_are_refused():
    plan = FaultPlan(_plan([{"point": "p", "kind": "transient"}]))
    with pytest.raises(InjectedFault):
        plan.fire("p")
    assert plan.firings[0]["kind"] == "transient"
    with pytest.raises(ValueError, match="kind"):
        FaultPlan(_plan([{"point": "p", "kind": "melt"}]))


def test_env_plan_parsing(monkeypatch, tmp_path):
    monkeypatch.setenv("SBR_FAULT_PLAN", json.dumps(_plan([{"point": "x", "kind": "nan"}], 3)))
    faults.reset()
    assert faults.plan().seed == 3
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(_plan([], 9)))
    monkeypatch.setenv("SBR_FAULT_PLAN", str(path))
    faults.reset()
    assert faults.plan().seed == 9
    monkeypatch.delenv("SBR_FAULT_PLAN")
    faults.reset()
    assert faults.plan() is None and faults.fire("x") is None


def _dispatch_u_sweep():
    from sbr_tpu_torch.baseline import solve_learning

    m = _base()
    ls = solve_learning(m.learning, CFG, device=CPU)
    return u_sweep(ls, US, m.economic, CFG)


def _dispatch_policy():
    base = tparams.make_interest_params(r=0.02, delta=0.1)
    return policy_sweep_interest(BETAS[:2], US[:2], [0.0, 0.02], base, config=CFG, device=CPU)


@pytest.mark.parametrize("sweep", ["beta_u_grid", "u_sweep", "policy_sweep_interest"])
def test_sweep_dispatch_fault_point_reaches_real_sweeps(sweep):
    run = {"beta_u_grid": _mono, "u_sweep": _dispatch_u_sweep,
           "policy_sweep_interest": _dispatch_policy}[sweep]
    faults.install(FaultPlan(_plan([
        {"point": "sweep.dispatch", "kind": "transient", "max_fires": 1}])))
    with pytest.raises(InjectedFault):
        run()
    assert run().status.numel() > 0  # max_fires spent: the next call runs clean
    assert faults.plan().firings[0]["target"].startswith(sweep.replace("_sweep_interest", "_interest"))


# ---------------------------------------------------------------------------
# Geometry and keys against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (4, 4), (5, 7), (64, 64)])
def test_tile_origins_equal_reference(shape):
    for nb, nu in ((4, 4), (6, 7), (13, 1), (1, 9)):
        assert tckpt.tile_origins(nb, nu, shape) == jckpt.tile_origins(nb, nu, shape)


def test_tile_assignment_equals_reference_and_partitions():
    for n_tiles in (1, 7, 8, 23):
        for n_proc in (1, 2, 3, 8):
            seen = []
            for p in range(n_proc):
                got = tdist.tile_assignment(n_tiles, n_proc, p)
                assert got == jdist.tile_assignment(n_tiles, n_proc, p)
                seen.extend(got)
            assert sorted(seen) == list(range(n_tiles))
    with pytest.raises(ValueError, match="process_id"):
        tdist.tile_assignment(4, 2, 2)


def test_sweep_fingerprint_carries_the_backend_tag():
    jbase, tbase = jparams.make_model_params(), _base()
    jcfg = jparams.SolverConfig(**CFG_KW)
    ours = tckpt._sweep_fingerprint(BETAS, US, tbase, CFG, (2, 2), torch.float64)
    assert ours == tckpt._sweep_fingerprint(BETAS, US, tbase, CFG, (2, 2), None)
    assert ours != tckpt._sweep_fingerprint(BETAS, US, tbase, CFG, (2, 2), torch.float32)
    for jdtype in (None, "float64"):
        assert ours != jckpt._sweep_fingerprint(BETAS, US, jbase, jcfg, (2, 2), jdtype)


def test_port_refuses_a_reference_checkpoint_dir(tmp_path):
    jckpt.run_tiled_grid(BETAS, US, jparams.make_model_params(),
                         config=jparams.SolverConfig(**CFG_KW), tile_shape=(2, 2),
                         checkpoint_dir=tmp_path, tile_owner=lambda b, u: b == 0)
    tiles = sorted(tmp_path.glob("tile_*.npz"))
    with pytest.raises(ValueError, match="different sweep"):
        _tiled(checkpoint_dir=tmp_path)
    assert sorted(tmp_path.glob("tile_*.npz")) == tiles  # nothing adopted or written


def test_auto_tile_shape_and_mesh_wait_for_their_items():
    with pytest.raises(NotImplementedError, match="1.A 9"):
        _tiled(tile_shape="auto")
    with pytest.raises(NotImplementedError, match="1.A 11"):
        _tiled(mesh=object())


def test_entry_points_need_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for run in (
        lambda: run_tiled_grid(BETAS, US, _base(), config=CFG, tile_shape=(2, 2)),
        lambda: run_tiled_grid_multihost(BETAS, US, _base(), str(tmp_path / "a"), config=CFG,
                                         tile_shape=(2, 2), timeout_s=5.0),
        lambda: run_tiled_grid_multihost(BETAS, US, _base(), str(tmp_path / "b"), config=CFG,
                                         tile_shape=(2, 2), elastic=False, timeout_s=5.0),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


# ---------------------------------------------------------------------------
# The tiled sweep against the reference and against the monolithic grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_ragged():
    return jckpt.run_tiled_grid(RB, RU, jparams.make_model_params(),
                                config=jparams.SolverConfig(**CFG_KW), tile_shape=(4, 3))


def test_tiled_grid_matches_reference(reference_ragged, tmp_path):
    got = _tiled(RB, RU, (4, 3), checkpoint_dir=tmp_path)
    ref = reference_ragged
    assert np.array_equal(got.status.numpy(), np.asarray(ref.status))
    assert _gap(got.xi.numpy(), ref.xi) <= 1e-12
    assert _gap(got.max_aw.numpy(), ref.max_aw) <= 1e-12
    assert (got.status.numpy() == 0).any() and (got.status.numpy() != 0).any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(4, 3), (1, 7), (6, 2), (5, 5)])
def test_tiled_equals_monolithic_bit_for_bit(dtype, shape):
    got = _tiled(RB, RU, shape, dtype=dtype)
    want = _mono(RB, RU, dtype=dtype)
    assert got.xi.dtype == dtype and got.status.dtype == torch.int32
    assert _same_grid(got, want)


def test_to_host_is_exact_across_dtypes():
    ts = [torch.tensor([[1.5, float("nan")]], dtype=torch.float64),
          torch.tensor([3.25, -0.0], dtype=torch.float32),
          torch.tensor([[-1], [7]], dtype=torch.int32),
          torch.zeros(0, dtype=torch.float64)]
    out = tckpt.to_host(*ts)
    for t, a in zip(ts, out):
        assert a.dtype == np.dtype(str(t.dtype).removeprefix("torch."))
        assert a.shape == tuple(t.shape) and a.tobytes() == t.numpy().tobytes()


def test_resume_from_disk_serves_tiles_and_recomputes_missing(tmp_path):
    first = _tiled(RB, RU, (3, 4), checkpoint_dir=tmp_path)
    tiles = sorted(tmp_path.glob("tile_*.npz"))
    assert len(tiles) == 4
    with np.load(tiles[0]) as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays["xi"] = np.full_like(arrays["xi"], 123.0)
    with open(tiles[0], "wb") as f:
        np.savez(f, **arrays)
    heal.write_sidecar(tiles[0])  # a valid sidecar: served, not quarantined
    tiles[1].unlink()
    report = {}
    second = _tiled(RB, RU, (3, 4), checkpoint_dir=tmp_path, report=report)
    assert report["counts"] == {"local": 3, "cache": 0, "computed": 1}
    assert np.all(second.xi.numpy()[:3, :4] == 123.0)
    assert _bits(second.max_aw) == _bits(first.max_aw)


def test_retry_then_raise(monkeypatch):
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected")

    monkeypatch.setattr(baseline_sweeps, "beta_u_grid", boom)
    with pytest.raises(RuntimeError, match="failed after 3 attempts"):
        _tiled(RB, RU, (6, 7), max_retries=2)
    assert calls["n"] == 3


def test_injected_transient_is_retried(tmp_path):
    faults.install(FaultPlan(_plan([
        {"point": "sweep.dispatch", "kind": "transient", "at_hits": [1]},
        {"point": "tile.compute", "kind": "transient", "at_hits": [3]},
    ])))
    got = _tiled(checkpoint_dir=tmp_path)
    assert _same_grid(got, _mono())
    assert [f["point"] for f in faults.plan().firings] == ["sweep.dispatch", "tile.compute"]


# ---------------------------------------------------------------------------
# Corrupt tiles, the degrade ladder, fault-free equality
# ---------------------------------------------------------------------------

def test_corrupt_tile_quarantined_and_recomputed(tmp_path):
    _tiled(checkpoint_dir=tmp_path)
    tiles = sorted(tmp_path.glob("tile_*.npz"))
    assert heal.verify_file(tiles[0]) == "ok"
    faults.corrupt_file(tiles[0])
    assert heal.verify_file(tiles[0]) == "mismatch"
    second = _tiled(checkpoint_dir=tmp_path)
    assert list((tmp_path / "quarantine").glob("tile_*.npz"))
    assert heal.verify_file(tiles[0]) == "ok"
    assert _same_grid(second, _mono())


def test_non_owner_leaves_foreign_corrupt_tile_in_place(tmp_path):
    _tiled(checkpoint_dir=tmp_path)
    tile = sorted(tmp_path.glob("tile_*.npz"))[0]
    faults.corrupt_file(tile)
    _tiled(checkpoint_dir=tmp_path, tile_owner=lambda b, u: False)
    assert tile.exists() and not (tmp_path / "quarantine").exists()
    assert heal.verify_file(tile) == "mismatch"


def test_legacy_tile_without_sidecar_is_trusted(tmp_path):
    _tiled(checkpoint_dir=tmp_path)
    tile = sorted(tmp_path.glob("tile_*.npz"))[0]
    with np.load(tile) as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays["xi"] = np.full_like(arrays["xi"], 321.0)
    with open(tile, "wb") as f:
        np.savez(f, **arrays)
    heal.sidecar_path(tile).unlink()
    assert heal.verify_file(tile) == "legacy"
    assert np.all(_tiled(checkpoint_dir=tmp_path).xi.numpy()[:2, :2] == 321.0)


NAN_RULE = {"point": "tile.result", "kind": "nan", "cells": 3, "max_fires": 1}


@pytest.fixture(scope="module")
def reference_repairs(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ref_repairs")
    jfaults.install(jfaults.FaultPlan(_plan([NAN_RULE])))
    try:
        grid = jckpt.run_tiled_grid(BETAS, US, jparams.make_model_params(),
                                    config=jparams.SolverConfig(**CFG_KW),
                                    tile_shape=(2, 2), checkpoint_dir=ck)
    finally:
        jfaults.install(None)
    return grid, json.loads((ck / "manifest.json").read_text())["repairs"]


def test_nan_poisoned_tile_repaired_as_the_reference_repairs_it(reference_repairs, tmp_path):
    ref_grid, ref_repairs = reference_repairs
    faults.install(FaultPlan(_plan([NAN_RULE])))
    report = {}
    healed = _tiled(checkpoint_dir=tmp_path, report=report)
    repairs = json.loads((tmp_path / "manifest.json").read_text())["repairs"]
    assert repairs == report["repairs"] == ref_repairs
    assert [r["rung"] for r in repairs] == [0, 0, 0] and all(r["repaired"] for r in repairs)
    assert _same_grid(healed, _mono())  # the exact fault-free values
    assert _gap(healed.xi.numpy(), ref_grid.xi) <= 1e-12
    assert _gap(healed.max_aw.numpy(), ref_grid.max_aw) <= 1e-12


def test_heal_disabled_leaves_poison():
    faults.install(FaultPlan(_plan([NAN_RULE])))
    poisoned = _tiled(heal_divergent=False)
    xi, want = poisoned.xi.numpy(), _mono().xi.numpy()
    assert np.isnan(xi[0, 0]) and np.isnan(xi[0, 1]) and np.isnan(xi[1, 0])
    rest = xi.copy()
    rest[:2, :2] = want[:2, :2]
    assert rest.tobytes() == want.tobytes()


def test_ladder_rungs_and_unrepairable_cell():
    cfg = tparams.SolverConfig(n_grid=96, bisect_iters=30)
    rungs = heal._ladder(cfg, torch.float32)
    assert rungs[0] == (cfg, torch.float32)
    assert rungs[1][0].bisect_iters == 90 and rungs[1][1] == torch.float64
    assert heal._ladder(tparams.SolverConfig(bisect_iters=60), None)[1][0].bisect_iters == 120
    # a NaN β stays divergent on every rung: reported, never patched
    arrays = {"xi": np.array([[5.0]]), "max_aw": np.array([[0.5]]),
              "status": np.array([[0]], np.int32)}
    flags = np.array([[1 << 7]], np.int32)
    report = heal.repair_divergent([float("nan")], [0.1], _base(), CFG, None, arrays,
                                   flags, device=CPU)
    assert report == [{"cell": [0, 0], "flags": 128, "rung": None, "repaired": False}]
    assert arrays["xi"][0, 0] == 5.0


def test_faulted_and_resumed_equals_fault_free(tmp_path):
    """A transient compute, a NaN result and a torn save in one seeded
    plan, then a resume: byte-identical to the fault-free grid."""
    faults.install(FaultPlan(_plan([
        {"point": "tile.compute", "kind": "transient", "at_hits": [1]},
        {"point": "tile.result", "kind": "nan", "at_hits": [2], "cells": 2},
        {"point": "checkpoint.save", "kind": "corrupt", "at_hits": [3]},
    ], seed=5)))
    report = {}
    faulted = _tiled(RB, RU, (4, 3), checkpoint_dir=tmp_path, report=report)
    kinds = [f["kind"] for f in faults.plan().firings]
    assert kinds == ["transient", "nan", "corrupt"]
    assert len(report["repairs"]) == 2 and all(r["repaired"] for r in report["repairs"])
    faults.install(None)
    report = {}
    resumed = _tiled(RB, RU, (4, 3), checkpoint_dir=tmp_path, report=report)
    assert report["counts"] == {"local": 5, "cache": 0, "computed": 1}
    assert len(list((tmp_path / "quarantine").glob("tile_*.npz"))) == 1
    want = _tiled(RB, RU, (4, 3))
    assert _same_grid(faulted, want) and _same_grid(resumed, want)


# ---------------------------------------------------------------------------
# Processes: SIGKILL and SIGTERM
# ---------------------------------------------------------------------------

WORKER = """
import sys
import numpy as np
import torch
from sbr_tpu_torch.models.params import SolverConfig, make_model_params
from sbr_tpu_torch.resilience import FaultPlan, faults
from sbr_tpu_torch.utils import run_tiled_grid

torch.set_num_threads(1)
faults.install(FaultPlan({"seed": 0, "rules": [RULE]}))
run_tiled_grid(np.linspace(0.5, 2.0, 4), np.linspace(0.05, 0.5, 4), make_model_params(),
               config=SolverConfig(n_grid=96, bisect_iters=40, numerics="fixed"),
               tile_shape=(2, 2), checkpoint_dir=sys.argv[1], device="cpu")
print("UNREACHABLE")
"""


def _worker(tmp_path, rule) -> Path:
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("RULE", json.dumps(rule)))
    return script


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "SBR_FAULT_PLAN": ""}


def test_resume_after_sigkill_mid_tile(tmp_path):
    ckpt = tmp_path / "ckpt"
    script = _worker(tmp_path, {"point": "tile.compute", "kind": "hang", "at_hits": [3],
                                "duration_s": 120.0})
    proc = subprocess.Popen([sys.executable, str(script), str(ckpt)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=_env())
    try:
        deadline = time.monotonic() + 120.0
        while len(list(ckpt.glob("tile_*.npz"))) < 2:
            assert proc.poll() is None, f"worker died early:\n{proc.stdout.read()}"
            assert time.monotonic() < deadline, "worker never produced 2 tiles"
            time.sleep(0.1)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    assert proc.returncode == -signal.SIGKILL
    assert len(list(ckpt.glob("tile_*.npz"))) == 2
    report = {}
    resumed = _tiled(checkpoint_dir=ckpt, report=report)
    assert report["counts"] == {"local": 2, "cache": 0, "computed": 2}
    assert _same_grid(resumed, _tiled())


def test_sigterm_exits_143_and_leaves_no_partial_files(tmp_path):
    ckpt = tmp_path / "ckpt"
    script = _worker(tmp_path, {"point": "tile.compute", "kind": "preempt", "at_hits": [2]})
    proc = subprocess.Popen([sys.executable, str(script), str(ckpt)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=_env())
    try:
        out, _ = proc.communicate(timeout=120.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    assert proc.returncode == 143, out
    assert "UNREACHABLE" not in out
    assert not list(ckpt.glob("*.tmp"))
    assert len(list(ckpt.glob("tile_*.npz"))) == 1  # the tile before the preemption
    assert _same_grid(_tiled(checkpoint_dir=ckpt), _tiled())


def test_graceful_shutdown_removes_registered_files_and_nests(tmp_path):
    tmp = tmp_path / "partial.tmp"
    lease = tmp_path / "tile_b00000_u00000.lease"
    for p in (tmp, lease):
        p.write_text("{}")
    shutdown.release_on_exit(lease)
    # a save whose own cleanup never ran: registered, never unregistered
    held = shutdown.track_tmp(tmp)
    held.__enter__()
    with pytest.raises(SystemExit) as exc:
        with shutdown.graceful_shutdown(label="outer"):
            with shutdown.graceful_shutdown(label="inner"):
                raise shutdown.Interrupted(signal.SIGTERM)
    assert exc.value.code == 128 + signal.SIGTERM
    assert not tmp.exists() and not lease.exists()
    del held
    assert shutdown.interrupted_status() == "tracked_tmp=0 held_releases=0 depth=0"
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    with pytest.raises(KeyboardInterrupt):
        with shutdown.graceful_shutdown():
            raise shutdown.Interrupted(signal.SIGINT)


# ---------------------------------------------------------------------------
# The static multi-process split and its work stealing
# ---------------------------------------------------------------------------

SB = np.linspace(0.5, 3.0, 6)
SU = np.linspace(0.02, 0.3, 8)


def _static(tmp_path, **kw):
    return run_tiled_grid_multihost(SB, SU, _base(), str(tmp_path), config=CFG,
                                    tile_shape=(3, 4), elastic=False, device=CPU, **kw)


def _direct():
    return run_tiled_grid(SB, SU, _base(), config=CFG, tile_shape=(3, 4), device=CPU)


def test_two_process_static_split_assembles_full_grid(tmp_path):
    assert _static(tmp_path, process_id=0, num_processes=2, wait=False) is None
    assert 0 < len(list(tmp_path.glob("tile_*.npz"))) < 4
    full = _static(tmp_path, process_id=1, num_processes=2, poll_s=0.1, timeout_s=10.0)
    assert len(list(tmp_path.glob("tile_*.npz"))) == 4
    assert _same_grid(full, _direct())


def test_static_split_defaults_to_one_process(tmp_path):
    assert _same_grid(_static(tmp_path, poll_s=0.05, timeout_s=10.0), _direct())


def test_wait_times_out_on_missing_peer(tmp_path):
    with pytest.raises(TimeoutError, match="peer process likely died"):
        _static(tmp_path, process_id=0, num_processes=2, poll_s=0.05, timeout_s=0.3,
                work_steal=False)


def test_survivor_adopts_orphaned_tiles(tmp_path):
    full = _static(tmp_path, process_id=0, num_processes=2, poll_s=0.05, timeout_s=120.0,
                   steal_grace_s=0.2, lease_ttl_s=5.0)
    assert len(list(tmp_path.glob("tile_*.npz"))) == 4
    assert not list(tmp_path.glob("tile_*.lease"))
    assert _same_grid(full, _direct())


def test_live_lease_blocks_expired_lease_taken(tmp_path):
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is False
    lease = tmp_path / "tile_b00000_u00000.lease"
    rec = json.loads(lease.read_text())
    assert set(rec) == {"pid", "host", "nonce", "ts", "ttl_s"}
    rec["ts"] -= 120.0
    lease.write_text(json.dumps(rec))
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True
    lease.write_text("{torn")  # a dead holder's torn write
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True


def test_lease_takeover_exactly_at_ttl_boundary(tmp_path, monkeypatch):
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True
    lease = tmp_path / "tile_b00000_u00000.lease"
    ts = json.loads(lease.read_text())["ts"]
    monkeypatch.setattr(tdist.time, "time", lambda: ts + 60.0)
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True
    fresh_ts = json.loads(lease.read_text())["ts"]
    monkeypatch.setattr(tdist.time, "time", lambda: fresh_ts + 59.999)
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is False


def test_expired_lease_race_loser_backs_off(tmp_path, monkeypatch):
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is True
    lease = tmp_path / "tile_b00000_u00000.lease"
    rec = json.loads(lease.read_text())
    rec["ts"] -= 120.0
    lease.write_text(json.dumps(rec))
    real_replace = os.replace

    def racing_replace(src, dst):
        real_replace(src, dst)
        if str(dst) == str(lease):  # a racer replaces right after us
            rival = dict(json.loads(lease.read_text()))
            rival["nonce"] = "rival-nonce"
            lease.write_text(json.dumps(rival))

    monkeypatch.setattr(tdist.os, "replace", racing_replace)
    assert tdist._try_lease(tmp_path, 0, 0, ttl_s=60.0) is False


def test_static_split_reads_the_process_group(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert tdist._default_rank_and_world(None, None) == (1, 2)
    assert tdist._default_rank_and_world(0, 3) == (0, 3)
    _static(tmp_path, wait=False)  # rank 1 of 2: the second half of the tiles
    got = sorted(p.name for p in tmp_path.glob("tile_*.npz"))
    assert got == ["tile_b00003_u00000.npz", "tile_b00003_u00004.npz"]
