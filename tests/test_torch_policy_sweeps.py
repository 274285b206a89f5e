"""The port's (β, u, r) policy sweep (sbr_tpu_torch.sweeps.policy_sweeps)
against sbr_tpu.sweeps.policy_sweeps, on the CPU.

Contracts, on grids of at most 3×3×3 cells from the stretch shape's axes
(``benchmarks/stretch.py:122-140``: β in [0.5, 3], u in [0, 0.45], r in
[0, 0.09]) at n_grid 256:

- status and ``Health.flags`` grids exactly equal in float64 and float32,
  under both numerics;
- fixed numerics: ξ and AW_max within F64_TOL = 1e-12 (measured 8.9e-16)
  and F32_TOL = 2e-5 (measured 1.2e-7), and the iteration grids equal;
- adaptive numerics: ξ and AW_max within ADAPTIVE_TOL = 1e-9 in float64
  (measured 4.1e-10: the HJB's `bs32` decisions, test_torch_ode) and
  F32_TOL in float32 (measured 4.8e-7); the Chandrupatla iteration
  counts equal on at least ADAPTIVE_EQUAL_COUNTS = 75% of the cells
  (measured 89% in float64 and 93% in float32 on the 3×3×3 grid,
  tests/torch_parity_report.py extensions): a count is decided in f's
  last bits, and a NO_ROOT cell's search stops where it stops (slice 3);
- each cell equals the port's scalar interest solve of that cell, and the
  r = 0 plane equals the port's β×u grid;
- the grid is batch-invariant: a sub-grid's cells equal the full grid's;
- telemetry: under a run the sweep logs the reference's preflight record,
  ``sweeps.policy_interest`` span, program call, status and health
  censuses and cell counter, after a warm-up; with the run or without it
  the grid's bits are the same.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.models import params as jp  # noqa: E402
from sbr_tpu.sweeps import policy_sweeps as jps  # noqa: E402
from sbr_tpu_torch.baseline import learning as tbl  # noqa: E402
from sbr_tpu_torch.interest import solver as tis  # noqa: E402
from sbr_tpu_torch.models import params as tp  # noqa: E402
from sbr_tpu_torch.sweeps import beta_u_grid  # noqa: E402
from sbr_tpu_torch.sweeps import policy_sweeps as tps  # noqa: E402
from torch_events import assert_same_events, events  # noqa: E402

CPU = "cpu"
F64_TOL = 1e-12
F32_TOL = 2e-5
ADAPTIVE_TOL = 1e-9
ADAPTIVE_EQUAL_COUNTS = 0.75
N_GRID = 256

BETAS = np.linspace(0.5, 3.0, 3)
US = np.linspace(0.0, 0.45, 3)
RS = np.linspace(0.0, 0.09, 3)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        assert np.abs(got[ok] - want[ok]).max() <= tol, np.abs(got[ok] - want[ok]).max()


def _config(numerics, mod=tp):
    return mod.SolverConfig(n_grid=N_GRID, numerics=numerics, refine_crossings=False,
                            bisect_iters=60)


@functools.lru_cache(maxsize=None)
def _sweeps(numerics, t_dtype, np_dtype, n=3):
    axes = (BETAS[:n], US[:n], RS[:n])
    port = tps.policy_sweep_interest(*axes, tp.make_interest_params(u=0.0, delta=0.1),
                                     _config(numerics), dtype=t_dtype, device=CPU)
    ref = jps.policy_sweep_interest(*axes, jp.make_interest_params(u=0.0, delta=0.1),
                                    _config(numerics, jp), dtype=np_dtype)
    return port, ref


CASES = [("fixed", torch.float64, np.float64), ("fixed", torch.float32, np.float32),
         ("adaptive", torch.float64, np.float64), ("adaptive", torch.float32, np.float32)]


@pytest.mark.parametrize("numerics,t_dtype,np_dtype", CASES)
def test_policy_grid_matches_reference(numerics, t_dtype, np_dtype):
    port, ref = _sweeps(numerics, t_dtype, np_dtype, 3 if numerics == "fixed" else 2)
    assert port.status.shape == tuple(ref.status.shape)
    assert np.array_equal(_np(port.status), np.asarray(ref.status))
    assert np.array_equal(_np(port.health.flags), np.asarray(ref.health.flags))
    if t_dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = F64_TOL if numerics == "fixed" else ADAPTIVE_TOL
    _close(port.xi, ref.xi, tol)
    _close(port.aw_max, ref.aw_max, tol)
    assert port.xi.dtype == t_dtype
    if numerics == "fixed":
        assert np.array_equal(_np(port.health.iterations), np.asarray(ref.health.iterations))
    else:
        got, want = _np(port.health.iterations), np.asarray(ref.health.iterations)
        assert (got == want).mean() >= ADAPTIVE_EQUAL_COUNTS


def test_every_status_occurs_on_the_test_grid():
    port, _ = _sweeps("fixed", torch.float64, np.float64)
    assert set(np.unique(_np(port.status))) >= {0, 1, 2}


def test_cells_equal_scalar_solves_and_the_r0_plane_the_baseline_grid():
    port, _ = _sweeps("fixed", torch.float64, np.float64)
    base = tp.make_interest_params(u=0.0, delta=0.1)
    cfg = _config("fixed")
    for ib, iu, ir in [(0, 0, 1), (1, 2, 2), (2, 1, 0)]:
        m = tp.make_interest_params(beta=BETAS[ib], eta=base.economic.eta, u=US[iu], r=RS[ir],
                                    delta=0.1, tspan=base.learning.tspan)
        ls = tbl.solve_learning(m.learning, cfg, device=CPU)
        res = tis.solve_equilibrium_interest(ls, m.economic, cfg).base
        assert int(res.status) == int(port.status[ib, iu, ir])
        _close(res.xi, port.xi[ib, iu, ir], F64_TOL)
        _close(res.aw_max, port.aw_max[ib, iu, ir], F64_TOL)
    grid = beta_u_grid(BETAS, US, tp.make_model_params(u=0.0), _config("fixed"), device=CPU)
    assert torch.equal(grid.status, port.status[:, :, 0])
    _close(grid.xi, port.xi[:, :, 0], F64_TOL)


def test_sub_grid_cells_equal_the_full_grid():
    full, _ = _sweeps("fixed", torch.float64, np.float64)
    sub = tps.policy_sweep_interest(BETAS[1:], US[:2], RS[2:], tp.make_interest_params(u=0.0),
                                    _config("fixed"), device=CPU)
    assert torch.equal(sub.status, full.status[1:, :2, 2:])
    assert torch.equal(sub.xi.nan_to_num(-1.0), full.xi[1:, :2, 2:].nan_to_num(-1.0))


def test_policy_sweep_validation_and_not_ported_options():
    base = tp.make_interest_params(delta=0.1)
    with pytest.raises(ValueError, match="delta"):
        tps.policy_sweep_interest([1.0], [0.1], [0.1], base, device=CPU)
    # mesh= is ported (tests/test_torch_parallel.py); an axis that does not
    # divide its values is refused before any collective
    from torch_mesh import AxisStub

    with pytest.raises(ValueError, match="does not divide"):
        tps.policy_sweep_interest([1.0], [0.1, 0.2, 0.3], [0.0], base,
                                  mesh=AxisStub(b=(1, 0), u=(2, 0)))
    assert tps.POLICY_PROGRAM_VERSION == jps.POLICY_PROGRAM_VERSION


def test_policy_sweep_events_equal_the_reference(tmp_path):
    import json

    from sbr_tpu import obs as jobs
    from sbr_tpu_torch import obs

    axes = (BETAS[:2], US[:2], RS[:2])
    for name in ("warm", "ref"):  # the reference's trace-time spans fire once
        with jobs.run_context(run_dir=str(tmp_path / name)):
            jps.policy_sweep_interest(*axes, jp.make_interest_params(u=0.0, delta=0.1),
                                      _config("fixed", jp))
    off = tps.policy_sweep_interest(*axes, tp.make_interest_params(u=0.0, delta=0.1),
                                    _config("fixed"), device=CPU)
    with obs.run_context(run_dir=str(tmp_path / "port")):
        on = tps.policy_sweep_interest(*axes, tp.make_interest_params(u=0.0, delta=0.1),
                                       _config("fixed"), device=CPU)
    got, want = events(tmp_path / "port"), events(tmp_path / "ref")
    assert_same_events(got, want, {"preflight", "stage_start", "stage_end", "jit_call",
                                   "status", "health"})
    for f in ("xi", "aw_max", "status"):
        assert _np(getattr(on, f)).tobytes() == _np(getattr(off, f)).tobytes()
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert [m["metrics"]["counters"]["sweeps.policy_interest.cells"] for m in manifests] == \
        [8, 8]


def _recorded_preflights(monkeypatch):
    """Every preflight record the sweep makes, in order."""
    from sbr_tpu_torch.obs import mem

    records = []
    real = mem.preflight

    def spy(*args, **kwargs):
        rec = real(*args, **kwargs)
        records.append(rec)
        return rec

    monkeypatch.setattr(mem, "preflight", spy)
    return records


def test_policy_preflight_verdicts_cpu_and_mesh(monkeypatch):
    """Without a card the preflight skips and measures nothing ("skipped",
    "no-capacity"), as the reference's does on the CPU; under a mesh it
    skips with reason "sharded", even with a capacity."""
    import torch_mesh as tm
    from sbr_tpu_torch import parallel
    from sbr_tpu_torch.obs import mem

    records = _recorded_preflights(monkeypatch)
    base = tp.make_interest_params(u=0.0, delta=0.1)
    tps._FOOTPRINT_CACHE.clear()
    # a card in the process does not give a grid on the CPU its budget
    monkeypatch.setattr(mem, "device_capacity", lambda stats=None: 80 * 2**30)
    tps.policy_sweep_interest(BETAS[:2], US[:2], RS[:2], base, _config("fixed"), device=CPU)
    assert records[-1]["verdict"] == "skipped" and records[-1]["reason"] == "no-capacity"
    assert records[-1]["label"] == "policy[2x2x2]" and not tps._FOOTPRINT_CACHE
    with tm.world_one():
        mesh = parallel.make_grid_mesh(device="cpu")
        got = tps.policy_sweep_interest(BETAS[:2], US[:2], RS[:2], base, _config("fixed"),
                                        mesh=mesh)
    assert records[-1]["verdict"] == "skipped" and records[-1]["reason"] == "sharded"
    assert not tps._FOOTPRINT_CACHE
    assert got.status.shape == (2, 2, 2)


def test_policy_preflight_measures_and_fails_closed(monkeypatch, tmp_path):
    """With a capacity (stubbed here: a grid on the CPU has none) the grid's
    footprint is measured (two probe grids, modelled out to a larger grid)
    and held to the budget: an oversized grid raises before it runs; one
    that fits runs and equals the grid without the preflight."""
    from sbr_tpu_torch import obs
    from sbr_tpu_torch.obs import mem
    from sbr_tpu_torch.resilience import faults

    records = _recorded_preflights(monkeypatch)
    dispatched = []
    real_fire = faults.fire
    monkeypatch.setattr(faults, "fire", lambda point, **kw: (
        dispatched.append(point) if point == "sweep.dispatch" else None,
        real_fire(point, **kw))[1])
    base = tp.make_interest_params(u=0.0, delta=0.1)
    axes = (np.linspace(0.5, 3.0, 5), np.linspace(0.0, 0.45, 5), RS)
    tps._FOOTPRINT_CACHE.clear()
    monkeypatch.setattr(tps, "_capacity", lambda dev: 4096)
    with pytest.raises(mem.MemoryPreflightError, match=r"policy\[5x5x3\]"):
        tps.policy_sweep_interest(*axes, base, _config("fixed"), device=CPU)
    assert records[-1]["verdict"] == "exceeds" and not dispatched
    # the two probes were measured, each once (cached per shape and config)
    assert sorted(k[0] for k in tps._FOOTPRINT_CACHE) == [(2, 2, 2), (4, 4, 4)]
    probes = [tps._FOOTPRINT_CACHE[k] for k in sorted(tps._FOOTPRINT_CACHE)]
    assert all(p["source"] == "measured" and p["total_bytes"] > 0 for p in probes)
    assert probes[1]["total_bytes"] > probes[0]["total_bytes"]
    assert records[-1]["footprint_bytes"] > probes[1]["total_bytes"]
    monkeypatch.setattr(tps, "_capacity", lambda dev: 80 * 2**30)
    tps._FOOTPRINT_CACHE.clear()
    with obs.run_context(run_dir=str(tmp_path / "measured")):
        fits = tps.policy_sweep_interest(*axes, base, _config("fixed"), device=CPU)
    assert records[-1]["verdict"] == "ok" and dispatched == ["sweep.dispatch"]
    monkeypatch.setenv("SBR_MEM_PREFLIGHT", "0")
    with obs.run_context(run_dir=str(tmp_path / "off")):
        plain = tps.policy_sweep_interest(*axes, base, _config("fixed"), device=CPU)
    # the probes run silently: the run's events are those of the grid alone
    # and the preflight record
    kinds = [[e["kind"] for e in events(tmp_path / d)] for d in ("measured", "off")]
    assert [k for k in kinds[0] if k != "preflight"] == kinds[1] and "preflight" in kinds[0]
    for f in ("xi", "aw_max", "status"):
        assert _np(getattr(fits, f)).tobytes() == _np(getattr(plain, f)).tobytes()
    # a grid no larger than the larger probe is measured as it is
    assert tps._preflight_footprint(2, 2, 2, _config("fixed"), torch.float64,
                                    torch.device(CPU))["source"] == "measured"
