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
- the grid is batch-invariant: a sub-grid's cells equal the full grid's.
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
    with pytest.raises(NotImplementedError, match="mesh"):
        tps.policy_sweep_interest([1.0], [0.1], [0.0], base, mesh=object(), device=CPU)
    assert tps.POLICY_PROGRAM_VERSION == jps.POLICY_PROGRAM_VERSION
