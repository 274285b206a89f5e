"""The port's heterogeneous-learning extension (sbr_tpu_torch.hetero, with
the hetero params and result records) against sbr_tpu.hetero, on the CPU.

Contracts:

- Stage 1, all three routes of `solve_learning_hetero`:
  - the exact Ω reduction (``grid_warp > 0``, the default): the warped
    grid, the CDFs and the PDFs within F64_TOL = 1e-12 (measured 7.3e-14
    on the grid, whose knots reach 44; 3.2e-14 on the CDFs);
  - RK4 on a uniform grid (``grid_warp == 0``, fixed): within F64_TOL
    (measured 1.1e-16);
  - `bs32` (``grid_warp == 0``, adaptive): ``ode_flags`` exact, values
    within test_torch_ode's BS32_TOL = 1e-6 of the compiled reference
    (measured 2.4e-7 at n_grid 384), for the reason stated there.
- Stages 2-3 from a Stage 1 carried across (`hetero_solution_from_numpy`):
  status, bankrun, converged and ``Health.flags`` exact, the fixed path's
  iteration counts exact; ξ, τ̄_IN, τ̄_OUT, the hazards and the AW curves
  within F64_TOL (measured 4.4e-16).
- The whole chain on the port's own Stage 1 (exact route): the same
  integers exact, floats within F64_TOL (measured 6.0e-14).
- In float32 the integers exact and floats within F32_TOL = 2e-5.
- The Section-2 model (``figures/master.py:233-235``) meets the scipy
  oracle of tests/oracle.py within the reference test's bounds.

Measured spreads: tests/torch_parity_report.py extensions.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.hetero import learning as jhl  # noqa: E402
from sbr_tpu.hetero import solver as jhs  # noqa: E402
from sbr_tpu.models import params as jp  # noqa: E402
from sbr_tpu_torch.hetero import hetero_solution_from_numpy  # noqa: E402
from sbr_tpu_torch.hetero import learning as thl  # noqa: E402
from sbr_tpu_torch.hetero import solver as ths  # noqa: E402
from sbr_tpu_torch.models import params as tp  # noqa: E402

from oracle import solve_hetero_oracle  # noqa: E402

CPU = "cpu"
F64_TOL = 1e-12
F32_TOL = 2e-5
BS32_TOL = 1e-6
N_GRID = 384

# Section 2 of the paper's figures (figures/master.py:233-235)
SECTION2 = dict(betas=(0.125, 12.5), dist=(0.9, 0.1), eta_bar=30.0, u=0.1, p=0.9,
                kappa=0.3, lam=0.1)
# A two-group model whose fast group is slow enough for a cheap RK4 route
# (hetero_substeps keeps β_max·h under 0.015)
MILD = dict(betas=(0.5, 2.0), dist=(0.5, 0.5), eta_bar=15.0, u=0.1, p=0.9, kappa=0.3, lam=0.1)
NO_RUN = dict(SECTION2, u=5.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), np.abs(got[ok] - want[ok]).max()


def _configs(numerics, warp, n_grid=N_GRID):
    kw = dict(n_grid=n_grid, numerics=numerics, grid_warp=warp)
    return tp.SolverConfig(**kw), jp.SolverConfig(**kw)


@functools.lru_cache(maxsize=None)
def _stage1(model, numerics, warp, t_dtype=torch.float64, np_dtype=np.float64):
    kw = dict(model)
    tc, jc = _configs(numerics, warp)
    tm, jm = tp.make_hetero_params(**kw), jp.make_hetero_params(**kw)
    return (thl.solve_learning_hetero(tm.learning, tc, dtype=t_dtype, device=CPU),
            jhl.solve_learning_hetero(jm.learning, jc, dtype=np_dtype), tm, jm, tc, jc)


def _key(model):
    return tuple(sorted(model.items()))


def _carried(jl):
    return hetero_solution_from_numpy(
        *(np.array(x) for x in (jl.grid, jl.cdfs, jl.pdfs, jl.t0, jl.dt, jl.betas, jl.dist)),
        ode_flags=None if jl.ode_flags is None else np.array(jl.ode_flags), device=CPU,
    )


def _assert_result_parity(r, jr, tol, fixed):
    assert int(r.status) == int(jr.status)
    assert bool(r.bankrun) == bool(jr.bankrun) and bool(r.converged) == bool(jr.converged)
    assert int(r.health.flags) == int(jr.health.flags)
    if fixed:
        assert int(r.health.iterations) == int(jr.health.iterations)
    for f in ("xi", "tau_bar_in_uncs", "tau_bar_out_uncs", "tolerance", "tau_grid", "hrs"):
        _close(getattr(r, f), getattr(jr, f), tol)


ROUTES = [("fixed", 0.5), ("adaptive", 0.5), ("fixed", 0.0), ("adaptive", 0.0)]


@pytest.mark.parametrize("numerics,warp", ROUTES)
def test_stage1_routes_match_reference(numerics, warp):
    model = SECTION2 if warp > 0 or numerics == "adaptive" else MILD
    tl, jl, *_ = _stage1(_key(model), numerics, warp)
    tol = BS32_TOL if (warp == 0 and numerics == "adaptive") else F64_TOL
    _close(tl.grid, jl.grid, F64_TOL)
    _close(tl.cdfs, jl.cdfs, tol)
    _close(tl.pdfs, jl.pdfs, tol)
    _close(tl.betas, jl.betas, 0.0)
    if jl.ode_flags is None:
        assert tl.ode_flags is None
    else:
        assert int(tl.ode_flags) == int(jl.ode_flags)


@pytest.mark.parametrize("numerics,warp", ROUTES)
@pytest.mark.parametrize("name", ["section2", "no_run"])
def test_stages23_from_carried_stage1(numerics, warp, name):
    model = {"section2": SECTION2, "no_run": NO_RUN}[name]
    if warp == 0 and numerics == "fixed":
        model = dict(MILD, u=model["u"])
    _, jl, tm, jm, tc, jc = _stage1(_key(model), numerics, warp)
    jr = jhs.solve_equilibrium_hetero(jl, jm.economic, jc)
    tl = _carried(jl)
    r = ths.solve_equilibrium_hetero(tl, tm.economic, tc)
    _assert_result_parity(r, jr, F64_TOL, numerics == "fixed")
    ja, ta = jhs.get_aw_hetero(jr, jl), ths.get_aw_hetero(r, tl)
    for f in ("t_grid", "aw_cum", "aw_out_groups", "aw_in_groups", "aw_groups", "aw_max"):
        _close(getattr(ta, f), getattr(ja, f), F64_TOL)
    if name == "no_run":
        assert int(r.status) == 1 and np.isnan(float(r.xi))


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_whole_chain_on_the_ports_stage1(numerics):
    tl, jl, tm, jm, tc, jc = _stage1(_key(SECTION2), numerics, 0.5)
    r = ths.solve_equilibrium_hetero(tl, tm.economic, tc)
    jr = jhs.solve_equilibrium_hetero(jl, jm.economic, jc)
    _assert_result_parity(r, jr, F64_TOL, numerics == "fixed")
    assert bool(r.bankrun)
    assert r.solve_time > 0.0


def test_float32_exact_route():
    tl, jl, tm, jm, tc, jc = _stage1(_key(SECTION2), "fixed", 0.5, torch.float32, np.float32)
    assert tl.cdfs.dtype == torch.float32
    _close(tl.cdfs, jl.cdfs, F32_TOL)
    r = ths.solve_equilibrium_hetero(tl, tm.economic, tc)
    jr = jhs.solve_equilibrium_hetero(jl, jm.economic, jc)
    _assert_result_parity(r, jr, F32_TOL * 10, True)


def test_section2_meets_the_oracle():
    m = tp.make_hetero_params(**SECTION2)
    cfg = tp.SolverConfig(n_grid=4096, numerics="fixed")
    lsh = thl.solve_learning_hetero(m.learning, cfg, device=CPU)
    res = ths.solve_equilibrium_hetero(lsh, m.economic, cfg)
    oracle = solve_hetero_oracle([0.125, 12.5], [0.9, 0.1], n_scan=400)
    assert bool(res.bankrun) == oracle.bankrun
    np.testing.assert_allclose(float(res.xi), oracle.xi, atol=1e-5)
    np.testing.assert_allclose(_np(res.tau_bar_in_uncs), oracle.tau_bar_ins, atol=1e-4)
    np.testing.assert_allclose(_np(res.tau_bar_out_uncs), oracle.tau_bar_outs, atol=1e-4)
    aw = ths.get_aw_hetero(res, lsh)
    assert float(aw.aw_max) >= m.economic.kappa


def test_params_and_not_ported_options():
    tm, jm = tp.make_hetero_params(**SECTION2), jp.make_hetero_params(**SECTION2)
    assert tm.learning.betas == jm.learning.betas and tm.learning.tspan == jm.learning.tspan
    assert tm.economic.eta == jm.economic.eta and tm.learning.n_groups == 2
    with pytest.raises(ValueError, match="sum to 1"):
        tp.make_hetero_params(betas=[1.0, 2.0], dist=[0.5, 0.6])
    tl, *_ = _stage1(_key(SECTION2), "fixed", 0.5)
    with pytest.raises(NotImplementedError, match="axis_name"):
        ths.solve_equilibrium_hetero(tl, tm.economic, axis_name="k")
    # the scenario hooks are ported: an identity hook is the hook-free
    # solve bit for bit, and a hook's rows are the ones solved on
    plain = ths.solve_equilibrium_hetero(tl, tm.economic)
    ident = ths.solve_equilibrium_hetero(tl, tm.economic,
                                         hazard_transform=lambda g, h, _: (h, None, ()),
                                         kappa_transform=lambda k: k)
    assert torch.equal(ident.hrs, plain.hrs) and torch.equal(ident.status, plain.status)
    assert _np(ident.xi).tobytes() == _np(plain.xi).tobytes()
    doubled = ths.solve_equilibrium_hetero(tl, tm.economic,
                                           hazard_transform=lambda g, h, _: (2.0 * h, None, ()))
    assert torch.equal(doubled.hrs, 2.0 * plain.hrs)
