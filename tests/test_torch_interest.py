"""The port's interest-rate extension (sbr_tpu_torch.interest, with the
interest params) against sbr_tpu.interest, on the CPU.

Contracts, on the Section-3 model (``figures/master.py:258-260``) and a
second calibration:

- the value function V from the same hazard table:
  - fixed numerics (the hoisted-node RK4 scan): within F64_TOL = 1e-12
    (measured 2.2e-16);
  - adaptive numerics (`bs32` with the cells as lanes): bit for bit equal
    to the reference run op by op (``jax.disable_jit()``) with equal
    attempt counts and flags; against the compiled reference flags exact
    and values within BS32_TOL = 1e-6 (measured 1.8e-10 at n_grid 256),
    for the reason test_torch_ode states;
- the whole solve (V, the effective hazard, τ̄_IN, τ̄_OUT, ξ, AW_max):
  status, bankrun and ``Health.flags`` exact; floats within F64_TOL under
  fixed numerics (measured 3.6e-15), within ADAPTIVE_TOL = 1e-9 under
  adaptive numerics (measured 5.4e-12 on V and 1.6e-12 on ξ at n_grid
  512: the compiled reference's bs32 rounds its own way; ROADMAP.md §3);
- float32: the integers exact, floats within F32_TOL = 2e-5;
- r = 0 gives the port's own baseline answer; the Section-3 model meets
  the scipy oracle of tests/oracle.py.

Measured spreads: tests/torch_parity_report.py extensions.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.baseline import learning as jbl  # noqa: E402
from sbr_tpu.baseline import solver as jbs  # noqa: E402
from sbr_tpu.interest import solver as jis  # noqa: E402
from sbr_tpu.interest import value_function as jvf  # noqa: E402
from sbr_tpu.models import params as jp  # noqa: E402
from sbr_tpu_torch.baseline import learning as tbl  # noqa: E402
from sbr_tpu_torch.baseline import solver as tbs  # noqa: E402
from sbr_tpu_torch.interest import solver as tis  # noqa: E402
from sbr_tpu_torch.interest import value_function as tvf  # noqa: E402
from sbr_tpu_torch.models import params as tp  # noqa: E402

from oracle import solve_interest_oracle  # noqa: E402

CPU = "cpu"
F64_TOL = 1e-12
F32_TOL = 2e-5
BS32_TOL = 1e-6
ADAPTIVE_TOL = 1e-9

SECTION3 = dict(beta=1.0, eta_bar=15.0, u=0.0, p=0.5, kappa=0.6, lam=0.01, r=0.06, delta=0.1)
SECOND = dict(beta=3.0, eta_bar=15.0, u=0.05, p=0.5, kappa=0.6, lam=0.01, r=0.02, delta=0.1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), np.abs(got[ok] - want[ok]).max()


def _configs(numerics, n_grid, warp=0.5):
    kw = dict(n_grid=n_grid, numerics=numerics, grid_warp=warp)
    return tp.SolverConfig(**kw), jp.SolverConfig(**kw)


def _hazard_tables(model, numerics, n_grid, warp):
    """The reference's hazard table, carried across: (tau_grid, hr, the
    port's index_fn, the reference's index_fn, uniform, models, configs)."""
    tc, jc = _configs(numerics, n_grid, warp)
    jm, tm = jp.make_interest_params(**model), tp.make_interest_params(**model)
    jl = jbl.solve_learning(jm.learning, jc)
    e = jm.economic
    tg, hr, _, _ = jbs._hazard_parts(e.p, e.lam, jl, e.eta, jc)
    uniform = jbs.hazard_grid_is_uniform(jl, jc)
    tls = tbl.learning_solution_from_numpy(
        *(np.array(x) for x in (jl.grid, jl.cdf, jl.pdf, jl.t0, jl.dt, jl.beta, jl.x0)),
        jl.closed_form, device=CPU,
    )
    eta_t = torch.tensor(e.eta, dtype=torch.float64)
    t_idx = None if uniform else (
        lambda t: tbs.warped_grid_index(t, eta_t, tls.beta, tls.x0, n_grid, warp))
    j_idx = None if uniform else (
        lambda t: jbs.warped_grid_index(t, jnp.asarray(e.eta), jl.beta, jl.x0, n_grid, warp))
    return tg, hr, t_idx, j_idx, uniform, e, tc, jc


@pytest.mark.parametrize("warp", [0.5, 0.0])
@pytest.mark.parametrize("model", ["section3", "second"])
def test_value_function_fixed_matches_reference(model, warp):
    m = {"section3": SECTION3, "second": SECOND}[model]
    tg, hr, t_idx, j_idx, uniform, e, tc, jc = _hazard_tables(m, "fixed", 256, warp)
    want, jh = jvf.solve_value_function(tg, hr, e.delta, e.r, e.u, jc, uniform=uniform,
                                        index_fn=j_idx, with_health=True)
    got, th = tvf.solve_value_function(torch.tensor(np.array(tg)), torch.tensor(np.array(hr)),
                                       e.delta, e.r, e.u, tc, uniform=uniform, index_fn=t_idx,
                                       with_health=True)
    _close(got, want, F64_TOL)
    assert int(th.flags) == int(jh.flags) == 0
    assert float(got[0]) == (e.u + e.delta) / (e.r + e.delta)


def test_value_function_adaptive_equals_op_by_op_reference():
    tg, hr, t_idx, j_idx, uniform, e, tc, jc = _hazard_tables(SECTION3, "adaptive", 64, 0.0)
    with jax.disable_jit():
        want, jh = jvf.solve_value_function(tg, hr, e.delta, e.r, e.u, jc, uniform=uniform,
                                            with_health=True)
    got, th = tvf.solve_value_function(torch.tensor(np.array(tg)), torch.tensor(np.array(hr)),
                                       e.delta, e.r, e.u, tc, uniform=uniform, with_health=True)
    assert _np(got).tobytes() == np.asarray(want).tobytes()
    assert int(th.iterations) == int(jh.iterations)
    assert int(th.flags) == int(jh.flags)


def test_value_function_adaptive_within_the_stated_spread():
    tg, hr, t_idx, j_idx, uniform, e, tc, jc = _hazard_tables(SECTION3, "adaptive", 128, 0.5)
    want, jh = jvf.solve_value_function(tg, hr, e.delta, e.r, e.u, jc, uniform=uniform,
                                        index_fn=j_idx, with_health=True)
    got, th = tvf.solve_value_function(torch.tensor(np.array(tg)), torch.tensor(np.array(hr)),
                                       e.delta, e.r, e.u, tc, uniform=uniform, index_fn=t_idx,
                                       with_health=True)
    _close(got, want, BS32_TOL)
    assert int(th.flags) == int(jh.flags)


@functools.lru_cache(maxsize=None)
def _solves(model_key, numerics, n_grid, t_dtype=torch.float64, np_dtype=np.float64):
    m = dict(model_key)
    tc, jc = _configs(numerics, n_grid)
    jm, tm = jp.make_interest_params(**m), tp.make_interest_params(**m)
    jl = jbl.solve_learning(jm.learning, jc, dtype=np_dtype)
    tl = tbl.solve_learning(tm.learning, tc, dtype=t_dtype, device=CPU)
    return (tis.solve_equilibrium_interest(tl, tm.economic, tc),
            jis.solve_equilibrium_interest(jl, jm.economic, jc))


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("model", ["section3", "second"])
def test_interest_solve_matches_reference(model, numerics):
    m = {"section3": SECTION3, "second": SECOND}[model]
    r, jr = _solves(tuple(sorted(m.items())), numerics, 512)
    tol = F64_TOL if numerics == "fixed" else ADAPTIVE_TOL
    b, jb = r.base, jr.base
    assert int(b.status) == int(jb.status)
    assert bool(b.bankrun) == bool(jb.bankrun)
    assert int(b.health.flags) == int(jb.health.flags)
    if numerics == "fixed":
        assert int(b.health.iterations) == int(jb.health.iterations)
    _close(r.v, jr.v, tol)
    _close(r.hr_effective, jr.hr_effective, tol)
    for f in ("xi", "tau_bar_in_unc", "tau_bar_out_unc", "aw_max", "tau_grid", "hr", "aw_cum"):
        _close(getattr(b, f), getattr(jb, f), tol)
    assert "EquilibriumResultInterest" in repr(r)


def test_interest_float32_matches_reference():
    r, jr = _solves(tuple(sorted(SECTION3.items())), "fixed", 512, torch.float32, np.float32)
    assert r.v.dtype == torch.float32
    assert int(r.base.status) == int(jr.base.status)
    assert int(r.base.health.flags) == int(jr.base.health.flags)
    _close(r.v, jr.v, F32_TOL)
    _close(r.base.xi, jr.base.xi, F32_TOL)


def test_r0_is_the_ports_baseline_solve():
    tm = tp.make_interest_params(r=0.0, delta=0.1)
    cfg = tp.SolverConfig(n_grid=512, numerics="fixed")
    ls = tbl.solve_learning(tm.learning, cfg, device=CPU)
    r = tis.solve_equilibrium_interest(ls, tm.economic, cfg).base
    b = tbs.solve_equilibrium_baseline(ls, tm.economic, cfg)
    assert int(r.status) == int(b.status)
    for f in ("xi", "tau_bar_in_unc", "tau_bar_out_unc"):
        assert torch.equal(getattr(r, f), getattr(b, f))


def test_section3_meets_the_oracle():
    tm = tp.make_interest_params(**SECTION3)
    cfg = tp.SolverConfig(n_grid=4096, numerics="fixed")
    ls = tbl.solve_learning(tm.learning, cfg, device=CPU)
    res = tis.solve_equilibrium_interest(ls, tm.economic, cfg)
    oracle = solve_interest_oracle(n_scan=400)
    assert bool(res.base.bankrun) == oracle.bankrun
    np.testing.assert_allclose(float(res.base.xi), oracle.xi, atol=1e-5)
    np.testing.assert_allclose(float(res.base.tau_bar_in_unc), oracle.tau_bar_in, atol=1e-4)
    np.testing.assert_allclose(float(res.base.tau_bar_out_unc), oracle.tau_bar_out, atol=1e-4)
    taus = _np(res.base.tau_grid)[::64]
    np.testing.assert_allclose(_np(res.v)[::64], [oracle.v_at(t) for t in taus], atol=5e-7)


def test_interest_params_validate_like_the_reference():
    for kw in (dict(r=0.2, delta=0.1), dict(r=-0.1), dict(delta=0.0)):
        with pytest.raises(ValueError):
            jp.make_interest_params(**kw)
        with pytest.raises(ValueError):
            tp.make_interest_params(**kw)
    tm, jm = tp.make_interest_params(**SECTION3), jp.make_interest_params(**SECTION3)
    assert tm.economic.eta == jm.economic.eta and tm.learning.tspan == jm.learning.tspan
