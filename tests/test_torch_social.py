"""The port's forced learning law and damped social fixed point
(sbr_tpu_torch.social.dynamics, social.solver) against sbr_tpu's, on the
CPU.

Contracts, in float64:

- `solve_forced_learning`: CDF and PDF within 1e-14 of the reference's
  (measured 2.2e-16: ``torch.cumsum`` and glibc's ``exp`` round apart from
  XLA's in the last bit);
- the fixed point: iterations, converged, aborted, the inner status and
  bankrun, and the merged ``Health.flags`` equal; under fixed numerics the
  merged ``Health.iterations`` too (adaptive inner Chandrupatla counts
  follow XLA's ``exp``, tests/test_torch_baseline.py); ξ, AW, G, the final
  error and the history ring (same NaN slots) within FP_TOL = 1e-10.
  Measured at the Figure-12 point, n_grid 4096 and 1024, both numerics:
  ξ 5.7e-14, AW 2.6e-14, G 1.7e-14, ring 2.4e-15
  (``python tests/torch_parity_report.py social``). The spread starts in the
  inner solve (XLA's ``exp``, its scan order) and the contractive damping
  does not grow it;
- in float32 the same integers, floats within F32_TOL = 1e-4 (measured:
  ξ 4.3e-5, AW 1.1e-5, some 40 ulp at ξ ≈ 8.9 after 45-50 iterations);
- `fixed_point_from_numpy` carries a reference result across bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sbr_tpu.models.params import SolverConfig as JConfig  # noqa: E402
from sbr_tpu.models.params import make_model_params as jmodel  # noqa: E402
from sbr_tpu.social import dynamics as jd  # noqa: E402
from sbr_tpu.social import solver as jsol  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig as TConfig  # noqa: E402
from sbr_tpu_torch.models.params import make_model_params as tmodel  # noqa: E402
from sbr_tpu_torch.social import closure as tc  # noqa: E402
from sbr_tpu_torch.social import dynamics as td  # noqa: E402
from sbr_tpu_torch.social import solver as tsol  # noqa: E402

from oracle import solve_social_oracle  # noqa: E402

CPU = "cpu"
FP_TOL = 1e-10
F32_TOL = 1e-4
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gap(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def as_numpy(obj):
    """A reference record (nested flax dataclasses) as nested dicts of numpy
    arrays, the input of `fixed_point_from_numpy`."""
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


@functools.lru_cache(maxsize=None)
def solved_pair(n_grid, numerics, max_iter=500, tol=1e-4, damping=0.5, dtype="float64",
                bisect_iters=90, **overrides):
    """(reference, port) fixed points of the Figure-12 model with
    ``overrides``, solved once per module run."""
    kw = dict(FIG12, **overrides)
    jcfg = JConfig(n_grid=n_grid, numerics=numerics, bisect_iters=bisect_iters)
    tcfg = TConfig(n_grid=n_grid, numerics=numerics, bisect_iters=bisect_iters)
    want = jsol.solve_equilibrium_social(
        jmodel(**kw), jcfg, tol=tol, max_iter=max_iter, damping=damping,
        dtype=getattr(jnp, dtype),
    )
    got = tsol.solve_equilibrium_social(
        tmodel(**kw), tcfg, tol=tol, max_iter=max_iter, damping=damping,
        dtype=getattr(torch, dtype), device=CPU,
    )
    return want, got


def assert_fixed_points_agree(want, got, tol, health_iterations=True):
    for name in ("iterations", "converged", "aborted"):
        assert int(_np(getattr(want, name))) == int(_np(getattr(got, name))), name
    for name in ("status", "bankrun"):
        assert int(_np(getattr(want.equilibrium, name))) == int(
            _np(getattr(got.equilibrium, name))), name
    assert int(want.health.flags) == int(got.health.flags)
    if health_iterations:
        assert int(want.health.iterations) == int(got.health.iterations)
    assert got.grid.dtype == getattr(torch, str(want.grid.dtype))
    np.testing.assert_array_equal(_np(want.grid), _np(got.grid))
    for a, b in ((want.xi, got.xi), (want.aw, got.aw), (want.learning.cdf, got.learning.cdf),
                 (want.learning.pdf, got.learning.pdf), (want.error, got.error),
                 (want.history_err, got.history_err), (want.history_xi, got.history_xi),
                 (want.equilibrium.tau_bar_in_unc, got.equilibrium.tau_bar_in_unc),
                 (want.equilibrium.tau_bar_out_unc, got.equilibrium.tau_bar_out_unc)):
        assert _gap(a, b) <= tol


# ---------------------------------------------------------------------------
# Forced learning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_learning_on_random_forcings(seed):
    g = np.random.default_rng(seed)
    n = 257
    grid = np.linspace(0.0, float(g.uniform(5.0, 40.0)), n)
    aw = np.abs(np.cumsum(g.normal(0.0, 0.05, n))) + g.uniform(0.0, 0.3)
    beta, x0 = float(g.uniform(0.2, 3.0)), float(g.uniform(1e-5, 0.1))
    want = jd.solve_forced_learning(beta, jnp.asarray(aw), jnp.asarray(grid), x0)
    got = td.solve_forced_learning(beta, torch.from_numpy(aw), torch.from_numpy(grid), x0)
    assert got.closed_form is False and got.cdf.dtype == torch.float64
    for name in ("cdf", "pdf"):
        assert _gap(getattr(want, name), getattr(got, name)) <= 1e-14
    for name in ("t0", "dt", "beta", "x0"):
        assert float(getattr(want, name)) == float(getattr(got, name)), name


def test_forced_learning_constant_forcing_is_closed_form():
    grid = torch.linspace(0.0, 10.0, 1001, dtype=torch.float64)
    aw = torch.full_like(grid, 0.3)
    ls = td.solve_forced_learning(1.5, aw, grid, 1e-3)
    want = 1.0 - (1.0 - 1e-3) * torch.exp(-1.5 * 0.3 * grid)
    assert float((ls.cdf - want).abs().max()) < 1e-13
    assert float((ls.pdf - (1.0 - ls.cdf) * 1.5 * aw).abs().max()) == 0.0


def test_forced_learning_float32():
    g = np.random.default_rng(7)
    grid = np.linspace(0.0, 20.0, 129).astype(np.float32)
    aw = g.uniform(0.0, 0.5, 129).astype(np.float32)
    want = jd.solve_forced_learning(0.9, jnp.asarray(aw), jnp.asarray(grid), 1e-4)
    got = td.solve_forced_learning(0.9, torch.from_numpy(aw), torch.from_numpy(grid), 1e-4)
    assert got.cdf.dtype == torch.float32
    # float32 cumulative sums in two orders: a few ulp of G ≤ 1
    assert _gap(want.cdf, got.cdf) <= 1e-6 and _gap(want.pdf, got.pdf) <= 1e-6


# ---------------------------------------------------------------------------
# The fixed point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("n_grid", [4096, 1024])
def test_figure12_fixed_point_matches_reference(n_grid, numerics):
    want, got = solved_pair(n_grid, numerics)
    assert bool(got.converged) and bool(got.equilibrium.bankrun)
    assert_fixed_points_agree(want, got, FP_TOL, health_iterations=numerics == "fixed")
    err, xi = got.history()
    w_err, w_xi = want.history()
    assert len(err) == int(got.iterations) < tsol.HISTORY_LEN
    assert np.abs(err - w_err).max() <= FP_TOL and np.abs(xi - w_xi).max() <= FP_TOL


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_figure12_fixed_point_float32(numerics):
    want, got = solved_pair(1024, numerics, dtype="float32")
    assert got.aw.dtype == torch.float32
    assert_fixed_points_agree(want, got, F32_TOL, health_iterations=numerics == "fixed")


def test_figure12_meets_the_oracle():
    """test_social's envelope against the independent numpy oracle."""
    _, got = solved_pair(4096, "fixed")
    m = tmodel(**FIG12)
    eta = m.economic.eta
    ora = solve_social_oracle(beta=0.9, x0=1e-4, u=0.5, p=0.99, kappa=0.25, lam=0.25,
                              eta=eta, tol=1e-4, max_iter=500)
    assert ora.bankrun and ora.converged
    assert abs(float(got.xi) - ora.xi) < 2e-3 * eta
    got_aw = np.interp(ora.grid, _np(got.grid), _np(got.aw))
    assert np.max(np.abs(got_aw - ora.aw)) < 5e-3


def test_no_run_marches_flat():
    """u above the hazard everywhere: ξ advances by η/500 an iteration (η
    times the rounded reciprocal, as XLA compiles it: bit for bit) while AW
    damps flat and converges without a run."""
    want, got = solved_pair(1024, "fixed", max_iter=600, u=50.0)
    assert_fixed_points_agree(want, got, FP_TOL)
    assert float(got.xi) == float(want.xi)
    np.testing.assert_array_equal(_np(got.history_xi), _np(want.history_xi))
    assert bool(got.converged) and not bool(got.equilibrium.bankrun)
    eta = tmodel(**FIG12).economic.eta
    assert float(got.xi) == pytest.approx(int(got.iterations) * eta / 500.0, rel=1e-9)
    assert float(got.aw.max() - got.aw.min()) < 1e-3


def test_x0_001_converges_without_a_run_and_has_no_window():
    want, got = solved_pair(1024, "fixed", x0=0.01)
    assert_fixed_points_agree(want, got, FP_TOL)
    assert bool(got.converged) and not bool(got.equilibrium.bankrun)
    assert int(got.equilibrium.status) == 1
    with pytest.raises(ValueError, match="no bank run"):
        tc.equilibrium_window(got.equilibrium)


def test_max_iter_exhaustion_flags_not_converged():
    want, got = solved_pair(1024, "fixed", max_iter=5)
    assert_fixed_points_agree(want, got, FP_TOL)
    assert int(got.iterations) == 5 and not bool(got.converged) and not bool(got.aborted)
    assert int(got.health.flags) & tsol.FP_NOT_CONVERGED


def test_abort_past_eta_flags_aborted_and_wraps_the_ring():
    """A no-run march that never converges (α = 0.01, tol 1e-14) passes η
    at iteration 501: FP_ABORTED, AW left at the last iterate, and the
    history ring wrapped around (501 > HISTORY_LEN)."""
    want, got = solved_pair(64, "fixed", max_iter=600, tol=1e-14, damping=0.01,
                            bisect_iters=8, u=50.0)
    assert_fixed_points_agree(want, got, FP_TOL)
    assert bool(got.aborted) and not bool(got.converged)
    assert int(got.iterations) > tsol.HISTORY_LEN
    assert int(got.health.flags) & tsol.FP_ABORTED
    assert not int(got.health.flags) & tsol.FP_NOT_CONVERGED
    err, xi = got.history()
    w_err, w_xi = want.history()
    assert len(xi) == tsol.HISTORY_LEN
    assert np.abs(xi - w_xi).max() <= FP_TOL and np.abs(err - w_err).max() <= FP_TOL
    assert xi[-1] == float(got.xi) > float(tmodel(**FIG12).economic.eta)


def test_result_helpers():
    want, got = solved_pair(1024, "fixed")
    r = repr(got)
    assert "\n" not in r and r.startswith("SocialFixedPointResult(")
    assert "converged=True" in r and "iterations=50" in r
    assert got.solve_time > 0
    t = np.linspace(0.0, 30.0, 77)
    for a, b in zip(want.curves_on(t), got.curves_on(t)):
        assert np.abs(a - b).max() <= FP_TOL


def test_verbose_prints_the_reference_lines(capfd):
    kw = dict(FIG12, u=50.0)
    jsol.solve_equilibrium_social(jmodel(**kw), JConfig(n_grid=64), max_iter=3, verbose=True)
    want = capfd.readouterr().out.strip().splitlines()
    tsol.solve_equilibrium_social(tmodel(**kw), TConfig(n_grid=64), max_iter=3, verbose=True,
                                  device=CPU)
    got = capfd.readouterr().out.strip().splitlines()
    assert len(got) == 3 and got[0].startswith("[social fp] iter 1: err=")
    assert got == want


def test_fixed_point_from_numpy_carries_the_reference_across():
    want, _ = solved_pair(1024, "fixed")
    got = tsol.fixed_point_from_numpy(as_numpy(want), device=CPU)
    for a, b in ((want.aw, got.aw), (want.grid, got.grid), (want.xi, got.xi),
                 (want.learning.cdf, got.learning.cdf), (want.history_err, got.history_err),
                 (want.equilibrium.xi, got.equilibrium.xi),
                 (want.equilibrium.tau_bar_in_unc, got.equilibrium.tau_bar_in_unc),
                 (want.health.flags, got.health.flags),
                 (want.equilibrium.health.flags, got.equilibrium.health.flags)):
        assert np.array_equal(_np(a), _np(b), equal_nan=True)
    assert got.learning.closed_form is False
    assert int(got.iterations) == int(want.iterations) and bool(got.converged)
    assert tc.equilibrium_window(got.equilibrium) == tc.equilibrium_window(want.equilibrium)


def test_entry_point_rules(monkeypatch):
    with pytest.raises(ValueError, match="max_iter"):
        tsol.solve_equilibrium_social(tmodel(**FIG12), TConfig(n_grid=64), max_iter=0,
                                      device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsol.solve_equilibrium_social(tmodel(**FIG12), TConfig(n_grid=64))
