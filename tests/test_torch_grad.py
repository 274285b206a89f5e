"""The port's gradient layer (sbr_tpu_torch.grad) against sbr_tpu.grad, on
the CPU, in float64.

Contracts:

- the primal: the differentiable cells' ξ, τ̄_IN and status are the
  port's own `solve_param_cell` / interest solve bit for bit, and the
  sensitivity surface's ξ grid is `beta_u_grid`'s;
- gradients against the reference's on every trusted cell (status RUN,
  no grad flag): within GRAD_RTOL = 1e-12 relative. Measured: ≤ 5.4e-15
  for the baseline (both numerics, refined or not), ≤ 3.4e-15 for the
  interest stack. The spread is the ~1e-14 of the forward solve (XLA's
  ``exp``), carried through one division. Untrusted cells are compared by
  their flags only: there a gradient is the derivative of a degenerate
  root (for a no-run cell, ξ sits on its bracket's end, where one ulp of
  τ̄_OUT decides whether ``minimum`` ties and splits its gradient);
- statuses, grad flags and `flag_census` equal the reference's;
- central finite differences with η pinned (`grad.parity.run_battery`)
  within 1e-5, and autograd through bisection's iterations is exactly 0;
- calibration: the same Adam steps as the reference's on the same data,
  recovery of the planted θ, a dead start reported unconverged;
- stress search: its sign and its boundary against the solver;
- served grads equal `cell_value_and_grads`, keep the plain answer's ξ,
  survive a disk-cache restart, and their program reads nothing from the
  host (a CUDA graph captures it).

Not mirrored: the reference's grad CLI and its obs audit and report tests,
which need the port's `obs/` (ROADMAP 1.A item 9).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.grad import api as japi  # noqa: E402
from sbr_tpu.grad import calibrate as jcal  # noqa: E402
from sbr_tpu.grad import stress as jstress  # noqa: E402
from sbr_tpu.grad.cell import baseline_cell as jcell  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu_torch.core.rootfind import bisect  # noqa: E402
from sbr_tpu_torch.diag.health import (  # noqa: E402
    GRAD_AT_NONEQUILIBRIUM,
    GRAD_ILL_CONDITIONED,
    GRAD_NONFINITE,
    flag_names,
)
from sbr_tpu_torch.grad import api, calibrate, stress  # noqa: E402
from sbr_tpu_torch.grad import cell as tcell  # noqa: E402
from sbr_tpu_torch.grad.cell import BASE_KEYS, aprime_tol, baseline_cell, interest_cell  # noqa: E402
from sbr_tpu_torch.grad.ift import implicit_root  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.models.params import ModelParams, params_to_pytree, with_overrides  # noqa: E402
from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint  # noqa: E402
from sbr_tpu_torch.serve.engine import BucketProgram, _query_columns  # noqa: E402
from sbr_tpu_torch.serve.live import GraphCounters  # noqa: E402
from sbr_tpu_torch.serve.loadgen import build_pool, http_request  # noqa: E402
from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid, solve_param_cell  # noqa: E402

CPU = "cpu"
F64 = torch.float64
GRAD_RTOL = 1e-12
WAIT = 120
POINTS = [dict(beta=1.5, u=0.1, kappa=0.6), dict(beta=0.9, u=0.07, kappa=0.45),
          dict(beta=2.2, u=0.2, kappa=0.3), dict(beta=1.5, u=0.5, kappa=0.6),
          dict(beta=1.5, u=0.1, kappa=0.97)]


def _cfg(mod, numerics="fixed", refine=False, n_grid=256, iters=90):
    return mod.SolverConfig(n_grid=n_grid, bisect_iters=iters, refine_crossings=refine,
                            numerics=numerics)


CFG = _cfg(tparams)
CFG_REFINE = _cfg(tparams, refine=True)


def _theta(params, **extra):
    th = {k: torch.tensor(float(v), dtype=F64) for k, v in params_to_pytree(params).items()
          if k != "eta_bar"}
    th.update({k: torch.tensor(float(v), dtype=F64) for k, v in extra.items()})
    return th


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores for these small solves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.float64(float(x)).tobytes()


def _assert_grads_agree(want, got, keys):
    """Statuses and flags equal; gradients within GRAD_RTOL on trusted
    cells (the module docstring says why only there)."""
    status = np.asarray(want.status)
    flags = np.asarray(want.flags)
    np.testing.assert_array_equal(got.status.numpy(), status)
    np.testing.assert_array_equal(got.flags.numpy(), flags)
    trusted = (flags == 0) & (status == 0)
    for k in keys:
        a = np.asarray(want.grads[k], np.float64)[trusted]
        b = got.grads[k].numpy()[trusted]
        assert np.all(np.abs(a - b) <= GRAD_RTOL * np.abs(a)), (k, a, b)
    return int(trusted.sum())


# ---------------------------------------------------------------------------
# implicit_root
# ---------------------------------------------------------------------------


def test_grad_matches_fd_and_iteration_backprop_is_zero():
    def resid(x, th):
        return 1.0 / (1.0 + torch.exp(-th["a"] * (x - 2.0))) - th["k"]

    def solve(th):
        return bisect(lambda x: resid(x, th), torch.tensor(0.0, dtype=F64),
                      torch.tensor(10.0, dtype=F64), num_iters=70)

    a = torch.tensor(1.3, dtype=F64, requires_grad=True)
    k = torch.tensor(0.4, dtype=F64, requires_grad=True)
    x = implicit_root(resid, solve, {"a": a, "k": k})
    ga, gk = torch.autograd.grad(x, [a, k])
    for name, g in (("a", ga), ("k", gk)):
        h = 1e-6
        up = {"a": a.detach(), "k": k.detach()}
        dn = dict(up)
        up[name] = up[name] + h
        dn[name] = dn[name] - h
        fd = (solve(up) - solve(dn)) / (2 * h)
        assert abs(float(g) - float(fd)) / abs(float(fd)) < 1e-6, name
    # the anti-oracle: through the iterations (constant brackets) the
    # result does not depend on θ at all for autograd, an exact 0
    naive = solve({"a": a, "k": k})
    assert not naive.requires_grad and naive.grad_fn is None
    assert torch.isfinite(x) and _bits(naive) == _bits(x)


def test_implicit_root_equals_the_reference_rule():
    """The same residual through both rules: the reference's custom JVP
    transposed by jax.grad, the port's backward."""
    from sbr_tpu.core.rootfind import bisect as jbisect
    from sbr_tpu.grad.ift import implicit_root as jroot

    def jres(x, th):
        return 1.0 / (1.0 + jnp.exp(-th["a"] * (x - 2.0))) - th["k"]

    def jsolve(th):
        return jbisect(lambda x: jres(x, th), 0.0, 10.0, num_iters=70)

    th = {"a": jnp.asarray(1.3), "k": jnp.asarray(0.4)}
    want = jax.grad(lambda t: jroot(jres, jsolve, t))(th)

    def tres(x, th):
        return 1.0 / (1.0 + torch.exp(-th["a"] * (x - 2.0))) - th["k"]

    def tsolve(th):
        return bisect(lambda x: tres(x, th), torch.tensor(0.0, dtype=F64),
                      torch.tensor(10.0, dtype=F64), num_iters=70)

    leaves = {"a": torch.tensor(1.3, dtype=F64, requires_grad=True),
              "k": torch.tensor(0.4, dtype=F64, requires_grad=True)}
    got = torch.autograd.grad(implicit_root(tres, tsolve, leaves), list(leaves.values()))
    for name, g in zip(leaves, got):
        assert float(g) == pytest.approx(float(want[name]), rel=1e-12), name


def test_batched_roots_are_per_lane():
    """A batch of roots is a per-lane division (the reference's vmapped
    diagonal solve): d√k/dk = 1/(2√k) in every lane."""
    def resid(x, th):
        return x * x - th["k"]

    def solve(th):
        return bisect(lambda x: resid(x, th), torch.zeros(5, dtype=F64),
                      torch.full((5,), 4.0, dtype=F64), num_iters=70)

    ks = torch.linspace(1.0, 4.0, 5, dtype=F64, requires_grad=True)
    x = implicit_root(resid, solve, {"k": ks})
    (g,) = torch.autograd.grad(x.sum(), ks)
    np.testing.assert_allclose(g.numpy(), 1.0 / (2.0 * np.sqrt(ks.detach().numpy())),
                               rtol=1e-8)


def test_fx_floor_keeps_an_ill_conditioned_root_finite():
    def resid(x, th):
        return (x - th["c"]) ** 3  # f_x = 0 at the root

    def solve(th):
        return th["c"].detach().clone()

    c = torch.tensor(1.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(implicit_root(resid, solve, {"c": c}), c)
    assert float(g) == 0.0  # ∂f/∂c is 0 too; the floor keeps 0/0 from a NaN
    (g2,) = torch.autograd.grad(implicit_root(resid, solve, {"c": c}, fx_floor=1e-3), c)
    assert torch.isfinite(g2)


# ---------------------------------------------------------------------------
# Against the reference, and the FD battery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_xi_and_grad_equals_the_reference(numerics, refine):
    cj, ct = _cfg(jparams, numerics, refine), _cfg(tparams, numerics, refine)
    trusted = 0
    for kw in POINTS:
        want = japi.xi_and_grad(jparams.make_model_params(**kw), config=cj, dtype=jnp.float64)
        got = api.xi_and_grad(tparams.make_model_params(**kw), config=ct, device=CPU)
        trusted += _assert_grads_agree(want, got, api.WRT_DEFAULT)
        # the primal is the port's own forward solve, bit for bit
        th = _theta(tparams.make_model_params(**kw))
        xi, tau_in, _, status, _ = solve_param_cell(*(th[k] for k in BASE_KEYS), ct, F64, CPU)
        assert _bits(got.xi) == _bits(xi) and int(got.status) == int(status)
        assert float(got.xi) == pytest.approx(float(want.xi), rel=1e-12, nan_ok=True)
        assert got.xi.dtype == F64 and set(got.grads) == set(api.WRT_DEFAULT)
    assert trusted == 3


@pytest.mark.parametrize("r", [0.0, 0.01])
def test_interest_xi_and_grad_equals_the_reference(r):
    kw = dict(beta=1.5, u=0.1, kappa=0.6, r=r, delta=0.1)
    wrt = ("beta", "u", "kappa", "r", "delta")
    want = japi.interest_xi_and_grad(jparams.make_interest_params(**kw), wrt=wrt,
                                     config=_cfg(jparams), dtype=jnp.float64)
    got = api.interest_xi_and_grad(tparams.make_interest_params(**kw), wrt=wrt, config=CFG,
                                   device=CPU)
    assert _assert_grads_agree(want, got, wrt) == 1


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_sensitivity_surface_equals_the_reference_and_beta_u_grid(numerics):
    betas, us = np.linspace(0.5, 2.5, 7), np.linspace(0.03, 0.3, 6)
    cj, ct = _cfg(jparams, numerics, n_grid=128, iters=60), _cfg(tparams, numerics,
                                                                  n_grid=128, iters=60)
    want = japi.sensitivity_surface(betas, us, jparams.make_model_params(), config=cj,
                                    dtype=jnp.float64)
    got = api.sensitivity_surface(betas, us, tparams.make_model_params(), config=ct,
                                  device=CPU)
    assert got.xi.shape == (7, 6) and all(g.shape == (7, 6) for g in got.grads.values())
    assert _assert_grads_agree(want, got, api.WRT_DEFAULT) >= 15
    grid = beta_u_grid(betas, us, tparams.make_model_params(), config=ct, device=CPU)
    assert torch.equal(torch.isnan(got.xi), torch.isnan(grid.xi))
    assert torch.equal(torch.nan_to_num(got.xi), torch.nan_to_num(grid.xi))
    assert torch.equal(got.status, grid.status)
    assert api.flag_census(got.status, got.flags) == japi.flag_census(want.status, want.flags)


def test_battery_fixed_refined():
    from sbr_tpu_torch.grad.parity import run_battery

    rep = run_battery(n=4, seed=0, tol=1e-5, config=CFG_REFINE, device=CPU)
    assert rep["n_checked"] >= 2, rep
    assert rep["ok"] and rep["worst_rel"] <= 1e-5, rep


def test_parity_cli_exit_code(capsys):
    from sbr_tpu_torch.grad.parity import main

    assert main(["--n", "2", "--device", CPU, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["n_points"] == 2
    assert main(["--n", "2", "--device", CPU, "--tol", "0"]) == 1


def test_adaptive_numerics_grad_matches_fixed():
    """The adaptive root-find runs a host-checked loop, which autograd
    never enters; its gradient equals the fixed path's within 1e-6."""
    params = tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6)
    grads = {}
    for numerics in ("adaptive", "fixed"):
        res = api.xi_and_grad(params, config=_cfg(tparams, numerics, iters=60), device=CPU)
        grads[numerics] = {k: float(v) for k, v in res.grads.items()}
    for k in api.WRT_DEFAULT:
        assert grads["adaptive"][k] == pytest.approx(grads["fixed"][k], rel=1e-6)


def test_interest_grads_match_fd():
    params = tparams.make_interest_params(beta=1.5, u=0.1, kappa=0.6, r=0.005, delta=0.1)
    th = _theta(ModelParams(params.learning, params.economic), r=0.005, delta=0.1)

    def xi_of(t):
        with torch.no_grad():
            return float(interest_cell(t, CFG, F64)["xi_candidate"])

    res = api.interest_xi_and_grad(params, wrt=("beta", "u", "kappa", "r"), config=CFG,
                                   device=CPU)
    for k in ("beta", "u", "kappa", "r"):
        h = 1e-6 * max(1.0, abs(float(th[k])))
        up, dn = dict(th), dict(th)
        up[k] = th[k] + h
        dn[k] = th[k] - h
        fd = (xi_of(up) - xi_of(dn)) / (2 * h)
        assert abs(float(res.grads[k]) - fd) / max(abs(fd), 1e-9) < 1e-5, k


# ---------------------------------------------------------------------------
# The primal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_baseline_cell_bitwise_vs_solve_param_cell(numerics, refine):
    cfg = _cfg(tparams, numerics, refine)
    for kw in POINTS:
        th = _theta(tparams.make_model_params(**kw))
        out = baseline_cell(th, cfg, F64)
        xi, tau_in, _, status, _ = solve_param_cell(*(th[k] for k in BASE_KEYS), cfg, F64, CPU)
        assert _bits(out["xi"]) == _bits(xi) and _bits(out["tau_in"]) == _bits(tau_in)
        assert int(out["status"]) == int(status)


def test_interest_cell_bitwise_vs_interest_solver():
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.interest.solver import solve_equilibrium_interest

    for r in (0.0, 0.01):
        ip = tparams.make_interest_params(beta=1.5, u=0.1, kappa=0.6, r=r, delta=0.1)
        ls = solve_learning(ip.learning, CFG, dtype=F64, device=CPU)
        res = solve_equilibrium_interest(ls, ip.economic, CFG)
        th = _theta(ModelParams(ip.learning, ip.economic), r=r, delta=0.1)
        out = interest_cell(th, CFG, F64)
        assert int(out["status"]) == int(res.base.status)
        assert _bits(out["xi"]) == _bits(res.base.xi)


def test_nonrun_xi_masked_nan_with_zero_gradient():
    th = _theta(tparams.make_model_params(beta=1.5, u=0.5, kappa=0.6))  # no crossing
    kappa = th["kappa"].clone().requires_grad_(True)
    out = baseline_cell({**th, "kappa": kappa}, CFG, F64)
    assert torch.isnan(out["xi"])
    (g,) = torch.autograd.grad(out["xi"], kappa)
    assert float(g) == 0.0  # the NaN mask is a constant branch


def test_differentiating_adds_no_solver_run(monkeypatch):
    """The forward runs the ξ root-find once; the backward runs none (the
    reference counts traces of its solver program for the same claim)."""
    calls = []
    compute_xi = tcell.compute_xi

    def counted(*args, **kwargs):
        calls.append(1)
        return compute_xi(*args, **kwargs)

    monkeypatch.setattr(tcell, "compute_xi", counted)
    th = _theta(tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6))
    kappa = th["kappa"].clone().requires_grad_(True)
    xi = baseline_cell({**th, "kappa": kappa}, CFG, F64)["xi_candidate"]
    assert len(calls) == 1
    torch.autograd.grad(xi, kappa)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# Grad-trust flags
# ---------------------------------------------------------------------------


def test_nonequilibrium_flag():
    res = api.xi_and_grad(tparams.make_model_params(beta=1.5, u=0.5, kappa=0.6), config=CFG,
                          device=CPU)
    assert int(res.flags) & GRAD_AT_NONEQUILIBRIUM
    assert not bool(res.trusted)
    assert "grad_at_nonequilibrium" in flag_names(int(res.flags))


def test_ill_conditioned_flag_near_aw_plateau():
    """AW'(ξ) = g(ξ) on the interior branch: κ just under the reachable
    mass at small u pushes ξ into the saturated tail where g ≈ 0. The
    flags equal the reference's on the same cells."""
    from sbr_tpu_torch.baseline.learning import logistic_cdf

    params = tparams.make_model_params(beta=1.5, u=0.005, kappa=0.6)
    th = _theta(params)
    out = baseline_cell(th, CFG, F64)
    reach = float(logistic_cdf(out["tau_out"], th["beta"], th["x0"])
                  - logistic_cdf(out["tau_in"], th["beta"], th["x0"]))
    th2 = {**th, "kappa": torch.tensor(reach * (1.0 - 1e-6), dtype=F64)}
    out2 = baseline_cell(th2, CFG, F64, aprime_tol_=1e-2)
    assert int(out2["status"]) == 0, "must still be a RUN root"
    assert int(out2["flags"]) & GRAD_ILL_CONDITIONED
    out_ok = baseline_cell(th, CFG, F64, aprime_tol_=1e-3)
    assert not (int(out_ok["flags"]) & GRAD_ILL_CONDITIONED)
    jth = {k: jnp.asarray(float(v)) for k, v in th2.items()}
    want = jcell(jth, _cfg(jparams), jnp.float64, aprime_tol_=1e-2)
    assert int(want["flags"]) == int(out2["flags"])
    assert int(want["status"]) == int(out2["status"])


def test_nonfinite_flag_and_census_equal_the_reference():
    """A NaN parameter (which the params constructors refuse, so it comes
    in through a θ dict) poisons every gradient: GRAD_NONFINITE on both
    sides, with the same census."""
    th = _theta(tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6))
    th["lam"] = torch.tensor(float("nan"), dtype=F64)
    got = api.cell_value_and_grads(th, api.WRT_DEFAULT, CFG, F64)
    want = japi.cell_value_and_grads({k: jnp.asarray(float(v)) for k, v in th.items()},
                                     api.WRT_DEFAULT, _cfg(jparams), jnp.float64)
    flags, status = got[5], got[4]
    assert int(flags) & GRAD_NONFINITE and int(want[5]) & GRAD_NONFINITE
    assert int(flags) == int(want[5]) and int(status) == int(want[4])
    assert api.flag_census(status, flags) == japi.flag_census(want[4], want[5])
    census = api.flag_census(np.array([0, 0, 1]), np.array([0, GRAD_NONFINITE,
                                                            GRAD_AT_NONEQUILIBRIUM]))
    assert census == japi.flag_census(np.array([0, 0, 1]),
                                      np.array([0, GRAD_NONFINITE, GRAD_AT_NONEQUILIBRIUM]))
    assert census["nonfinite_run"] == 1 and census["untrusted"] == 2


def test_aprime_tol_resolution(monkeypatch):
    assert aprime_tol(F64) == pytest.approx(float(torch.finfo(F64).eps) ** 0.5)
    monkeypatch.setenv("SBR_GRAD_APRIME_TOL", "0.25")
    assert aprime_tol(F64) == 0.25
    assert aprime_tol(F64, 0.5) == 0.5  # explicit wins


def test_flag_census_counts():
    surf = api.sensitivity_surface(np.linspace(0.8, 2.0, 3), np.array([0.08, 0.5]),
                                   tparams.make_model_params(), config=CFG, device=CPU)
    census = api.flag_census(surf.status, surf.flags)
    assert census["cells"] == 6
    assert census["run_cells"] + census["at_nonequilibrium"] == 6
    assert census["nonfinite_run"] == 0


def test_validation_errors():
    with pytest.raises(ValueError, match="wrt"):
        api.xi_and_grad(tparams.make_model_params(), wrt=("bogus",), device=CPU)
    with pytest.raises(ValueError, match="wrt"):
        api.xi_and_grad(tparams.make_model_params(), wrt=(), device=CPU)
    with pytest.raises(ValueError, match="wrt"):
        calibrate.fit_withdrawals([0.0], [0.0], tparams.make_model_params(), wrt=("eta",),
                                  device=CPU)
    with pytest.raises(ValueError, match="wrt"):
        stress.stress_search(tparams.make_model_params(), wrt=("x0",), device=CPU)


# ---------------------------------------------------------------------------
# Health and params
# ---------------------------------------------------------------------------


def test_threaded_health_gradient_equals_health_free_bitwise():
    def with_health(k):
        x, h = bisect(lambda x: x * x - k, torch.tensor(0.0, dtype=F64),
                      torch.tensor(3.0, dtype=F64), num_iters=40, with_health=True)
        return x + h.residual + h.bracket_width

    def solve(th):
        return bisect(lambda x: x * x - th["k"], torch.tensor(0.0, dtype=F64),
                      torch.tensor(3.0, dtype=F64), num_iters=40)

    k = torch.tensor(2.0, dtype=F64, requires_grad=True)
    # health leaves carry no gradient, and bisection's iterate none either
    # (constant brackets): the health-threaded sum is as gradient-free as x
    assert not with_health(k).requires_grad
    x = implicit_root(lambda x, th: x * x - th["k"], solve, {"k": k})
    (g0,) = torch.autograd.grad(x, k)
    assert float(g0) == pytest.approx(1 / (2 * np.sqrt(2.0)), rel=1e-10)


def test_full_solve_health_threading_leaks_nothing():
    th = _theta(tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6))
    u = th["u"].clone().requires_grad_(True)
    out = solve_param_cell(*({**th, "u": u}[k] for k in BASE_KEYS), CFG, F64, CPU)
    health = out[4]
    assert not health.residual.requires_grad and not health.bracket_width.requires_grad
    (g1,) = torch.autograd.grad(torch.nansum(out[2]) + health.residual, u)
    out = solve_param_cell(*({**th, "u": u}[k] for k in BASE_KEYS), CFG, F64, CPU)
    (g0,) = torch.autograd.grad(torch.nansum(out[2]), u)
    assert _bits(g1) == _bits(g0)


def test_make_model_params_accepts_tensor_scalars():
    def f(beta):
        p = tparams.make_model_params(beta=beta)
        return p.economic.eta + p.learning.tspan[1]

    beta = torch.tensor(2.0, dtype=F64, requires_grad=True)
    v = f(beta)
    assert float(v.detach()) == pytest.approx(15.0 / 2.0 + 2 * 15.0 / 2.0)
    (g,) = torch.autograd.grad(v, beta)
    assert float(g) == pytest.approx(-3 * 15.0 / 4.0)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

TRUTH = dict(beta=1.4, u=0.12, kappa=0.55)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_recovers_planted_parameters_in_the_reference_s_steps(numerics):
    """From the reference's second fixture (test_grad's obs-events start)
    both packages converge in the same number of steps, with loss
    histories within 1e-8 relative (measured 1.6e-10 fixed, 5.1e-10
    adaptive: the forward's ~1e-14 spread, amplified by the Adam steps),
    and the port recovers θ* within 1e-3."""
    cj, ct = _cfg(jparams, numerics), _cfg(tparams, numerics)
    init = dict(beta=1.2, u=0.14, kappa=0.6)
    j_obs = jcal.synth_withdrawals(jparams.make_model_params(**TRUTH), n_obs=48, config=cj)
    t_obs = calibrate.synth_withdrawals(tparams.make_model_params(**TRUTH), n_obs=48, config=ct,
                                        device=CPU)
    np.testing.assert_array_equal(np.asarray(j_obs[0]), t_obs[0].numpy())
    assert float(t_obs[2]) == pytest.approx(float(j_obs[2]), rel=1e-12)
    want = jcal.fit_withdrawals(*j_obs[:2], jparams.with_overrides(
        jparams.make_model_params(**TRUTH), **init), xi_obs=j_obs[2], steps=400, config=cj)
    got = calibrate.fit_withdrawals(*t_obs[:2], with_overrides(
        tparams.make_model_params(**TRUTH), **init), xi_obs=t_obs[2], steps=400, config=ct,
        device=CPU)
    assert got.converged and want.converged and got.steps == want.steps
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-8)
    for k, v in TRUTH.items():
        assert abs(got.params[k] - v) / v < 1e-3, (k, got.params)


def test_adam_steps_equal_the_reference_along_its_trajectory():
    """The reference's main fixture (start (1.1, 0.16, 0.62), fixed
    numerics): at each of the reference's first 40 iterates the port's
    loss is the reference's within 1e-12 relative, and so is its gradient
    wherever the cell is a trusted RUN. The first iterates are no-run
    cells, where ξ sits on its bracket's end; at one of them τ̄_OUT rounds
    one ulp apart, ξ ties τ̄_OUT in the port only, and ``minimum`` splits
    the gradient there. From that iterate on the port's own fit takes
    another path, which stalls short of θ* (ROADMAP §3); the reference's
    own fit stalls the same way from bench.py's start (u = 0.15)."""
    cj = _cfg(jparams)
    t_obs, aw_obs, xi_obs = jcal.synth_withdrawals(jparams.make_model_params(**TRUTH), n_obs=48,
                                                   config=cj)
    init = jparams.with_overrides(jparams.make_model_params(**TRUTH), beta=1.1, u=0.16,
                                  kappa=0.62)
    wrt = ("beta", "u", "kappa")
    step = jcal._step_fn(cj, "float64", wrt, 0.05, True, 1e-2)
    theta0 = {k: jnp.asarray(v, jnp.float64) for k, v in jparams.params_to_pytree(init).items()
              if k != "eta_bar"}
    rest = {k: v for k, v in theta0.items() if k not in wrt}
    raw = jcal._raw_of(theta0, wrt)
    m = {k: jnp.zeros(()) for k in wrt}
    v, t = dict(m), 0
    trest = {k: torch.tensor(float(x), dtype=F64) for k, x in rest.items()}
    T, A = torch.tensor(np.asarray(t_obs)), torch.tensor(np.asarray(aw_obs))
    X = torch.tensor(float(xi_obs), dtype=F64)
    compared = 0
    for _ in range(40):
        before = {k: float(raw[k]) for k in wrt}
        raw, m, v, t, loss, g = step(raw, m, v, t, rest, t_obs, aw_obs, jnp.asarray(xi_obs))
        with torch.enable_grad():
            leaves = {k: torch.tensor(x, dtype=F64, requires_grad=True) for k, x in before.items()}
            loss_t = calibrate._loss(leaves, trest, T, A, X, 1e-2, CFG, F64)
            grads = torch.autograd.grad(loss_t, list(leaves.values()))
        assert float(loss_t.detach()) == pytest.approx(float(loss), rel=1e-12)
        theta = {**trest, **{k: calibrate._TRANSFORMS[k][1](leaves[k].detach()) for k in wrt}}
        out = baseline_cell(theta, CFG, F64)
        if int(out["status"]) == 0 and int(out["flags"]) == 0:
            compared += 1
            for k, gk in zip(wrt, grads):
                assert float(gk) == pytest.approx(float(g[k]), rel=1e-9, abs=1e-13), k
    assert compared >= 35


def test_dead_start_reports_unconverged():
    t_obs, aw_obs, xi_obs = calibrate.synth_withdrawals(tparams.make_model_params(**TRUTH),
                                                        n_obs=32, config=CFG, device=CPU)
    # u above the hazard peak: no crossing, flat curve, dead gradient
    bad = with_overrides(tparams.make_model_params(**TRUTH), u=0.6)
    fit = calibrate.fit_withdrawals(t_obs, aw_obs, bad, xi_obs=xi_obs, steps=80, config=CFG,
                                    device=CPU)
    assert not fit.converged and fit.steps <= 80


def test_synth_noise_is_seeded():
    p = tparams.make_model_params(**TRUTH)
    a = calibrate.synth_withdrawals(p, n_obs=16, noise=1e-3, seed=3, config=CFG, device=CPU)
    b = calibrate.synth_withdrawals(p, n_obs=16, noise=1e-3, seed=3, config=CFG, device=CPU)
    c = calibrate.synth_withdrawals(p, n_obs=16, config=CFG, device=CPU)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert float((a[1] - c[1]).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# Stress search
# ---------------------------------------------------------------------------


def test_flips_no_run_cell_and_matches_solver_boundary():
    p0 = tparams.make_model_params(beta=1.5, u=0.1, kappa=0.97)  # NO_ROOT: κ too high
    res = stress.stress_search(p0, wrt=("kappa",), steps=200, lr=0.02, config=CFG, device=CPU)
    assert res.flipped and res.validated
    assert res.margin0 > 0 and res.margin_final < 0
    kappa_star = res.params_flipped["kappa"]
    th = _theta(p0)

    def status_at(kappa):
        out = solve_param_cell(*((torch.tensor(kappa, dtype=F64) if k == "kappa" else th[k])
                                 for k in BASE_KEYS), CFG, F64, CPU)
        return int(out[3])

    lo, hi = 0.5, 0.97  # run at lo, no run at hi
    assert status_at(lo) == 0 and status_at(hi) != 0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if status_at(mid) == 0:
            lo = mid
        else:
            hi = mid
    assert abs(kappa_star - lo) < 2e-3, (kappa_star, lo)
    want = jstress.stress_search(jparams.make_model_params(beta=1.5, u=0.1, kappa=0.97),
                                 wrt=("kappa",), steps=200, lr=0.02, config=_cfg(jparams))
    assert (res.steps, res.flipped, res.validated) == (want.steps, want.flipped, want.validated)
    assert kappa_star == pytest.approx(want.params_flipped["kappa"], rel=1e-9)


def test_already_running_cell_is_zero_shock():
    res = stress.stress_search(tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6),
                               wrt=("kappa",), config=CFG, device=CPU)
    assert res.flipped and res.margin0 < 0
    assert res.shock_norm == 0.0


@pytest.mark.parametrize("kappa, u", [(0.6, 0.1), (0.97, 0.1), (0.6, 0.5)])
def test_margin_sign_agrees_with_solver_and_reference(kappa, u):
    th = _theta(tparams.make_model_params(beta=1.5, u=u, kappa=kappa))
    wrt = {k: th[k].clone().requires_grad_(True) for k in ("u", "kappa")}
    m = stress.run_margin({**th, **wrt}, CFG, F64)
    status = int(solve_param_cell(*(th[k] for k in BASE_KEYS), CFG, F64, CPU)[3])
    assert (float(m) < 0) == (status == 0), (kappa, u, float(m), status)
    grads = torch.autograd.grad(m, list(wrt.values()))
    jth = {k: jnp.asarray(float(v)) for k, v in th.items()}
    want = jstress.run_margin(jth, _cfg(jparams), jnp.float64)
    jg = jax.grad(lambda w: jstress.run_margin({**jth, **w}, _cfg(jparams), jnp.float64))(
        {k: jth[k] for k in wrt})
    assert float(m) == pytest.approx(float(want), rel=1e-12, abs=1e-15)
    for k, g in zip(wrt, grads):
        assert float(g) == pytest.approx(float(jg[k]), rel=1e-12, abs=1e-15), k


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def test_scenario_xi_and_grad_on_reducible_specs_and_raises_on_others():
    from sbr_tpu_torch.scenario import ScenarioSpec

    p = tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6)
    base = api.scenario_xi_and_grad(ScenarioSpec(), p, config=CFG, device=CPU)
    plain = api.xi_and_grad(p, config=CFG, device=CPU)
    assert _bits(base.xi) == _bits(plain.xi)
    assert all(_bits(base.grads[k]) == _bits(plain.grads[k]) for k in api.WRT_DEFAULT)
    ip = tparams.make_interest_params(beta=1.5, u=0.1, kappa=0.6, r=0.01, delta=0.1)
    inter = api.scenario_xi_and_grad(ScenarioSpec(modifiers=("interest",)), ip, config=CFG,
                                     device=CPU)
    direct = api.interest_xi_and_grad(ip, config=CFG, device=CPU)
    assert set(inter.grads) == {"beta", "u", "kappa", "r"}
    assert all(_bits(inter.grads[k]) == _bits(direct.grads[k]) for k in inter.grads)
    for spec in (ScenarioSpec(modifiers=("lolr",)), ScenarioSpec(learning="social"),
                 ScenarioSpec(banks=2, exposure=((0, 1, 0.5),))):
        with pytest.raises(NotImplementedError, match="gradient coverage"):
            api.scenario_xi_and_grad(spec, p, config=CFG, device=CPU)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _engine(tmp_path=None, buckets=(1, 4)):
    cfg = tparams.SolverConfig(n_grid=128, bisect_iters=60, refine_crossings=False)
    serve = ServeConfig(buckets=buckets,
                        cache_dir=str(tmp_path / "cache") if tmp_path is not None else None)
    return Engine(config=cfg, serve=serve, device=CPU)


def test_grads_query_matches_api_and_caches():
    eng = _engine()
    try:
        p = tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6)
        plain = eng.query(p)
        res = eng.query(p, grads=True)
        assert plain.grads is None and res.grads is not None
        assert _bits(res.xi) == _bits(plain.xi)  # the grad program serves the same ξ
        assert (res.status, res.flags) == (plain.status, plain.flags)
        gres = api.xi_and_grad(p, config=eng.config, dtype=eng.dtype, device=CPU)
        for k in ("beta", "u", "kappa"):
            assert _bits(res.grads[k]) == _bits(gres.grads[k])
        assert res.grad_flags == int(gres.flags)
        # separate cache identities, both hit on repeat
        assert eng.query(p, grads=True).source == "lru"
        assert eng.query(p).source == "lru"
        assert eng._result_key(p) != eng._result_key(p, grads=True)
    finally:
        eng.close()


def test_grads_are_bitwise_in_every_bucket():
    pool = build_pool(5, 5)
    answers = {}
    for buckets in ((1,), (8,)):
        eng = _engine(buckets=buckets)
        try:
            answers[buckets] = [(_bits(r.xi), {k: _bits(v) for k, v in r.grads.items()},
                                 r.grad_flags) for r in eng.query_many(pool, grads=True)]
        finally:
            eng.close()
    assert answers[(1,)] == answers[(8,)]


def test_grads_survive_disk_restart(tmp_path):
    p = tparams.make_model_params(beta=1.5, u=0.1, kappa=0.6)
    eng = _engine(tmp_path)
    try:
        first = eng.query(p, grads=True)
    finally:
        eng.close()
    eng2 = _engine(tmp_path)
    try:
        res = eng2.query(p, grads=True)
    finally:
        eng2.close()
    assert res.source == "disk"
    assert res.grads == first.grads and res.grad_flags == first.grad_flags


def test_endpoint_grads_field():
    eng = _engine().start()
    ep = None
    try:
        ep = ServeEndpoint(eng).start()
        code, body, _ = http_request(ep.port, "/query",
                                     {"beta": 1.5, "u": 0.1, "kappa": 0.6, "grads": True})
        doc = json.loads(body)
        assert code == 200 and set(doc["grads"]) == {"beta", "u", "kappa"}
        assert "grad_flags" in doc
        code, body, _ = http_request(ep.port, "/query", {"beta": 1.5, "u": 0.1, "kappa": 0.6})
        plain = json.loads(body)
        assert code == 200 and "grads" not in plain and plain["xi"] == doc["xi"]
    finally:
        if ep is not None:
            ep.close()
        eng.close()


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_grads_program_is_capturable(numerics):
    """The grads program reads nothing from the host and makes no tensor
    from host data, forward and backward: a CUDA graph can capture it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class HostTouches(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.touches, self.ops = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            if "_local_scalar_dense" in str(func) or "lift_fresh" in str(func):
                self.touches.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg = tparams.SolverConfig(n_grid=128, bisect_iters=30, refine_crossings=False,
                               numerics=numerics)
    program = BucketProgram(4, cfg, F64, torch.device(CPU), GraphCounters(),
                            _query_columns(build_pool(4, 4), np.float64),
                            aprime_tol=aprime_tol(F64))
    mode = HostTouches()
    with mode:
        out = program.solve()
    assert mode.touches == [] and mode.ops > 1000
    assert out.shape == (10, 4) and torch.isfinite(out[6:9]).any()
