"""The port's models, Stage 1 and Stages 2-3 (sbr_tpu_torch.models,
utils.status, baseline) against sbr_tpu's, on the CPU.

Contracts:

- parameters: the same defaults, derivations (η = η̄/β, tspan = (0, 2η)),
  η-pinning under `with_overrides`, validation errors and pytree dicts;
  `SolverConfig` resolves ``numerics="auto"`` from ``SBR_NUMERICS``;
- status codes, flag bits and the status accounting are the reference's;
- Stage 1: the grid bit for bit, the closed-form curves within 4 ulp
  (``jnp.exp`` and glibc's ``exp``, which PyTorch's CPU kernels match,
  differ by one ulp on about 15% of float64 arguments);
- Stages 2-3 in float64, port against live sbr_tpu: status, bankrun,
  ``Health.flags`` and the fixed path's iteration counts exact; ξ, τ̄_IN,
  τ̄_OUT, AW_max, the hazard and the AW curves within F64_TOL = 1e-12
  (measured spread: 7.1e-15, tests/torch_parity_report.py), far under the
  1e-9 at which float64 transcendentals differ across backends;
- in float32 the same integers exact and floats within F32_TOL = 2e-5
  (measured: 1.9e-6 on the grids, two ulp at ξ ≈ 10);
- the golden scalars of the high-precision oracle within 1e-6 in both
  numerics modes;
- carried across: the port's Stages 2-3 on sbr_tpu's own Stage 1
  (`learning_solution_from_numpy`) meet the same contract.

Adaptive iteration counts are not held bit for bit: XLA's ``exp`` rounds
apart from glibc's, and Chandrupatla's stopping test is decided in the
last bits of f (tests/test_torch_core.py shows the loops equal when f
rounds equally). They are held on average (tests/test_torch_sweeps.py).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.baseline import learning as jl  # noqa: E402
from sbr_tpu.baseline import solver as js  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.models.results import Status as JStatus  # noqa: E402
from sbr_tpu.utils import status as jstatus  # noqa: E402
from sbr_tpu_torch.baseline import learning as tl  # noqa: E402
from sbr_tpu_torch.baseline import solver as ts  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.models.results import Status  # noqa: E402
from sbr_tpu_torch.utils import status as tstatus  # noqa: E402

from oracle import solve_oracle  # noqa: E402

CPU = "cpu"
F64_TOL = 1e-12
F32_TOL = 2e-5
MODES = ["fixed", "adaptive"]
CASES = [
    {},
    {"beta": 3.0},
    {"u": 0.01},
    {"u": 5.0},
    {"p": 0.9, "kappa": 0.3, "lam": 0.1},
    {"beta": 0.3, "u": 0.02},
    {"beta": 40.0, "u": 0.5},
]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), np.abs(got[ok] - want[ok]).max()


def _models(**kw):
    return (tparams.with_overrides(tparams.make_model_params(), **kw),
            jparams.with_overrides(jparams.make_model_params(), **kw))


@functools.lru_cache(maxsize=None)
def _port(kw, mode, t_dtype=torch.float64, n_grid=4096):
    tm = tparams.with_overrides(tparams.make_model_params(), **dict(kw))
    cfg = tparams.SolverConfig(numerics=mode, n_grid=n_grid)
    ls = tl.solve_learning(tm.learning, cfg, dtype=t_dtype, device=CPU)
    return ts.solve_equilibrium_baseline(ls, tm.economic, cfg)


@functools.lru_cache(maxsize=None)
def _ref(kw, mode, np_dtype=np.float64, n_grid=4096):
    jm = jparams.with_overrides(jparams.make_model_params(), **dict(kw))
    cfg = jparams.SolverConfig(numerics=mode, n_grid=n_grid)
    jls = jl.solve_learning(jm.learning, cfg, dtype=np_dtype)
    # the reference's jitted solve (its telemetry path): one compile per
    # config and dtype serves every case
    e = jm.economic
    args = (jnp.asarray(v, np_dtype) for v in (e.u, e.p, e.kappa, e.lam, e.eta, jls.grid[-1]))
    return js._jitted_core(cfg)(jls, *args)


def _solve(kw, mode, t_dtype=torch.float64, np_dtype=np.float64, n_grid=4096):
    """(port, reference) results of one case, each computed once."""
    key = tuple(sorted(kw.items()))
    return _port(key, mode, t_dtype, n_grid), _ref(key, mode, np_dtype, n_grid)


def _assert_result_parity(r, jr, tol, fixed):
    assert int(r.status) == int(jr.status)
    assert bool(r.bankrun) == bool(jr.bankrun) and bool(r.converged) == bool(jr.converged)
    assert int(r.health.flags) == int(jr.health.flags)
    if fixed:
        assert int(r.health.iterations) == int(jr.health.iterations)
    for f in ("xi", "tau_bar_in_unc", "tau_bar_out_unc", "tau_in", "tau_out", "aw_max"):
        _close(getattr(r, f), getattr(jr, f), tol)
    for f in ("tau_grid", "aw_cum", "aw_out", "aw_in"):
        _close(getattr(r, f), getattr(jr, f), tol)
    hr, jhr = _np(r.hr), np.asarray(jr.hr)
    _close(hr / np.abs(jhr).max(), jhr / np.abs(jhr).max(), tol)


# -- parameters ---------------------------------------------------------------


def test_defaults_and_derivations_match():
    for kw in ({}, {"beta": 2.0}, {"beta": 0.5, "eta_bar": 30.0}, {"eta": 4.0}, {"tspan": (0.0, 9.0)}):
        assert tparams.params_to_pytree(tparams.make_model_params(**kw)) == jparams.params_to_pytree(
            jparams.make_model_params(**kw))
    m = tparams.make_model_params(beta=2.0)
    assert m.economic.eta == 7.5 and m.learning.tspan == (0.0, 15.0)


def test_with_overrides_pins_eta_and_tspan():
    base = tparams.make_model_params()
    m = tparams.with_overrides(base, beta=3.0)
    assert m.economic.eta == 15.0 and m.learning.tspan == (0.0, 30.0)
    assert tparams.params_to_pytree(m) == jparams.params_to_pytree(
        jparams.with_overrides(jparams.make_model_params(), beta=3.0))
    with pytest.raises(ValueError, match="Unknown parameter overrides"):
        tparams.with_overrides(base, gamma=1.0)


@pytest.mark.parametrize("kw", [
    {"beta": -1.0}, {"x0": -0.1}, {"tspan": (1.0, 0.5)}, {"u": -0.1}, {"p": 1.5},
    {"kappa": 1.0}, {"lam": 0.0}, {"eta": -2.0}, {"insurance_cap": 1.0},
    {"suspension_t": -1.0}, {"lolr_rate": -0.5},
])
def test_validation_errors_match(kw):
    with pytest.raises(ValueError) as want:
        jparams.make_model_params(**kw)
    with pytest.raises(ValueError) as got:
        tparams.make_model_params(**kw)
    assert str(got.value) == str(want.value)


def test_pytree_round_trip_from_the_reference():
    jm = jparams.with_overrides(jparams.make_model_params(u=0.2), beta=4.0, lolr_rate=0.1)
    tree = jparams.params_to_pytree(jm)
    tm = tparams.pytree_to_params(tree)
    assert tparams.params_to_pytree(tm) == tree
    assert tparams.pytree_to_params(tparams.params_to_pytree(tm)) == tm
    with pytest.raises(ValueError, match="Missing params leaves"):
        tparams.pytree_to_params({k: v for k, v in tree.items() if k != "eta"})
    with pytest.raises(ValueError, match="Unknown params leaves"):
        tparams.pytree_to_params({**tree, "r": 0.1})


def test_solver_config_resolution(monkeypatch):
    assert tparams.SolverConfig(numerics="fixed").numerics == "fixed"
    monkeypatch.setenv("SBR_NUMERICS", "adaptive")
    assert tparams.SolverConfig().adaptive
    monkeypatch.delenv("SBR_NUMERICS")
    assert tparams.SolverConfig().numerics == "adaptive"
    monkeypatch.setenv("SBR_NUMERICS", "fixed")
    assert tparams.SolverConfig().numerics == "fixed"
    c = tparams.SolverConfig()
    assert (c.n_grid, c.bisect_iters, c.grid_warp, c.quad_order, c.refine_crossings) == (4096, 90, 0.5, 8, True)
    for bad in ({"numerics": "fast"}, {"n_grid": 8}, {"grid_warp": 1.5}, {"bisect_iters": 0}):
        with pytest.raises(ValueError):
            tparams.SolverConfig(**bad)


def test_status_codes_and_accounting():
    assert {s.name: int(s) for s in Status} == {s.name: int(s) for s in JStatus}
    grid = np.asarray([[0, 1, 1], [2, 3, -1]], dtype=np.int32)
    assert tstatus.status_counts(torch.from_numpy(grid)) == jstatus.status_counts(grid)
    assert tstatus.status_summary(torch.from_numpy(grid)) == jstatus.status_summary(grid)


# -- Stage 1 ------------------------------------------------------------------


@pytest.mark.parametrize("np_dtype,t_dtype", [(np.float32, torch.float32), (np.float64, torch.float64)])
def test_solve_learning_matches(np_dtype, t_dtype):
    for beta in (1.0, 3.0, 1e4):
        tm, jm = _models(beta=beta)
        cfg = dict(n_grid=512)
        ls = tl.solve_learning(tm.learning, tparams.SolverConfig(**cfg), dtype=t_dtype, device=CPU)
        jls = jl.solve_learning(jm.learning, jparams.SolverConfig(**cfg), dtype=np_dtype)
        assert _np(ls.grid).tobytes() == np.asarray(jls.grid).tobytes()
        assert _np(ls.dt).tobytes() == np.asarray(jls.dt).tobytes()
        assert ls.closed_form and ls.device.type == "cpu" and ls.dtype == t_dtype
        for f in ("cdf", "pdf"):
            want = np.asarray(getattr(jls, f))
            got = _np(getattr(ls, f))
            assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want).max())), f


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tparams.make_model_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.solve_learning(m.learning)
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    with pytest.raises(RuntimeError, match="no CUDA device"):
        beta_u_grid([1.0], [0.1], m)


# -- Stages 2-3 ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_equilibrium_matches_reference_f64(mode, case):
    r, jr = _solve(CASES[case], mode, n_grid=1024)
    _assert_result_parity(r, jr, F64_TOL, mode == "fixed")
    assert r.solve_time > 0.0


@pytest.mark.parametrize("mode", MODES)
def test_equilibrium_matches_reference_f32(mode):
    for kw in CASES[:3]:
        r, jr = _solve(kw, mode, torch.float32, np.float32, n_grid=1024)
        _assert_result_parity(r, jr, F32_TOL, mode == "fixed")


@pytest.mark.parametrize("mode", MODES)
def test_golden_scalars(mode):
    """The oracle's Figure-3 scalars, β=3 with η pinned, and the u=5
    no-run cell, at the full default config (n_grid 4096, refinement on)."""
    r = _port((), mode)
    assert abs(float(r.xi) - 10.215436) < 1e-6
    assert abs(float(r.tau_bar_in_unc) - 7.327538) < 1e-6
    assert abs(float(r.tau_bar_out_unc) - 10.446095) < 1e-6
    assert abs(float(r.aw_max) - 0.618231) < 1e-6
    orc = solve_oracle()
    assert abs(float(r.xi) - orc.xi) < 1e-6 and abs(float(r.aw_max) - orc.aw_max) < 1e-5
    r3 = _port((("beta", 3.0),), mode)
    assert abs(float(r3.xi) - 3.256394) < 1e-6
    r5 = _port((("u", 5.0),), mode)
    assert int(r5.status) == Status.NO_CROSSING == 1 and np.isnan(float(r5.xi))
    assert not bool(r5.bankrun) and bool(r5.converged)


@pytest.mark.parametrize("mode", MODES)
def test_stages_2_3_on_the_reference_stage_1(mode):
    """Stage 1 carried across from sbr_tpu: isolates Stages 2-3 from the
    exp/log rounding of Stage 1."""
    for kw in CASES[:3]:
        tm, jm = _models(**kw)
        jcfg = jparams.SolverConfig(numerics=mode, n_grid=1024)
        jls = jl.solve_learning(jm.learning, jcfg)
        ls = tl.learning_solution_from_numpy(
            *(np.array(getattr(jls, f)) for f in ("grid", "cdf", "pdf", "t0", "dt", "beta", "x0")),
            jls.closed_form, CPU)
        r = ts.solve_equilibrium_baseline(ls, tm.economic, tparams.SolverConfig(numerics=mode, n_grid=1024))
        e = jm.economic
        jr = js._jitted_core(jcfg)(jls, *(jnp.asarray(v) for v in (e.u, e.p, e.kappa, e.lam, e.eta, 30.0)))
        _assert_result_parity(r, jr, F64_TOL, mode == "fixed")


def test_sampled_stage_1():
    """The grid-backed (non-closed-form) path: uniform hazard grid,
    cumulative trapezoid, finite-difference slope test, AW_max from the
    curve."""
    for u in (0.1, 0.01, 5.0):
        tm, jm = _models(u=u)
        cfg = dict(numerics="fixed", n_grid=1024)
        grid = np.linspace(0.0, 30.0, 1024)
        cdf = 1e-4 / (1e-4 + (1 - 1e-4) * np.exp(-grid))
        pdf = cdf * (1 - cdf)
        jls = jl.learning_solution_from_samples(jnp.asarray(grid), jnp.asarray(cdf), jnp.asarray(pdf))
        ls = tl.learning_solution_from_samples(*(torch.from_numpy(a) for a in (grid, cdf, pdf)))
        assert not ls.closed_form
        r = ts.solve_equilibrium_baseline(ls, tm.economic, tparams.SolverConfig(**cfg))
        e = jm.economic
        jr = js._jitted_core(jparams.SolverConfig(**cfg))(
            jls, *(jnp.asarray(v) for v in (e.u, e.p, e.kappa, e.lam, e.eta, 30.0)))
        _assert_result_parity(r, jr, F64_TOL, True)


def test_hazard_and_warped_grid():
    for beta in (0.5, 3.0, 1e3):
        tm, jm = _models(beta=beta)
        cfg = dict(n_grid=1024)
        ls = tl.solve_learning(tm.learning, tparams.SolverConfig(**cfg), device=CPU)
        jls = jl.solve_learning(jm.learning, jparams.SolverConfig(**cfg))
        for warp in (0.0, 0.5):
            tg, hr = ts.hazard_rate(0.5, 0.01, ls, 15.0, tparams.SolverConfig(grid_warp=warp, **cfg))
            jtg, jhr = js.hazard_rate(0.5, 0.01, jls, 15.0, jparams.SolverConfig(grid_warp=warp, **cfg))
            _close(tg, jtg, F64_TOL * 15)
            _close(_np(hr) / np.asarray(jhr).max(), np.asarray(jhr) / np.asarray(jhr).max(), F64_TOL)
        t = np.linspace(0.0, 15.0, 777)
        got = ts.warped_grid_index(torch.from_numpy(t), torch.tensor(15.0, dtype=torch.float64),
                                   ls.beta, ls.x0, 1024, 0.5)
        want = np.asarray(js.warped_grid_index(jnp.asarray(t), 15.0, jls.beta, jls.x0, 1024, 0.5))
        assert np.abs(_np(got) - want).max() <= 1 and (_np(got) != want).mean() < 0.01


def test_buffers_with_refinement_and_compute_xi():
    tm, jm = _models()
    for mode in MODES:
        cfg = dict(n_grid=1024, numerics=mode)
        ls = tl.solve_learning(tm.learning, tparams.SolverConfig(**cfg), device=CPU)
        jls = jl.solve_learning(jm.learning, jparams.SolverConfig(**cfg))
        tc, jc = tparams.SolverConfig(**cfg), jparams.SolverConfig(**cfg)
        tg, hr, integ, ie = ts._hazard_parts(0.5, 0.01, ls, 15.0, tc)
        jtg, jhr, jinteg, jie = js._hazard_parts(0.5, 0.01, jls, 15.0, jc)
        u = torch.tensor([0.02, 0.1, 5.0], dtype=torch.float64)
        hz = ts._make_hazard_at(0.5, 0.01, ls, tg, integ, ie, tc)
        jhz = js._make_hazard_at(0.5, 0.01, jls, jtg, jinteg, jie, jc)
        tin, tout, h = ts.optimal_buffer(u, tg, hr, 30.0, hazard_at=hz, with_health=True,
                                         adaptive=tc.adaptive)
        buffers = jax.jit(lambda uk: js.optimal_buffer(uk, jtg, jhr, 30.0, hazard_at=jhz,
                                                       with_health=True, adaptive=jc.adaptive))
        xi_of = jax.jit(lambda a, b: js.compute_xi(a, b, jls, 0.6, jc))
        for k, uk in enumerate(u.tolist()):
            jin, jout, jh = buffers(jnp.asarray(uk))
            _close(tin[k], jin, F64_TOL)
            _close(tout[k], jout, F64_TOL)
            assert int(h.flags[k]) == int(jh.flags)
            xi = ts.compute_xi(tin[k], tout[k], ls, 0.6, tc)
            jxi = xi_of(jin, jout)
            assert bool(xi[2]) == bool(jxi[2]) and bool(xi[3]) == bool(jxi[3])
            if bool(jxi[2]):
                _close(xi[0], jxi[0], F64_TOL)


def test_classify_cell_truth_table():
    combos = np.array(np.meshgrid([0, 1], [0, 1], [0, 1])).reshape(3, -1).astype(bool)
    err = np.full(combos.shape[1], 1e-9)
    got = ts.classify_cell(*(torch.from_numpy(c) for c in combos), torch.from_numpy(err), torch.float64)
    want = js.classify_cell(*(jnp.asarray(c) for c in combos), jnp.asarray(err), jnp.float64)
    for g, w in zip(got, want):
        assert _np(g).tolist() == np.asarray(w).tolist()


def test_repr():
    r, jr = _solve({}, "fixed", n_grid=1024)
    assert repr(r).split(", solve_time")[0] == repr(jr).split(", solve_time")[0]
