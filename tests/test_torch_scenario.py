"""The port's composed scenarios (sbr_tpu_torch.scenario) and the stage
hooks under them, on the CPU, against sbr_tpu.scenario and against the
port's own plain solves, at the reference tests' size (n_grid 96,
bisect_iters 40).

Contracts, in float64:

- `ScenarioSpec`: the reference's validation errors, reductions,
  projections and wire form; `spec_fingerprint` equal to the reference's
  hex, the dtype given as a torch dtype;
- the hooks: with both ``None`` (or identity hooks) the baseline and
  hetero solves are their hook-free selves bit for bit; a κ hook is the
  solve at the transformed κ bit for bit;
- reducible specs: the port's own plain solve bit for bit (ξ, status and
  every `Health` leaf), in both numerics, and `scenario_grid` with the
  baseline spec `beta_u_grid` bit for bit;
- compositions (policy modifiers, interest, hetero, social) against
  `sbr_tpu.scenario.solve`: statuses, flags and fixed-point iteration
  counts equal; ξ within 1e-12 under fixed numerics (measured ≤ 4.3e-14).
  Under adaptive numerics the same 1e-12 holds where no HJB runs
  (measured 1.8e-15); with the interest modifier the ROADMAP §3 contract
  for the adaptive ODE paths holds: 1e-9, and 1e-6 where the HJB's `bs32`
  ran out of its step budget (ODE_BUDGET flagged on both sides: a hetero
  grid's duplicate knots; measured 5.2e-7);
- multi-bank: `iterations` and `converged` equal on every test network,
  statuses equal, κ_eff and spillovers within 1e-12 (measured 4.4e-16:
  the spillover's prefix sum associates apart from ``jnp.cumsum``);
- serving: the scenario route answers, caches and keys as the reference's
  does, with the reference's HTTP codes;
- telemetry: `scenario_grid`, `solve` (reduced and composed) and
  `solve_multibank` under a run log the reference's spans, program calls,
  status and per-bank health censuses, after a warm-up.

Every wait carries a timeout and every server is closed in a ``finally``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sbr_tpu import scenario as js  # noqa: E402
from sbr_tpu.models import params as jp  # noqa: E402
from sbr_tpu.serve.engine import Engine as JEngine  # noqa: E402
from sbr_tpu_torch import scenario as ts  # noqa: E402
from sbr_tpu_torch.baseline import solve_equilibrium_baseline, solve_learning  # noqa: E402
from sbr_tpu_torch.baseline.solver import solve_equilibrium_core  # noqa: E402
from sbr_tpu_torch.diag.health import ODE_BUDGET  # noqa: E402
from sbr_tpu_torch.hetero import solve_equilibrium_hetero, solve_learning_hetero  # noqa: E402
from sbr_tpu_torch.interest import solve_equilibrium_interest  # noqa: E402
from sbr_tpu_torch.models import params as tp  # noqa: E402
from sbr_tpu_torch.models.results import Status  # noqa: E402
from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint  # noqa: E402
from sbr_tpu_torch.serve.loadgen import http_request  # noqa: E402
from sbr_tpu_torch.social.solver import solve_equilibrium_social  # noqa: E402
from sbr_tpu_torch.sweeps import beta_u_grid  # noqa: E402
from torch_events import assert_same_events, events  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
WAIT = 120  # seconds
CFG_KW = dict(n_grid=96, bisect_iters=40)
FIXED_TOL = 1e-12
ADAPTIVE_HJB_TOL = 1e-9
BUDGET_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores, where its small CPU ops wait on each other
    (a gossip population query took 337 s under six workers, 4.7 s with
    one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, numerics="fixed", **kw):
    return mod.SolverConfig(numerics=numerics, **{**CFG_KW, **kw})


def _sweep_cfg(mod, numerics="fixed"):
    return _cfg(mod, numerics, refine_crossings=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(h):
    return [_np(getattr(h, f.name)) for f in dataclasses.fields(h)]


def _bitwise(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _same_health(a, b) -> bool:
    return all(_bitwise(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _gap(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def _tspec(jspec):
    """The port's spec with the reference spec's fields."""
    return ts.ScenarioSpec(**{f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})


def _hetero(mod, **econ_kw):
    """Section-2-like K = 2 groups with interest-typed economics (the
    reference's composition tests)."""
    hp = mod.make_hetero_params(betas=(0.8, 1.6), dist=(0.5, 0.5), u=0.05)
    e = hp.economic
    econ = mod.EconomicParamsInterest(u=e.u, p=e.p, kappa=e.kappa, lam=e.lam,
                                      eta_bar=e.eta_bar, eta=e.eta, **econ_kw)
    return mod.ModelParamsHetero(learning=hp.learning, economic=econ)


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw, match", [
    (dict(learning="bayesian"), "unknown learning"),
    (dict(modifiers=("taxes",)), "unknown modifier"),
    (dict(modifiers=("lolr", "lolr")), "duplicate"),
    (dict(learning="hetero", banks=3), "baseline"),
    (dict(learning="social", banks=2), "baseline"),
    (dict(exposure=((0, 1, 0.5),)), "banks >= 2"),
    (dict(banks=2, exposure=((0, 5, 0.5),)), "out of range"),
    (dict(banks=2, exposure=((1, 1, 0.5),)), "self-exposure"),
    (dict(banks=2, exposure=((0, 1, -0.5),)), "non-negative"),
    (dict(banks=0), "banks must be"),
    (dict(social_damping=0.0), "social_damping"),
    (dict(contagion_damping=1.5), "contagion_damping"),
    (dict(lgd=2.0), "lgd"),
    (dict(kappa_floor=0.0), "kappa_floor"),
])
def test_spec_validation_is_the_reference_s(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        ts.ScenarioSpec(**kw)
    with pytest.raises(ValueError) as want:
        js.ScenarioSpec(**kw)
    assert str(got.value).replace("sbr_tpu_torch", "sbr_tpu") == str(want.value)


SPECS = [
    dict(),
    dict(modifiers=("interest",)),
    dict(learning="hetero"),
    dict(learning="social"),
    dict(modifiers=("lolr",)),
    dict(banks=2),
    dict(modifiers=("interest", "lolr")),
    dict(learning="social", modifiers=("insurance_cap", "suspension"), social_tol=1e-6),
    dict(modifiers=("insurance_cap", "lolr"), banks=3, exposure=((0, 1, 0.5), (1, 2, 0.25)),
         lgd=0.4, contagion_damping=0.5),
]


@pytest.mark.parametrize("kw", SPECS)
def test_spec_reductions_projections_and_wire_form(kw):
    a, b = js.ScenarioSpec(**kw), ts.ScenarioSpec(**kw)
    assert b.reduces_to() == a.reduces_to()
    assert b.policy_modifiers == a.policy_modifiers
    assert b.grad_reduction() == a.grad_reduction()
    assert b.to_doc() == a.to_doc()
    assert ts.ScenarioSpec.from_doc(b.to_doc()) == b
    assert ts.ScenarioSpec.from_doc(json.loads(json.dumps(a.to_doc()))) == b
    assert _tspec(a.cell_program_spec()) == b.cell_program_spec()
    assert _tspec(a.social_program_spec()) == b.social_program_spec()
    assert ts.SCENARIO_PROGRAM_VERSION == js.SCENARIO_PROGRAM_VERSION
    assert ts.SCENARIO_KEYS == js.SCENARIO_KEYS


def test_spec_from_doc_errors():
    with pytest.raises(ValueError, match="unknown scenario field"):
        ts.ScenarioSpec.from_doc({"modfiers": ["lolr"]})
    with pytest.raises(ValueError, match="JSON object"):
        ts.ScenarioSpec.from_doc(["lolr"])


@pytest.mark.parametrize("kw", SPECS[:6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spec_fingerprint_equals_the_reference_hex(kw, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    a, b = js.ScenarioSpec(**kw), ts.ScenarioSpec(**kw)
    assert ts.spec_fingerprint(b) == js.spec_fingerprint(a)
    for jpar, tpar in (
        (jp.make_model_params(u=0.08, lolr_rate=0.1), tp.make_model_params(u=0.08, lolr_rate=0.1)),
        (jp.make_interest_params(r=0.02, delta=0.1), tp.make_interest_params(r=0.02, delta=0.1)),
        (_hetero(jp, r=0.01, delta=0.1), _hetero(tp, r=0.01, delta=0.1)),
    ):
        want = js.spec_fingerprint(a, jpar, _cfg(jp), jnp.dtype(jdt).name)
        assert ts.spec_fingerprint(b, tpar, _cfg(tp), dtype) == want
        assert ts.spec_fingerprint(b, tpar, _cfg(tp), str(dtype).removeprefix("torch.")) == want
    assert (ts.spec_fingerprint(b, dtype=torch.float32)
            != ts.spec_fingerprint(b, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_hook_free_core_keeps_its_bits(numerics):
    """The core called positionally as before the hooks, with None hooks and
    with identity hooks: one result, bit for bit; a κ hook is the solve at
    the transformed κ, bit for bit."""
    cfg = _cfg(tp, numerics)
    m = tp.make_model_params(beta=1.2, u=0.08)
    ls = solve_learning(m.learning, cfg, device=CPU)
    e = m.economic
    args = (ls, e.u, e.p, e.kappa, e.lam, e.eta, ls.grid[-1], cfg)
    plain = solve_equilibrium_core(*args)
    assert int(plain.status) == Status.RUN
    none = solve_equilibrium_core(*args, hazard_transform=None, kappa_transform=None)
    ident = solve_equilibrium_core(*args, hazard_transform=lambda g, h, at: (h, at, ()),
                                   kappa_transform=lambda k: k)
    for res in (none, ident):
        for f in ("xi", "tau_bar_in_unc", "tau_bar_out_unc", "aw_max", "status", "hr", "aw_cum"):
            assert _bitwise(getattr(res, f), getattr(plain, f)), f
        assert _same_health(res.health, plain.health)
    assert _bitwise(solve_equilibrium_baseline(ls, e, cfg).xi, plain.xi)
    scaled = solve_equilibrium_core(*args, kappa_transform=lambda k: k * 1.1)
    direct = solve_equilibrium_core(ls, e.u, e.p, e.kappa * 1.1, e.lam, e.eta, ls.grid[-1], cfg)
    assert _bitwise(scaled.xi, direct.xi) and _same_health(scaled.health, direct.health)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_hetero_hooks(numerics):
    cfg = _cfg(tp, numerics)
    m = tp.make_hetero_params(betas=(0.6, 1.4), dist=(0.4, 0.6), u=0.05)
    lsh = solve_learning_hetero(m.learning, cfg, device=CPU)
    plain = solve_equilibrium_hetero(lsh, m.economic, cfg)
    ident = solve_equilibrium_hetero(lsh, m.economic, cfg,
                                     hazard_transform=lambda g, h, _: (h, None, ()),
                                     kappa_transform=lambda k: k)
    for f in ("xi", "tau_bar_in_uncs", "tau_bar_out_uncs", "hrs", "status"):
        assert _bitwise(getattr(ident, f), getattr(plain, f)), f
    assert _same_health(ident.health, plain.health)
    # the hook rewrites the (K, n) rows: halving every hazard row moves the
    # buffers; its extra health merges after the ξ stage's
    seen = {}

    def halve(grid, hrs, at):
        seen["shapes"] = (tuple(grid.shape), tuple(hrs.shape), at)
        return 0.5 * hrs, None, ()

    halved = solve_equilibrium_hetero(lsh, m.economic, cfg, hazard_transform=halve)
    assert seen["shapes"] == ((cfg.n_grid,), (2, cfg.n_grid), None)
    assert _bitwise(halved.hrs, 0.5 * plain.hrs)
    assert not _bitwise(halved.tau_bar_in_uncs, plain.tau_bar_in_uncs)
    econ = dataclasses.replace(m.economic, kappa=m.economic.kappa * 1.1)
    assert _bitwise(solve_equilibrium_hetero(lsh, m.economic, cfg,
                                             kappa_transform=lambda k: k * 1.1).xi,
                    solve_equilibrium_hetero(lsh, econ, cfg).xi)


# ---------------------------------------------------------------------------
# Reductions: the port's own plain solves, bit for bit
# ---------------------------------------------------------------------------


def _assert_result_bitwise(res, xi, status, health):
    assert _bitwise(res.xi, xi) and _bitwise(res.status, status)
    assert _same_health(res.health, health)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_baseline_and_interest_reductions_are_the_plain_solves(numerics):
    cfg = _cfg(tp, numerics)
    m = tp.make_model_params(beta=1.2, u=0.08)
    direct = solve_equilibrium_baseline(solve_learning(m.learning, cfg, device=CPU),
                                        m.economic, cfg)
    res = ts.solve(ts.ScenarioSpec(), m, config=cfg, device=CPU)
    _assert_result_bitwise(res, direct.xi, direct.status, direct.health)
    assert int(res.status) == Status.RUN
    m = tp.make_interest_params(beta=1.0, u=0.05, r=0.02, delta=0.1)
    direct = solve_equilibrium_interest(solve_learning(m.learning, cfg, device=CPU),
                                        m.economic, cfg)
    res = ts.solve(ts.ScenarioSpec(modifiers=("interest",)), m, config=cfg, device=CPU)
    _assert_result_bitwise(res, direct.base.xi, direct.base.status, direct.base.health)
    assert _bitwise(res.detail.v, direct.v)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_hetero_and_social_reductions_are_the_plain_solves(numerics):
    cfg = _cfg(tp, numerics)
    m = tp.make_hetero_params(betas=(0.6, 1.4), dist=(0.4, 0.6), u=0.05)
    direct = solve_equilibrium_hetero(solve_learning_hetero(m.learning, cfg, device=CPU),
                                      m.economic, cfg)
    res = ts.solve(ts.ScenarioSpec(learning="hetero"), m, config=cfg, device=CPU)
    _assert_result_bitwise(res, direct.xi, direct.status, direct.health)
    m = tp.make_model_params(beta=1.0, u=0.1)
    direct = solve_equilibrium_social(m, cfg, max_iter=30, device=CPU)
    res = ts.solve(ts.ScenarioSpec(learning="social", social_max_iter=30), m, config=cfg,
                   device=CPU)
    _assert_result_bitwise(res, direct.equilibrium.xi, direct.equilibrium.status, direct.health)
    assert int(res.detail.iterations) == int(direct.iterations)
    assert _bitwise(res.detail.aw, direct.aw)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_scenario_grid_reduction_is_beta_u_grid(numerics):
    cfg = _sweep_cfg(tp, numerics)
    betas, us = np.linspace(0.5, 2.0, 6), np.linspace(0.02, 0.5, 5)
    base = tp.make_model_params()
    composed = ts.scenario_grid(ts.ScenarioSpec(), betas, us, base, config=cfg, device=CPU)
    plain = beta_u_grid(betas, us, base, config=cfg, device=CPU)
    for f in ("xi", "max_aw", "status"):
        assert _bitwise(getattr(composed, f), getattr(plain, f)), f
    assert _same_health(composed.health, plain.health)


# ---------------------------------------------------------------------------
# Compositions against sbr_tpu.scenario.solve
# ---------------------------------------------------------------------------


COMPOSED = {
    "insurance_lolr": (dict(modifiers=("insurance_cap", "lolr")),
                       lambda m: m.make_model_params(u=0.08, insurance_cap=0.2, lolr_rate=0.1)),
    "suspension": (dict(modifiers=("suspension",)),
                   lambda m: m.make_model_params(u=0.08, suspension_t=6.0)),
    "suspension_frozen": (dict(modifiers=("suspension",)),
                          lambda m: m.make_model_params(u=0.08, suspension_t=1e-3)),
    "lolr_rescue": (dict(modifiers=("lolr",)),
                    lambda m: m.make_model_params(u=0.08, lolr_rate=5.0)),
    "insurance_capped": (dict(modifiers=("insurance_cap",)),
                         lambda m: m.make_model_params(u=0.08, insurance_cap=0.9)),
    "interest_insurance": (dict(modifiers=("interest", "insurance_cap")),
                           lambda m: m.make_interest_params(beta=1.0, u=0.05, r=0.02, delta=0.1,
                                                            insurance_cap=0.1)),
    "insurance_interest_lolr": (dict(modifiers=("insurance_cap", "interest", "lolr")),
                                lambda m: m.make_interest_params(beta=1.0, u=0.05, r=0.02,
                                                                 delta=0.1, insurance_cap=0.1,
                                                                 lolr_rate=0.05)),
    "hetero_insurance_lolr": (dict(learning="hetero", modifiers=("insurance_cap", "lolr")),
                              lambda m: _hetero(m, insurance_cap=0.1, lolr_rate=0.05)),
    "hetero_interest": (dict(learning="hetero", modifiers=("interest",)),
                        lambda m: _hetero(m, r=0.02, delta=0.1)),
    "hetero_interest_suspension": (dict(learning="hetero", modifiers=("interest", "suspension")),
                                   lambda m: _hetero(m, r=0.02, delta=0.1, suspension_t=8.0)),
    "social_insurance_lolr": (dict(learning="social", modifiers=("insurance_cap", "lolr"),
                                   social_max_iter=120),
                              lambda m: m.make_model_params(beta=1.0, u=0.1, insurance_cap=0.1,
                                                            lolr_rate=0.05)),
    "social_interest": (dict(learning="social", modifiers=("interest",), social_max_iter=120),
                        lambda m: m.make_interest_params(beta=1.0, u=0.1, r=0.02, delta=0.1)),
    "social_hetero": (dict(learning="social", social_max_iter=150),
                      lambda m: _hetero(m)),
    "social_hetero_interest_policy": (
        dict(learning="social", modifiers=("interest", "insurance_cap", "lolr"),
             social_max_iter=150),
        lambda m: _hetero(m, r=0.01, delta=0.1, insurance_cap=0.1, lolr_rate=0.05)),
}
# Every case runs under fixed numerics; these also under adaptive, one of
# each family, to keep the file short on the CPU (the adaptive HJB costs
# seconds a solve here: inside each of ~44 fixed-point iterations of
# social_hetero_interest_policy it takes over a minute, so that case runs
# adaptive on the card only, in chip_smoke.py's scenario phase).
ADAPTIVE = {"insurance_lolr", "suspension", "interest_insurance", "hetero_insurance_lolr",
            "hetero_interest", "social_insurance_lolr", "social_hetero"}


def _detail_iterations(res):
    d = res.detail
    return int(_np(d["iterations"] if isinstance(d, dict) else d.iterations))


@pytest.mark.parametrize("name, numerics", [
    (name, numerics) for name in sorted(COMPOSED) for numerics in ("fixed", "adaptive")
    if numerics == "fixed" or name in ADAPTIVE
])
def test_composition_matches_the_reference(name, numerics):
    spec_kw, make = COMPOSED[name]
    want = js.solve(js.ScenarioSpec(**spec_kw), make(jp), config=_cfg(jp, numerics))
    got = ts.solve(ts.ScenarioSpec(**spec_kw), make(tp), config=_cfg(tp, numerics), device=CPU)
    assert got.fingerprint == want.fingerprint
    assert int(_np(got.status)) == int(_np(want.status))
    assert int(_np(got.health.flags)) == int(_np(want.health.flags))
    flags = int(_np(got.health.flags))
    if numerics == "fixed" or "interest" not in spec_kw.get("modifiers", ()):
        tol = FIXED_TOL
    else:
        tol = BUDGET_TOL if flags & ODE_BUDGET else ADAPTIVE_HJB_TOL
    assert _gap(got.xi, want.xi) <= tol
    if spec_kw.get("learning") == "social":
        assert _detail_iterations(got) == _detail_iterations(want)
        if isinstance(want.detail, dict):
            assert bool(_np(got.detail["converged"])) == bool(np.asarray(want.detail["converged"]))
            assert _gap(got.detail["aw"], want.detail["aw"]) <= tol


def test_policy_modifiers_economics():
    """The reference's semantics tests on the port alone."""
    cfg = _cfg(tp)
    base = tp.make_model_params(u=0.08)

    def solve(mods, **kw):
        return int(ts.solve(ts.ScenarioSpec(modifiers=mods), tp.with_overrides(base, **kw),
                            config=cfg, device=CPU).status)

    assert solve(("insurance_cap",)) == Status.RUN
    assert solve(("insurance_cap",), insurance_cap=0.9) != Status.RUN
    assert solve(("suspension",), suspension_t=1e6) == Status.RUN
    assert solve(("suspension",), suspension_t=1e-3) == Status.NO_CROSSING
    assert solve(("lolr",), lolr_rate=5.0) == Status.NO_ROOT
    plain = ts.solve(ts.ScenarioSpec(), base, config=cfg, device=CPU)
    inert = ts.solve(ts.ScenarioSpec(modifiers=("insurance_cap", "lolr")), base, config=cfg,
                     device=CPU)
    assert int(inert.status) == int(plain.status)
    assert abs(float(inert.xi) - float(plain.xi)) <= 1e-12
    with pytest.raises(ValueError, match="r/delta"):
        ts.solve(ts.ScenarioSpec(modifiers=("interest",)), base, config=cfg, device=CPU)
    with pytest.raises(ValueError, match="ModelParamsHetero"):
        ts.solve(ts.ScenarioSpec(learning="hetero"), base, config=cfg, device=CPU)
    with pytest.raises(ValueError, match="scalar-beta"):
        ts.solve(ts.ScenarioSpec(), _hetero(tp), config=cfg, device=CPU)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("name, mods, make", [
    ("insurance", ("insurance_cap",), lambda m: m.make_model_params(insurance_cap=0.4)),
    ("policy", ("insurance_cap", "suspension", "lolr"),
     lambda m: m.make_model_params(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1)),
    ("interest", ("interest",), lambda m: m.make_interest_params(r=0.02, delta=0.1)),
])
def test_scenario_grid_matches_the_reference(name, mods, make, numerics):
    betas, us = np.linspace(0.5, 2.0, 6), np.linspace(0.02, 0.5, 5)
    want = js.scenario_grid(js.ScenarioSpec(modifiers=mods), betas, us, make(jp),
                            config=_sweep_cfg(jp, numerics))
    got = ts.scenario_grid(ts.ScenarioSpec(modifiers=mods), betas, us, make(tp),
                           config=_sweep_cfg(tp, numerics), device=CPU)
    assert np.array_equal(_np(got.status), np.asarray(want.status))
    assert np.array_equal(_np(got.health.flags), np.asarray(want.health.flags))
    tol = ADAPTIVE_HJB_TOL if (numerics == "adaptive" and "interest" in mods) else FIXED_TOL
    assert _gap(got.xi, want.xi) <= tol and _gap(got.max_aw, want.max_aw) <= tol
    assert (_np(got.status) == Status.RUN).any() and (_np(got.status) != Status.RUN).any()


def test_scenario_grid_errors_and_tiled_grid_not_ported():
    """`scenario_grid`'s spec errors, and the same errors from the tiled
    scenario sweep (ported since slice 10), which also needs the card
    unless told the CPU."""
    base = tp.make_model_params()
    with pytest.raises(ValueError, match="single-bank"):
        ts.scenario_grid(ts.ScenarioSpec(banks=2), [1.0], [0.1], base, device=CPU)
    with pytest.raises(ValueError, match="learning='baseline'"):
        ts.scenario_grid(ts.ScenarioSpec(learning="social"), [1.0], [0.1], base, device=CPU)
    with pytest.raises(ValueError, match="single-bank"):
        ts.run_tiled_scenario_grid(ts.ScenarioSpec(banks=2), [1.0], [0.1], base, device=CPU)
    with pytest.raises(ValueError, match="learning='baseline'"):
        ts.run_tiled_scenario_grid(ts.ScenarioSpec(learning="social"), [1.0], [0.1], base,
                                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.run_tiled_scenario_grid(ts.ScenarioSpec(), [1.0], [0.1], base)


# the tiled scenario sweep: a ragged 6×5 grid in 4×3 tiles
TB = np.linspace(0.4, 2.6, 6)
TU = np.linspace(0.02, 0.9, 5)
POLICY_MODS = ("insurance_cap", "suspension", "lolr")
POLICY_KW = dict(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1)


def _tiled_scenario(spec, base, **kw):
    return ts.run_tiled_scenario_grid(spec, TB, TU, base, config=_sweep_cfg(tp),
                                      tile_shape=(4, 3), device=CPU, **kw)


def _same_cells(a, b) -> bool:
    return all(_bitwise(getattr(a, f), getattr(b, f)) for f in ("xi", "max_aw", "status"))


def test_tiled_scenario_grid_reducible_is_the_plain_sweep(tmp_path):
    """A baseline-reducible spec is `scenario_grid` and `beta_u_grid` bit
    for bit, and is keyed as the plain sweep: a plain tiled sweep's
    checkpoint directory resumes it without a recompute."""
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    base = tp.make_model_params()
    run_tiled_grid(TB, TU, base, config=_sweep_cfg(tp), tile_shape=(4, 3),
                   checkpoint_dir=tmp_path, device=CPU)
    report = {}
    got = _tiled_scenario(ts.ScenarioSpec(), base, checkpoint_dir=tmp_path, report=report)
    assert report["counts"] == {"local": 4, "cache": 0, "computed": 0}
    want = ts.scenario_grid(ts.ScenarioSpec(), TB, TU, base, config=_sweep_cfg(tp), device=CPU)
    plain = beta_u_grid(TB, TU, base, config=_sweep_cfg(tp), device=CPU)
    assert _same_cells(got, want) and _same_cells(got, plain)


@pytest.fixture(scope="module")
def reference_tiled_policy():
    spec = js.ScenarioSpec(modifiers=POLICY_MODS)
    return js.run_tiled_scenario_grid(spec, TB, TU, jp.make_model_params(**POLICY_KW),
                                      config=_sweep_cfg(jp), tile_shape=(4, 3))


def test_tiled_scenario_grid_policy_spec(reference_tiled_policy, tmp_path):
    """A composed spec: `scenario_grid` on the same axes bit for bit, the
    reference's tiled sweep within the fixed-numerics contract (statuses
    equal, ξ within 1e-12), and keyed apart from the plain sweep."""
    spec, base = ts.ScenarioSpec(modifiers=POLICY_MODS), tp.make_model_params(**POLICY_KW)
    got = _tiled_scenario(spec, base, checkpoint_dir=tmp_path / "composed")
    want = ts.scenario_grid(spec, TB, TU, base, config=_sweep_cfg(tp), device=CPU)
    assert _same_cells(got, want)
    ref = reference_tiled_policy
    assert np.array_equal(_np(got.status), np.asarray(ref.status))
    assert _gap(got.xi, ref.xi) <= FIXED_TOL and _gap(got.max_aw, ref.max_aw) <= FIXED_TOL
    assert (_np(got.status) == Status.RUN).any() and (_np(got.status) != Status.RUN).any()
    with pytest.raises(ValueError, match="different sweep"):
        _tiled_scenario(ts.ScenarioSpec(), base, checkpoint_dir=tmp_path / "composed")


def test_tiled_scenario_grid_heals_only_reducible_specs():
    from sbr_tpu_torch.resilience import FaultPlan, faults

    nan = {"seed": 0, "rules": [{"point": "tile.result", "kind": "nan", "cells": 2,
                                 "max_fires": 1}]}
    base = tp.make_model_params(**POLICY_KW)
    try:
        faults.install(FaultPlan(nan))
        report = {}
        healed = _tiled_scenario(ts.ScenarioSpec(), base, report=report)
        assert [r["repaired"] for r in report["repairs"]] == [True, True]
        plain = beta_u_grid(TB, TU, base, config=_sweep_cfg(tp), device=CPU)
        assert _same_cells(healed, plain)
        faults.install(FaultPlan(nan))
        report = {}
        spec = ts.ScenarioSpec(modifiers=POLICY_MODS)
        kept = _tiled_scenario(spec, base, report=report)
        assert report["repairs"] == []
        assert np.isnan(_np(kept.xi)[0, 0]) and np.isnan(_np(kept.xi)[0, 1])
    finally:
        faults.install(None)


# ---------------------------------------------------------------------------
# Multi-bank contagion
# ---------------------------------------------------------------------------


NETWORKS = {
    "flip": (dict(banks=3, exposure=((0, 1, 1.0), (0, 2, 1.0), (1, 2, 0.5)), lgd=0.9),
             lambda m: [m.make_model_params(beta=1.0, u=0.05),
                        m.make_model_params(beta=1.0, u=0.05, kappa=0.93),
                        m.make_model_params(beta=1.0, u=0.05, kappa=0.93)]),
    "empty": (dict(banks=3),
              lambda m: [m.make_model_params(beta=1.0 + 0.3 * i, u=0.05 + 0.02 * i)
                         for i in range(3)]),
    "exhausted": (dict(banks=2, exposure=((0, 1, 1.0), (1, 0, 1.0)), lgd=0.9,
                       contagion_max_iter=1),
                  lambda m: [m.make_model_params(u=0.05), m.make_model_params(u=0.05, kappa=0.93)]),
    "ring": (dict(banks=8, exposure=tuple((i, (i + 1) % 8, 0.6) for i in range(8)),
                  contagion_max_iter=12, contagion_tol=1e-5),
             lambda m: [m.make_model_params(beta=1.0 + 0.5 * i / 7, u=0.05) for i in range(8)]),
    "damped_insured_ring": (
        dict(banks=8, exposure=tuple((i, (i + 1) % 8, 0.6) for i in range(8)),
             contagion_max_iter=20, contagion_damping=0.5, lgd=0.8, modifiers=("insurance_cap",)),
        lambda m: [m.make_model_params(beta=1.0 + 0.5 * i / 7, u=0.05, kappa=0.5 + 0.05 * i,
                                       insurance_cap=0.05) for i in range(8)]),
    "calm_tol_zero": (dict(banks=2, exposure=((0, 1, 0.5),), contagion_tol=0.0),
                      lambda m: m.make_model_params(u=5.0)),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_multibank_matches_the_reference(name):
    spec_kw, make = NETWORKS[name]
    want = js.solve_multibank(js.ScenarioSpec(**spec_kw), make(jp), config=_sweep_cfg(jp))
    got = ts.solve_multibank(ts.ScenarioSpec(**spec_kw), make(tp), config=_sweep_cfg(tp),
                             device=CPU)
    assert got.fingerprint == want.fingerprint
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    assert np.array_equal(_np(got.status), np.asarray(want.status))
    assert np.array_equal(_np(got.health.flags), np.asarray(want.health.flags))
    for f in ("xi", "aw_max", "kappa_eff", "spillover", "tau_bar_in"):
        assert _gap(getattr(got, f), getattr(want, f)) <= FIXED_TOL, f


def _scenario_calls(pkg, run_dir):
    if pkg == "ref":
        from sbr_tpu import obs as mod

        S, P, kw = js, jp, {}
    else:
        from sbr_tpu_torch import obs as mod

        S, P, kw = ts, tp, {"device": CPU}
    spec_kw, make = NETWORKS["flip"]
    with mod.run_context(run_dir=str(run_dir)):
        S.scenario_grid(S.ScenarioSpec(modifiers=("insurance_cap",)), np.linspace(0.5, 2.0, 3),
                        np.linspace(0.02, 0.5, 3), P.make_model_params(insurance_cap=0.4),
                        config=_sweep_cfg(P), **kw)
        S.solve(S.ScenarioSpec(), P.make_model_params(), config=_cfg(P), **kw)
        S.solve(S.ScenarioSpec(modifiers=("lolr",)), P.make_model_params(u=0.08, lolr_rate=0.1),
                config=_cfg(P), **kw)
        S.solve_multibank(S.ScenarioSpec(**spec_kw), make(P), config=_sweep_cfg(P), **kw)
    return events(run_dir)


def test_scenario_events_equal_the_reference(tmp_path):
    _scenario_calls("ref", tmp_path / "warm")  # the reference's trace-time spans, once
    want = _scenario_calls("ref", tmp_path / "ref")
    got = _scenario_calls("port", tmp_path / "port")
    assert_same_events(got, want, {"stage_start", "stage_end", "jit_call", "status", "health"})
    banks = [(e["stage"].split("[")[0], e.get("bank")) for e in got if e["kind"] == "health"]
    assert banks[-3:] == [("scenario.multibank", i) for i in range(3)]


def _batch(plist, spec=None, kappa=None):
    cfg = _sweep_cfg(tp)
    spec = spec or ts.ScenarioSpec(banks=len(plist))
    cols = ts.multibank._bank_columns(spec, plist, torch.float64, CPU)
    if kappa is not None:
        cols[ts.SCENARIO_KEYS.index("kappa")] = kappa
    return ts.engine.batch_fn(ts.ScenarioSpec(), cfg, "float64")(*cols), cols


def test_empty_network_equals_independent_solves():
    _, make = NETWORKS["empty"]
    plist = make(tp)
    mb = ts.solve_multibank(ts.ScenarioSpec(banks=3), plist, config=_sweep_cfg(tp), device=CPU)
    assert mb.converged and mb.iterations == 1
    (xi, _t, _a, status, health), cols = _batch(plist)
    assert _bitwise(mb.status, status) and _bitwise(mb.xi, xi)
    assert _same_health(mb.health, health)
    assert _bitwise(mb.kappa_eff, cols[ts.SCENARIO_KEYS.index("kappa")])
    # and each bank is its own single-bank cell
    for i, p in enumerate(plist):
        one = ts.solve_scenario_cell(ts.ScenarioSpec(), *(c[i:i + 1] for c in cols),
                                     config=_sweep_cfg(tp))
        assert _bitwise(one[0], xi[i:i + 1]) and _bitwise(one[3], status[i:i + 1])


def test_contagion_flips_a_sound_bank():
    _, make = NETWORKS["flip"]
    plist = make(tp)
    no_net = ts.solve_multibank(ts.ScenarioSpec(banks=3), plist, config=_sweep_cfg(tp),
                                device=CPU)
    assert int(no_net.status[0]) == Status.RUN and int(no_net.status[1]) != Status.RUN
    spec_kw, _ = NETWORKS["flip"]
    mb = ts.solve_multibank(ts.ScenarioSpec(**spec_kw), plist, config=_sweep_cfg(tp), device=CPU)
    assert int(mb.status[0]) == Status.RUN and int(mb.status[1]) == Status.RUN
    assert float(mb.kappa_eff[1]) < 0.93 and float(mb.spillover[1]) > 0
    assert bool(mb.bankrun.all()) and "runs=3" in repr(mb)


def test_exhaustion_reports_the_solved_kappa():
    spec_kw, make = NETWORKS["exhausted"]
    plist = make(tp)
    mb = ts.solve_multibank(ts.ScenarioSpec(**spec_kw), plist, config=_sweep_cfg(tp), device=CPU)
    assert not mb.converged
    (xi, _t, _a, status, _h), _ = _batch(plist, ts.ScenarioSpec(**spec_kw), mb.kappa_eff)
    assert _bitwise(mb.status, status) and _bitwise(mb.xi, xi)


def test_shared_params_normalize_and_defaults_agree():
    cfg = _sweep_cfg(tp)
    p = tp.make_model_params(u=0.05)
    spec = ts.ScenarioSpec(banks=3)
    shared = ts.solve_multibank(spec, p, config=cfg, device=CPU)
    listed = ts.solve_multibank(spec, [p, p, p], config=cfg, device=CPU)
    assert shared.fingerprint == listed.fingerprint
    with pytest.raises(ValueError, match="params structs"):
        ts.solve_multibank(spec, [p, p], config=cfg, device=CPU)
    with pytest.raises(ValueError, match="banks >= 2"):
        ts.solve_multibank(ts.ScenarioSpec(), p, device=CPU)
    spec = ts.ScenarioSpec(banks=2, exposure=((0, 1, 0.5),))
    a = ts.solve(spec, [p, p], device=CPU)
    b = ts.solve_multibank(spec, [p, p], device=CPU)
    assert a.fingerprint == b.fingerprint and _bitwise(a.xi, b.xi)


def test_program_cache_ignores_host_only_knobs():
    cfg = _sweep_cfg(tp)
    a = ts.engine.batch_fn(ts.ScenarioSpec(banks=2, exposure=((0, 1, 0.5),), lgd=0.5), cfg,
                           "float64")
    b = ts.engine.batch_fn(ts.ScenarioSpec(banks=3, lgd=0.6, contagion_tol=1e-4), cfg, "float64")
    assert a is b
    assert ts.ScenarioSpec(lgd=0.9).cell_program_spec() == ts.ScenarioSpec()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _engine(tmp_path=None):
    serve = ServeConfig(buckets=(1, 8), cache_dir=str(tmp_path) if tmp_path else None)
    return Engine(config=_sweep_cfg(tp), serve=serve, device=CPU)


def test_served_scenario_query_is_cached_by_fingerprint(tmp_path):
    spec = ts.ScenarioSpec(modifiers=("insurance_cap", "lolr"))
    params = tp.make_model_params(u=0.08, insurance_cap=0.1, lolr_rate=0.05)
    engine = _engine(tmp_path)
    try:
        first = engine.query_scenario(params, spec)
        again = engine.query_scenario(params, spec)
        other = engine.query_scenario(tp.with_overrides(params, lolr_rate=0.2), spec)
    finally:
        engine.close()
    assert (first["source"], again["source"]) == ("computed", "lru")
    assert first["scenario_fingerprint"] == again["scenario_fingerprint"]
    assert other["scenario_fingerprint"] != first["scenario_fingerprint"]
    direct = ts.solve(spec, params, config=_sweep_cfg(tp), device=CPU)
    assert first["status"] == int(direct.status) == Status.RUN
    assert first["xi"] == float(direct.xi)
    assert first["flags"] == int(direct.health.flags) and first["banks"] == 1
    # the key carries the engine's tag: it is not the bare spec fingerprint
    assert first["scenario_fingerprint"] != direct.fingerprint
    engine = _engine(tmp_path)
    try:
        restored = engine.query_scenario(params, spec)
    finally:
        engine.close()
    assert restored["source"] == "disk" and restored["xi"] == first["xi"]


def test_served_multibank_query_matches_the_reference():
    spec_kw = dict(banks=3, exposure=((0, 1, 0.5), (0, 2, 0.5)))
    engine = _engine()
    ref = JEngine(config=_sweep_cfg(jp))
    try:
        got = engine.query_scenario(tp.make_model_params(u=0.05), ts.ScenarioSpec(**spec_kw))
        want = ref.query_scenario(jp.make_model_params(u=0.05), js.ScenarioSpec(**spec_kw))
    finally:
        engine.close()
        ref.close()
    assert got["banks"] == 3 and len(got["xi"]) == 3
    for k in ("status", "flags", "iterations", "converged", "banks"):
        assert got[k] == want[k], k
    for k in ("xi", "aw_max", "kappa_eff"):
        assert _gap(np.asarray(got[k], float), np.asarray(want[k], float)) <= FIXED_TOL


def test_endpoint_scenario_routes_and_codes():
    engine = _engine().start()
    endpoint = None
    try:
        endpoint = ServeEndpoint(engine).start()
        port = endpoint.port

        def post(doc):
            code, body, _ = http_request(port, "/query", doc)
            return code, json.loads(body)

        code, plain = post({"u": 0.08, "scenario": {"modifiers": ["insurance_cap"]}})
        assert code == 200 and plain["status"] == Status.RUN
        code, capped = post({"u": 0.08, "insurance_cap": 0.9,
                             "scenario": {"modifiers": ["insurance_cap"]}})
        assert code == 200 and capped["status"] != Status.RUN
        assert capped["scenario_fingerprint"] != plain["scenario_fingerprint"]
        code, again = post({"u": 0.08, "scenario": {"modifiers": ["insurance_cap"]}})
        assert code == 200 and again["source"] == "lru"
        code, interest = post({"u": 0.05, "r": 0.02, "delta": 0.1,
                               "scenario": {"modifiers": ["interest"]}})
        assert code == 200 and "scenario_fingerprint" in interest
        code, banks = post({"u": 0.05, "scenario": {"banks": 2, "exposure": [[0, 1, 0.5]]}})
        assert code == 200 and len(banks["status"]) == 2
        for doc, reason in (
            ({"u": 0.05, "scenario": {"modifiers": ["interest"]}}, "unservable scenario"),
            ({"u": 0.05, "scenario": {"modfiers": ["lolr"]}}, "bad scenario"),
            ({"u": 0.05, "scenario": {"learning": "bayesian"}}, "bad scenario"),
            ({"u": 0.05, "r": 0.02}, "bad parameters"),
            ({"u": 0.05, "r": 0.02, "scenario": {"modifiers": ["insurance_cap"]}},
             "bad parameters"),
            ({"u": 0.05, "insurance_cap": 0.5}, "bad parameters"),
            ({"u": 0.05, "lolr_rate": 0.2, "scenario": {"modifiers": ["suspension"]}},
             "bad parameters"),
            ({"u": 0.05, "grads": True, "scenario": {"modifiers": ["lolr"]}}, "grads"),
            ({"u": 0.05, "scenario": {}, "population": {"graph": {"n": 100, "avg_degree": 4}}},
             "mutually exclusive"),
        ):
            code, body = post(doc)
            assert code == 400 and reason in body["error"], (doc, body)
        code, body = post({"u": 0.05, "grads": True})
        assert code == 200 and set(body["grads"]) == {"beta", "u", "kappa"}
        code, statz, _ = http_request(port, "/statz")
        assert code == 200
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()


def test_scenario_modules_import_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sbr_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sbr_tpu_torch.scenario as sc\n"
        "import sbr_tpu_torch.infomodels.population\n"
        "import sbr_tpu_torch.serve.engine, sbr_tpu_torch.serve.endpoint\n"
        "import sbr_tpu_torch as st\n"
        "cfg = st.SolverConfig(n_grid=64, bisect_iters=30, refine_crossings=False)\n"
        "r = sc.solve(sc.ScenarioSpec(modifiers=('lolr',)), st.make_model_params(u=0.08),\n"
        "    config=cfg, device='cpu')\n"
        "print('ok', int(r.status))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tp.make_model_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.solve(ts.ScenarioSpec(modifiers=("lolr",)), m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.scenario_grid(ts.ScenarioSpec(), [1.0], [0.1], m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.solve_multibank(ts.ScenarioSpec(banks=2), m)
