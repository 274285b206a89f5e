"""The composed-scenario solve: the port of ``sbr_tpu.scenario.engine``.

`solve(spec, params)` runs the staged pipeline a `ScenarioSpec` describes:

- **Reducible specs** dispatch to the plain solves (`solve_param_cell`,
  `solve_equilibrium_baseline`, `solve_equilibrium_interest(_core)`,
  `solve_equilibrium_hetero`, `solve_equilibrium_social`), so a baseline,
  hetero, interest or social spec is the plain solve bit for bit, by
  construction.
- **Genuine compositions** run through the stage hooks of
  `baseline.solver.solve_equilibrium_core` and
  `hetero.solver.solve_equilibrium_hetero` (``hazard_transform``,
  ``kappa_transform``): the policy modifiers and the interest HJB stage
  (`interest.solver.effective_hazard_stage`) splice into any pipeline,
  hetero × interest × social at once included.
- **Multi-bank specs** (banks >= 2) route to `scenario.multibank`.

The reference vmaps one cell; here `solve_scenario_cell` takes whole
batches, as `solve_param_cell` does: β (and p, λ, η, t0, t1, x0) have a row
shape R, u, κ and the modifier knobs a cell shape C, so one call solves a
β×u grid (`scenario_grid`), a batch of banks (`multibank`) or a batch of
served queries. The composed social fixed point is the port's damped loop
(`social.solver.run_fixed_point`), one host read an iteration, with its
copies of XLA's damping and ξ-march arithmetic.

`run_tiled_scenario_grid` runs `scenario_grid` tiles through the tiled,
checkpointed runner (`utils.checkpoint.run_tiled_grid`). Not ported: the
reference's telemetry calls (ROADMAP 1.A item 9).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from sbr_tpu_torch.baseline.learning import logistic_cdf, solve_learning
from sbr_tpu_torch.baseline.solver import (
    _col,
    get_aw,
    hazard_grid_is_uniform,
    solve_equilibrium_baseline,
    solve_equilibrium_core,
    warped_grid_index,
)
from sbr_tpu_torch.core.integrate import cumtrapz
from sbr_tpu_torch.core.interp import linspace
from sbr_tpu_torch.diag.health import Health, or_reduce_flags
from sbr_tpu_torch.hetero.solver import _cdf_rows_at, solve_equilibrium_hetero
from sbr_tpu_torch.interest.solver import effective_hazard_stage
from sbr_tpu_torch.models.params import ModelParams, SolverConfig
from sbr_tpu_torch.models.results import LearningSolutionHetero, _fmt
from sbr_tpu_torch.scenario.spec import ScenarioSpec, spec_fingerprint
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.social.dynamics import solve_forced_learning
from sbr_tpu_torch.social.solver import no_run_xi, run_fixed_point
from sbr_tpu_torch.sweeps.baseline_sweeps import GridSweepResult, _RowLearning, solve_param_cell

# θ keys of the baseline cell, in `solve_param_cell`'s column order (the
# reference's `grad.cell.BASE_KEYS`).
BASE_KEYS = ("beta", "u", "p", "kappa", "lam", "eta", "t0", "t1", "x0")
# θ column order of one composed cell: the `solve_param_cell` columns,
# then interest's rate/maturity, then the policy knobs.
SCENARIO_KEYS = BASE_KEYS + ("r", "delta", "insurance_cap", "suspension_t", "lolr_rate")


@dataclasses.dataclass
class ScenarioResult:
    """One solved scenario: the headline values plus the underlying solve's
    result in ``detail`` (an `EquilibriumResult`, `EquilibriumResultHetero`,
    `EquilibriumResultInterest`, `SocialFixedPointResult`, or the composed
    social fixed point's dict)."""

    spec: ScenarioSpec
    fingerprint: str
    xi: object
    status: object
    bankrun: object
    health: object
    detail: object

    def __repr__(self) -> str:
        return (
            f"ScenarioResult(spec={self.spec.learning}+{list(self.spec.modifiers)}"
            f"x{self.spec.banks}, ξ={_fmt(self.xi)}, status={_fmt(self.status)}, "
            f"fp={self.fingerprint[:12]})"
        )


def _theta_values(params) -> dict:
    """The SCENARIO_KEYS values of one params struct as Python floats (r/δ
    default to the inert 0 / 0.1 when the economics is not
    interest-typed; the hetero family has no scalar β)."""
    econ = params.economic
    lrn = params.learning
    vals = {
        "beta": getattr(lrn, "beta", None),
        "u": econ.u,
        "p": econ.p,
        "kappa": econ.kappa,
        "lam": econ.lam,
        "eta": econ.eta,
        "t0": lrn.tspan[0],
        "t1": lrn.tspan[1],
        "x0": lrn.x0,
        "r": getattr(econ, "r", 0.0),
        "delta": getattr(econ, "delta", 0.1),
        "insurance_cap": econ.insurance_cap,
        "suspension_t": econ.suspension_t,
        "lolr_rate": econ.lolr_rate,
    }
    return {k: float(v) for k, v in vals.items() if v is not None}


def _tensors(values: dict, dtype, device) -> dict:
    """0-d tensors of ``dtype`` on ``device``, made in one host copy."""
    table = torch.tensor(list(values.values()), dtype=dtype).to(device)
    return dict(zip(values, table.unbind()))


def scenario_theta(params, dtype, device="cpu") -> dict:
    """The SCENARIO_KEYS dict of one params struct, as 0-d tensors of
    ``dtype`` on ``device``."""
    vals = _theta_values(params)
    return _tensors({k: vals[k] for k in SCENARIO_KEYS}, dtype, device)


def scenario_theta_hetero(params, dtype, device="cpu") -> dict:
    """θ dict for hetero-family specs: SCENARIO_KEYS without the scalar β
    (the group betas/dist go to Stage 1 from the params struct)."""
    return _tensors(_theta_values(params), dtype, device)


def _validate_params(spec: ScenarioSpec, params) -> None:
    """Spec × params compatibility checks (the composition matrix)."""
    if "interest" in spec.modifiers and not hasattr(params.economic, "r"):
        raise ValueError(
            "spec activates the 'interest' modifier but params carries no "
            "r/delta — build it with make_interest_params(...)"
        )
    if spec.learning == "hetero" and not hasattr(params.learning, "betas"):
        raise ValueError(
            "spec.learning='hetero' requires ModelParamsHetero (betas/dist "
            "group structure) — build it with make_hetero_params(...)"
        )
    if spec.learning == "baseline" and not hasattr(params.learning, "beta"):
        raise ValueError(
            "spec.learning='baseline' requires scalar-beta params "
            "(make_model_params / make_interest_params)"
        )
    if spec.learning == "social" and not (
        hasattr(params.learning, "beta") or hasattr(params.learning, "betas")
    ):
        raise ValueError(
            "spec.learning='social' requires scalar-beta params, or "
            "ModelParamsHetero for the social × hetero composition"
        )


# ---------------------------------------------------------------------------
# Stage-transformer builders
# ---------------------------------------------------------------------------


def _scaled(hazard_at, scale):
    return lambda t: scale * hazard_at(t)


def _suspended(hazard_at, s):
    return lambda t: torch.where(t < s, hazard_at(t), 0.0)


def _make_hazard_transform(spec: ScenarioSpec, theta: dict, config: SolverConfig, ls):
    """The baseline-family hazard transform for ``spec.modifiers``: rewrites
    (hr, hazard_at) in spec order; None when no hazard modifier is active.
    θ values have the cell shape (or broadcast to it) and are aligned
    against the grid axis of the (R + (n,)) hazard rows."""
    mods = tuple(m for m in spec.modifiers if m != "lolr")
    if not mods:
        return None
    warped = not hazard_grid_is_uniform(ls, config)

    def transform(tau_grid, hr, hazard_at):
        extra = []
        for mod in mods:
            if mod == "interest":
                index_fn = None
                if warped and ls.closed_form:
                    def index_fn(t):
                        return warped_grid_index(t, theta["eta"], ls.beta, ls.x0,
                                                 config.n_grid, config.grid_warp)
                hr, hazard_at, _v, v_health = effective_hazard_stage(
                    tau_grid, hr, theta["r"], theta["delta"], theta["u"], config,
                    hazard_at=hazard_at, uniform=not warped, index_fn=index_fn,
                )
                extra.append(v_health)
            elif mod == "insurance_cap":
                scale = 1.0 - theta["insurance_cap"]
                hr = _col(scale) * hr
                if hazard_at is not None:
                    hazard_at = _scaled(hazard_at, scale)
            elif mod == "suspension":
                s = theta["suspension_t"]
                hr = torch.where(tau_grid < _col(s), hr, 0.0)
                if hazard_at is not None:
                    hazard_at = _suspended(hazard_at, s)
        return hr, hazard_at, tuple(extra)

    return transform


def _make_hazard_transform_hetero(spec: ScenarioSpec, theta: dict, config: SolverConfig):
    """The K-group variant: modifiers rewrite the (K, n) hazard rows; the
    interest stage solves one HJB per row (the rows as lanes), and its
    per-group flags OR-reduce into one scalar Health, the hetero solve's
    scalar-health contract."""
    mods = tuple(m for m in spec.modifiers if m != "lolr")
    if not mods:
        return None
    uniform = not (config.grid_warp > 0.0)  # mirrors hazard_rates_hetero

    def transform(tau_grid, hrs, _):
        extra = []
        for mod in mods:
            if mod == "interest":
                # one HJB lane a group row, on the shared grid
                hrs, _none, _v, v_health = effective_hazard_stage(
                    tau_grid, hrs, theta["r"], theta["delta"],
                    theta["u"].expand(hrs.shape[:-1]), config, hazard_at=None,
                    uniform=uniform,
                )
                extra.append(Health.of_flags(or_reduce_flags(v_health.flags), hrs.dtype))
            elif mod == "insurance_cap":
                hrs = (1.0 - theta["insurance_cap"]) * hrs
            elif mod == "suspension":
                hrs = torch.where(tau_grid < theta["suspension_t"], hrs, 0.0)
        return hrs, None, tuple(extra)

    return transform


def _make_kappa_transform(spec: ScenarioSpec, theta: dict):
    """κ_eff = κ·(1 + lolr_rate) when the LOLR modifier is active."""
    if "lolr" not in spec.modifiers:
        return None
    lolr = theta["lolr_rate"]
    return lambda kappa: torch.as_tensor(kappa, dtype=lolr.dtype, device=lolr.device) * (1.0 + lolr)


# ---------------------------------------------------------------------------
# The composed cell (the scenario analogue of solve_param_cell)
# ---------------------------------------------------------------------------


def solve_scenario_cell(spec: ScenarioSpec, *cols, config: SolverConfig, dtype=None,
                        device=None):
    """Composed cells from the 14 SCENARIO_KEYS columns → (xi,
    tau_bar_in_unc, aw_max, status, health), the lean outputs every batch
    shares. β, p, λ, η, t0, t1 and x0 have the row shape R; u, κ, r, δ and
    the policy knobs the cell shape C (see `solve_param_cell`).

    Reducible specs route through the plain cells exactly
    (`solve_param_cell`, `solve_equilibrium_interest_core`), so a composed
    grid whose spec reduces is the plain grid bit for bit."""
    dtype = torch.float64 if dtype is None else dtype
    if device is None:
        device = next((c.device for c in cols if isinstance(c, torch.Tensor)), None)
    device = torch.device(device) if device is not None else default_device()
    red = spec.reduces_to()
    if red == "baseline":
        return solve_param_cell(*cols[:9], config, dtype, device)
    theta = {k: torch.as_tensor(v, dtype=dtype, device=device)
             for k, v in zip(SCENARIO_KEYS, cols)}
    ls = solve_learning(
        _RowLearning(theta["beta"], (theta["t0"], theta["t1"]), theta["x0"]),
        config, dtype=dtype, device=device,
    )
    if red == "interest":
        from sbr_tpu_torch.interest.solver import solve_equilibrium_interest_core

        res = solve_equilibrium_interest_core(
            ls, theta["u"], theta["p"], theta["kappa"], theta["lam"],
            theta["eta"], theta["r"], theta["delta"], theta["t1"], config,
        ).base
        return res.xi, res.tau_bar_in_unc, res.aw_max, res.status, res.health
    res = solve_equilibrium_core(
        ls, theta["u"], theta["p"], theta["kappa"], theta["lam"], theta["eta"],
        theta["t1"], config,
        hazard_transform=_make_hazard_transform(spec, theta, config, ls),
        kappa_transform=_make_kappa_transform(spec, theta),
        curves=False,
    )
    return res.xi, res.tau_bar_in_unc, res.aw_max, res.status, res.health


def batch_fn(spec: ScenarioSpec, config: SolverConfig, dtype_name: str):
    """The batch program over the 14 SCENARIO_KEYS columns (each of shape
    (N,), on one device): the multi-bank unit. Cached per (cell-program
    spec, config, dtype): the key is the spec projected onto what the cell
    depends on (`cell_program_spec`), so specs differing only in host-side
    knobs (lgd, contagion_tol, ...) share one program."""
    return _batch_fn_cached(spec.cell_program_spec(), config, dtype_name)


@functools.lru_cache(maxsize=None)
def _batch_fn_cached(spec: ScenarioSpec, config: SolverConfig, dtype_name: str):
    dtype = getattr(torch, dtype_name)

    def fn(*cols):
        return solve_scenario_cell(spec, *cols, config=config, dtype=dtype)

    return fn


def scenario_grid(
    spec: ScenarioSpec,
    beta_values,
    u_values,
    base: ModelParams,
    config: Optional[SolverConfig] = None,
    dtype=None,
    device=None,
) -> GridSweepResult:
    """β×u grid sweep through the composed pipeline: a policy sweep is a
    grid sweep over a composed cell. η and tspan stay pinned at the base
    model's as in `sweeps.beta_u_grid`, with the same `GridSweepResult` and
    the same sweep default (``config=None``: refinement off). With a
    baseline-reducible spec the cell is `solve_param_cell`, so the grid is
    `beta_u_grid`'s bit for bit. Runs on ``device`` (default: the CUDA
    card) in ``dtype`` (default: float64)."""
    if spec.banks != 1:
        raise ValueError(
            "scenario_grid sweeps single-bank specs; use multibank.solve for banks > 1"
        )
    if spec.learning != "baseline":
        raise ValueError(
            f"scenario_grid requires learning='baseline' cells, got {spec.learning!r}"
        )
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    _validate_params(spec, base)

    beta_values = torch.as_tensor(beta_values, dtype=dtype, device=device)
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    theta = scenario_theta(base, dtype, device)
    scalars = tuple(theta[k] for k in SCENARIO_KEYS[2:])  # all but beta, u
    xi, _, aw_max, status, health = solve_scenario_cell(
        spec.cell_program_spec(), beta_values.unsqueeze(-1), u_values, *scalars,
        config=config, dtype=dtype, device=device,
    )
    return GridSweepResult(
        beta_values=beta_values, u_values=u_values, max_aw=aw_max, xi=xi,
        status=status, health=health,
    )


def run_tiled_scenario_grid(
    spec: ScenarioSpec,
    beta_values,
    u_values,
    base: ModelParams,
    checkpoint_dir: Optional[str] = None,
    config: Optional[SolverConfig] = None,
    dtype=None,
    tile_shape=(256, 256),
    **kw,
):
    """β×u scenario sweep through the tiled runner: `scenario_grid` cells
    with `utils.checkpoint.run_tiled_grid`'s checkpoint resume, cross-run
    tile cache, retry policy and budget, and degrade-ladder repair on
    baseline-reducible specs. The spec joins the sweep fingerprint and
    every tile-cache key, so composed and plain sweeps never share bytes,
    except the exact baseline reduction, which is keyed as a plain sweep
    (its cells are `beta_u_grid`'s bit for bit). Same spec constraints as
    `scenario_grid`; ``**kw`` passes through to `run_tiled_grid`
    (``device``, ``max_retries``, ``tile_cache``, ``heal_divergent``,
    ``report``, ...). Runs on the CUDA card unless given ``device``."""
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    if spec.banks != 1:
        raise ValueError(
            "run_tiled_scenario_grid sweeps single-bank specs; use "
            "multibank.solve for banks > 1"
        )
    if spec.learning != "baseline":
        raise ValueError(
            f"run_tiled_scenario_grid requires learning='baseline' cells, "
            f"got {spec.learning!r}"
        )
    _validate_params(spec, base)
    passthrough = None if spec.reduces_to() == "baseline" else spec
    return run_tiled_grid(
        beta_values, u_values, base, config=config, tile_shape=tile_shape,
        checkpoint_dir=checkpoint_dir, dtype=dtype, scenario_spec=passthrough,
        **kw,
    )


# ---------------------------------------------------------------------------
# Composed social fixed point (social × {hetero, interest, policy})
# ---------------------------------------------------------------------------


class _ThetaEcon:
    """Duck-typed economics over a θ dict."""

    def __init__(self, theta: dict):
        self.u = theta["u"]
        self.p = theta["p"]
        self.kappa = theta["kappa"]
        self.lam = theta["lam"]
        self.eta = theta["eta"]


def _aw_curve_hetero(xi, tau_ins, tau_outs, grid, lsh: LearningSolutionHetero):
    """Dist-weighted aggregate AW(t) on ``grid``: the hetero analogue of
    `baseline.solver.get_aw`'s cumulative curve (each branch zeroed before
    its own start, plus the aggregate G(0) offset)."""
    tau_in_con = torch.minimum(tau_ins, xi)
    tau_out_con = torch.minimum(tau_outs, xi)

    def branch(tau_con):
        shift = grid[None, :] - xi + tau_con[:, None]
        vals = _cdf_rows_at(lsh, torch.clamp(shift, min=0.0))
        return torch.where(shift >= 0, vals, 0.0)

    aw = lsh.dist @ (branch(tau_out_con) - branch(tau_in_con))
    return aw + torch.dot(lsh.dist, lsh.cdfs[:, 0])


def _solve_composed_social(spec: ScenarioSpec, params, config: SolverConfig, dtype, device,
                           fp: str) -> ScenarioResult:
    """The damped fixed point (`social.solver.run_fixed_point`, plain
    damping: the Anderson step stays the plain social solve's) with the
    inner equilibrium generalized to any composed baseline-family or hetero
    pipeline; the inner solves honour ``config.numerics``. tspan is (0, η)
    as in the plain social solve."""
    hetero = hasattr(params.learning, "betas")
    if hetero:
        theta = scenario_theta_hetero(params, dtype, device)
        betas = torch.as_tensor(params.learning.betas, dtype=dtype).to(device)
        dist = torch.as_tensor(params.learning.dist, dtype=dtype).to(device)
        inner = dataclasses.replace(spec.social_program_spec(), learning="hetero")
    else:
        theta = scenario_theta(params, dtype, device)
        inner = dataclasses.replace(spec.social_program_spec(), learning="baseline")
    eta, x0 = theta["eta"], theta["x0"]
    grid = linspace(torch.zeros((), dtype=dtype, device=device), eta, config.n_grid, dtype, device)
    kt = _make_kappa_transform(inner, theta)

    if hetero:
        econ = _ThetaEcon(theta)
        ht = _make_hazard_transform_hetero(inner, theta, config)
        dx = grid[1] - grid[0]

        def step(aw, xi):
            big_a = cumtrapz(aw, dx=dx)
            cdfs = 1.0 - (1.0 - x0) * torch.exp(-betas[:, None] * big_a[None, :])
            pdfs = (1.0 - cdfs) * betas[:, None] * aw[None, :]
            lsh = LearningSolutionHetero(grid=grid, cdfs=cdfs, pdfs=pdfs, t0=grid[0], dt=dx,
                                         betas=betas, dist=dist)
            res = solve_equilibrium_hetero(lsh, econ, config, tspan_end=eta,
                                           hazard_transform=ht, kappa_transform=kt)
            xi_new = no_run_xi(res, xi, eta)
            aw_new = _aw_curve_hetero(xi_new, res.tau_bar_in_uncs, res.tau_bar_out_uncs, grid, lsh)
            return lsh, res, xi_new, aw_new

        aw0 = logistic_cdf(grid, torch.dot(dist, betas), x0)
    else:
        def step(aw, xi):
            ls = solve_forced_learning(theta["beta"], aw, grid, x0)
            res = solve_equilibrium_core(
                ls, theta["u"], theta["p"], theta["kappa"], theta["lam"], eta, eta, config,
                hazard_transform=_make_hazard_transform(inner, theta, config, ls),
                kappa_transform=kt,
            )
            xi_new = no_run_xi(res, xi, eta)
            aw_new = get_aw(xi_new, res.tau_bar_in_unc, res.tau_bar_out_unc, grid, ls)[0]
            return ls, res, xi_new, aw_new

        aw0 = logistic_cdf(grid, theta["beta"], x0)

    out = run_fixed_point(step, aw0, grid, eta, spec.social_tol, spec.social_max_iter,
                          spec.social_damping)
    eq = out.equilibrium
    detail = dict(
        equilibrium=eq, aw=out.aw, xi=out.xi, iterations=out.iterations,
        converged=out.converged, aborted=out.aborted, error=out.error, health=out.health,
    )
    return ScenarioResult(spec, fp, eq.xi, eq.status, eq.bankrun, out.health, detail)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def solve(
    spec: ScenarioSpec,
    params,
    config: Optional[SolverConfig] = None,
    dtype=None,
    device=None,
):
    """Solve one composed scenario (module docstring) on ``device``
    (default: the CUDA card) in ``dtype`` (default: float64).

    ``params`` is a `ModelParams` (or the hetero/interest variant the spec
    needs; for multi-bank, optionally a list of one params per bank). The
    result's ``fingerprint`` keys every cache a composed scenario touches.
    Multi-bank specs return `multibank.MultiBankResult`, the others
    `ScenarioResult`."""
    if spec.banks > 1:
        # before defaulting config: multibank's own default is the sweep's
        # (refinement off), and solve and solve_multibank must agree on the
        # numerics, and so on the fingerprint, for the same call
        from sbr_tpu_torch.scenario.multibank import solve_multibank

        return solve_multibank(spec, params, config=config, dtype=dtype, device=device)

    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    _validate_params(spec, params)
    fp = spec_fingerprint(spec, params, config, dtype)
    red = spec.reduces_to()

    if red == "baseline":
        ls = solve_learning(params.learning, config, dtype=dtype, device=device)
        res = solve_equilibrium_baseline(ls, params.economic, config)
        return ScenarioResult(spec, fp, res.xi, res.status, res.bankrun, res.health, res)
    if red == "interest":
        from sbr_tpu_torch.interest.solver import solve_equilibrium_interest

        ls = solve_learning(params.learning, config, dtype=dtype, device=device)
        res = solve_equilibrium_interest(ls, params.economic, config)
        b = res.base
        return ScenarioResult(spec, fp, b.xi, b.status, b.bankrun, b.health, res)
    if red == "hetero":
        from sbr_tpu_torch.hetero.learning import solve_learning_hetero

        lsh = solve_learning_hetero(params.learning, config, dtype=dtype, device=device)
        res = solve_equilibrium_hetero(lsh, params.economic, config)
        return ScenarioResult(spec, fp, res.xi, res.status, res.bankrun, res.health, res)
    if red == "social" and hasattr(params.learning, "beta"):
        # social × hetero params (no scalar β) fall through to the composed
        # fixed point even without modifiers: the plain social solve is
        # scalar-β only
        from sbr_tpu_torch.social.solver import solve_equilibrium_social

        res = solve_equilibrium_social(
            params, config, tol=spec.social_tol, max_iter=spec.social_max_iter,
            damping=spec.social_damping, dtype=dtype, device=device,
        )
        eq = res.equilibrium
        return ScenarioResult(spec, fp, eq.xi, eq.status, eq.bankrun, res.health, res)
    if spec.learning == "social":
        return _solve_composed_social(spec, params, config, dtype, device, fp)
    if spec.learning == "hetero":
        from sbr_tpu_torch.hetero.learning import solve_learning_hetero

        theta = scenario_theta_hetero(params, dtype, device)
        lsh = solve_learning_hetero(params.learning, config, dtype=dtype, device=device)
        res = solve_equilibrium_hetero(
            lsh, params.economic, config,
            hazard_transform=_make_hazard_transform_hetero(spec, theta, config),
            kappa_transform=_make_kappa_transform(spec, theta),
        )
        return ScenarioResult(spec, fp, res.xi, res.status, res.bankrun, res.health, res)
    # composed baseline family
    theta = scenario_theta(params, dtype, device)
    ls = solve_learning(params.learning, config, dtype=dtype, device=device)
    res = solve_equilibrium_core(
        ls, theta["u"], theta["p"], theta["kappa"], theta["lam"], theta["eta"],
        ls.grid[..., -1], config,
        hazard_transform=_make_hazard_transform(spec, theta, config, ls),
        kappa_transform=_make_kappa_transform(spec, theta),
    )
    return ScenarioResult(spec, fp, res.xi, res.status, res.bankrun, res.health, res)
