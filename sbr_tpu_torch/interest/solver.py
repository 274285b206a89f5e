"""Equilibrium with a positive interest rate: the port of
``sbr_tpu.interest.solver``.

Baseline hazard → the HJB value function V on the hazard grid → the
effective hazard h − r·V for the buffer crossings → the baseline ξ
root-find and AW curves. V is computed at every r; at r = 0 the effective
hazard is h itself, so the reference's r = 0 fallback is algebraic, not a
branch, and r can vary per cell (the policy sweep).

Shapes follow `baseline.solver`: the learning solution and the hazard are
rows R, and u and r have the cell shape C.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from sbr_tpu_torch.baseline.solver import (
    _hazard_parts,
    _make_hazard_at,
    classify_cell,
    compute_xi,
    get_aw,
    hazard_grid_is_uniform,
    optimal_buffer,
    warped_grid_index,
)
from sbr_tpu_torch.core.interp import interp, interp_guided, interp_uniform
from sbr_tpu_torch.diag.health import NAN_OUTPUT, Health, flag_bit
from sbr_tpu_torch.interest.value_function import solve_value_function
from sbr_tpu_torch.models.params import EconomicParamsInterest, SolverConfig
from sbr_tpu_torch.models.results import EquilibriumResult, LearningSolution, _fmt


@dataclasses.dataclass(frozen=True)
class EquilibriumResultInterest:
    """The baseline result plus the value function and the effective
    hazard on its ``tau_grid`` (shape C + (n,))."""

    base: EquilibriumResult
    v: torch.Tensor  # V(τ̄) on tau_grid
    hr_effective: torch.Tensor  # h − rV, used for the buffer crossings

    def replace(self, **changes) -> "EquilibriumResultInterest":
        return dataclasses.replace(self, **changes)

    def __repr__(self) -> str:
        return (
            f"EquilibriumResultInterest(ξ={_fmt(self.base.xi)}, "
            f"bankrun={_fmt(self.base.bankrun)}, status={_fmt(self.base.status)}, "
            f"V(0)={_fmt(self.v[..., 0])}, solve_time={_fmt(self.base.solve_time, 3)}s)"
        )


def effective_hazard_stage(tau_grid, hr, r, delta, u, config: SolverConfig, hazard_at=None,
                           uniform: bool = True, index_fn=None):
    """The interest stack's hazard transformer: V on the hazard grid, then
    h − r·V, plus, when ``hazard_at`` is given, the continuous effective
    hazard (V linearly interpolated as the hazard is). Returns
    ``(hr_eff, hazard_eff_at, v, v_health)``; ``v_health`` carries the HJB
    flags and NAN_OUTPUT for a non-finite V."""
    dtype = hr.dtype
    r = torch.as_tensor(r, dtype=dtype).to(hr.device)
    v, ode_health = solve_value_function(
        tau_grid, hr, delta, r, u, config, uniform=uniform, index_fn=index_fn, with_health=True,
    )
    hr_eff = hr - r.unsqueeze(-1) * v

    hazard_eff_at = None
    if hazard_at is not None:
        t0 = tau_grid[..., 0]
        dt = tau_grid[..., 1] - tau_grid[..., 0]
        if uniform:
            def v_at(tau):
                return interp_uniform(tau, t0, dt, v)
        elif index_fn is not None:
            def v_at(tau):
                return interp_guided(tau, tau_grid, v, index_fn(tau))
        else:
            def v_at(tau):
                return interp(tau, tau_grid, v)

        def hazard_eff_at(tau):
            return hazard_at(tau) - r * v_at(tau)

    v_flags = flag_bit((~torch.isfinite(v)).any(-1), NAN_OUTPUT) | ode_health.flags
    return hr_eff, hazard_eff_at, v, Health.of_flags(v_flags, dtype)


def solve_equilibrium_interest_core(ls: LearningSolution, u, p, kappa, lam, eta, r, delta,
                                    tspan_end, config: SolverConfig | None = None
                                    ) -> EquilibriumResultInterest:
    """The interest-rate solve of every cell at once: u and r have the
    cell shape C, the learning solution and p, κ, λ, η, δ the row shape."""
    if config is None:
        config = SolverConfig()
    dtype, dev = ls.dtype, ls.device
    u = torch.as_tensor(u, dtype=dtype).to(dev)
    r = torch.as_tensor(r, dtype=dtype).to(dev)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    warped = not hazard_grid_is_uniform(ls, config)
    tau_grid, hr, integ, int_eta = _hazard_parts(p, lam, ls, eta, config)
    index_fn = None
    if warped:
        eta_c = torch.as_tensor(eta, dtype=dtype).to(dev)

        def index_fn(t):
            return warped_grid_index(t, eta_c, ls.beta, ls.x0, config.n_grid, config.grid_warp)

    hazard_at = None
    if ls.closed_form and config.refine_crossings:
        hazard_at = _make_hazard_at(p, lam, ls, tau_grid, integ, int_eta, config)

    hr_eff, hazard_eff_at, v, v_health = effective_hazard_stage(
        tau_grid, hr, r, delta, u, config, hazard_at=hazard_at, uniform=not warped,
        index_fn=index_fn,
    )
    tau_in_unc, tau_out_unc, cross_health = optimal_buffer(
        u, tau_grid, hr_eff, tspan_end, hazard_at=hazard_eff_at, with_health=True,
        adaptive=config.adaptive,
    )
    no_crossing = tau_in_unc == tau_out_unc
    xi_c, err, root_ok, increasing, xi_health = compute_xi(
        tau_in_unc, tau_out_unc, ls, kappa, config, with_health=True
    )
    health = cross_health.merge(xi_health, v_health)
    run, status, converged, tolerance = classify_cell(no_crossing, root_ok, increasing, err, dtype)
    xi = torch.where(run, xi_c, nan)

    run_col = run.unsqueeze(-1)
    aw_cum, aw_out, aw_in = (
        torch.where(run_col, c, nan) for c in get_aw(xi, tau_in_unc, tau_out_unc, tau_grid, ls)
    )
    base = EquilibriumResult(
        xi=xi,
        tau_bar_in_unc=tau_in_unc,
        tau_bar_out_unc=tau_out_unc,
        tau_in=torch.clamp(xi - tau_in_unc, min=0.0),
        tau_out=torch.clamp(xi - tau_out_unc, min=0.0),
        bankrun=run,
        status=status,
        converged=converged,
        tolerance=tolerance,
        tau_grid=tau_grid,
        hr=hr,
        aw_cum=aw_cum,
        aw_out=aw_out,
        aw_in=aw_in,
        aw_max=torch.where(run, torch.amax(aw_cum, dim=-1), nan),
        health=health,
    )
    return EquilibriumResultInterest(base=base, v=v, hr_effective=hr_eff)


def solve_equilibrium_interest(ls: LearningSolution, econ: EconomicParamsInterest,
                               config: SolverConfig | None = None,
                               tspan_end=None) -> EquilibriumResultInterest:
    """One interest-rate equilibrium on the learning solution's device.
    ``tspan_end`` defaults to the learning grid's end; the embedded
    baseline result carries the wall-clock ``solve_time``, taken after the
    device has finished."""
    if config is None:
        config = SolverConfig()
    t0 = time.perf_counter()
    if tspan_end is None:
        tspan_end = ls.grid[..., -1]
    res = solve_equilibrium_interest_core(
        ls, econ.u, econ.p, econ.kappa, econ.lam, econ.eta, econ.r, econ.delta, tspan_end, config
    )
    if ls.device.type == "cuda":
        torch.cuda.synchronize(ls.device)
    return res.replace(base=res.base.replace(solve_time=time.perf_counter() - t0))
