"""Gradient-based worst-case stress search: the port of
``sbr_tpu.grad.stress``.

"What is the smallest shock that tips this bank into a run?" by
first-order search on a differentiable run margin,

    margin(θ) = max( u − max_τ̄ h(τ̄; θ),           # a crossing must exist
                     κ − [G(τ̄_OUT) − G(τ̄_IN)] )    # AW must be able to reach κ

which is negative on (to grid resolution) the run region. `stress_search`
runs projected sign-gradient descent on the margin inside a box (only the
``wrt`` parameters move, clipped each step), bisects the segment from θ₀
to the first flipped iterate for the margin's zero, steps just past it,
and validates the point against the port's `solve_param_cell`, never the
surrogate alone. For ``wrt=("kappa",)`` that is the minimal κ shock.
Not ported: the reference's obs span and ``grad`` events (ROADMAP item 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from sbr_tpu_torch.baseline.learning import logistic_cdf
from sbr_tpu_torch.baseline.solver import _hazard_parts
from sbr_tpu_torch.core.rootfind import first_upcrossing, last_downcrossing
from sbr_tpu_torch.grad.api import _resolve
from sbr_tpu_torch.grad.cell import BASE_KEYS, _device_of, _ls_of, _theta
from sbr_tpu_torch.models.params import ModelParams, SolverConfig, params_to_pytree
from sbr_tpu_torch.sweeps.baseline_sweeps import solve_param_cell

# Default search boxes (natural parameter space).
DEFAULT_BOUNDS: Dict[str, Tuple[float, float]] = {
    "beta": (1e-3, 1e4),
    "u": (1e-6, 10.0),
    "kappa": (1e-4, 1.0 - 1e-4),
    "p": (1e-4, 1.0 - 1e-4),
    "lam": (1e-6, 10.0),
}


@dataclasses.dataclass(frozen=True)
class StressResult:
    """Outcome of one worst-case search (host-side)."""

    flipped: bool  # a run-triggering perturbation was found
    validated: bool  # the real solver confirms RUN at the flipped point
    params0: dict  # starting θ (natural space, floats)
    params_flipped: Optional[dict]  # boundary-refined flipped θ (or None)
    delta: Optional[dict]  # params_flipped − params0 per wrt dim
    shock_norm: Optional[float]  # L2 norm of delta (the shock size)
    margin0: float  # starting margin (> 0: no run)
    margin_final: float  # margin at the returned point
    steps: int  # gradient steps taken until the first flip (or budget)


def run_margin(theta: dict, config: SolverConfig, dtype=torch.float64, device=None):
    """The differentiable run margin (module docstring); negative where
    the cell supports a bank-run equilibrium, up to grid resolution. The
    hazard's peak is ``amax``, which splits a tie's gradient evenly as
    ``jnp.max`` does."""
    theta = _theta(theta, BASE_KEYS, dtype, _device_of(theta, device))
    ls = _ls_of(theta["beta"], theta["t0"], theta["t1"], theta["x0"], config, dtype)
    tau_grid, hr, _, _ = _hazard_parts(theta["p"], theta["lam"], ls, theta["eta"], config)
    m_cross = theta["u"] - torch.amax(hr, dim=-1)
    t_in = first_upcrossing(tau_grid, hr, theta["u"], theta["t1"])
    t_out = last_downcrossing(tau_grid, hr, theta["u"], theta["t1"])
    reach = (logistic_cdf(t_out, theta["beta"], theta["x0"])
             - logistic_cdf(t_in, theta["beta"], theta["x0"]))
    return torch.maximum(m_cross, theta["kappa"] - reach)


def stress_search(params: ModelParams, wrt=("kappa",),
                  bounds: Optional[Dict[str, Tuple[float, float]]] = None, steps: int = 200,
                  lr: float = 0.02, margin_eps: float = 1e-6,
                  config: Optional[SolverConfig] = None, dtype=None,
                  device=None) -> StressResult:
    """The smallest shock along the steepest-descent path that flips
    ``params`` from no run into a bank run (module docstring). ``lr`` is
    relative: each parameter moves lr·scale a step, scale = max(|θ₀|, 5%
    of its box); ``margin_eps`` is how far past the boundary the returned
    point sits (a point on it is ambiguous for the forward solver)."""
    config, dtype, device = _resolve(config, dtype, device)
    wrt = tuple(wrt)
    unknown = set(wrt) - set(DEFAULT_BOUNDS)
    if not wrt or unknown:
        raise ValueError(
            f"wrt must be a non-empty subset of {tuple(DEFAULT_BOUNDS)}, got {wrt!r}"
        )
    box = {**DEFAULT_BOUNDS, **(bounds or {})}
    theta0 = {k: torch.full((), float(v), dtype=dtype, device=device)
              for k, v in params_to_pytree(params).items() if k != "eta_bar"}
    rest = {k: v for k, v in theta0.items() if k not in wrt}

    def margin_of(wv) -> float:
        with torch.no_grad():
            return float(run_margin({**rest, **wv}, config, dtype))

    def grad_of(wv) -> dict:
        with torch.enable_grad():
            leaves = {k: x.detach().requires_grad_(True) for k, x in wv.items()}
            g = torch.autograd.grad(run_margin({**rest, **leaves}, config, dtype),
                                    list(leaves.values()), allow_unused=True)
        return {k: (gk if gk is not None else torch.zeros_like(leaves[k]))
                for k, gk in zip(leaves, g)}

    def clip(wv):
        return {k: torch.clamp(x, box[k][0], box[k][1]) for k, x in wv.items()}

    scale = {k: max(abs(float(theta0[k])), (box[k][1] - box[k][0]) * 0.05) for k in wrt}
    wv = {k: theta0[k] for k in wrt}
    m0 = margin_of(wv)
    flipped = m0 < 0  # already a run: zero shock
    n_steps = 0
    if not flipped:
        for i in range(steps):
            g = grad_of(wv)
            wv_prev = dict(wv)
            wv = clip({k: wv[k] - lr * scale[k] * torch.sign(g[k]) for k in wrt})
            n_steps = i + 1
            if margin_of(wv) < 0:
                flipped = True
                break
            if all(float(wv[k]) == float(wv_prev[k]) for k in wrt):
                break  # pinned at the box: no flip reachable

    result_kwargs = dict(params0={k: float(theta0[k]) for k in BASE_KEYS}, margin0=m0,
                         steps=n_steps)
    if not flipped:
        return StressResult(flipped=False, validated=False, params_flipped=None, delta=None,
                            shock_norm=None, margin_final=margin_of(wv), **result_kwargs)

    # bisect the segment θ₀ → the flipped iterate for the margin's zero,
    # then step margin_eps past it: the minimal shock along the path
    wv_flip = dict(wv)

    def at(t):
        return {k: theta0[k] + t * (wv_flip[k] - theta0[k]) for k in wrt}

    if m0 >= 0:
        lo_t, hi_t = 0.0, 1.0
        for _ in range(60):
            mid = 0.5 * (lo_t + hi_t)
            if margin_of(at(mid)) < 0:
                hi_t = mid
            else:
                lo_t = mid
        # walk past the boundary with a step that doubles from the
        # bisection's residual, so any t ≤ 1 is reached in ~60 steps
        t_star = hi_t
        step_t = max(hi_t - lo_t, 1e-9)
        for _ in range(60):
            if margin_of(at(t_star)) <= -margin_eps:
                break
            t_star = min(1.0, t_star + step_t)
            step_t *= 2.0
            if t_star >= 1.0:
                break
        wv_star = at(t_star)
    else:
        wv_star = {k: theta0[k] for k in wrt}

    theta_star = {**theta0, **wv_star}
    # validate against the real forward solve, not the surrogate
    _, _, _, status, _ = solve_param_cell(*(theta_star[k] for k in BASE_KEYS), config, dtype,
                                          device)
    delta = {k: float(wv_star[k]) - float(theta0[k]) for k in wrt}
    return StressResult(
        flipped=True, validated=int(status) == 0,
        params_flipped={k: float(x) for k, x in theta_star.items()},
        delta=delta, shock_norm=math.sqrt(sum(d * d for d in delta.values())),
        margin_final=margin_of(wv_star), **result_kwargs,
    )
