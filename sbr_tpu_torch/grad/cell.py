"""Differentiable equilibrium cells: the port of ``sbr_tpu.grad.cell``.

One fully parameterised Stage 2-3 solve, stage for stage the port's
`sweeps.baseline_sweeps.solve_param_cell`, built so that autograd flows
θ → ξ end to end:

- **Stage 1 and the hazard** are closed-form and quadrature arithmetic:
  plain autograd (the warped grid, the cumulative Gauss-Legendre integral
  and the hazard ratio are smooth in θ).
- **Buffer crossings**: the coarse crossing is a boolean transition plus
  linear interpolation; its indices carry no gradient and the
  interpolation differentiates directly, the exact derivative of the grid
  estimator. With ``config.refine_crossings`` the crossing is the root of
  h(τ̄; θ) = u, wrapped in `ift.implicit_root` with the same
  `baseline.solver.hazard_at_from_parts` residual the forward refines.
- **ξ**: `ift.implicit_root` around the same `compute_xi` the forward
  solve runs, so the primal ξ is `solve_param_cell`'s bit for bit
  (tested), with the residual F(ξ, θ) = AW(ξ; θ) − κ in closed form.
- **Interest** (`interest_cell`): the HJB value function integrates with
  the fixed RK4 of `interest.value_function` (its passes run eagerly
  under autograd), so autograd differentiates the trajectory; under an
  adaptive config the gradient path recomputes V with the fixed scheme,
  as the reference's ``jax.checkpoint``-ed scan does.

Shapes: every θ entry is a tensor of a shape that broadcasts to the cell
shape C (a scalar solve has C = ()); Stage 1 and the hazard are rebuilt
per cell where β, p, λ, η, the tspan or x0 vary per cell. Classification
(status, grad flags) runs on detached values, so integers never carry
gradients.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.baseline.learning import logistic_cdf, logistic_pdf, solve_learning
from sbr_tpu_torch.baseline.solver import (
    _hazard_parts,
    _root_tol,
    classify_cell,
    compute_xi,
    hazard_at_from_parts,
    hazard_grid_is_uniform,
    quad_nodes_weights,
    warped_grid_index,
)
from sbr_tpu_torch.core.interp import searchsorted_right, take_last
from sbr_tpu_torch.core.rootfind import bisect, chandrupatla, first_upcrossing, last_downcrossing
from sbr_tpu_torch.diag.health import GRAD_AT_NONEQUILIBRIUM, GRAD_ILL_CONDITIONED, flag_bit
from sbr_tpu_torch.grad.ift import implicit_root
from sbr_tpu_torch.models.params import SolverConfig
from sbr_tpu_torch.models.results import Status
from sbr_tpu_torch.sweeps.baseline_sweeps import _RowLearning

# θ keys of the baseline cell, in `solve_param_cell`'s column order.
BASE_KEYS = ("beta", "u", "p", "kappa", "lam", "eta", "t0", "t1", "x0")
# θ keys of the interest cell (the baseline's, then the rate and maturity).
INTEREST_KEYS = BASE_KEYS + ("r", "delta")


def aprime_tol(dtype, override: Optional[float] = None) -> float:
    """|AW'(ξ)| at or below which dξ/dθ = −F_θ/AW'(ξ) is flagged
    `GRAD_ILL_CONDITIONED`: √eps of the dtype (≈1.5e-8 in float64) unless
    ``SBR_GRAD_APRIME_TOL`` is set; an explicit ``override`` wins."""
    if override is not None:
        return float(override)
    env = os.environ.get("SBR_GRAD_APRIME_TOL", "").strip()
    if env:
        return float(env)
    return float(torch.finfo(dtype).eps) ** 0.5


def _fixed_ode(config: SolverConfig) -> SolverConfig:
    """The gradient path's ODE numerics: fixed-step RK4. The root-finds
    keep the caller's numerics; only the ODE stage is pinned."""
    if not config.adaptive:
        return config
    return dataclasses.replace(config, numerics="fixed")


def _theta(theta: dict, keys, dtype, device) -> dict:
    """The θ entries as tensors of ``dtype`` on ``device`` (a tensor that
    already is one passes through, its gradient history intact)."""
    return {k: torch.as_tensor(theta[k], dtype=dtype, device=device) for k in keys}


def _device_of(theta: dict, device):
    """``device``, else ``theta["beta"]``'s when it is a tensor, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    beta = theta["beta"]
    return beta.device if isinstance(beta, torch.Tensor) else torch.device("cpu")


def _ls_of(beta, t0, t1, x0, config: SolverConfig, dtype):
    """Closed-form Stage 1 from θ tensors (`solve_param_cell`'s), silent
    to telemetry like the reference's traced cell."""
    with obs.program():
        return solve_learning(_RowLearning(beta, (t0, t1), x0), config, dtype=dtype,
                              device=beta.device)


def _crossing_ops(theta: dict, tau_grid, hr, integ, int_eta, config: SolverConfig, dtype):
    """Buffer times (τ̄_IN, τ̄_OUT), differentiable: the coarse scan
    crossings, then under ``config.refine_crossings`` the IFT-wrapped
    refinement against the continuous hazard, bracketed by ±one local grid
    interval as `baseline.solver.optimal_buffer` brackets it."""
    u = theta["u"]
    default = theta["t1"]
    t_in, has_up = first_upcrossing(tau_grid, hr, u, default, return_flag=True)
    t_out, has_dn = last_downcrossing(tau_grid, hr, u, default, return_flag=True)
    if not config.refine_crossings:
        return t_in, t_out

    nodes, weights = quad_nodes_weights(config.quad_order, dtype, tau_grid.device)
    # every gradient carrier rides the operand, the coarse crossings too,
    # so the solves bracket from exactly the forward path's estimates
    op = {
        "tau_grid": tau_grid, "integ": integ, "int_eta": int_eta, "p": theta["p"],
        "lam": theta["lam"], "beta": theta["beta"], "x0": theta["x0"], "u": u,
        "t_in_coarse": t_in, "t_out_coarse": t_out,
    }

    def hz(x, o):
        return hazard_at_from_parts(
            x, o["tau_grid"], o["integ"], o["int_eta"], o["p"], o["lam"], o["beta"],
            o["x0"], nodes, weights,
        )

    n = tau_grid.shape[-1]

    def bracket(o, t):
        g = o["tau_grid"]
        i = torch.clamp(searchsorted_right(g, t) - 1, 0, n - 1)
        return (take_last(g, torch.clamp(i - 1, min=0)),
                take_last(g, torch.clamp(i + 2, max=n - 1)))

    def refine(f, lo, hi):
        if config.adaptive:
            return chandrupatla(f, lo, hi, budget=60)
        return bisect(f, lo, hi, num_iters=60)

    def solve_in(o):
        lo, hi = bracket(o, o["t_in_coarse"])
        return refine(lambda x: hz(x, o) - o["u"], lo, hi)

    def solve_out(o):
        lo, hi = bracket(o, o["t_out_coarse"])
        return refine(lambda x: o["u"] - hz(x, o), lo, hi)

    t_in_ref = implicit_root(lambda x, o: hz(x, o) - o["u"], solve_in, op)
    t_out_ref = implicit_root(lambda x, o: o["u"] - hz(x, o), solve_out, op)
    return torch.where(has_up, t_in_ref, t_in), torch.where(has_dn, t_out_ref, t_out)


def _aw_residual(x, o):
    """F(ξ, θ) = AW(ξ) − κ in closed form: the ξ root's IFT residual,
    `compute_xi`'s formula with closed-form Stage 1."""
    t_out = torch.minimum(o["t_out"], x)
    t_in = torch.minimum(o["t_in"], x)
    return (
        logistic_cdf(t_out, o["beta"], o["x0"])
        - logistic_cdf(t_in, o["beta"], o["x0"])
        - o["kappa"]
    )


def _xi_and_class(theta: dict, t_in, t_out, config: SolverConfig, dtype, tol_ap: float) -> dict:
    """The IFT-wrapped ξ root and the forward solve's classification."""
    op = {k: theta[k] for k in ("beta", "x0", "kappa", "t0", "t1")}
    op.update(t_in=t_in, t_out=t_out)

    def solve(o):
        # the forward's own root-find on the same Stage 1: ξ is
        # solve_param_cell's bit for bit
        ls = _ls_of(o["beta"], o["t0"], o["t1"], o["x0"], config, dtype)
        return compute_xi(o["t_in"], o["t_out"], ls, o["kappa"], config)[0]

    xi_c = implicit_root(_aw_residual, solve, op)

    op_s = {k: v.detach() for k, v in op.items()}
    xi_s = xi_c.detach()
    err = _aw_residual(xi_s, op_s).abs()
    root_ok = err <= _root_tol(dtype)
    beta_s, x0_s = op_s["beta"], op_s["x0"]
    increasing = logistic_pdf(torch.minimum(op_s["t_out"], xi_s), beta_s, x0_s) >= (
        logistic_pdf(torch.minimum(op_s["t_in"], xi_s), beta_s, x0_s)
    )
    no_crossing = op_s["t_in"] == op_s["t_out"]
    run, status, _, _ = classify_cell(no_crossing, root_ok, increasing, err, dtype)

    # AW'(ξ), the IFT denominator, by autograd of the same residual at the
    # detached root: the conditioning check measures the division made
    with torch.enable_grad():
        x_ = xi_s.clone().requires_grad_(True)
        r = _aw_residual(x_, op_s)
        (aw_prime,) = torch.autograd.grad(r, x_, torch.ones_like(r))
    flags = (
        flag_bit(status != int(Status.RUN), GRAD_AT_NONEQUILIBRIUM)
        | flag_bit(aw_prime.abs() <= tol_ap, GRAD_ILL_CONDITIONED)
    )
    nan = torch.full((), float("nan"), dtype=dtype, device=xi_c.device)
    return {
        "xi": torch.where(run, xi_c, nan),
        "xi_candidate": xi_c,
        "tau_in": t_in,
        "tau_out": t_out,
        "status": status,
        "flags": flags,
        "aw_prime": aw_prime,
        "residual": err,
    }


def baseline_cell(theta: dict, config: SolverConfig, dtype=torch.float64,
                  aprime_tol_: Optional[float] = None, device=None) -> dict:
    """Differentiable baseline Stage 2-3 solve from a θ dict (BASE_KEYS).

    Returns a dict: ``xi`` (NaN-masked as the forward solve's, with a zero
    gradient on non-run cells), ``xi_candidate`` (the unmasked root, the
    quantity to differentiate near run boundaries), the buffers
    ``tau_in``/``tau_out``, ``status``, the grad-trust ``flags``,
    ``aw_prime`` (the IFT denominator) and ``residual``. ``device``
    defaults to ``theta["beta"]``'s when it is a tensor, else the CPU."""
    device = _device_of(theta, device)
    theta = _theta(theta, BASE_KEYS, dtype, device)
    tol_ap = aprime_tol(dtype, aprime_tol_)
    ls = _ls_of(theta["beta"], theta["t0"], theta["t1"], theta["x0"], config, dtype)
    tau_grid, hr, integ, int_eta = _hazard_parts(theta["p"], theta["lam"], ls, theta["eta"],
                                                 config)
    t_in, t_out = _crossing_ops(theta, tau_grid, hr, integ, int_eta, config, dtype)
    return _xi_and_class(theta, t_in, t_out, config, dtype, tol_ap)


def interest_cell(theta: dict, config: SolverConfig, dtype=torch.float64,
                  aprime_tol_: Optional[float] = None, device=None) -> dict:
    """Differentiable interest-rate Stage 2-3 solve (INTEREST_KEYS):
    baseline hazard → HJB value function (fixed RK4, module docstring) →
    effective hazard h − rV → grid buffer crossings (refinement is off on
    this stack: the effective hazard is known on the grid only, through V)
    → the same IFT ξ root as the baseline."""
    from sbr_tpu_torch.interest.value_function import solve_value_function

    device = _device_of(theta, device)
    theta = _theta(theta, INTEREST_KEYS, dtype, device)
    tol_ap = aprime_tol(dtype, aprime_tol_)
    ls = _ls_of(theta["beta"], theta["t0"], theta["t1"], theta["x0"], config, dtype)
    tau_grid, hr, _, _ = _hazard_parts(theta["p"], theta["lam"], ls, theta["eta"], config)
    warped = not hazard_grid_is_uniform(ls, config)
    index_fn = None
    if warped:
        def index_fn(t):
            return warped_grid_index(t, theta["eta"], ls.beta, ls.x0, config.n_grid,
                                     config.grid_warp)

    v = solve_value_function(tau_grid, hr, theta["delta"], theta["r"], theta["u"],
                             _fixed_ode(config), uniform=not warped, index_fn=index_fn)
    hr_eff = hr - theta["r"].unsqueeze(-1) * v
    t_in = first_upcrossing(tau_grid, hr_eff, theta["u"], theta["t1"])
    t_out = last_downcrossing(tau_grid, hr_eff, theta["u"], theta["t1"])
    return _xi_and_class(theta, t_in, t_out, config, dtype, tol_ap)


def aw_cum_at(t, xi, tau_in_unc, tau_out_unc, beta, x0):
    """Cumulative aggregate-withdrawal curve AW(t) in closed form,
    differentiable in every argument: `baseline.solver.get_aw`'s formula,
    AW(t) = [G(t−ξ+τ_OUT^CON)]₊ − [G(t−ξ+τ_IN^CON)]₊ + G(0). Each branch is
    zero before its start through a safe ``where`` (the clipped argument
    keeps its gradient finite there), and ``maximum`` splits a tie's
    gradient evenly, as ``jnp.maximum`` does."""
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    tau_in_con = torch.minimum(tau_in_unc, xi)
    tau_out_con = torch.minimum(tau_out_unc, xi)
    shift_in = t - xi + tau_in_con
    aw_in = torch.where(shift_in >= 0, logistic_cdf(torch.maximum(shift_in, zero), beta, x0),
                        zero)
    shift_out = t - xi + tau_out_con
    aw_out = torch.where(shift_out >= 0, logistic_cdf(torch.maximum(shift_out, zero), beta, x0),
                         zero)
    return aw_out - aw_in + logistic_cdf(zero, beta, x0)
