"""Mean-field fixed points of the information models: the port of
``sbr_tpu.infomodels.meanfield``.

Every information model closes the loop against a solver curve as the
gossip channel does: the agent simulation's (G, AW) trajectories converge,
in the dense-graph limit, to the curves of a mean-field fixed point. The
gossip channel's fixed point is `social.solver.solve_equilibrium_social`,
reused as it is; the other models get theirs from the same damped outer
iteration (`social.solver.run_fixed_point`, plain damping) with Stage 1
generalized (`info_learning_curve`):

- **gossip × K groups**: the forced law per group,
  G(t) = Σ_k w_k·[1 − (1−x0)·exp(−β·(a_k/⟨a⟩)·A(t))], A = ∫AW;
- **bayes**: the evidence integral Λ(t) = ∫ llr(w_obs(s)) ds is shared in
  the dense limit, and an agent crosses when awareness·Λ first exceeds its
  logistic threshold, so G(t) = x0 + (1−x0)·Σ_k w_k·σ((a_k·M(t) − θ_k)/s)
  with M the running max of Λ;
- **rewire**: the observed withdrawal fraction is tilted,
  w_obs = AW·(1+b)/(1 + b·AW) (`observed_fraction`). Only this curve is
  ported; the rewiring simulation is not.

The information fixed point iterates on the windowed aggregate: it drops
`get_aw`'s permanent +G(0) offset (``aw_new − G(0)``), as the reference
does.
"""

from __future__ import annotations

import time

import torch

from sbr_tpu_torch.baseline.learning import logistic_cdf
from sbr_tpu_torch.baseline.solver import get_aw, solve_equilibrium_core
from sbr_tpu_torch.core.integrate import cumtrapz
from sbr_tpu_torch.infomodels.spec import InfoModelSpec
from sbr_tpu_torch.models.params import ModelParams, SolverConfig
from sbr_tpu_torch.models.results import LearningSolution
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.social.solver import (
    SocialFixedPointResult,
    _finish,
    _model_scalars,
    fixed_point_grid,
    no_run_xi,
    run_fixed_point,
    solve_equilibrium_social,
)


def observed_fraction(aw, spec: InfoModelSpec):
    """The withdrawn fraction an agent observes among its in-neighbours,
    given the population fraction ``aw`` (a tensor or a numpy array): the
    identity on static graphs, the attention tilt AW·(1+b)/(1+b·AW) under
    panic rewiring."""
    if spec.dynamics != "rewire" or spec.rewire_bias == 0.0:
        return aw
    b = spec.rewire_bias
    return aw * (1.0 + b) / (1.0 + b * aw)


def info_learning_curve(spec: InfoModelSpec, beta, aw_samples, grid, x0) -> LearningSolution:
    """Stage 1 of the information fixed point: the population learning
    curve (CDF and PDF on ``grid``) that the forcing ``aw_samples`` induces
    under ``spec`` (module docstring for the laws). The homogeneous static
    gossip case is `social.dynamics.solve_forced_learning`."""
    dtype, device = aw_samples.dtype, aw_samples.device
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    dt = grid[1] - grid[0]
    weights, thresholds, awareness = spec.group_table()
    w_obs = observed_fraction(aw_samples, spec)
    cdf = torch.zeros_like(w_obs)
    pdf = torch.zeros_like(w_obs)
    if spec.channel == "gossip":
        big_a = cumtrapz(w_obs, dx=dt)
        # relative intake a_k/⟨a⟩: the scalar awareness cancels in the
        # gossip channel, so the homogeneous law is the forced ODE at β
        mean_a = sum(w * a for w, a in zip(weights, awareness))
        for wk, ak in zip(weights, awareness):
            g_k = 1.0 - (1.0 - x0) * torch.exp(-beta * (ak / mean_a) * big_a)
            cdf = cdf + wk * g_k
            pdf = pdf + wk * (1.0 - g_k) * beta * (ak / mean_a) * w_obs
        eff_beta = beta
    else:
        llr0, llr1 = spec.llr
        llr = w_obs * llr1 + (1.0 - w_obs) * llr0
        lam = cumtrapz(llr, dx=dt)
        m = torch.cummax(lam, dim=-1).values
        # dM/dt: the positive llr while the integral sits at its running max
        mdot = torch.where(lam >= m, torch.clamp(llr, min=0.0), 0.0)
        s = spec.threshold_scale
        for wk, tk, ak in zip(weights, thresholds, awareness):
            sig = torch.sigmoid((ak * m - tk) / s)
            cdf = cdf + wk * sig
            pdf = pdf + wk * sig * (1.0 - sig) * (ak / s) * mdot
        cdf = x0 + (1.0 - x0) * cdf
        pdf = (1.0 - x0) * pdf
        eff_beta = torch.tensor(spec.awareness, dtype=dtype, device=device)
    return LearningSolution(
        grid=grid, cdf=cdf, pdf=pdf, t0=grid[0], dt=dt, beta=eff_beta, x0=x0,
        closed_form=False,
    )


def solve_fixed_point_info(
    spec: InfoModelSpec,
    model: ModelParams,
    config: SolverConfig | None = None,
    tol: float = 1e-4,
    max_iter: int = 250,
    damping: float = 0.5,
    dtype=None,
    device=None,
) -> SocialFixedPointResult:
    """The mean-field fixed point of ``spec`` at ``model``'s economics, on
    ``device`` (the CUDA card unless the caller names one), in float64
    unless given ``dtype=torch.float32``: the solver curve every
    `close_loop(infomodel=spec)` run compares against.

    A gossip-reducible spec is `solve_equilibrium_social` itself, bit for
    bit. Every other spec runs the generalized Stage 1 under plain
    damping (the Anderson step stays the social solver's). Its bootstrap
    is channel-matched: gossip starts from the word-of-mouth logistic at
    β, bayes from the zero-evidence curve, which already carries the
    panic-prone cohort σ(−θ_k/s)."""
    if spec.reduces_to_gossip():
        return solve_equilibrium_social(
            model, config=config, tol=tol, max_iter=max_iter, damping=damping,
            dtype=dtype, device=device,
        )
    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    t0 = time.perf_counter()
    beta, x0, u, p, kappa, lam, eta = _model_scalars(model, dtype, device)
    grid = fixed_point_grid(model, config, dtype, device)

    def step(aw, xi):
        ls = info_learning_curve(spec, beta, aw, grid, x0)
        res = solve_equilibrium_core(ls, u, p, kappa, lam, eta, eta, config)
        xi_new = no_run_xi(res, xi, eta)
        aw_new = get_aw(xi_new, res.tau_bar_in_unc, res.tau_bar_out_unc, grid, ls)[0]
        # drop get_aw's permanent +G(0): for observer models the t = 0
        # cohort is the panic-prone tail, which the branches already carry
        return ls, res, xi_new, aw_new - ls.cdf[0]

    if spec.channel == "gossip":
        aw0 = logistic_cdf(grid, beta, x0)
    else:
        aw0 = info_learning_curve(spec, beta, torch.zeros_like(grid), grid, x0).cdf
    res = run_fixed_point(step, aw0, grid, eta, tol, max_iter, damping)
    return _finish(res, t0)
