"""Stages 2+3 for K heterogeneous groups: the port of
``sbr_tpu.hetero.solver``.

- The K hazard rates share one [0, η] grid (a quarter of it inherited
  from the warped learning grid when ``grid_warp > 0``) and come out of
  one broadcast cumulative trapezoid.
- The per-group buffers are the scan-pair crossings of each hazard row
  (the reference's ``vmap`` over rows).
- ξ is the root of the dist-weighted AW(ξ) = κ on [0, 2·max τ̄_OUT], by
  fixed bisection or Chandrupatla, from the weighted midpoint guess.
- The first-crossing validation rejects a root before which the withdrawal
  path dips back below κ (a masked reduction over boolean transitions).

The scenario hooks ``hazard_transform`` and ``kappa_transform`` are the
reference's, and so are its telemetry spans (``hetero.hazards``,
``hetero.buffers``, ``hetero.xi``) and ``health`` census. Under ``axis_name``, a sharded group axis ``(mesh,
axis)``, each rank holds its block of the groups; the dist-weighted AW
sums are psums (in rank order), the bracket's upper end a pmax, and the
no-crossing count and the crossing flags reduce across ranks, so every rank
runs the identical ξ root-find and ξ, the status and the health come out
replicated (`hetero.sharded`).
"""

from __future__ import annotations

import time

import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.baseline.solver import _root_tol, classify_cell
from sbr_tpu_torch.core.integrate import cumtrapz
from sbr_tpu_torch.core.interp import interp, linspace
from sbr_tpu_torch.core.rootfind import bisect, chandrupatla, first_upcrossing, last_downcrossing
from sbr_tpu_torch.diag.health import as_out_crossing, or_reduce_flags
from sbr_tpu_torch.hetero.learning import wreduce
from sbr_tpu_torch.models.params import EconomicParams, SolverConfig
from sbr_tpu_torch.models.results import AWHetero, EquilibriumResultHetero, LearningSolutionHetero


def hazard_rates_hetero(p, lam, lsh: LearningSolutionHetero, eta, config: SolverConfig):
    """All K hazard rates on one [0, η] grid,
    h_k(τ̄) = p·e^{λτ̄}·g_k(τ̄) / (p·∫₀^τ̄ e^{λs}g_k + (1−p)·∫₀^η e^{λs}g_k).
    Returns (tau_grid (n,), hrs (K, n))."""
    dtype, dev = lsh.dtype, lsh.device

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    eta, p, lam = tensor(eta), tensor(p), tensor(lam)
    if config.grid_warp > 0.0:
        # three quarters uniform on [0, η], one quarter strided from the
        # warped learning grid clipped at η (its transition knots)
        n = config.n_grid
        n_u = n - n // 4
        # jnp.linspace in the default float64, truncated to int32
        idx = linspace(0.0, float(lsh.grid.shape[0] - 1), n - n_u, torch.float64, dev).to(torch.int64)
        inherit = torch.minimum(torch.clamp(lsh.grid[idx], min=0.0), eta)
        uniform = linspace(0.0, eta, n_u, dtype, dev)
        tau_grid = torch.sort(torch.cat([uniform, inherit])).values
        tau_grid[0] = 0.0
        tau_grid[-1] = eta
    else:
        tau_grid = linspace(0.0, eta, config.n_grid, dtype, dev)

    g = lsh.pdf_at(tau_grid)  # (K, n)
    growth = torch.exp(lam * tau_grid)[None, :]
    integ = cumtrapz(growth * g, x=tau_grid)  # (K, n)
    int_eta = integ[:, -1:]
    hrs = (p * growth * g) / (p * integ + (1.0 - p) * int_eta)
    return tau_grid, hrs


def _cdf_rows_at(lsh: LearningSolutionHetero, t):
    """G_k(t_k) for per-group times ``t`` of shape (K,) + E: ``jnp.interp``
    of each group's row at its own times."""
    return interp(t.movedim(0, -1), lsh.grid, lsh.cdfs).movedim(-1, 0)


def compute_xi_hetero(tau_bar_in_uncs, tau_bar_out_uncs, lsh: LearningSolutionHetero, kappa,
                      config: SolverConfig | None = None, axis_name=None,
                      with_health: bool = False):
    """Root of the dist-weighted AW(ξ) = κ. Returns (xi, err, root_ok,
    is_increasing, first_crossing_ok), with the root-find's `Health`
    appended under ``with_health``. The slope test steps by the LOCAL
    learning-grid spacing at ξ (floored at 1e-9 of the span)."""
    if config is None:
        config = SolverConfig()
    dtype, dev = lsh.dtype, lsh.device
    kappa = torch.as_tensor(kappa, dtype=dtype).to(dev)
    dist = lsh.dist

    def aw_of(xi):
        t_out = torch.minimum(tau_bar_out_uncs, xi)
        t_in = torch.minimum(tau_bar_in_uncs, xi)
        return wreduce(torch.dot(dist, _cdf_rows_at(lsh, t_out) - _cdf_rows_at(lsh, t_in)),
                       axis_name)

    lo = torch.zeros((), dtype=dtype, device=dev)
    hi = 2.0 * torch.max(tau_bar_out_uncs)
    if axis_name is not None:
        from sbr_tpu_torch.parallel.collectives import pmax

        hi = pmax(hi, *axis_name)
    x0 = wreduce(torch.dot(dist, 0.5 * (tau_bar_in_uncs + tau_bar_out_uncs)), axis_name)

    if config.adaptive:
        out = chandrupatla(lambda x: aw_of(x) - kappa, lo, hi, budget=config.bisect_iters,
                           x0=x0, with_health=with_health)
    else:
        out = bisect(lambda x: aw_of(x) - kappa, lo, hi, num_iters=config.bisect_iters,
                     x0=x0, with_health=with_health)
    xi, xi_health = out if with_health else (out, None)

    aw = aw_of(xi)
    err = (aw - kappa).abs()
    root_ok = err <= _root_tol(dtype)

    grid = lsh.grid
    n_l = grid.shape[0]
    i_xi = torch.clamp(torch.searchsorted(grid, xi.reshape(1), right=True)[0] - 1, 0, n_l - 2)
    eps = torch.maximum(grid[i_xi + 1] - grid[i_xi], 1e-9 * (grid[-1] - grid[0]))
    t_out = torch.minimum(tau_bar_out_uncs, xi)
    t_in = torch.minimum(tau_bar_in_uncs, xi)
    aw_eps = wreduce(
        torch.dot(dist, _cdf_rows_at(lsh, t_out + eps) - _cdf_rows_at(lsh, t_in + eps)),
        axis_name)
    is_increasing = aw_eps >= aw

    first_ok = _first_crossing_ok(xi, tau_bar_in_uncs, lsh, kappa, axis_name=axis_name)
    if with_health:
        return xi, err, root_ok, is_increasing, first_ok, xi_health
    return xi, err, root_ok, is_increasing, first_ok


def _first_crossing_ok(xi_star, tau_bar_in_uncs, lsh: LearningSolutionHetero, kappa, axis_name=None):
    """False when AW(t; ξ*) = Σ_k dist_k·(G_k(t) − G_k(max(0, t − τ_I_k)))
    crosses κ downward anywhere on the learning grid before ξ* (then an
    earlier crossing exists and the root is a false equilibrium)."""
    t = lsh.grid
    tau_i = torch.clamp(xi_star - tau_bar_in_uncs, min=0.0)
    shifted = torch.clamp(t[None, :] - tau_i[:, None], min=0.0)  # (K, n)
    aw_path = wreduce(lsh.dist @ (lsh.cdfs - _cdf_rows_at(lsh, shifted)), axis_name)
    in_range = t <= xi_star
    above = (aw_path > kappa) & in_range
    down = above[:-1] & ~above[1:] & in_range[1:]
    return ~down.any()


def solve_equilibrium_hetero(lsh: LearningSolutionHetero, econ: EconomicParams,
                             config: SolverConfig | None = None, tspan_end=None,
                             axis_name=None, hazard_transform=None,
                             kappa_transform=None) -> EquilibriumResultHetero:
    """The full K-group equilibrium, branchless with status codes, on the
    learning solution's device. ``tspan_end`` defaults to the learning
    grid's end; the result carries the wall-clock ``solve_time``, taken
    after the device has finished.

    The scenario hooks, as in the reference: ``hazard_transform(tau_grid,
    hrs, None)`` returns ``(hrs, _, extra_health)`` and rewrites the (K, n)
    hazard rows before the buffer crossings (the middle slot is unused:
    the hetero family has no continuous-hazard refinement);
    ``kappa_transform(kappa)`` gives the threshold of the ξ root-find.
    ``extra_health`` merges after the crossing and ξ health. With both
    ``None`` the solve is the hook-free one, bit for bit."""
    if config is None:
        config = SolverConfig()
    t_start = time.perf_counter()
    dtype, dev = lsh.dtype, lsh.device
    if tspan_end is None:
        tspan_end = lsh.grid[-1]
    u = torch.as_tensor(econ.u, dtype=dtype).to(dev)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    with obs.span("hetero.hazards", groups=int(lsh.cdfs.shape[0])) as sp:
        tau_grid, hrs = hazard_rates_hetero(econ.p, econ.lam, lsh, econ.eta, config)
        sp.sync(hrs)
    extra_health = ()
    if hazard_transform is not None:
        hrs, _, extra_health = hazard_transform(tau_grid, hrs, None)
    kappa_eff = econ.kappa if kappa_transform is None else kappa_transform(econ.kappa)
    with obs.span("hetero.buffers") as sp:
        default = torch.as_tensor(tspan_end, dtype=dtype).to(dev)
        tau_in_uncs, h_in = first_upcrossing(tau_grid, hrs, u, default, with_health=True)
        tau_out_uncs, h_out = last_downcrossing(tau_grid, hrs, u, default, with_health=True)
        sp.sync(tau_in_uncs, tau_out_uncs)
    # no group can optimally exit
    no_crossing = wreduce((tau_in_uncs != tau_out_uncs).sum(), axis_name) == 0

    with obs.span("hetero.xi") as sp:
        xi_c, err, root_ok, increasing, first_ok, xi_health = compute_xi_hetero(
            tau_in_uncs, tau_out_uncs, lsh, kappa_eff, config, axis_name=axis_name,
            with_health=True,
        )
        sp.sync(xi_c)
    cross_flags = or_reduce_flags(h_in.flags | as_out_crossing(h_out).flags)
    if axis_name is not None:
        # OR across ranks: each rank's mask, gathered
        from sbr_tpu_torch.parallel.collectives import all_gather

        cross_flags = or_reduce_flags(all_gather(cross_flags.reshape(1), *axis_name))
    if lsh.ode_flags is not None:
        cross_flags = cross_flags | lsh.ode_flags
    health = xi_health.replace(flags=xi_health.flags | cross_flags)
    if extra_health:
        health = health.merge(*extra_health)

    run, status, converged, tolerance = classify_cell(
        no_crossing, root_ok, increasing, err, dtype, first_ok=first_ok
    )
    res = EquilibriumResultHetero(
        xi=torch.where(run, xi_c, nan),
        tau_bar_in_uncs=tau_in_uncs,
        tau_bar_out_uncs=tau_out_uncs,
        hrs=hrs,
        tau_grid=tau_grid,
        bankrun=run,
        status=status,
        converged=converged,
        tolerance=tolerance,
        health=health,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = res.replace(solve_time=time.perf_counter() - t_start)
    obs.log_health("hetero.equilibrium", res.health, res.status)
    return res


def get_aw_hetero(result: EquilibriumResultHetero, lsh: LearningSolutionHetero,
                  axis_name=None) -> AWHetero:
    """Group-decomposed AW curves on the learning grid:
    AW_k(t) = G_k(max(0, t−ξ+τ̄_OUT_k^CON)) − G_k(max(0, t−ξ+τ̄_IN_k^CON)),
    each branch zeroed before its own start; the total is the dist-weighted
    sum (a psum under ``axis_name``). A NaN ξ (no run) gives NaN curves."""
    t = lsh.grid
    xi = result.xi
    nan_lane = torch.isnan(xi)
    zero = torch.zeros((), dtype=lsh.dtype, device=lsh.device)
    nan = torch.full((), float("nan"), dtype=lsh.dtype, device=lsh.device)

    def branch(tau_con):
        shift = t[None, :] - xi + tau_con[:, None]  # (K, n)
        vals = _cdf_rows_at(lsh, torch.clamp(shift, min=0.0))
        # shift >= 0 is False for NaN; re-inject NaN so a no-run lane
        # reads as the sentinel, not as "zero withdrawals"
        return torch.where(nan_lane, nan, torch.where(shift >= 0, vals, zero))

    aw_in_groups = branch(torch.minimum(result.tau_bar_in_uncs, xi))
    aw_out_groups = branch(torch.minimum(result.tau_bar_out_uncs, xi))
    aw_groups = aw_out_groups - aw_in_groups
    aw_cum = wreduce(lsh.dist @ aw_groups, axis_name)
    return AWHetero(
        t_grid=t, aw_cum=aw_cum, aw_out_groups=aw_out_groups, aw_in_groups=aw_in_groups,
        aw_groups=aw_groups, aw_max=torch.max(aw_cum),
    )
