"""Stages 2+3, the hazard rate, the optimal buffers, the equilibrium crash
time and the aggregate-withdrawal curves: the port of
``sbr_tpu.baseline.solver``.

The reference writes one cell and lets ``vmap`` batch it. Here every
function takes whole batches (see `core.interp` for the shapes): the
hazard tables depend only on β, p, λ and η, so a sweep builds them once
per row (shape R + (n,)), and the crossings, the ξ root-find and the
classification run over every cell at once (shape C). A scalar solve is
the case R = C = ().

Arithmetic follows the reference operation by operation. Where XLA fuses
multiply-adds under ``jit`` or sums in its own order, the results agree to
the last bits, not bit for bit (the tests state the tolerance).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.baseline.learning import logistic_cdf, logistic_pdf
from sbr_tpu_torch.core.integrate import cumtrapz, cumulative_gauss_legendre
from sbr_tpu_torch.core.interp import linspace, searchsorted_right, take_last
from sbr_tpu_torch.core.rootfind import (
    bisect,
    chandrupatla,
    first_upcrossing,
    last_downcrossing,
    threshold_crossings_masked,
)
from sbr_tpu_torch.diag.health import as_out_crossing
from sbr_tpu_torch.models.params import EconomicParams, SolverConfig
from sbr_tpu_torch.models.results import EquilibriumResult, LearningSolution, Status


def _col(v: torch.Tensor) -> torch.Tensor:
    """A row-shaped tensor (R) aligned against a grid axis: R + (1,)."""
    return v.unsqueeze(-1)


def _root_tol(dtype) -> float:
    """Root-acceptance tolerance on |AW(ξ*) − κ|: 1e-7 in float64, 1e-4 in
    float32 (the reference's ladder, which separates converged cells from
    cells without a root)."""
    return 1e-7 if dtype == torch.float64 else 1e-4


def _warped_grid(eta, beta, x0, n: int, warp: float, dtype):
    """Transition-resolving hazard grid for the closed-form logistic: the
    sorted union of ⌈(1−warp)·n⌉ uniform points on [0, η] and ⌊warp·n⌋
    points of the logistic inverse-CDF map
    t(q) = [logit(x0 + q·(G(η)−x0)) − logit(x0)] / β, which cluster through
    the 1/β-wide transition at any β. Levels that round to 1 (float32 at
    β·η ≳ 29) would give log1p(−1) = −inf; they become +inf, which the
    clip pins to η, as in the reference. Shape R + (n,)."""
    device = eta.device
    n_q = max(1, int(warp * n))
    n_u = n - n_q
    rows = torch.broadcast_shapes(eta.shape, beta.shape, x0.shape)
    t_uniform = linspace(0.0, eta, n_u, dtype, device)
    q = linspace(0.0, 1.0, n_q, dtype, device)
    g_eta = logistic_cdf(eta, beta, x0)
    levels = _col(x0) + q * _col(g_eta - x0)

    def logit(v):
        return torch.log(v) - torch.log1p(-v)

    sat = levels >= 1.0
    safe_levels = torch.where(sat, 0.5, levels)
    num = logit(safe_levels) - _col(logit(x0))
    t_quant = torch.where(sat, float("inf"), num / _col(beta))
    grid = torch.cat([t_uniform.expand(*rows, n_u), t_quant.expand(*rows, n_q)], dim=-1)
    grid = torch.sort(grid, dim=-1).values
    grid = torch.minimum(torch.clamp(grid, min=0.0), _col(eta).expand(*rows, 1))
    grid[..., 0].fill_(0.0)
    grid[..., -1] = eta.expand(rows)
    return grid


def warped_grid_index(t, eta, beta, x0, n: int, warp: float):
    """Bracketing-index guess into `_warped_grid`'s knots in closed form:
    the count of uniform knots ≤ t is a floor division and the count of
    quantile knots ≤ t inverts the logistic map that placed them. Exact up
    to rounding at knot boundaries; pair with `core.interp.interp_guided`,
    which absorbs ±1."""
    n_q = max(1, int(warp * n))
    n_u = n - n_q
    if n_u >= 2:
        per = torch.full_like(eta, n_u - 1) / eta
        cnt_u = torch.clamp(torch.floor(t * per).to(torch.int64) + 1, 0, n_u)
    else:
        cnt_u = torch.full(t.shape, n_u, dtype=torch.int64, device=t.device)
    g_eta = logistic_cdf(eta, beta, x0)
    ratio = (logistic_cdf(t, beta, x0) - x0) / (g_eta - x0)
    cnt_q = torch.clamp(torch.floor(ratio * (n_q - 1)).to(torch.int64) + 1, 0, n_q)
    return cnt_u + cnt_q - 1


def hazard_grid_is_uniform(ls: LearningSolution, config: SolverConfig) -> bool:
    """Whether `_hazard_parts` builds a uniform grid."""
    return not (ls.closed_form and config.grid_warp > 0.0)


def _hazard_parts(p, lam, ls: LearningSolution, eta, config: SolverConfig):
    """Hazard grid, hazard values and the cumulative normalisation integral
    of one row per β: (tau_grid, hr, integ) of shape R + (n,), int_eta of
    shape R."""
    dtype, device = ls.dtype, ls.device
    eta = torch.as_tensor(eta, dtype=dtype, device=device)
    p = torch.as_tensor(p, dtype=dtype, device=device)
    lam = torch.as_tensor(lam, dtype=dtype, device=device)

    if ls.closed_form:
        beta, x0 = _col(ls.beta), _col(ls.x0)
        if not hazard_grid_is_uniform(ls, config):
            tau_grid = _warped_grid(eta, ls.beta, ls.x0, config.n_grid, config.grid_warp, dtype)
        else:
            tau_grid = linspace(0.0, eta, config.n_grid, dtype, device)

        def integrand(ts):
            return torch.exp(_col(lam) * ts) * logistic_pdf(ts, beta, x0)

        integ = cumulative_gauss_legendre(integrand, tau_grid, order=config.quad_order)
        g_tau = logistic_pdf(tau_grid, beta, x0)
    else:
        tau_grid = linspace(0.0, eta, config.n_grid, dtype, device)
        g_tau = ls.pdf_at(tau_grid)
        integ = cumtrapz(torch.exp(_col(lam) * tau_grid) * g_tau, x=tau_grid)

    int_eta = integ[..., -1]
    hr = (_col(p) * torch.exp(_col(lam) * tau_grid) * g_tau) / (
        _col(p) * integ + _col((1.0 - p) * int_eta)
    )
    return tau_grid, hr, integ, int_eta


def hazard_rate(p, lam, ls: LearningSolution, eta, config: SolverConfig | None = None):
    """Hazard rate h(τ̄) on the static [0, η] grid,
    h(τ̄) = p·e^{λτ̄}·g(τ̄) / (p·∫₀^τ̄ e^{λs}g(s)ds + (1−p)·∫₀^η e^{λs}g(s)ds).
    Returns (tau_grid, hr)."""
    if config is None:
        config = SolverConfig()
    tau_grid, hr, _, _ = _hazard_parts(p, lam, ls, eta, config)
    return tau_grid, hr


def hazard_at_from_parts(tau, tau_grid, integ, int_eta, p, lam, beta, x0, nodes, weights):
    """Continuous exact hazard h(τ̄) at the cells' ``tau`` from the row
    tables: one knot lookup plus a single Gauss-Legendre panel over the
    sub-interval, summed in node order."""
    n = tau_grid.shape[-1]
    i = torch.clamp(searchsorted_right(tau_grid, tau) - 1, 0, n - 2)
    a = take_last(tau_grid, i)
    half = 0.5 * (tau - a)
    mid = 0.5 * (tau + a)
    acc = None
    for k in range(nodes.shape[0]):
        xs = mid + half * nodes[k]
        term = weights[k] * (torch.exp(lam * xs) * logistic_pdf(xs, beta, x0))
        acc = term if acc is None else acc + term
    i_loc = take_last(integ, i) + half * acc
    num = p * torch.exp(lam * tau) * logistic_pdf(tau, beta, x0)
    return num / (p * i_loc + (1.0 - p) * int_eta)


def quad_nodes_weights(order: int, dtype, device="cpu"):
    """Gauss-Legendre nodes and weights as tensors of ``dtype``."""
    nodes, weights = np.polynomial.legendre.leggauss(order)

    def filled(values):
        # filled on the device: a host copy cannot be captured in a CUDA graph
        return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])

    return filled(nodes), filled(weights)


def _make_hazard_at(p, lam, ls: LearningSolution, tau_grid, integ, int_eta, config: SolverConfig):
    """Continuous exact hazard evaluator for closed-form Stage 1 (a closure
    over `hazard_at_from_parts`)."""
    dtype, device = tau_grid.dtype, tau_grid.device
    nodes, weights = quad_nodes_weights(config.quad_order, dtype, device)
    p = torch.as_tensor(p, dtype=dtype, device=device)
    lam = torch.as_tensor(lam, dtype=dtype, device=device)

    def hazard_at(tau):
        return hazard_at_from_parts(
            tau, tau_grid, integ, int_eta, p, lam, ls.beta, ls.x0, nodes, weights
        )

    return hazard_at


def optimal_buffer(
    u,
    tau_grid,
    hr,
    tspan_end,
    hazard_at=None,
    refine_iters: int = 60,
    with_health: bool = False,
    adaptive: bool = False,
):
    """Unconstrained buffer times (τ̄_IN, τ̄_OUT) where h crosses u, with
    the reference's boundary fallbacks.

    ``adaptive`` uses the blocked crossing search
    (`core.rootfind.threshold_crossings_masked`, bit-identical to the scan
    pair) and Chandrupatla refinement; otherwise the scan pair and
    fixed-iteration bisection. With ``hazard_at``, genuine crossings are
    refined within ±one local grid interval; fallback lanes keep their grid
    values. With ``with_health`` the merged crossing `Health` is appended.
    """
    default = torch.as_tensor(tspan_end, dtype=hr.dtype, device=hr.device)
    if adaptive:
        out = threshold_crossings_masked(tau_grid, hr, u, default, with_health=with_health)
        t_in, has_up, t_out, has_dn = out[:4]
        cross_health = out[4].merge(as_out_crossing(out[5])) if with_health else None
    elif with_health:
        t_in, has_up, h_in = first_upcrossing(
            tau_grid, hr, u, default, return_flag=True, with_health=True
        )
        t_out, has_dn, h_out = last_downcrossing(
            tau_grid, hr, u, default, return_flag=True, with_health=True
        )
        cross_health = h_in.merge(as_out_crossing(h_out))
    else:
        t_in, has_up = first_upcrossing(tau_grid, hr, u, default, return_flag=True)
        t_out, has_dn = last_downcrossing(tau_grid, hr, u, default, return_flag=True)
        cross_health = None
    if hazard_at is None:
        return (t_in, t_out, cross_health) if with_health else (t_in, t_out)

    n = tau_grid.shape[-1]

    def bracket(t):
        # ±one LOCAL grid interval around the coarse crossing
        i = torch.clamp(searchsorted_right(tau_grid, t) - 1, 0, n - 1)
        lo = take_last(tau_grid, torch.clamp(i - 1, min=0))
        hi = take_last(tau_grid, torch.clamp(i + 2, max=n - 1))
        return lo, hi

    def refine(f, lo, hi):
        if adaptive:
            return chandrupatla(f, lo, hi, budget=refine_iters)
        return bisect(f, lo, hi, num_iters=refine_iters)

    lo_i, hi_i = bracket(t_in)
    t_in_ref = refine(lambda t: hazard_at(t) - u, lo_i, hi_i)
    lo_o, hi_o = bracket(t_out)
    # down-crossing: u − h is locally increasing
    t_out_ref = refine(lambda t: u - hazard_at(t), lo_o, hi_o)
    t_in = torch.where(has_up, t_in_ref, t_in)
    t_out = torch.where(has_dn, t_out_ref, t_out)
    return (t_in, t_out, cross_health) if with_health else (t_in, t_out)


def compute_xi(
    tau_bar_in_unc,
    tau_bar_out_unc,
    ls: LearningSolution,
    kappa,
    config: SolverConfig | None = None,
    lo=None,
    hi=None,
    x0=None,
    with_health: bool = False,
):
    """Root of AW(ξ) = κ with AW(ξ) = G(min(ξ, τ̄_OUT)) − G(min(ξ, τ̄_IN)),
    and the first-crossing validation.

    Returns (xi_candidate, abs_error, root_ok, is_increasing): ``root_ok``
    is |AW(ξ*)−κ| under the dtype's tolerance; ``is_increasing`` is the
    slope test, g(t_out) ≥ g(t_in) in closed form (the ε→0 limit of the
    reference's finite difference), else the finite difference with ε the
    learning-grid spacing. With ``with_health`` the root-find's `Health` is
    appended. Fixed numerics bisect ``bisect_iters`` times; adaptive runs
    Chandrupatla with that budget."""
    if config is None:
        config = SolverConfig()
    dtype, device = ls.dtype, ls.device
    kappa = torch.as_tensor(kappa, dtype=dtype, device=device)
    lo = tau_bar_in_unc if lo is None else lo
    hi = tau_bar_out_unc if hi is None else hi

    def aw_of(xi):
        t_out = torch.minimum(tau_bar_out_unc, xi)
        t_in = torch.minimum(tau_bar_in_unc, xi)
        return ls.cdf_at(t_out) - ls.cdf_at(t_in)

    if config.adaptive:
        out = chandrupatla(
            lambda x: aw_of(x) - kappa, lo, hi, budget=config.bisect_iters,
            x0=x0, with_health=with_health,
        )
    else:
        out = bisect(
            lambda x: aw_of(x) - kappa, lo, hi, num_iters=config.bisect_iters,
            x0=x0, with_health=with_health,
        )
    xi, xi_health = out if with_health else (out, None)

    aw = aw_of(xi)
    err = (aw - kappa).abs()
    root_ok = err <= _root_tol(dtype)

    t_out = torch.minimum(tau_bar_out_unc, xi)
    t_in = torch.minimum(tau_bar_in_unc, xi)
    if ls.closed_form:
        is_increasing = logistic_pdf(t_out, ls.beta, ls.x0) >= logistic_pdf(t_in, ls.beta, ls.x0)
    else:
        eps = ls.dt
        is_increasing = (ls.cdf_at(t_out + eps) - ls.cdf_at(t_in + eps)) >= aw
    if with_health:
        return xi, err, root_ok, is_increasing, xi_health
    return xi, err, root_ok, is_increasing


def _branches(times, xi, tau_bar_in_unc, tau_bar_out_unc, ls: LearningSolution):
    """The out- and in-branches of AW at ``times`` (shape (k,) + C), each
    zeroed before its own start, as the reference's masks do."""
    zero = torch.zeros((), dtype=ls.dtype, device=ls.device)
    shift_in = times - xi + torch.minimum(tau_bar_in_unc, xi)
    aw_in = torch.where(shift_in >= 0, ls.cdf_at(torch.clamp(shift_in, min=0.0)), zero)
    shift_out = times - xi + torch.minimum(tau_bar_out_unc, xi)
    aw_out = torch.where(shift_out >= 0, ls.cdf_at(torch.clamp(shift_out, min=0.0)), zero)
    return aw_out, aw_in


def get_aw(xi, tau_bar_in_unc, tau_bar_out_unc, tau_grid, ls: LearningSolution):
    """Aggregate-withdrawal curves on the hazard grid:
    AW_cum(t) = G(t−ξ+τ̄_OUT^CON) − G(t−ξ+τ̄_IN^CON) + G(0), each branch
    zeroed before its start. Returns (aw_cum, aw_out, aw_in) of shape
    C + (n,)."""
    times = tau_grid.movedim(-1, 0)  # (n,) + R, against the cells C
    aw_out, aw_in = _branches(times, xi, tau_bar_in_unc, tau_bar_out_unc, ls)
    zero = torch.zeros((), dtype=ls.dtype, device=ls.device)
    aw_cum = aw_out - aw_in + ls.cdf_at(zero)
    return tuple(v.movedim(0, -1) for v in (aw_cum, aw_out, aw_in))


def _aw_max_exact(xi, tau_bar_in_unc, tau_bar_out_unc, eta, ls: LearningSolution):
    """Exact max of the AW curve for closed-form Stage 1: the global max
    lies in {0, η, t*, ξ−τ̄_IN^CON, ξ−τ̄_OUT^CON}, where t* is the point at
    which the two pdf arguments straddle the logistic peak
    s* = ln((1−x0)/x0)/β symmetrically. NaN propagates through the max, as
    ``jnp.max``'s does."""
    dtype, device = ls.dtype, ls.device
    eta = torch.as_tensor(eta, dtype=dtype, device=device)
    tau_in_con = torch.minimum(tau_bar_in_unc, xi)
    tau_out_con = torch.minimum(tau_bar_out_unc, xi)
    s_star = (torch.log1p(-ls.x0) - torch.log(ls.x0)) / ls.beta
    t_peak = xi + s_star - 0.5 * (tau_in_con + tau_out_con)

    def clip(v):
        return torch.minimum(torch.clamp(v, min=0.0), eta)

    shape = torch.broadcast_shapes(xi.shape, t_peak.shape)
    candidates = torch.stack([
        v.expand(shape) for v in (
            torch.zeros((), dtype=dtype, device=device), eta, clip(t_peak),
            clip(xi - tau_in_con), clip(xi - tau_out_con),
        )
    ])
    aw_out, aw_in = _branches(candidates, xi, tau_bar_in_unc, tau_bar_out_unc, ls)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.amax(aw_out - aw_in, dim=0) + ls.cdf_at(zero)


def classify_cell(no_crossing, root_ok, increasing, err, dtype, first_ok=None):
    """The reference's branchless 5-case outcome split of one cell (the
    ``first_ok`` hook is the hetero family's first-crossing validation).
    Returns (run, status, converged, tolerance)."""
    valid_slope = increasing if first_ok is None else increasing & first_ok
    run = ~no_crossing & (root_ok & valid_slope)
    status = torch.where(
        no_crossing,
        int(Status.NO_CROSSING),
        torch.where(
            ~root_ok,
            int(Status.NO_ROOT),
            torch.where(valid_slope, int(Status.RUN), int(Status.FALSE_EQ)),
        ),
    ).to(torch.int32)
    converged = no_crossing | run
    tolerance = torch.where(no_crossing, 0.0, torch.where(run, err, float("inf"))).to(dtype)
    return run, status, converged, tolerance


def solve_equilibrium_core(
    ls: LearningSolution,
    u,
    p,
    kappa,
    lam,
    eta,
    tspan_end,
    config: SolverConfig | None = None,
    hazard_transform=None,
    kappa_transform=None,
    curves: bool = True,
) -> EquilibriumResult:
    """The equilibrium solve of every cell at once: u and κ have the cell
    shape C, p, λ, η and the learning solution the row shape R.

    Faithful to the reference's ``solve_equilibrium_core``, including the
    no-crossing branch, expressed through status codes. ``curves=False``
    skips the (n,)-long AW curves per cell, which the sweeps do not return
    (their fields are then ``None``).

    The scenario hooks, as in the reference:

    - ``hazard_transform(tau_grid, hr, hazard_at)`` returns
      ``(hr, hazard_at, extra_health)``. It rewrites the hazard between the
      hazard stage and the buffer crossings; it sees the batched rows
      (``hr`` of shape R + (n,)) and may return cell-shaped ones
      (C + (n,)). ``extra_health`` is a tuple of `Health` merged after the
      ξ stage's, in the reference's order.
    - ``kappa_transform(kappa)`` rewrites the threshold before the ξ
      root-find.

    With both ``None`` the function is the hook-free solve, bit for bit."""
    if config is None:
        config = SolverConfig()
    dtype, device = ls.dtype, ls.device
    u = torch.as_tensor(u, dtype=dtype, device=device)
    nan = torch.full((), float("nan"), dtype=dtype, device=device)

    # Spans are silent inside programs (the sweeps, the fixed point); an
    # eager call gets the per-stage wall split.
    with obs.span("baseline.hazard") as sp:
        tau_grid, hr, integ, int_eta = _hazard_parts(p, lam, ls, eta, config)
        sp.sync(hr)
    hazard_at = (
        _make_hazard_at(p, lam, ls, tau_grid, integ, int_eta, config)
        if (ls.closed_form and config.refine_crossings)
        else None
    )
    extra_health = ()
    if hazard_transform is not None:
        hr, hazard_at, extra_health = hazard_transform(tau_grid, hr, hazard_at)
    if kappa_transform is not None:
        kappa = kappa_transform(kappa)
    with obs.span("baseline.buffers") as sp:
        tau_in_unc, tau_out_unc, cross_health = optimal_buffer(
            u, tau_grid, hr, tspan_end, hazard_at=hazard_at, with_health=True,
            adaptive=config.adaptive,
        )
        sp.sync(tau_in_unc, tau_out_unc)
    no_crossing = tau_in_unc == tau_out_unc

    with obs.span("baseline.xi") as sp:
        xi_c, err, root_ok, increasing, xi_health = compute_xi(
            tau_in_unc, tau_out_unc, ls, kappa, config, with_health=True
        )
        sp.sync(xi_c)
    health = cross_health.merge(xi_health, *extra_health)
    run, status, converged, tolerance = classify_cell(no_crossing, root_ok, increasing, err, dtype)
    xi = torch.where(run, xi_c, nan)

    aw_cum = aw_out = aw_in = None
    if curves or not ls.closed_form:
        aw_cum, aw_out, aw_in = (
            torch.where(_col(run), v, nan)
            for v in get_aw(xi, tau_in_unc, tau_out_unc, tau_grid, ls)
        )
    if ls.closed_form:
        aw_max = torch.where(run, _aw_max_exact(xi, tau_in_unc, tau_out_unc, eta, ls), nan)
    else:
        aw_max = torch.where(run, torch.amax(aw_cum, dim=-1), nan)

    return EquilibriumResult(
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
        aw_max=aw_max,
        health=health,
    )


@functools.lru_cache(maxsize=None)
def _core_program(config: SolverConfig):
    """The whole solve as one program, cached per config: what the telemetry
    path hands to `obs.jit_call` (the reference's jitted core)."""

    def core(ls, u, p, kappa, lam, eta, tspan_end):
        obs.prof.note_call("baseline.equilibrium", ls, u, p, kappa, lam, eta, tspan_end)
        return solve_equilibrium_core(ls, u, p, kappa, lam, eta, tspan_end, config)

    return core


def solve_equilibrium_baseline(
    ls: LearningSolution,
    econ: EconomicParams,
    config: SolverConfig | None = None,
    tspan_end=None,
) -> EquilibriumResult:
    """One equilibrium, on the learning solution's device.
    ``tspan_end`` defaults to the learning grid's end. The result carries
    the wall-clock ``solve_time``, taken after the device has finished.

    The solve is one program (`obs.jit_call`) inside the
    ``baseline.equilibrium`` span, followed by a ``health`` census: with
    telemetry on they are logged, and the bits are the same either way."""
    if config is None:
        config = SolverConfig()
    if tspan_end is None:
        tspan_end = ls.grid[..., -1]
    t0 = time.perf_counter()
    args = tuple(
        torch.as_tensor(v, dtype=ls.dtype, device=ls.device)
        for v in (econ.u, econ.p, econ.kappa, econ.lam, econ.eta, tspan_end)
    )
    with obs.span("baseline.equilibrium"):
        res = obs.jit_call("baseline.equilibrium", _core_program(config), ls, *args)
    if ls.device.type == "cuda":
        torch.cuda.synchronize(ls.device)
    res = res.replace(solve_time=time.perf_counter() - t0)
    obs.log_health("baseline.equilibrium", res.health, res.status)
    return res
