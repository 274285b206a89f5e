"""Stage 1 for K heterogeneous groups, the coupled SI network: the port of
``sbr_tpu.hetero.learning``.

    dG_k/dt = (1 − G_k)·β_k·ω(t),   ω(t) = Σ_j dist_j·G_j(t)

Three routes, chosen as in the reference:

- ``grid_warp > 0`` (the default): the exact Ω reduction. With
  Ω(t) = ∫₀ᵗ ω, every group has the closed form
  G_k(Ω) = 1 − (1−x0)·e^{−β_k·Ω}, and t(Ω) = ∫₀^Ω dv/ω(v) is a scalar
  quadrature with an analytic integrand, evaluated on a grid of knots
  that resolves every group's transition (`_omega_knots`).
- ``grid_warp == 0``, fixed numerics: RK4 on a uniform grid with
  `hetero_substeps` micro-steps per interval.
- ``grid_warp == 0``, adaptive numerics: `core.ode.bs32` on the same grid;
  its flags ride along as ``ode_flags``.

The group axis leads every table. The reference's ``axis_name`` (a group
axis sharded across devices) is not ported yet: it raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sbr_tpu_torch.core.integrate import cumulative_gauss_legendre
from sbr_tpu_torch.core.interp import interp, linspace
from sbr_tpu_torch.core.ode import bs32, rk4
from sbr_tpu_torch.models.params import LearningParamsHetero, SolverConfig
from sbr_tpu_torch.models.results import LearningSolutionHetero
from sbr_tpu_torch.social.agents import default_device


def no_axis_name(axis_name) -> None:
    """Refuse a sharded group axis, which the port does not have yet."""
    if axis_name is not None:
        raise NotImplementedError(
            "a sharded group axis (axis_name) is not ported yet (ROADMAP.md 1.A "
            "item 11); pass axis_name=None"
        )


def hetero_rhs(t, G, args):
    """Coupled SI rhs for a (K,) state: (1 − G)·β·(dist·G)."""
    del t
    betas, dist, _ = args
    return (1.0 - G) * betas * torch.dot(dist, G)


def hetero_substeps(params: LearningParamsHetero, config: SolverConfig) -> int:
    """RK4 micro-steps per interval keeping β_max·h ≲ 0.015."""
    t0, t1 = params.tspan
    h0 = (t1 - t0) / (config.n_grid - 1)
    beta_max = float(max(params.betas))
    return max(config.ode_substeps, int(math.ceil(beta_max * h0 / 0.015)))


def solve_learning_hetero_arrays(betas, dist, x0: float, grid, substeps: int,
                                 axis_name=None, adaptive_tols=None) -> LearningSolutionHetero:
    """The coupled K-ODE on ``grid``: RK4 with ``substeps`` micro-steps, or
    `bs32` with ``adaptive_tols = (rtol, atol)``, whose flags are kept as
    ``ode_flags``."""
    no_axis_name(axis_name)
    g0 = torch.full(betas.shape, float(x0), dtype=betas.dtype, device=betas.device)
    ode_flags = None
    if adaptive_tols is not None:
        rtol, atol = adaptive_tols
        cdfs, ode_health = bs32(
            hetero_rhs, g0, grid, args=(betas, dist, None), rtol=rtol, atol=atol,
            with_health=True,
        )
        ode_flags = ode_health.flags
    else:
        cdfs = rk4(hetero_rhs, g0, grid, args=(betas, dist, None), substeps=substeps)
    cdfs = torch.clamp(cdfs.T, 0.0, 1.0)  # (K, n)
    omega = dist @ cdfs
    pdfs = (1.0 - cdfs) * betas[:, None] * omega[None, :]
    return LearningSolutionHetero(
        grid=grid, cdfs=cdfs, pdfs=pdfs, t0=grid[0], dt=grid[1] - grid[0],
        betas=betas, dist=dist, ode_flags=ode_flags,
    )


def _omega_of(betas, dist, x0):
    """ω(Ω) = 1 − (1−x0)·Σ_j dist_j·e^{−β_j·Ω}, broadcasting over Ω (the
    group sum on a new leading axis)."""

    def omega(v):
        shape = betas.shape + (1,) * v.dim()
        e = torch.exp(-betas.reshape(shape) * v.unsqueeze(0))
        return 1.0 - (1.0 - x0) * torch.sum(dist.reshape(shape) * e, dim=0)

    return omega


def _omega_knots(betas, dist, x0, omega_hi, n_q: int, n_log: int, dtype):
    """Quantile and log knots on [0, omega_hi] (the caller pins the ends):
    ``n_q`` (group, level) pairs, the groups round-robin over at most
    ``n_q`` β-sorted representatives and the levels a golden-ratio
    sequence, each mapped to Ω = −ln((1−L)/(1−x0))/β_k; then ``n_log``
    log-spaced knots through the early ramp. The picks are host numpy, as
    in the reference; at most n_q + n_log knots."""
    dev = betas.device
    k = betas.shape[0]
    n_sel = min(k, n_q)
    gidx = torch.from_numpy(np.linspace(0, k - 1, n_sel).astype(np.int64)).to(dev)
    slots = torch.from_numpy(np.arange(n_q) % n_sel).to(dev)
    sel = torch.sort(betas).values[gidx][slots]
    phi = 0.6180339887498949
    q = torch.from_numpy((np.arange(1, n_q + 1) * phi) % 1.0).to(dtype=dtype, device=dev)
    q = torch.clamp(q, 1.0 / (2 * n_q), 1.0)
    g_hi = 1.0 - (1.0 - x0) * torch.exp(-sel * omega_hi)
    hi_level = torch.full((), 1.0 - 1e-15, dtype=dtype, device=dev)
    levels = torch.minimum(torch.maximum(x0 + q * (g_hi - x0), x0), hi_level)
    quant = -torch.log((1.0 - levels) / (1.0 - x0)) / sel

    beta_ave = torch.dot(dist, betas)
    lo = torch.maximum(x0 / beta_ave * 1e-2, omega_hi * 1e-14)
    logs = torch.exp(linspace(torch.log(lo), torch.log(omega_hi), n_log, dtype, dev))
    knots = torch.cat([quant.reshape(-1), logs])
    return torch.minimum(torch.clamp(knots, min=0.0), omega_hi)


def solve_learning_hetero_exact(params: LearningParamsHetero, config: SolverConfig | None = None,
                                dtype=None, device=None):
    """The exact Ω reduction: returns (t_grid, omega_grid, omega_vals), the
    warped time grid, Ω at its knots and ω(Ω) there.

    Pass 1 maps t(Ω) coarsely out to Ω = t1 (an upper bound, since ω ≤ 1)
    and inverts it at t1 for Ω₁; pass 2 lays the final n_grid knots on
    [0, Ω₁] (quantiles, logs, and uniform-in-t knots inverted through the
    coarse map), with the ends pinned."""
    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    dev = torch.device(device) if device is not None else default_device()
    t0, t1 = params.tspan
    if t0 != 0.0:
        raise ValueError(f"hetero exact path assumes tspan starting at 0, got {params.tspan}")

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    betas, dist, x0 = tensor(params.betas), tensor(params.dist), tensor(params.x0)
    t1_t = tensor(t1)
    omega = _omega_of(betas, dist, x0)
    n = config.n_grid
    order = config.quad_order
    zero = torch.zeros(1, dtype=dtype, device=dev)

    def inv_omega(v):
        return 1.0 / omega(v)

    coarse = torch.sort(torch.cat([
        zero,
        _omega_knots(betas, dist, x0, t1_t, n // 2, n // 8, dtype),
        linspace(0.0, t1_t, n // 4, dtype, dev),
    ])).values
    t_coarse = cumulative_gauss_legendre(inv_omega, coarse, order=order)
    omega1 = interp(t1_t, t_coarse, coarse)

    knots = _omega_knots(betas, dist, x0, omega1, n // 2, n // 8, dtype)
    n_unif = n - int(knots.shape[0]) - 2
    t_targets = linspace(0.0, t1_t, n_unif, dtype, dev)
    omega_unif = interp(t_targets, t_coarse, coarse)
    omega_grid = torch.sort(torch.cat([zero, knots, omega_unif, omega1.reshape(1)])).values
    omega_grid = torch.minimum(torch.clamp(omega_grid, min=0.0), omega1)
    omega_grid[0] = 0.0
    omega_grid[-1] = omega1

    t_grid = cumulative_gauss_legendre(inv_omega, omega_grid, order=order)
    # t(Ω₁) = t1 up to the coarse inversion's error; downstream reads
    # grid[-1] as the end of tspan
    t_grid[-1] = t1_t
    return t_grid, omega_grid, omega(omega_grid)


def hetero_solution_from_omega(betas, dist, x0, t_grid, omega_grid, omega_vals) -> LearningSolutionHetero:
    """Expand the Ω table into per-group rows in closed form."""
    cdfs = 1.0 - (1.0 - x0) * torch.exp(-betas[:, None] * omega_grid[None, :])
    pdfs = (1.0 - cdfs) * betas[:, None] * omega_vals[None, :]
    return LearningSolutionHetero(
        grid=t_grid, cdfs=cdfs, pdfs=pdfs, t0=t_grid[0], dt=t_grid[1] - t_grid[0],
        betas=betas, dist=dist,
    )


def solve_learning_hetero(params: LearningParamsHetero, config: SolverConfig | None = None,
                          dtype=None, device=None) -> LearningSolutionHetero:
    """Solve the K-group system on ``device`` (default: the CUDA card) in
    ``dtype`` (default float64): the exact Ω reduction when
    ``config.grid_warp > 0``, else the coupled ODE on a uniform grid (RK4,
    or `bs32` under adaptive numerics)."""
    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    dev = torch.device(device) if device is not None else default_device()

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    betas, dist = tensor(params.betas), tensor(params.dist)
    if config.grid_warp > 0.0:
        t_grid, omega_grid, omega_vals = solve_learning_hetero_exact(params, config, dtype, dev)
        return hetero_solution_from_omega(
            betas, dist, tensor(params.x0), t_grid, omega_grid, omega_vals
        )
    t0, t1 = params.tspan
    grid = linspace(t0, t1, config.n_grid, dtype, dev)
    return solve_learning_hetero_arrays(
        betas, dist, params.x0, grid, hetero_substeps(params, config),
        adaptive_tols=(config.ode_rtol, config.ode_atol) if config.adaptive else None,
    )


def hetero_solution_from_numpy(grid, cdfs, pdfs, t0, dt, betas, dist, ode_flags=None,
                               device=None) -> LearningSolutionHetero:
    """A `LearningSolutionHetero` from numpy arrays, for instance those of
    an ``sbr_tpu`` Stage 1, so that the port's Stages 2-3 can start from
    exactly the reference's Stage 1. The dtype is the arrays'."""
    dev = torch.device(device) if device is not None else default_device()

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    return LearningSolutionHetero(
        grid=t(grid), cdfs=t(cdfs), pdfs=t(pdfs), t0=t(t0), dt=t(dt), betas=t(betas),
        dist=t(dist), ode_flags=None if ode_flags is None else t(ode_flags),
    )
