"""Stage 1, learning dynamics: the port of ``sbr_tpu.baseline.learning``.

The logistic SI model dx/dt = βx(1−x) has the exact solution
G(t) = x0 / (x0 + (1 − x0)·e^{−βt}), evaluated in closed form, and the
PDF g(t) = β·G·(1 − G).
"""

from __future__ import annotations

import torch

from sbr_tpu_torch.core.interp import linspace
from sbr_tpu_torch.models.params import LearningParams, SolverConfig
from sbr_tpu_torch.models.results import LearningSolution
from sbr_tpu_torch.social.agents import default_device


def logistic_cdf(t, beta, x0):
    """Exact SI-model CDF, in the decaying-exponential form so that large
    βt saturates to 1 instead of overflowing."""
    return x0 / (x0 + (1.0 - x0) * torch.exp(-beta * t))


def logistic_pdf(t, beta, x0):
    """Exact SI-model PDF g(t) = β·G(t)·(1 − G(t))."""
    g = logistic_cdf(t, beta, x0)
    return beta * g * (1.0 - g)


def solve_learning(
    params: LearningParams,
    config: SolverConfig | None = None,
    dtype=None,
    device=None,
) -> LearningSolution:
    """Solve Stage 1 on a static uniform grid over ``params.tspan``.

    Returns a closed-form `LearningSolution` on ``device`` (default: the
    CUDA card) in ``dtype`` (default: float64). ``params`` may carry
    tensors of a row shape R for ``beta`` (and the tspan ends and x0), as
    the β×u sweep and a served batch do; the samples then have shape
    R + (n_grid,)."""
    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    t0, t1 = params.tspan
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    t1 = torch.as_tensor(t1, dtype=dtype, device=device)
    beta = torch.as_tensor(params.beta, dtype=dtype, device=device)
    x0 = torch.as_tensor(params.x0, dtype=dtype, device=device)
    grid = linspace(t0, t1, config.n_grid, dtype, device)
    if beta.dim() > 0:
        grid = grid.expand(*torch.broadcast_shapes(beta.shape, grid.shape[:-1]), grid.shape[-1])
    b = beta.unsqueeze(-1)
    x0_col = x0.unsqueeze(-1) if x0.dim() > 0 else x0
    cdf = logistic_cdf(grid, b, x0_col)
    pdf = logistic_pdf(grid, b, x0_col)
    return LearningSolution(
        grid=grid,
        cdf=cdf,
        pdf=pdf,
        t0=t0,
        dt=grid[..., 1] - grid[..., 0],
        beta=beta,
        x0=x0,
        closed_form=True,
    )


def learning_solution_from_samples(grid, cdf, pdf) -> LearningSolution:
    """Wrap sampled curves on a uniform grid (ODE-backed stages)."""
    return LearningSolution(
        grid=grid,
        cdf=cdf,
        pdf=pdf,
        t0=grid[..., 0],
        dt=grid[..., 1] - grid[..., 0],
        beta=torch.full(grid.shape[:-1], float("nan"), dtype=grid.dtype, device=grid.device),
        x0=cdf[..., 0],
        closed_form=False,
    )


def learning_solution_from_numpy(grid, cdf, pdf, t0, dt, beta, x0, closed_form: bool,
                                 device=None) -> LearningSolution:
    """A `LearningSolution` from numpy arrays, for instance those of an
    ``sbr_tpu`` Stage 1, so that the port's Stages 2-3 can run on exactly
    the reference's Stage 1: its float ``exp`` rounds apart from PyTorch's
    and from the card's. The dtype is the arrays'."""
    device = torch.device(device) if device is not None else default_device()

    def t(a):
        return torch.as_tensor(a).to(device)

    return LearningSolution(
        grid=t(grid), cdf=t(cdf), pdf=t(pdf), t0=t(t0), dt=t(dt), beta=t(beta),
        x0=t(x0), closed_form=bool(closed_form),
    )
