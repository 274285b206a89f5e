"""Forced learning dynamics dG/dt = (1 − G)·β·AW(t): the port of
``sbr_tpu.social.dynamics``.

The equation is separable: for any forcing AW with cumulative integral
A(t) = ∫₀ᵗ AW(s) ds, G(t) = 1 − (1 − x0)·exp(−β·A(t)). For piecewise-linear
AW samples A is the trapezoid cumulative, exactly, so the solve is one
cumulative sum and one ``exp``; the PDF is g = (1 − G)·β·AW.
"""

from __future__ import annotations

import torch

from sbr_tpu_torch.core.integrate import cumtrapz
from sbr_tpu_torch.models.results import LearningSolution


def solve_forced_learning(beta, aw_samples, grid, x0) -> LearningSolution:
    """Exact solve of dG/dt = (1 − G)·β·AW(t) for AW sampled on the uniform
    ``grid`` (both of shape (n,)), from G(0) = ``x0``.

    Returns a sampled `LearningSolution` (``closed_form=False``) in the
    samples' dtype, on their device: downstream consumers interpolate."""
    dtype, device = aw_samples.dtype, aw_samples.device
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    dt = grid[1] - grid[0]
    big_a = cumtrapz(aw_samples, dx=dt)
    cdf = 1.0 - (1.0 - x0) * torch.exp(-beta * big_a)
    pdf = (1.0 - cdf) * beta * aw_samples
    return LearningSolution(
        grid=grid, cdf=cdf, pdf=pdf, t0=grid[0], dt=dt, beta=beta, x0=x0,
        closed_form=False,
    )
