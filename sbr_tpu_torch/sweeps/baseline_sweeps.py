"""Comparative-statics sweeps: the port of
``sbr_tpu.sweeps.baseline_sweeps`` (the Figure-4 u-sweep and the Figure-5
β×u grid).

The reference vmaps one cell twice. Here a sweep is one batched solve:
the Stage-1 and hazard tables are built once per β row (shape
(n_b, 1, n_grid)) and every (β, u) cell runs the crossings, the ξ
root-find and the classification at once. Cells are independent, so
the result does not depend on the batching.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sbr_tpu_torch.baseline.learning import solve_learning
from sbr_tpu_torch.baseline.solver import solve_equilibrium_core
from sbr_tpu_torch.diag.health import Health
from sbr_tpu_torch.models.params import ModelParams, SolverConfig
from sbr_tpu_torch.models.results import LearningSolution
from sbr_tpu_torch.resilience import faults
from sbr_tpu_torch.social.agents import default_device

# Version of the β×u grid-cell numerics, the reference's: a tile cache
# keyed on it must also carry the port's backend tag (see ROADMAP.md),
# since the port's cells agree with the reference's to a tolerance, not
# bit for bit.
GRID_PROGRAM_VERSION = 2


@dataclasses.dataclass(frozen=True)
class USweepResult:
    """Figure-4 outputs: per-u scalars."""

    u_values: torch.Tensor
    max_withdrawals: torch.Tensor  # AW_max, NaN when no run
    collapse_times: torch.Tensor  # ξ
    return_times: torch.Tensor  # ξ − τ̄_IN
    status: torch.Tensor  # int32 Status codes
    health: Optional[Health] = None  # per-cell, leaves (n_u,)


@dataclasses.dataclass(frozen=True)
class GridSweepResult:
    """Figure-5 outputs: (B, U) grids."""

    beta_values: torch.Tensor
    u_values: torch.Tensor
    max_aw: torch.Tensor  # (B, U)
    xi: torch.Tensor  # (B, U)
    status: torch.Tensor  # (B, U)
    health: Optional[Health] = None  # per-cell, leaves (B, U)


def _lean_cell(ls: LearningSolution, u, p, kappa, lam, eta, tspan_end, config: SolverConfig):
    """The cells' scalars only: (xi, τ̄_IN, AW_max, status, health)."""
    r = solve_equilibrium_core(ls, u, p, kappa, lam, eta, tspan_end, config, curves=False)
    return r.xi, r.tau_bar_in_unc, r.aw_max, r.status, r.health


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded sweeps are not ported yet (ROADMAP item 1.A 11); pass mesh=None"
        )


def u_sweep(
    ls: LearningSolution,
    u_values,
    econ,
    config: SolverConfig | None = None,
    tspan_end=None,
    mesh=None,
    mesh_axis: str = "u",
) -> USweepResult:
    """Figure-4 u-sweep: one Stage-1 solution shared across all u, on its
    device and in its dtype; Stages 2-3 for every u at once."""
    _no_mesh(mesh)
    if config is None:
        config = SolverConfig()
    if tspan_end is None:
        tspan_end = ls.grid[..., -1]
    dtype, device = ls.dtype, ls.device
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    scalars = (econ.p, econ.kappa, econ.lam, econ.eta, tspan_end)
    # fault point (resilience.faults): a transient here is a failure at
    # dispatch; without a plan it costs one check of a module global
    faults.fire("sweep.dispatch", target=f"u_sweep[{int(u_values.shape[0])}]")
    xi, tau_in, aw_max, status, health = _lean_cell(
        ls, u_values, *(torch.as_tensor(v, dtype=dtype, device=device) for v in scalars), config
    )
    return USweepResult(
        u_values=u_values,
        max_withdrawals=aw_max,
        collapse_times=xi,
        return_times=xi - tau_in,
        status=status,
        health=health,
    )


def beta_u_grid(
    beta_values,
    u_values,
    base: ModelParams,
    config: Optional[SolverConfig] = None,
    mesh=None,
    mesh_axes: tuple = ("b", "u"),
    dtype=None,
    device=None,
) -> GridSweepResult:
    """Figure-5 β×u grid. ``config=None`` selects the sweep default with
    crossing refinement off, as in the reference. η and tspan stay pinned
    at the base model's resolved values for every β (the copy-constructor
    semantics of `models.params.with_overrides`). Runs on ``device``
    (default: the CUDA card) in ``dtype`` (default: float64)."""
    _no_mesh(mesh)
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    econ = base.economic
    t0, t1 = base.learning.tspan
    beta_values = torch.as_tensor(beta_values, dtype=dtype, device=device)
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    # fault point: the tile loop's retry policy wraps this call, so a
    # transient injected here exercises the real recovery path
    faults.fire("sweep.dispatch",
                target=f"beta_u_grid[{int(beta_values.shape[0])}x{int(u_values.shape[0])}]")
    xi, _, aw_max, status, health = solve_param_cell(
        beta_values.unsqueeze(-1), u_values, econ.p, econ.kappa, econ.lam, econ.eta,
        t0, t1, base.learning.x0, config, dtype, device,
    )
    return GridSweepResult(
        beta_values=beta_values, u_values=u_values, max_aw=aw_max, xi=xi,
        status=status, health=health,
    )


class _RowLearning:
    """Duck-typed `LearningParams` holding tensors (a β per row)."""

    def __init__(self, beta, tspan, x0):
        self.beta = beta
        self.tspan = tspan
        self.x0 = x0


def solve_param_cell(beta, u, p, kappa, lam, eta, t0, t1, x0, config: SolverConfig,
                     dtype=None, device=None):
    """Fully parameterised equilibrium cells: closed-form Stage 1 rebuilt
    per β row, then the lean Stage 2-3 solve. ``beta`` (and p, λ, η, t0,
    t1, x0) have the row shape R, ``u`` and κ the cell shape C: a β×u grid
    passes β as a column, a batch of independent queries passes every
    parameter per cell. Returns (xi, τ̄_IN, AW_max, status, health)."""
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    t0, t1, x0 = (torch.as_tensor(v, dtype=dtype, device=device) for v in (t0, t1, x0))
    learning = _RowLearning(torch.as_tensor(beta, dtype=dtype, device=device), (t0, t1), x0)
    ls = solve_learning(learning, config, dtype=dtype, device=device)
    econ = (torch.as_tensor(v, dtype=dtype, device=device) for v in (p, kappa, lam, eta))
    return _lean_cell(ls, u, *econ, t1, config)
