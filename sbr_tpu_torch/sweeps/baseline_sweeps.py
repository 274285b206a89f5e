"""Comparative-statics sweeps: the port of
``sbr_tpu.sweeps.baseline_sweeps`` (the Figure-4 u-sweep and the Figure-5
β×u grid).

The reference vmaps one cell twice. Here a sweep is one batched solve:
the Stage-1 and hazard tables are built once per β row (shape
(n_b, 1, n_grid)) and every (β, u) cell runs the crossings, the ξ
root-find and the classification at once. Cells are independent, so
the result does not depend on the batching.

With ``mesh`` (a ``DeviceMesh`` of `parallel.mesh`; every rank calls the
sweep alike), each rank solves only its block of the cells (the value
arrays cut along the named mesh axes, `parallel.shard_axis_values`), and
one all-gather along each axis hands every rank the whole grid. A cell's
bits depend on its own row alone, so a sharded sweep equals the unsharded
one bit for bit.

With telemetry on (`sbr_tpu_torch.obs`), each sweep is one program through
`obs.jit_call` inside its span, followed by ``status`` and ``health``
censuses, as in the reference. `grid_tile_footprint` measures one grid
dispatch's memory for the tiled sweep's preflight and planner.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from sbr_tpu_torch import obs
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


@functools.lru_cache(maxsize=None)
def _u_sweep_fn(config: SolverConfig):
    """The u-sweep program, cached per config (the reference's jitted
    sweep): one batched lean solve over every u."""

    def fn(ls, u_values, p, kappa, lam, eta, tspan_end):
        obs.prof.note_call("sweeps.u_sweep", ls, u_values, p, kappa, lam, eta, tspan_end)
        return _lean_cell(ls, u_values, p, kappa, lam, eta, tspan_end, config)

    return fn


@functools.lru_cache(maxsize=None)
def _grid_fn(config: SolverConfig):
    """The β×u grid program, cached per config: `solve_param_cell` with β
    as a column against the u row."""

    def fn(beta_values, u_values, p, kappa, lam, eta, t0, t1, x0):
        obs.prof.note_call("sweeps.beta_u_grid", beta_values, u_values, p, kappa, lam, eta,
                           t0, t1, x0)
        return solve_param_cell(beta_values.unsqueeze(-1), u_values, p, kappa, lam, eta, t0,
                                t1, x0, config, beta_values.dtype, beta_values.device)

    return fn


def _mesh_device(mesh, device):
    """The device a sweep runs on: the mesh's, else ``device`` (default:
    the CUDA card)."""
    if mesh is not None:
        from sbr_tpu_torch.parallel.mesh import mesh_device

        return mesh_device(mesh)
    return torch.device(device) if device is not None else default_device()


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
    device and in its dtype; Stages 2-3 for every u at once. With
    ``mesh``, each rank solves its block of u along ``mesh_axis`` (whose
    size must divide len(u_values)) and every rank gets the whole sweep."""
    if config is None:
        config = SolverConfig()
    if tspan_end is None:
        tspan_end = ls.grid[..., -1]
    dtype, device = ls.dtype, ls.device
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    u_local = u_values
    if mesh is not None:
        from sbr_tpu_torch.parallel import shard_axis_values

        (u_local,) = shard_axis_values(mesh, (mesh_axis,), u_values)
    scalars = (econ.p, econ.kappa, econ.lam, econ.eta, tspan_end)
    args = (ls, u_local) + tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in scalars)
    n_u = int(u_values.shape[0])
    # fault point (resilience.faults): a transient here is a failure at
    # dispatch; without a plan it costs one check of a module global
    faults.fire("sweep.dispatch", target=f"u_sweep[{n_u}]")
    with obs.span("sweeps.u_sweep", n_u=n_u, sharded=mesh is not None) as sp:
        out = obs.jit_call("sweeps.u_sweep", _u_sweep_fn(config), *args)
        if mesh is not None:
            from sbr_tpu_torch.parallel.collectives import all_gather_blocks

            out = tuple(all_gather_blocks(o, mesh, (mesh_axis,)) for o in out)
        xi, tau_in, aw_max, status, health = out
        sp.sync(status)
    obs.metrics.metrics().inc("sweeps.u_sweep.cells", n_u)
    obs.log_status("sweeps.u_sweep", status)
    obs.log_health("sweeps.u_sweep", health, status)
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
    (default: the CUDA card) in ``dtype`` (default: float64).

    With ``mesh``, the (B, U) grid is cut along the mesh axes named by
    ``mesh_axes``, each of whose sizes must divide the matching value
    array's length; each rank solves its block on the mesh's device and
    every rank gets the whole grid (module docstring)."""
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = _mesh_device(mesh, device)
    econ = base.economic
    t0, t1 = base.learning.tspan
    beta_values = torch.as_tensor(beta_values, dtype=dtype, device=device)
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    scalars = tuple(torch.as_tensor(v, dtype=dtype, device=device)
                    for v in (econ.p, econ.kappa, econ.lam, econ.eta, t0, t1, base.learning.x0))
    n_b, n_u = int(beta_values.shape[0]), int(u_values.shape[0])
    b_local, u_local = beta_values, u_values
    if mesh is not None:
        from sbr_tpu_torch.parallel import shard_axis_values

        b_local, u_local = shard_axis_values(mesh, mesh_axes, beta_values, u_values)
    # fault point: the tile loop's retry policy wraps this call, so a
    # transient injected here exercises the real recovery path
    faults.fire("sweep.dispatch", target=f"beta_u_grid[{n_b}x{n_u}]")
    with obs.span("sweeps.beta_u_grid", n_beta=n_b, n_u=n_u,
                  dtype=str(dtype).removeprefix("torch."), sharded=mesh is not None) as sp:
        out = obs.jit_call("sweeps.beta_u_grid", _grid_fn(config), b_local, u_local, *scalars)
        if mesh is not None:
            from sbr_tpu_torch.parallel.collectives import all_gather_blocks

            out = tuple(all_gather_blocks(o, mesh, tuple(mesh_axes)) for o in out)
        xi, _, aw_max, status, health = out
        sp.sync(status)
    obs.metrics.metrics().inc("sweeps.beta_u_grid.cells", n_b * n_u)
    obs.log_status("sweeps.beta_u_grid", status)
    obs.log_health("sweeps.beta_u_grid", health, status)
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
    parameter per cell. Returns (xi, τ̄_IN, AW_max, status, health).
    A program region: telemetry inside it is silent, as inside the
    reference's jitted cell."""
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    with obs.program():
        t0, t1, x0 = (torch.as_tensor(v, dtype=dtype, device=device) for v in (t0, t1, x0))
        learning = _RowLearning(torch.as_tensor(beta, dtype=dtype, device=device), (t0, t1), x0)
        ls = solve_learning(learning, config, dtype=dtype, device=device)
        econ = (torch.as_tensor(v, dtype=dtype, device=device) for v in (p, kappa, lam, eta))
        return _lean_cell(ls, u, *econ, t1, config)


_FOOTPRINT_CACHE: dict = {}


def grid_tile_footprint(n_b: int, n_u: int, config: Optional[SolverConfig] = None,
                        dtype=None, device=None) -> dict:
    """Measured memory footprint of ONE (n_b × n_u) β×u grid dispatch
    (argument/output/temp bytes, summed as ``total_bytes``): the model the
    OOM preflight compares against the card's capacity and the
    ``tile_shape="auto"`` planner probes (`obs.mem.measure_footprint`: the
    program runs once on probe axes). ``config=None`` is the sweep default
    (refinement off), as in `beta_u_grid`. Cached per (shape, config,
    dtype, device)."""
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    key = ((int(n_b), int(n_u)), config, dtype, str(device))
    fp = _FOOTPRINT_CACHE.get(key)
    if fp is None:
        from sbr_tpu_torch.models.params import make_model_params

        base = make_model_params()
        betas = torch.linspace(0.5, 2.0, int(n_b), dtype=dtype, device=device)
        us = torch.linspace(0.01, 0.5, int(n_u), dtype=dtype, device=device)
        econ = base.economic
        scalars = tuple(torch.as_tensor(v, dtype=dtype, device=device)
                        for v in (econ.p, econ.kappa, econ.lam, econ.eta,
                                  *base.learning.tspan, base.learning.x0))
        fp = obs.mem.measure_footprint(_grid_fn(config), betas, us, *scalars)
        _FOOTPRINT_CACHE[key] = fp
    return dict(fp)
