"""Policy sweeps over the interest-rate extension, the (β, u, r) grid: the
port of ``sbr_tpu.sweeps.policy_sweeps``.

The reference vmaps one cell three times. Here the grid is one batched
solve: Stage 1 and the hazard tables are built once per β row (shape
(B, 1, 1, n_grid)), and the HJB value function, the crossings, the ξ
root-find and the classification run over every (β, u, r) cell at once
(shape (B, U, R)). Each cell is `solve_equilibrium_interest_core`'s, so an
r = 0 cell is the baseline solver's answer. Cells are independent, so a
cell's result does not depend on the grid around it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.baseline.learning import solve_learning
from sbr_tpu_torch.diag.health import Health
from sbr_tpu_torch.interest.solver import solve_equilibrium_interest_core
from sbr_tpu_torch.models.params import ModelParamsInterest, SolverConfig
from sbr_tpu_torch.resilience import faults
from sbr_tpu_torch.sweeps.baseline_sweeps import _mesh_device, _RowLearning
from sbr_tpu_torch.utils.checkpoint import dtype_name

# Version of the (β, u, r) cell numerics, the reference's; a cache keyed
# on it must also carry the port's backend tag (see GRID_PROGRAM_VERSION).
POLICY_PROGRAM_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PolicySweepResult:
    """(B, U, R) grids of equilibrium scalars."""

    beta_values: torch.Tensor
    u_values: torch.Tensor
    r_values: torch.Tensor
    xi: torch.Tensor  # (B, U, R)
    aw_max: torch.Tensor  # (B, U, R)
    status: torch.Tensor  # (B, U, R) int32
    health: Optional[Health] = None  # per cell, leaves (B, U, R)


def _policy_program(base: ModelParamsInterest, config: SolverConfig, dtype, dev):
    """The grid's one batched solve, ``program(betas, us, rs)`` on a block
    of the (β, u, r) axes: Stage 1 per β row, then every cell at once."""
    econ = base.economic

    def tensor(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(dtype=dtype, device=dev)

    t0, t1 = (tensor(v) for v in base.learning.tspan)

    def program(beta_values, u_values, r_values):
        block = (beta_values.shape[0], u_values.shape[0], r_values.shape[0])
        learning = _RowLearning(beta_values.reshape(-1, 1, 1), (t0, t1),
                                tensor(base.learning.x0))
        ls = solve_learning(learning, config, dtype=dtype, device=dev)
        return solve_equilibrium_interest_core(
            ls,
            u_values.reshape(1, -1, 1).expand(block),
            *(tensor(v) for v in (econ.p, econ.kappa, econ.lam, econ.eta)),
            r_values.reshape(1, 1, -1).expand(block),
            tensor(econ.delta),
            t1,
            config,
        ).base

    return program


_FOOTPRINT_CACHE: dict = {}

# the two grids the preflight measures to model a larger one
_PROBE_SHAPES = ((2, 2, 2), (4, 4, 4))


def policy_tile_footprint(n_b: int, n_u: int, n_r: int, config: Optional[SolverConfig] = None,
                          dtype=None, device=None) -> dict:
    """Measured memory footprint of ONE (n_b × n_u × n_r) policy-grid
    dispatch (``arg_bytes``, ``out_bytes``, ``temp_bytes``, ``total_bytes``):
    the (β, u, r) analogue of `baseline_sweeps.grid_tile_footprint`. The
    reference estimates it ahead of time from the compiled program; the port
    runs the program once on probe axes of that shape
    (`obs.mem.measure_footprint`). ``config=None`` is the sweep default.
    Cached per (shape, config, dtype, device)."""
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    dev = _mesh_device(None, device)
    key = ((int(n_b), int(n_u), int(n_r)), config, dtype, str(dev))
    fp = _FOOTPRINT_CACHE.get(key)
    if fp is None:
        from sbr_tpu_torch.models.params import make_interest_params

        base = make_interest_params()
        delta = base.economic.delta
        axes = (np.linspace(0.5, 2.0, int(n_b)), np.linspace(0.01, 0.5, int(n_u)),
                np.linspace(0.0, 0.5 * delta, int(n_r)))
        args = [torch.as_tensor(a).to(dtype=dtype, device=dev) for a in axes]
        with obs.program():  # the probe leaves no trace in the run's events
            fp = obs.mem.measure_footprint(_policy_program(base, config, dtype, dev), *args)
        _FOOTPRINT_CACHE[key] = fp
    return dict(fp)


def _capacity(dev: torch.device):
    """The memory the grid's device holds: the card's, or None for a grid
    on the CPU, which has no budget to hold it to (even in a process that
    uses a card)."""
    return obs.mem.device_capacity() if dev.type == "cuda" else None


def _preflight_footprint(n_b: int, n_u: int, n_r: int, config, dtype, dev) -> dict:
    """The grid's footprint for the OOM preflight, without running a grid
    that may not fit: measured where the grid is no larger than the larger
    probe, else the linear model (fixed + per-cell bytes) of the two
    probes' measured footprints, as the tiled sweep's planner models a
    tile."""
    cells = n_b * n_u * n_r
    big = _PROBE_SHAPES[-1]
    if cells <= big[0] * big[1] * big[2]:
        return policy_tile_footprint(n_b, n_u, n_r, config, dtype, dev)
    points = [(b * u * r, policy_tile_footprint(b, u, r, config, dtype, dev)["total_bytes"])
              for b, u, r in _PROBE_SHAPES]
    fixed, per_cell = obs.mem.fit_linear_model(points)
    return {"total_bytes": int(fixed + per_cell * cells), "source": "planner-model",
            "model_fixed_bytes": int(fixed), "model_per_cell_bytes": per_cell}


def policy_sweep_interest(
    beta_values,
    u_values,
    r_values,
    base: ModelParamsInterest,
    config: Optional[SolverConfig] = None,
    dtype=None,
    mesh=None,
    mesh_axes: tuple = ("b", "u"),
    device=None,
) -> PolicySweepResult:
    """(β, u, r) grid of interest-rate equilibria on ``device`` (default:
    the CUDA card) in ``dtype`` (default: float64).

    ``config=None`` is not ``SolverConfig()``: None selects the sweep
    default with crossing refinement off, as in the reference. η, tspan
    and δ stay pinned at the base model's resolved values for every cell.
    Every r must be below δ. With ``mesh``, β and u are cut along the
    mesh axes named by ``mesh_axes`` (r is not cut); each rank solves its
    (B/n_b, U/n_u, R) block on the mesh's device and every rank gets the
    whole grid, bit for bit the unsharded one.

    With telemetry on, the grid runs as one program through `obs.jit_call`
    inside the ``sweeps.policy_interest`` span, followed by the status and
    health censuses. Before it, the OOM preflight (`obs.mem`), the grid's
    only memory check: on the card the grid's footprint
    (`_preflight_footprint`) against the card's budget, failing closed with
    `obs.mem.MemoryPreflightError`; "skipped" without a capacity (the CPU)
    and, under a mesh, "skipped" with reason "sharded" (the unsharded
    measure would overstate a rank's share)."""
    if config is None:
        config = SolverConfig(refine_crossings=False)
    econ = base.economic
    dtype = torch.float64 if dtype is None else dtype
    dev = _mesh_device(mesh, device)
    if float(np.max(np.asarray(r_values))) >= econ.delta:
        raise ValueError(f"All r values must be < delta = {econ.delta}")

    def tensor(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(dtype=dtype, device=dev)

    beta_values, u_values, r_values = tensor(beta_values), tensor(u_values), tensor(r_values)
    cells = (beta_values.shape[0], u_values.shape[0], r_values.shape[0])
    n_b, n_u, n_r = (int(c) for c in cells)
    if obs.mem.preflight_enabled():
        label = f"policy[{n_b}x{n_u}x{n_r}]"
        capacity = _capacity(dev)
        if capacity is None or mesh is not None:
            obs.mem.preflight(label, None, capacity=None,
                              skip_reason="sharded" if mesh is not None else "no-capacity")
        else:
            obs.mem.check_preflight(obs.mem.preflight(
                label, _preflight_footprint(n_b, n_u, n_r, config, dtype, dev),
                capacity=capacity))
    faults.fire("sweep.dispatch", target="policy_interest[{}x{}x{}]".format(*cells))
    program = _policy_program(base, config, dtype, dev)

    b_local, u_local = beta_values, u_values
    if mesh is not None:
        from sbr_tpu_torch.parallel import shard_axis_values

        b_local, u_local = shard_axis_values(mesh, mesh_axes, beta_values, u_values)
    with obs.span("sweeps.policy_interest", n_beta=n_b, n_u=n_u, n_r=n_r,
                  dtype=dtype_name(dtype), sharded=mesh is not None) as sp:
        res = obs.jit_call("sweeps.policy_interest", program, b_local, u_local, r_values)
        if mesh is not None:
            from sbr_tpu_torch.parallel.collectives import all_gather_blocks

            axes = (mesh_axes[0], mesh_axes[1], None)
            res = dataclasses.replace(res, **{
                f: all_gather_blocks(getattr(res, f), mesh, axes)
                for f in ("xi", "aw_max", "status", "health")})
        sp.sync(res.status)
    obs.metrics.metrics().inc("sweeps.policy_interest.cells", n_b * n_u * n_r)
    obs.log_status("sweeps.policy_interest", res.status)
    obs.log_health("sweeps.policy_interest", res.health, res.status)
    return PolicySweepResult(
        beta_values=beta_values, u_values=u_values, r_values=r_values,
        xi=res.xi, aw_max=res.aw_max, status=res.status, health=res.health,
    )
