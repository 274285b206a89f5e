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
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.sweeps.baseline_sweeps import _no_mesh, _RowLearning
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
    Every r must be below δ. ``mesh=`` (sharded sweeps) is not ported yet
    and raises.

    With telemetry on, the grid runs as one program through `obs.jit_call`
    inside the ``sweeps.policy_interest`` span, followed by the status and
    health censuses. The OOM preflight logs its record as the reference's
    does; the port measures no footprint for this grid, so on the card the
    verdict is "skipped" ("not-measured")."""
    _no_mesh(mesh)
    if config is None:
        config = SolverConfig(refine_crossings=False)
    econ = base.economic
    dtype = torch.float64 if dtype is None else dtype
    dev = torch.device(device) if device is not None else default_device()
    if float(np.max(np.asarray(r_values))) >= econ.delta:
        raise ValueError(f"All r values must be < delta = {econ.delta}")

    def tensor(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(dtype=dtype, device=dev)

    beta_values, u_values, r_values = tensor(beta_values), tensor(u_values), tensor(r_values)
    cells = (beta_values.shape[0], u_values.shape[0], r_values.shape[0])
    n_b, n_u, n_r = (int(c) for c in cells)
    if obs.mem.preflight_enabled():
        obs.mem.preflight(f"policy[{n_b}x{n_u}x{n_r}]", None,
                          skip_reason=None if obs.mem.device_capacity() is None
                          else "not-measured")
    faults.fire("sweep.dispatch", target="policy_interest[{}x{}x{}]".format(*cells))
    t0, t1 = (tensor(v) for v in base.learning.tspan)

    def program(beta_values, u_values, r_values):
        learning = _RowLearning(beta_values.reshape(-1, 1, 1), (t0, t1),
                                tensor(base.learning.x0))
        ls = solve_learning(learning, config, dtype=dtype, device=dev)
        return solve_equilibrium_interest_core(
            ls,
            u_values.reshape(1, -1, 1).expand(cells),
            *(tensor(v) for v in (econ.p, econ.kappa, econ.lam, econ.eta)),
            r_values.reshape(1, 1, -1).expand(cells),
            tensor(econ.delta),
            t1,
            config,
        ).base

    with obs.span("sweeps.policy_interest", n_beta=n_b, n_u=n_u, n_r=n_r,
                  dtype=dtype_name(dtype), sharded=False) as sp:
        res = obs.jit_call("sweeps.policy_interest", program, beta_values, u_values, r_values)
        sp.sync(res.status)
    obs.metrics.metrics().inc("sweeps.policy_interest.cells", n_b * n_u * n_r)
    obs.log_status("sweeps.policy_interest", res.status)
    obs.log_health("sweeps.policy_interest", res.health, res.status)
    return PolicySweepResult(
        beta_values=beta_values, u_values=u_values, r_values=r_values,
        xi=res.xi, aw_max=res.aw_max, status=res.status, health=res.health,
    )
