"""Comparative-statics sweeps of the port (``sbr_tpu.sweeps``): the
Figure-4 u-sweep, the Figure-5 β×u grid and the (β, u, r) policy grid of
the interest-rate extension."""

from sbr_tpu_torch.sweeps.baseline_sweeps import (
    GRID_PROGRAM_VERSION,
    GridSweepResult,
    USweepResult,
    beta_u_grid,
    solve_param_cell,
    u_sweep,
)
from sbr_tpu_torch.sweeps.policy_sweeps import (
    POLICY_PROGRAM_VERSION,
    PolicySweepResult,
    policy_sweep_interest,
)

__all__ = [
    "GRID_PROGRAM_VERSION",
    "GridSweepResult",
    "POLICY_PROGRAM_VERSION",
    "PolicySweepResult",
    "USweepResult",
    "beta_u_grid",
    "policy_sweep_interest",
    "solve_param_cell",
    "u_sweep",
]
