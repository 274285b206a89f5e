"""Comparative-statics sweeps of the port (``sbr_tpu.sweeps``): the
Figure-4 u-sweep and the Figure-5 β×u grid."""

from sbr_tpu_torch.sweeps.baseline_sweeps import (
    GRID_PROGRAM_VERSION,
    GridSweepResult,
    USweepResult,
    beta_u_grid,
    solve_param_cell,
    u_sweep,
)

__all__ = [
    "GRID_PROGRAM_VERSION",
    "GridSweepResult",
    "USweepResult",
    "beta_u_grid",
    "solve_param_cell",
    "u_sweep",
]
