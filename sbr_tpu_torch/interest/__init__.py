"""The positive-interest-rate extension of the port (``sbr_tpu.interest``):
the HJB value function V on the hazard grid, the effective hazard h − rV
for the buffer crossings, and the baseline Stages 2-3 on it."""

from sbr_tpu_torch.interest.solver import (
    EquilibriumResultInterest,
    effective_hazard_stage,
    solve_equilibrium_interest,
    solve_equilibrium_interest_core,
)
from sbr_tpu_torch.interest.value_function import solve_value_function

__all__ = [
    "EquilibriumResultInterest",
    "effective_hazard_stage",
    "solve_equilibrium_interest",
    "solve_equilibrium_interest_core",
    "solve_value_function",
]
