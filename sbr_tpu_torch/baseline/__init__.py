"""The baseline three-stage solve of the port (``sbr_tpu.baseline``):
Stage 1 in closed form, the hazard and buffer crossings, the ξ root-find
and the status classification."""

from sbr_tpu_torch.baseline.learning import (
    learning_solution_from_numpy,
    logistic_cdf,
    logistic_pdf,
    solve_learning,
)
from sbr_tpu_torch.baseline.solver import (
    compute_xi,
    get_aw,
    hazard_rate,
    optimal_buffer,
    solve_equilibrium_baseline,
    solve_equilibrium_core,
)

__all__ = [
    "compute_xi",
    "get_aw",
    "hazard_rate",
    "learning_solution_from_numpy",
    "logistic_cdf",
    "logistic_pdf",
    "optimal_buffer",
    "solve_equilibrium_baseline",
    "solve_equilibrium_core",
    "solve_learning",
]
