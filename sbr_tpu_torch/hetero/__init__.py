"""The heterogeneous-learning extension of the port (``sbr_tpu.hetero``):
K groups with their own learning rates, the group axis leading every
table. The sharded group axis (``hetero/sharded.py``) is not ported yet."""

from sbr_tpu_torch.hetero.learning import hetero_solution_from_numpy, solve_learning_hetero
from sbr_tpu_torch.hetero.solver import (
    compute_xi_hetero,
    get_aw_hetero,
    hazard_rates_hetero,
    solve_equilibrium_hetero,
)

__all__ = [
    "compute_xi_hetero",
    "get_aw_hetero",
    "hazard_rates_hetero",
    "hetero_solution_from_numpy",
    "solve_equilibrium_hetero",
    "solve_learning_hetero",
]
