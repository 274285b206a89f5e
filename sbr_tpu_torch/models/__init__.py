"""Parameter and result records of the port (``sbr_tpu.models``: the
baseline family)."""

from sbr_tpu_torch.models.params import (
    EconomicParams,
    LearningParams,
    ModelParams,
    SolverConfig,
    make_model_params,
    params_to_pytree,
    pytree_to_params,
    with_overrides,
)
from sbr_tpu_torch.models.results import EquilibriumResult, LearningSolution, Status

__all__ = [
    "EconomicParams",
    "EquilibriumResult",
    "LearningParams",
    "LearningSolution",
    "ModelParams",
    "SolverConfig",
    "Status",
    "make_model_params",
    "params_to_pytree",
    "pytree_to_params",
    "with_overrides",
]
