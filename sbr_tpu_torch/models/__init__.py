"""Parameter and result records of the port (``sbr_tpu.models``: the
baseline, heterogeneous-learning and interest-rate families)."""

from sbr_tpu_torch.models.params import (
    EconomicParams,
    EconomicParamsInterest,
    LearningParams,
    LearningParamsHetero,
    ModelParams,
    ModelParamsHetero,
    ModelParamsInterest,
    SolverConfig,
    make_hetero_params,
    make_interest_params,
    make_model_params,
    params_to_pytree,
    pytree_to_params,
    with_overrides,
)
from sbr_tpu_torch.models.results import (
    AWHetero,
    EquilibriumResult,
    EquilibriumResultHetero,
    LearningSolution,
    LearningSolutionHetero,
    Status,
)

__all__ = [
    "AWHetero",
    "EconomicParams",
    "EconomicParamsInterest",
    "EquilibriumResult",
    "EquilibriumResultHetero",
    "LearningParams",
    "LearningParamsHetero",
    "LearningSolution",
    "LearningSolutionHetero",
    "ModelParams",
    "ModelParamsHetero",
    "ModelParamsInterest",
    "SolverConfig",
    "Status",
    "make_hetero_params",
    "make_interest_params",
    "make_model_params",
    "params_to_pytree",
    "pytree_to_params",
    "with_overrides",
]
