"""Information models, PyTorch port: the spec algebra (:mod:`spec`), the
agent-level engine (:mod:`engine`) with its gossip and bayes channels on
static graphs, and their mean-field fixed points (:mod:`meanfield`)."""

from sbr_tpu_torch.infomodels.engine import (
    InfoSimResult,
    agent_fields_from_numpy,
    simulate_info,
)
from sbr_tpu_torch.infomodels.meanfield import (
    info_learning_curve,
    observed_fraction,
    solve_fixed_point_info,
)
from sbr_tpu_torch.infomodels.spec import (
    CHANNELS,
    DYNAMICS,
    INFOMODEL_PROGRAM_VERSION,
    InfoModelSpec,
    default_spec,
    infomodel_fingerprint,
)

__all__ = [
    "CHANNELS",
    "DYNAMICS",
    "INFOMODEL_PROGRAM_VERSION",
    "InfoModelSpec",
    "InfoSimResult",
    "agent_fields_from_numpy",
    "default_spec",
    "info_learning_curve",
    "infomodel_fingerprint",
    "observed_fraction",
    "simulate_info",
    "solve_fixed_point_info",
]
