"""Information models, PyTorch port: the spec algebra (:mod:`spec`) and the
agent-level engine (:mod:`engine`) with its gossip and bayes channels on
static graphs."""

from sbr_tpu_torch.infomodels.engine import (
    InfoSimResult,
    agent_fields_from_numpy,
    simulate_info,
)
from sbr_tpu_torch.infomodels.spec import (
    CHANNELS,
    DYNAMICS,
    INFOMODEL_PROGRAM_VERSION,
    InfoModelSpec,
    default_spec,
)

__all__ = [
    "CHANNELS",
    "DYNAMICS",
    "INFOMODEL_PROGRAM_VERSION",
    "InfoModelSpec",
    "InfoSimResult",
    "agent_fields_from_numpy",
    "default_spec",
    "simulate_info",
]
