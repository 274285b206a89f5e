"""Information models, PyTorch port: the spec algebra (:mod:`spec`), the
agent-level engine (:mod:`engine`) with its gossip and bayes channels on
static graphs, their mean-field fixed points (:mod:`meanfield`), and the
population what-if queries over both (:mod:`population`)."""

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
from sbr_tpu_torch.infomodels.population import (
    crossing_times,
    parse_population_doc,
    population_fingerprint,
    population_query,
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
    "crossing_times",
    "default_spec",
    "info_learning_curve",
    "infomodel_fingerprint",
    "observed_fraction",
    "parse_population_doc",
    "population_fingerprint",
    "population_query",
    "simulate_info",
    "solve_fixed_point_info",
]
