"""Social-learning extension, PyTorch port: the explicit-agent simulation
(:mod:`agents`), its counter RNG (:mod:`rng`), the fused infection and
belief steps (:mod:`fused`) and graphs generated on the device
(:mod:`graphgen`)."""

from sbr_tpu_torch.social.agents import (
    AgentSimConfig,
    AgentSimResult,
    PreparedAgentGraph,
    erdos_renyi_edges,
    load_agent_state,
    prepare_agent_graph,
    prepared_from_numpy,
    save_agent_state,
    scale_free_edges,
    simulate_agents,
)
from sbr_tpu_torch.social.graphgen import (
    ErdosRenyiSpec,
    ScaleFreeSpec,
    StochasticBlockSpec,
    generate_edges,
    prepare_generated_graph,
)

__all__ = [
    "AgentSimConfig",
    "AgentSimResult",
    "ErdosRenyiSpec",
    "PreparedAgentGraph",
    "ScaleFreeSpec",
    "StochasticBlockSpec",
    "erdos_renyi_edges",
    "generate_edges",
    "load_agent_state",
    "prepare_agent_graph",
    "prepare_generated_graph",
    "prepared_from_numpy",
    "save_agent_state",
    "scale_free_edges",
    "simulate_agents",
]
