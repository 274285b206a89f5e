"""Social-learning extension, PyTorch port: the explicit-agent simulation
(:mod:`agents`), its counter RNG (:mod:`rng`) and the fused infection step
(:mod:`fused`)."""

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

__all__ = [
    "AgentSimConfig",
    "AgentSimResult",
    "PreparedAgentGraph",
    "erdos_renyi_edges",
    "load_agent_state",
    "prepare_agent_graph",
    "prepared_from_numpy",
    "save_agent_state",
    "scale_free_edges",
    "simulate_agents",
]
