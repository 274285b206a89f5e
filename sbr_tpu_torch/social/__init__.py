"""Social-learning extension, PyTorch port: the explicit-agent simulation
(:mod:`agents`), its counter RNG (:mod:`rng`), the fused infection and
belief steps (:mod:`fused`), graphs generated on the device
(:mod:`graphgen`), the forced learning law (:mod:`dynamics`), the damped
social fixed point (:mod:`solver`) and the equilibrium → agent closure
(:mod:`closure`)."""

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

# The fixed point and the closure stand on the baseline solver, whose
# modules import this package's `fused` and `agents`: they load on first
# use, so that importing either side first works.
_LAZY = {
    "solve_forced_learning": "dynamics",
    "SocialFixedPointResult": "solver",
    "fixed_point_from_numpy": "solver",
    "solve_equilibrium_social": "solver",
    "LoopComparison": "closure",
    "close_loop": "closure",
    "equilibrium_window": "closure",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AgentSimConfig",
    "AgentSimResult",
    "ErdosRenyiSpec",
    "LoopComparison",
    "PreparedAgentGraph",
    "ScaleFreeSpec",
    "SocialFixedPointResult",
    "StochasticBlockSpec",
    "close_loop",
    "equilibrium_window",
    "erdos_renyi_edges",
    "fixed_point_from_numpy",
    "generate_edges",
    "load_agent_state",
    "prepare_agent_graph",
    "prepare_generated_graph",
    "prepared_from_numpy",
    "save_agent_state",
    "scale_free_edges",
    "simulate_agents",
    "solve_equilibrium_social",
    "solve_forced_learning",
]
