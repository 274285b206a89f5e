"""sbr_tpu_torch — the PyTorch and CUDA port of ``sbr_tpu``.

A second package beside the JAX one, which stays the reference: each
ported module is held to ``sbr_tpu`` on the same inputs by the tests.
``sbr_tpu_torch/X/y.py`` is the port of ``sbr_tpu/X/y.py``. The package
imports ``torch`` and ``numpy``, never ``jax`` or ``sbr_tpu``.

Ported so far: the explicit-agent simulation on one device
(``social.agents``), with the fused infection step as a CUDA kernel for
Hopper (``social.fused``, ``csrc/infection_update.cu``).

Device rule: entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise when there is no card. On CPU tensors every
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
the kernel or raises.
"""

from sbr_tpu_torch.social.agents import (
    AgentSimConfig,
    AgentSimResult,
    PreparedAgentGraph,
    default_device,
    erdos_renyi_edges,
    load_agent_state,
    prepare_agent_graph,
    prepared_from_numpy,
    save_agent_state,
    scale_free_edges,
    simulate_agents,
)

__version__ = "0.1.0"

__all__ = [
    "AgentSimConfig",
    "AgentSimResult",
    "PreparedAgentGraph",
    "default_device",
    "erdos_renyi_edges",
    "load_agent_state",
    "prepare_agent_graph",
    "prepared_from_numpy",
    "save_agent_state",
    "scale_free_edges",
    "simulate_agents",
]
