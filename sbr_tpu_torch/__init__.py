"""sbr_tpu_torch — the PyTorch and CUDA port of ``sbr_tpu``.

A second package beside the JAX one, which stays the reference: each
ported module is held to ``sbr_tpu`` on the same inputs by the tests.
``sbr_tpu_torch/X/y.py`` is the port of ``sbr_tpu/X/y.py``. The package
imports ``torch`` and ``numpy``, never ``jax`` or ``sbr_tpu``.

Ported so far, each on one device:

- slice 1, the explicit-agent simulation (``social.agents``), whose fused
  infection step is a CUDA kernel for Hopper (``social.fused``,
  ``csrc/infection_update.cu``);
- slice 2, the information-model simulation (``infomodels``: the spec and
  `simulate_info`, gossip and bayes channels on static graphs) on graphs
  generated on the device (``social.graphgen``), whose fused belief step
  is a second CUDA kernel (``csrc/belief_update.cu``);
- slice 3, the flagship equilibrium solve (``models``, ``diag``, ``core``,
  ``baseline``, ``sweeps``): Stage 1 in closed form, the hazard and the
  buffer crossings, the ξ root-find and the classification, and the
  Figure-4 u-sweep and Figure-5 β×u grid over them, batched over cells in
  plain PyTorch (it has no kernel of its own). Its entry points compute in
  float64 unless given ``dtype=torch.float32``;
- slice 4, the social-learning extension (``social.dynamics``,
  ``social.solver``, ``social.closure``, ``infomodels.meanfield``): the
  forced learning law, the damped fixed point as a Python loop over the
  device, the information models' mean-field fixed points, and
  `close_loop`, which feeds a solved equilibrium's withdrawal window to
  the agent simulation and so drives both kernels. It adds no kernel;
- slice 5, the serving engine (``serve``): micro-batched queries padded
  to a bucket ladder, a fingerprint-keyed result cache
  (``utils.checkpoint``), one CUDA graph captured per bucket of
  `solve_param_cell`, the HTTP endpoint and the load generator, with the
  retry policy (``resilience``) and the latency histograms (``obs``). It
  adds no kernel;
- slice 6, the last TPU kernel and the extensions: the recount's bit
  gather of the withdrawn mask, a CUDA kernel (``social.recount``,
  ``csrc/recount_gather.cu``) measured by the port's ablation script
  (``benchmarks.ablate_pallas_recount``); the ODE integrators
  (``core.ode``); the heterogeneous-learning extension (``hetero``); the
  positive-interest-rate extension (``interest``); and the (β, u, r)
  policy sweep over it (``sweeps.policy_sweeps``);
- slice 8, composed scenarios (``scenario``: `ScenarioSpec`, `solve`
  through the stage hooks of the baseline and hetero solves,
  `scenario_grid`, multi-bank contagion) and population what-ifs
  (``infomodels.population``), with their serving routes. Scenarios run
  no kernel; a population query runs S agent populations through
  `close_loop`, so both agent kernels get a served path. It adds no
  kernel;
- slice 9, panic rewiring (``dynamics="rewire"`` of `simulate_info`, its
  closures and populations: the edge set regenerated every epoch with the
  sources tilted toward the withdrawing agents, every step still ending
  in the infection or belief kernel) and the gradient layer (``grad``:
  implicit-function-theorem gradients of ξ as a ``torch.autograd``
  function, sensitivity surfaces, calibration, stress search, and the
  served ``grads`` route). It adds no kernel;
- slice 10, the tiled, checkpointed β×u sweep (``utils.checkpoint``:
  `run_tiled_grid`, which the paper-resolution Figure-5 heatmap needs),
  its resilience stack (``resilience``: seeded fault injection, graceful
  shutdown, the degrade ladder, the elastic scheduler and the cross-run
  tile cache), the multi-process sweep farm
  (``parallel.run_tiled_grid_multihost``), the tiled scenario sweep and
  the serving engine's tile-cache rung (``serve.fleet.TileCacheBridge``).
  It adds no kernel.

Device rule: entry points run on the CUDA card unless the caller passes
``device="cpu"``, and raise when there is no card. On CPU tensors every
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
the kernel or raises.
"""

from sbr_tpu_torch.baseline import solve_equilibrium_baseline, solve_learning
from sbr_tpu_torch.grad import (
    fit_withdrawals,
    interest_xi_and_grad,
    sensitivity_surface,
    stress_search,
    synth_withdrawals,
    xi_and_grad,
)
from sbr_tpu_torch.hetero import get_aw_hetero, solve_equilibrium_hetero, solve_learning_hetero
from sbr_tpu_torch.infomodels import (
    InfoModelSpec,
    InfoSimResult,
    default_spec,
    population_query,
    simulate_info,
    solve_fixed_point_info,
)
from sbr_tpu_torch.interest import solve_equilibrium_interest
from sbr_tpu_torch.models import (
    EquilibriumResult,
    LearningSolution,
    ModelParams,
    SolverConfig,
    Status,
    make_hetero_params,
    make_interest_params,
    make_model_params,
    with_overrides,
)
from sbr_tpu_torch.parallel import run_tiled_grid_multihost
from sbr_tpu_torch.resilience import (
    FaultPlan,
    InjectedFault,
    RetryBudget,
    RetryError,
    RetryPolicy,
    TileCache,
    graceful_shutdown,
    policy_from_env,
)
from sbr_tpu_torch.scenario import (
    ScenarioSpec,
    run_tiled_scenario_grid,
    scenario_grid,
    solve_multibank,
    spec_fingerprint,
)
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
from sbr_tpu_torch.social.closure import LoopComparison, close_loop, equilibrium_window
from sbr_tpu_torch.social.dynamics import solve_forced_learning
from sbr_tpu_torch.social.graphgen import (
    ErdosRenyiSpec,
    ScaleFreeSpec,
    StochasticBlockSpec,
    generate_edges,
    prepare_generated_graph,
)
from sbr_tpu_torch.social.solver import (
    SocialFixedPointResult,
    fixed_point_from_numpy,
    solve_equilibrium_social,
)
from sbr_tpu_torch.sweeps import beta_u_grid, policy_sweep_interest, solve_param_cell, u_sweep
from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

__version__ = "0.1.0"

__all__ = [
    "AgentSimConfig",
    "AgentSimResult",
    "EquilibriumResult",
    "ErdosRenyiSpec",
    "FaultPlan",
    "InfoModelSpec",
    "InfoSimResult",
    "InjectedFault",
    "LearningSolution",
    "LoopComparison",
    "ModelParams",
    "PreparedAgentGraph",
    "RetryBudget",
    "RetryError",
    "RetryPolicy",
    "ScaleFreeSpec",
    "ScenarioSpec",
    "SocialFixedPointResult",
    "SolverConfig",
    "Status",
    "StochasticBlockSpec",
    "TileCache",
    "beta_u_grid",
    "close_loop",
    "default_device",
    "default_spec",
    "equilibrium_window",
    "erdos_renyi_edges",
    "fit_withdrawals",
    "fixed_point_from_numpy",
    "generate_edges",
    "get_aw_hetero",
    "graceful_shutdown",
    "interest_xi_and_grad",
    "load_agent_state",
    "make_hetero_params",
    "make_interest_params",
    "make_model_params",
    "policy_from_env",
    "policy_sweep_interest",
    "population_query",
    "prepare_agent_graph",
    "prepare_generated_graph",
    "prepared_from_numpy",
    "run_tiled_grid",
    "run_tiled_grid_multihost",
    "run_tiled_scenario_grid",
    "save_agent_state",
    "scale_free_edges",
    "scenario_grid",
    "sensitivity_surface",
    "simulate_agents",
    "simulate_info",
    "solve_equilibrium_baseline",
    "solve_equilibrium_hetero",
    "solve_equilibrium_interest",
    "solve_equilibrium_social",
    "solve_fixed_point_info",
    "solve_forced_learning",
    "solve_learning",
    "solve_learning_hetero",
    "solve_multibank",
    "solve_param_cell",
    "spec_fingerprint",
    "stress_search",
    "synth_withdrawals",
    "u_sweep",
    "with_overrides",
    "xi_and_grad",
]
