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

import importlib

# Public names and the module each lives in. They load on first use (PEP
# 562), so importing a torch-free module of the package (``obs.report``,
# ``obs.history``) loads no torch.
_EXPORTS = {
    "solve_equilibrium_baseline": "sbr_tpu_torch.baseline",
    "solve_learning": "sbr_tpu_torch.baseline",
    "fit_withdrawals": "sbr_tpu_torch.grad",
    "interest_xi_and_grad": "sbr_tpu_torch.grad",
    "sensitivity_surface": "sbr_tpu_torch.grad",
    "stress_search": "sbr_tpu_torch.grad",
    "synth_withdrawals": "sbr_tpu_torch.grad",
    "xi_and_grad": "sbr_tpu_torch.grad",
    "get_aw_hetero": "sbr_tpu_torch.hetero",
    "solve_equilibrium_hetero": "sbr_tpu_torch.hetero",
    "solve_learning_hetero": "sbr_tpu_torch.hetero",
    "InfoModelSpec": "sbr_tpu_torch.infomodels",
    "InfoSimResult": "sbr_tpu_torch.infomodels",
    "default_spec": "sbr_tpu_torch.infomodels",
    "population_query": "sbr_tpu_torch.infomodels",
    "simulate_info": "sbr_tpu_torch.infomodels",
    "solve_fixed_point_info": "sbr_tpu_torch.infomodels",
    "solve_equilibrium_interest": "sbr_tpu_torch.interest",
    "EquilibriumResult": "sbr_tpu_torch.models",
    "LearningSolution": "sbr_tpu_torch.models",
    "ModelParams": "sbr_tpu_torch.models",
    "SolverConfig": "sbr_tpu_torch.models",
    "Status": "sbr_tpu_torch.models",
    "make_hetero_params": "sbr_tpu_torch.models",
    "make_interest_params": "sbr_tpu_torch.models",
    "make_model_params": "sbr_tpu_torch.models",
    "with_overrides": "sbr_tpu_torch.models",
    "run_tiled_grid_multihost": "sbr_tpu_torch.parallel",
    "FaultPlan": "sbr_tpu_torch.resilience",
    "InjectedFault": "sbr_tpu_torch.resilience",
    "RetryBudget": "sbr_tpu_torch.resilience",
    "RetryError": "sbr_tpu_torch.resilience",
    "RetryPolicy": "sbr_tpu_torch.resilience",
    "TileCache": "sbr_tpu_torch.resilience",
    "graceful_shutdown": "sbr_tpu_torch.resilience",
    "policy_from_env": "sbr_tpu_torch.resilience",
    "ScenarioSpec": "sbr_tpu_torch.scenario",
    "run_tiled_scenario_grid": "sbr_tpu_torch.scenario",
    "scenario_grid": "sbr_tpu_torch.scenario",
    "solve_multibank": "sbr_tpu_torch.scenario",
    "spec_fingerprint": "sbr_tpu_torch.scenario",
    "AgentSimConfig": "sbr_tpu_torch.social.agents",
    "AgentSimResult": "sbr_tpu_torch.social.agents",
    "PreparedAgentGraph": "sbr_tpu_torch.social.agents",
    "default_device": "sbr_tpu_torch.social.agents",
    "erdos_renyi_edges": "sbr_tpu_torch.social.agents",
    "load_agent_state": "sbr_tpu_torch.social.agents",
    "prepare_agent_graph": "sbr_tpu_torch.social.agents",
    "prepared_from_numpy": "sbr_tpu_torch.social.agents",
    "save_agent_state": "sbr_tpu_torch.social.agents",
    "scale_free_edges": "sbr_tpu_torch.social.agents",
    "simulate_agents": "sbr_tpu_torch.social.agents",
    "LoopComparison": "sbr_tpu_torch.social.closure",
    "close_loop": "sbr_tpu_torch.social.closure",
    "equilibrium_window": "sbr_tpu_torch.social.closure",
    "solve_forced_learning": "sbr_tpu_torch.social.dynamics",
    "ErdosRenyiSpec": "sbr_tpu_torch.social.graphgen",
    "ScaleFreeSpec": "sbr_tpu_torch.social.graphgen",
    "StochasticBlockSpec": "sbr_tpu_torch.social.graphgen",
    "generate_edges": "sbr_tpu_torch.social.graphgen",
    "prepare_generated_graph": "sbr_tpu_torch.social.graphgen",
    "SocialFixedPointResult": "sbr_tpu_torch.social.solver",
    "fixed_point_from_numpy": "sbr_tpu_torch.social.solver",
    "solve_equilibrium_social": "sbr_tpu_torch.social.solver",
    "beta_u_grid": "sbr_tpu_torch.sweeps",
    "policy_sweep_interest": "sbr_tpu_torch.sweeps",
    "solve_param_cell": "sbr_tpu_torch.sweeps",
    "u_sweep": "sbr_tpu_torch.sweeps",
    "run_tiled_grid": "sbr_tpu_torch.utils.checkpoint",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(module), name)
    else:
        try:
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as err:
            if err.name != f"{__name__}.{name}":
                raise
            raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__version__ = "0.1.0"

__all__ = sorted(_EXPORTS)
