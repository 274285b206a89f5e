"""Composed scenarios, the port of ``sbr_tpu.scenario``: a `ScenarioSpec`
describes a staged solve pipeline (learning stage × ordered hazard/buffer
modifiers × N-bank contagion coupling) and `solve(spec, params)` runs it
through the stage hooks of the plain solves. Reducible specs are the plain
solves bit for bit; genuine compositions (hetero × interest × social,
policy-modifier sweeps, interbank contagion) are data, not new solvers.
`run_tiled_scenario_grid` sweeps a spec through the tiled, checkpointed
runner (`utils.checkpoint.run_tiled_grid`).
"""

from sbr_tpu_torch.scenario.engine import (
    SCENARIO_KEYS,
    ScenarioResult,
    run_tiled_scenario_grid,
    scenario_grid,
    scenario_theta,
    solve,
    solve_scenario_cell,
)
from sbr_tpu_torch.scenario.multibank import MultiBankResult, solve_multibank
from sbr_tpu_torch.scenario.spec import (
    HAZARD_MODIFIERS,
    LEARNING_STAGES,
    SCENARIO_PROGRAM_VERSION,
    ScenarioSpec,
    spec_fingerprint,
)

__all__ = [
    "HAZARD_MODIFIERS",
    "LEARNING_STAGES",
    "SCENARIO_KEYS",
    "SCENARIO_PROGRAM_VERSION",
    "MultiBankResult",
    "ScenarioResult",
    "ScenarioSpec",
    "run_tiled_scenario_grid",
    "scenario_grid",
    "scenario_theta",
    "solve",
    "solve_multibank",
    "solve_scenario_cell",
    "spec_fingerprint",
]
