"""The K-group hetero pipeline with the group axis sharded over a mesh:
the port of ``sbr_tpu.hetero.sharded``.

Every per-group stage (the learning rows, the hazards, the buffer
crossings, the AW decomposition) stays on its rank. Only the couplings
cross ranks: the ω mixing field of the coupled ODE, the dist-weighted AW
sums of the ξ root-find (psums), the bracket's upper end (a pmax) and the
all-groups no-crossing test (`hetero.solver` under ``axis_name``). Float
psums sum in rank order, so a run is reproducible and at one rank it is
the single-device solve bit for bit; across ranks only the grouping of
the sums differs (tested within 1e-9, as the reference holds its own).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from sbr_tpu_torch.hetero.learning import (
    hetero_solution_from_omega,
    hetero_substeps,
    solve_learning_hetero_arrays,
    solve_learning_hetero_exact,
)
from sbr_tpu_torch.hetero.solver import get_aw_hetero, solve_equilibrium_hetero
from sbr_tpu_torch.models.params import ModelParamsHetero, SolverConfig
from sbr_tpu_torch.models.results import AWHetero, EquilibriumResultHetero, LearningSolutionHetero
from sbr_tpu_torch.parallel.collectives import all_gather_blocks
from sbr_tpu_torch.parallel.mesh import axis_size, mesh_device, shard_axis_values

# the per-group fields, which come back gathered along the group axis
_GROUP_FIELDS = {
    LearningSolutionHetero: ("cdfs", "pdfs", "betas", "dist"),
    EquilibriumResultHetero: ("tau_bar_in_uncs", "tau_bar_out_uncs", "hrs"),
    AWHetero: ("aw_out_groups", "aw_in_groups", "aw_groups"),
}


def _gathered(res, mesh, axis: str):
    fields = _GROUP_FIELDS[type(res)]
    return dataclasses.replace(res, **{
        f: all_gather_blocks(getattr(res, f), mesh, (axis,)) for f in fields
    })


def solve_hetero_sharded(
    params: ModelParamsHetero,
    mesh,
    config: SolverConfig | None = None,
    axis: str = "k",
    dtype=torch.float64,
    with_aw: bool = True,
) -> Tuple[LearningSolutionHetero, EquilibriumResultHetero, Optional[AWHetero]]:
    """Full hetero solve with the group axis sharded over ``mesh[axis]``
    (a ``DeviceMesh``; every rank calls it alike), on the mesh's device.

    Returns (learning, equilibrium, aw) with the structure of the
    single-device ``solve_learning_hetero`` → ``solve_equilibrium_hetero``
    → ``get_aw_hetero`` pipeline, whole on every rank: the per-group arrays
    gathered, the scalars and shared-grid curves replicated. K must divide
    by the mesh axis size."""
    if config is None:
        config = SolverConfig()
    k = params.learning.n_groups
    n_dev = axis_size(mesh, axis)
    if k % n_dev:
        raise ValueError(
            f"K = {k} groups must divide evenly over the {n_dev}-device mesh "
            f"axis {axis!r}; pad the group list or choose a compatible mesh."
        )
    dev = mesh_device(mesh)
    t0, t1 = params.learning.tspan
    x0 = params.learning.x0

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    betas_l, dist_l = shard_axis_values(mesh, (axis, axis), tensor(params.learning.betas),
                                        tensor(params.learning.dist))
    axis_name = (mesh, axis)
    if config.grid_warp > 0.0:
        # the exact Ω path: the scalar t(Ω) table carries all of the
        # coupling and is computed from every group on every rank; each
        # rank then expands its own rows in closed form, with no collective
        tables = solve_learning_hetero_exact(params.learning, config, dtype, dev)
        lsh = hetero_solution_from_omega(betas_l, dist_l, tensor(x0), *tables)
    else:
        from sbr_tpu_torch.core.interp import linspace

        grid = linspace(t0, t1, config.n_grid, dtype, dev)
        lsh = solve_learning_hetero_arrays(betas_l, dist_l, x0, grid,
                                           hetero_substeps(params.learning, config),
                                           axis_name=axis_name)
    res = solve_equilibrium_hetero(lsh, params.economic, config, axis_name=axis_name)
    aw = get_aw_hetero(res, lsh, axis_name=axis_name) if with_aw else None
    return (_gathered(lsh, mesh, axis), _gathered(res, mesh, axis),
            _gathered(aw, mesh, axis) if aw is not None else None)
