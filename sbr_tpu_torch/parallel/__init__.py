"""Meshes, collectives and multi-process runs of the port
(``sbr_tpu.parallel``).

- `mesh`: ``DeviceMesh`` construction (`make_agent_mesh`,
  `make_grid_mesh`, `balanced_2d`) and `shard_axis_values`;
- `collectives`: the ``lax`` collectives the sharded programs use, and
  `exclusive_psum`;
- `distributed`: `initialize_distributed` (one sharded program across
  processes) and the storage-only sweep farm (`run_tiled_grid_multihost`).
"""

from sbr_tpu_torch.parallel.collectives import exclusive_psum
from sbr_tpu_torch.parallel.distributed import (
    initialize_distributed,
    run_tiled_grid_multihost,
    tile_assignment,
)
from sbr_tpu_torch.parallel.mesh import (
    balanced_2d,
    make_agent_mesh,
    make_grid_mesh,
    shard_axis_values,
)

__all__ = [
    "balanced_2d",
    "exclusive_psum",
    "initialize_distributed",
    "make_agent_mesh",
    "make_grid_mesh",
    "run_tiled_grid_multihost",
    "shard_axis_values",
    "tile_assignment",
]
