"""Multi-process sweep farming of the port (``sbr_tpu.parallel``): the
storage-only part of ``parallel.distributed``, which shares a β×u sweep
between processes through its checkpoint directory. The process-group
bring-up and the mesh helpers wait for ROADMAP 1.A item 11."""

from sbr_tpu_torch.parallel.distributed import run_tiled_grid_multihost, tile_assignment

__all__ = ["run_tiled_grid_multihost", "tile_assignment"]
