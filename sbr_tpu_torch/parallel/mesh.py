"""Device meshes of the port: the counterpart of ``sbr_tpu.parallel.mesh``.

A JAX ``Mesh`` is one controller driving many devices. Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over a process group: one
rank a device, every rank running the same program (SPMD). Its axis names
are the reference's: ``"agents"`` for the agent simulation, ``("b", "u")``
for the β×u grid, ``"u"`` for the u-sweep, ``"k"`` for the hetero group
axis.

- 2-D (b, u) meshes for comparative-statics grids: cells are independent,
  each rank solves its block and one gather assembles the grid.
- 1-D agent meshes for the explicit-agent simulation: agents and edges
  shard over one axis, with the collectives of `parallel.collectives`.

A caller that never brought a process group up (`initialize_distributed`)
gets a world-size-1 mesh over its own device, as the reference's helpers
build a one-device mesh on one device. That group rendezvous through an
in-memory ``HashStore``, so it reads no environment variable. Its backend
is ``nccl`` on the card and ``gloo`` on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def balanced_2d(n: int) -> Tuple[int, int]:
    """Most-square factorization (a, b) of n with a ≤ b; (1, n) for primes."""
    for a in range(int(math.isqrt(n)), 0, -1):
        if n % a == 0:
            return a, n // a
    return 1, n


def _device_type(device) -> str:
    """The mesh's device type: the CUDA card unless the caller names one."""
    if device is None:
        from sbr_tpu_torch.social.agents import default_device

        return default_device().type
    return torch.device(device).type


def ensure_group(device_type: str) -> None:
    """Bring up a world-size-1 process group over an in-memory store when
    none is up: ``nccl`` for the card, ``gloo`` for the CPU."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=600))


def _ranks(devices) -> list:
    import torch.distributed as dist

    return list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]


def _mesh(device_type: str, ranks: list, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda":
        # one card a rank, or every rank on the one card: pick it before
        # the mesh's own guess (a rank's index modulo the card count)
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def make_grid_mesh(
    devices: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str] = ("b", "u"),
    shape: Optional[Tuple[int, int]] = None,
    device=None,
):
    """2-D mesh over all (or the given) ranks for β×u grid sweeps, laid out
    row-major as the reference lays its devices; ``device`` sets its device
    type (default: the CUDA card)."""
    device_type = _device_type(device)
    ensure_group(device_type)
    ranks = _ranks(devices)
    if shape is None:
        shape = balanced_2d(len(ranks))
    if shape[0] * shape[1] != len(ranks):
        raise ValueError(f"Mesh shape {shape} does not use {len(ranks)} devices")
    return _mesh(device_type, ranks, tuple(shape), tuple(axis_names))


def make_agent_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "agents",
                    device=None):
    """1-D mesh over all (or the given) ranks for agent/edge sharding."""
    device_type = _device_type(device)
    ensure_group(device_type)
    ranks = _ranks(devices)
    return _mesh(device_type, ranks, (len(ranks),), (axis_name,))


def axis_size(mesh, axis: str) -> int:
    """Ranks along mesh axis ``axis``."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_axis_values(mesh, mesh_axes: Sequence[str], *value_arrays):
    """This rank's block of each 1-D value array, the array cut evenly along
    its own mesh axis: the port's side of the reference's
    ``NamedSharding(mesh, P(axis))`` placement. Each mesh axis size must
    divide the matching array length."""
    out = []
    for ax, v in zip(mesh_axes, value_arrays, strict=True):
        size = axis_size(mesh, ax)
        n = int(v.shape[0])
        if n % size:
            raise ValueError(
                f"mesh axis {ax!r} of size {size} does not divide the {n} values"
            )
        block = n // size
        i = axis_index(mesh, ax)
        out.append(v[i * block:(i + 1) * block])
    return tuple(out)
