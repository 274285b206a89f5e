"""Mesh collectives of the port: the counterpart of
``sbr_tpu.parallel.collectives`` and of the ``lax`` collectives the
sharded programs use, over one axis of a ``DeviceMesh``.

Each takes ``(x, mesh, axis)`` and is named after its ``lax`` counterpart:

- `all_gather`: the tiled ``lax.all_gather`` (blocks concatenated along
  dim 0 in rank order);
- `psum_scatter`: the tiled ``lax.psum_scatter`` (``reduce_scatter_tensor``);
- `psum`, `pmax`: ``lax.psum`` / ``lax.pmax``, replicated on every rank;
- `exclusive_psum`: the reference's exclusive prefix sum over the axis;
- `all_gather_blocks`: a sharded sweep's block gathered into its grid.

Integer sums are exact in any order, so they go through the backend's own
reduction. A float sum is summed here in rank order, from rank 0 up, after
an all-gather: the result is the same on every rank and from run to run,
and at world size 1 it is ``x`` itself.

Only collectives that exist across the supported torch versions are used:
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce`` and
``isend``/``recv``.

**Transport.** On an ``nccl`` group every tensor stays on the card. A
``gloo`` group whose tensors lie on the card (several ranks sharing one
card, which NCCL refuses) stages each collective through the host: the
tensor is copied to the CPU, reduced or gathered there, and copied back.
That is the stated transport of a gloo group on CUDA tensors, not a
fallback: nothing switches backend or device after an error. Booleans
travel as ``uint8``.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from sbr_tpu_torch.parallel.mesh import axis_index, axis_size


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it travels: on the host for a gloo group, bools as uint8."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    return x.contiguous()


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    y = y.to(like.device)
    return y.view(torch.bool) if like.dtype == torch.bool else y


def _quiet(collective, *args, **kwargs):
    """Run a collective without the deprecation notice newer torch gives
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor``: their named
    successors do not exist in every supported version, and the semantics
    are the same."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return collective(*args, **kwargs)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-gather along dim 0: the ranks' blocks in rank order."""
    group = mesh.get_group(axis)
    w = _wire(x, group)
    out = torch.empty((axis_size(mesh, axis) * w.shape[0],) + tuple(w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _quiet(dist.all_gather_into_tensor, out, w, group=group)
    return _back(out, x)


def _ordered_sum(blocks: torch.Tensor) -> torch.Tensor:
    """Σ over dim 0 in rank order: ((x0 + x1) + x2) + …"""
    acc = blocks[0].clone()
    for i in range(1, blocks.shape[0]):
        acc = acc + blocks[i]
    return acc


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the axis, replicated on every rank."""
    if x.is_floating_point():
        n = axis_size(mesh, axis)
        flat = x.reshape(1, *x.shape) if x.dim() == 0 else x
        blocks = all_gather(flat, mesh, axis).reshape((n,) + tuple(x.shape))
        return _ordered_sum(blocks)
    group = mesh.get_group(axis)
    w = _wire(x, group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _back(w, x)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Maximum over the axis (exact in any order), replicated."""
    group = mesh.get_group(axis)
    w = _wire(x, group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
    return _back(w, x)


def psum_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled psum_scatter along dim 0: rank i receives block i of the sum,
    by the backend's reduction (the sharded programs scatter integer
    counts, exact in any order). The length of ``x`` must divide by the
    axis size."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: length {x.shape[0]} does not divide by {n}")
    block = x.shape[0] // n
    group = mesh.get_group(axis)
    w = _wire(x, group)
    out = torch.empty((block,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    _quiet(dist.reduce_scatter_tensor, out, w, op=dist.ReduceOp.SUM, group=group)
    return _back(out, x)


def exclusive_psum(x: torch.Tensor, mesh, axis: str, n_dev: int | None = None) -> torch.Tensor:
    """Exclusive prefix sum over the axis: rank d receives Σ_{d' < d} x_{d'}
    (zeros on rank 0).

    The reference's schedule: ``n_dev − 1`` rotations of a ring, each rank
    passing what it holds to its successor, so peak memory stays O(len(x)).
    After i+1 rotations rank d holds x_{d−(i+1)} and adds it only when that
    is a genuine predecessor; so the sum is ((0 + x_{d−1}) + x_{d−2}) + …,
    nearest predecessor first, bitwise the reference's for floats too."""
    size = axis_size(mesh, axis)
    if n_dev is not None and int(n_dev) != size:
        raise ValueError(f"n_dev={n_dev} is not the size {size} of mesh axis {axis!r}")
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    d = axis_index(mesh, axis)
    excl = torch.zeros_like(x)
    cur = _wire(x, group).clone()
    for i in range(size - 1):
        nxt = torch.empty_like(cur)
        req = dist.isend(cur, dst=ranks[(d + 1) % size], group=group)
        dist.recv(nxt, src=ranks[(d - 1) % size], group=group)
        req.wait()
        cur = nxt
        if d > i:
            excl = excl + _back(cur, x)
    return excl


def all_gather_blocks(x, mesh, axes):
    """A block of a grid, sharded along its leading dims, gathered whole on
    every rank: ``axes[i]`` names the mesh axis dim i is cut along (None:
    not cut). A dataclass of tensors (a `Health`) is gathered leaf by leaf.
    The output of a sweep whose cells each rank solved for its own block."""
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: all_gather_blocks(getattr(x, f.name), mesh, axes)
            for f in dataclasses.fields(x)
        })
    for dim in reversed(range(len(axes))):
        if axes[dim] is None:
            continue
        x = all_gather(x.movedim(dim, 0).contiguous(), mesh, axes[dim]).movedim(0, dim)
    return x
