"""Sweep farming across processes through a shared checkpoint directory:
the storage-only part of ``sbr_tpu.parallel.distributed``.

β×u cells are independent, so processes need not share a device or a
process group: `run_tiled_grid_multihost` splits the tiles between them
and uses the checkpoint directory (`utils.checkpoint`) as the rendezvous.
Every finished tile is an atomically renamed npz, any process can adopt
any tile from disk, and the assembly pass is a pure read.

**Elastic mode** (the default; ``SBR_ELASTIC=0`` or ``elastic=False``
turns it off): every process runs the elastic scheduler
(`resilience.elastic.run_elastic_grid`): heartbeats, a throughput-weighted
claim plan over the remaining tiles, per-tile leases and the cross-run
tile cache. Processes may join or leave at any point; the grid is
byte-identical whatever the churn.

**Static split** (``elastic=False``): each process computes its
`tile_assignment` share, then waits at a filesystem barrier. After
``steal_grace_s`` (``SBR_STEAL_GRACE_S``, default 300 s) without a new
tile landing, a waiting process leases the stalled tiles (atomic
``O_EXCL`` lease files, JSON ``{pid, host, nonce, ts, ttl_s}``; an expired
lease, TTL ``SBR_STEAL_LEASE_TTL_S`` default 900 s, is taken over) and
computes them itself.

`initialize_distributed` and the mesh helpers of the reference wait for
ROADMAP 1.A item 11; the static split takes its default rank and world
size from ``torch.distributed`` when a process group is initialized.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from pathlib import Path
from typing import Optional

import numpy as np

from sbr_tpu_torch.resilience import faults, shutdown


def tile_assignment(n_tiles: int, n_processes: int, process_id: int) -> range:
    """Contiguous balanced split: process p owns tiles [start_p, end_p).
    Every tile has exactly one owner; sizes differ by at most 1."""
    if not 0 <= process_id < n_processes:
        raise ValueError(f"process_id {process_id} not in [0, {n_processes})")
    base, rem = divmod(n_tiles, n_processes)
    start = process_id * base + min(process_id, rem)
    return range(start, start + base + (1 if process_id < rem else 0))


def _lease_path(ckpt: Path, bi: int, ui: int) -> Path:
    return ckpt / f"tile_b{bi:05d}_u{ui:05d}.lease"


def _cleanup_leases(ckpt) -> None:
    """Drop leases of tiles that now exist: leases are scaffolding."""
    for lease in Path(ckpt).glob("tile_*.lease"):
        if lease.with_suffix(".npz").exists():
            try:
                lease.unlink()
            except OSError:
                pass


def _try_lease(ckpt, bi: int, ui: int, ttl_s: float) -> bool:
    """Claim the lease of tile (bi, ui): an atomic ``O_EXCL`` create, or the
    takeover of a lease whose holder's TTL has lapsed. False: a live holder
    has it.

    A takeover writes a per-claim nonce and re-reads the lease after its
    ``os.replace``: of two processes racing for one expired lease only the
    one whose nonce survives proceeds."""
    ckpt = Path(ckpt)
    lease = _lease_path(ckpt, bi, ui)
    nonce = uuid.uuid4().hex
    record = json.dumps({
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "nonce": nonce,
        "ts": time.time(),
        "ttl_s": ttl_s,
    })
    try:
        fd = os.open(lease, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            held = json.loads(lease.read_text())
            # the holder's own TTL; strict `<`: a lease exactly at its TTL
            # has expired
            if time.time() - float(held.get("ts", 0.0)) < float(held.get("ttl_s", ttl_s)):
                return False
        except (OSError, ValueError):
            pass  # an unreadable lease is a dead holder's torn write
        tmp = ckpt / f"{lease.name}.{os.getpid()}.tmp"
        try:
            tmp.write_text(record)
            os.replace(tmp, lease)
            now_held = json.loads(lease.read_text())
        except (OSError, ValueError):
            return False
        return now_held.get("nonce") == nonce
    with os.fdopen(fd, "w") as f:
        f.write(record)
    return True


def _default_rank_and_world(process_id, num_processes):
    """``torch.distributed``'s rank and world size when a process group is
    initialized, else 0 and 1 (the reference reads ``jax.process_index()``
    and ``jax.process_count()``)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if process_id is None:
        process_id = dist.get_rank() if live else 0
    if num_processes is None:
        num_processes = dist.get_world_size() if live else 1
    return int(process_id), int(num_processes)


def run_tiled_grid_multihost(
    beta_values,
    u_values,
    base,
    checkpoint_dir: str,
    config=None,
    tile_shape=(256, 256),
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    wait: bool = True,
    poll_s: float = 5.0,
    timeout_s: float = 24 * 3600.0,
    dtype=None,
    verbose: bool = False,
    work_steal: bool = True,
    steal_grace_s: Optional[float] = None,
    lease_ttl_s: Optional[float] = None,
    elastic: Optional[bool] = None,
    heartbeat_ttl_s: Optional[float] = None,
    tile_cache_dir=None,
    device=None,
    report: Optional[dict] = None,
):
    """Farm a β×u grid across processes through the shared checkpoint
    directory (module docstring). Tiles compute on ``device`` (default: the
    CUDA card; raises without one).

    Elastic mode (the default) ignores ``process_id`` / ``num_processes``.
    ``work_steal=False`` promises that this process computes only its own
    share and that a dead peer surfaces as ``TimeoutError``, which the
    elastic scheduler cannot honour, so it selects the static split too.

    With ``wait`` (default) the process polls until every tile exists and
    returns the assembled grid; with ``wait=False`` it returns None after
    its own share. A dict passed as ``report`` receives the elastic
    scheduler's report (`resilience.elastic.run_elastic_grid`)."""
    from sbr_tpu_torch.resilience import elastic as elastic_mod
    from sbr_tpu_torch.utils.checkpoint import (
        _tile_path,
        resolve_tile_shape,
        run_tiled_grid,
        tile_origins,
    )

    if elastic_mod.elastic_enabled(elastic) and work_steal:
        return elastic_mod.run_elastic_grid(
            beta_values, u_values, base, checkpoint_dir, config=config,
            tile_shape=tile_shape, dtype=dtype, wait=wait, poll_s=poll_s,
            timeout_s=timeout_s, verbose=verbose, lease_ttl_s=lease_ttl_s,
            heartbeat_ttl_s=heartbeat_ttl_s, tile_cache_dir=tile_cache_dir,
            device=device, report=report,
        )

    process_id, num_processes = _default_rank_and_world(process_id, num_processes)
    nb, nu = len(np.asarray(beta_values)), len(np.asarray(u_values))
    resolved_shape, _ = resolve_tile_shape(nb, nu, tile_shape, config, dtype)
    tiles = tile_origins(nb, nu, resolved_shape)
    owned = {tiles[i] for i in tile_assignment(len(tiles), num_processes, process_id)}
    common = dict(config=config, tile_shape=tile_shape, checkpoint_dir=checkpoint_dir,
                  dtype=dtype, device=device)

    run_tiled_grid(beta_values, u_values, base, verbose=verbose,
                   tile_owner=lambda bi, ui: (bi, ui) in owned, **common)
    if not wait:
        return None

    # The barrier: every tile must exist before assembly. After the grace
    # period, missing tiles are adopted under leases. The whole barrier runs
    # inside the shutdown envelope, so a SIGTERM in a poll's sleep still
    # hands back any held lease.
    if steal_grace_s is None:
        steal_grace_s = float(os.environ.get("SBR_STEAL_GRACE_S", "300"))
    if lease_ttl_s is None:
        lease_ttl_s = float(os.environ.get("SBR_STEAL_LEASE_TTL_S", "900"))

    ckpt = Path(checkpoint_dir)
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    # the grace clock runs from the last drop in the missing count, so a
    # slow peer that keeps landing tiles is never stolen from
    last_progress = t0
    n_missing_prev: Optional[int] = None
    with shutdown.graceful_shutdown(label="multihost_barrier"):
        while True:
            missing = [t for t in tiles if not _tile_path(ckpt, *t).exists()]
            if not missing:
                break
            if n_missing_prev is not None and len(missing) < n_missing_prev:
                last_progress = time.monotonic()
            n_missing_prev = len(missing)
            faults.fire("barrier.poll", target=f"missing={len(missing)}")
            if work_steal and time.monotonic() - last_progress >= steal_grace_s:
                # lease the whole stalled batch, then compute it in one pass
                leased = []
                for bi, ui in missing:
                    if _tile_path(ckpt, bi, ui).exists():
                        continue
                    if _try_lease(ckpt, bi, ui, lease_ttl_s):
                        shutdown.release_on_exit(_lease_path(ckpt, bi, ui))
                        leased.append((bi, ui))
                if leased:
                    leased_set = set(leased)
                    if verbose:
                        print(f"  adopting {len(leased)} orphaned tile(s): {leased} …")
                    try:
                        run_tiled_grid(beta_values, u_values, base, verbose=False,
                                       tile_owner=lambda b, u: (b, u) in leased_set, **common)
                    finally:
                        for bi, ui in leased:
                            lease = _lease_path(ckpt, bi, ui)
                            try:
                                lease.unlink()
                            except OSError:
                                pass
                            shutdown.unregister_release(lease)
                    last_progress = time.monotonic()
                    continue
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(missing)} tiles still missing after {timeout_s:.0f}s "
                    f"(first: {missing[0]}); a peer process likely died and its "
                    "tiles could not be adopted (work stealing "
                    f"{'on' if work_steal else 'off'}) — rerun with its "
                    "process_id (or a smaller num_processes) to adopt its tiles."
                )
            if verbose:
                print(f"  waiting on {len(missing)} peer tiles …")
            time.sleep(poll_s)

    _cleanup_leases(ckpt)
    return run_tiled_grid(beta_values, u_values, base, verbose=verbose, **common)
