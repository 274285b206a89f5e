"""Self-healing primitives: integrity sidecars, quarantine, and the
per-cell degrade ladder of divergent sweep cells; the port of
``sbr_tpu.resilience.heal``.

**Integrity sidecars.** Every written file gains a ``<file>.sha256``
sidecar (hex digest of its bytes, written after the file's atomic rename).
`verify_file` re-hashes on read: a mismatch means torn or bit-rotted
storage, and the file is quarantined (moved into ``quarantine/`` beside
it, never deleted: it is evidence) and the value recomputed. Files without
a sidecar verify as ``"legacy"`` and are trusted. The serving engine's
disk cache, the tiled sweep's checkpoints and the cross-run tile cache
(`resilience.elastic.TileCache`) all verify through them.

**Degrade ladder** (`repair_divergent`). A cell whose health bitmask
carries a divergent bit (NaN poison, a non-finite residual) is re-run
alone up a ladder of more conservative numerics:

- rung 0: the same config and dtype. It repairs transient garbage (and
  injected NaN poison) where the mathematics is fine; being
  deterministic, it cannot mask a genuine numerical failure, which
  recomputes divergent again and climbs;
- rung 1: float64 with doubled bisection halvings (at least 90).

A repaired cell replaces the original only when its recompute is not
divergent: the ladder only ever raises trust. The reference also logs
each outcome as an obs ``repair`` event; that waits for the port's run
log (ROADMAP 1.A item 9).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def sidecar_path(path) -> Path:
    return Path(str(path) + ".sha256")


def _digest(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_sidecar(path, source=None) -> Path:
    """Write (atomically) the sha256 sidecar for ``path``. ``source``
    (default ``path``) is the file whose bytes are hashed, so a writer can
    publish the sidecar of a staged temp file before renaming it into
    place."""
    side = sidecar_path(path)
    tmp = Path(str(side) + ".tmp")
    tmp.write_text(_digest(source if source is not None else path) + "\n")
    os.replace(tmp, side)
    return side


def verify_file(path) -> str:
    """``"ok"`` (digest matches), ``"legacy"`` (no sidecar; trusted), or
    ``"mismatch"`` (corrupt)."""
    side = sidecar_path(path)
    if not side.exists():
        return "legacy"
    try:
        stored = side.read_text().strip()
    except OSError:
        return "mismatch"
    return "ok" if stored and stored == _digest(path) else "mismatch"


def quarantine(path, reason: str = "sha256-mismatch") -> Optional[Path]:
    """Move a corrupt file (and its sidecar) into a ``quarantine/`` dir
    beside it: the evidence is kept and the slot freed for a recompute.
    Returns the quarantined path (None if the move itself failed).
    ``reason`` is the reference's obs label, unused until obs is ported."""
    path = Path(path)
    qdir = path.parent / "quarantine"
    qdir.mkdir(exist_ok=True)
    dest, i = qdir / path.name, 0
    while dest.exists():
        i += 1
        dest = qdir / f"{path.name}.{i}"
    try:
        os.replace(path, dest)
    except OSError:
        return None
    side = sidecar_path(path)
    if side.exists():
        try:
            os.replace(side, Path(str(dest) + ".sha256"))
        except OSError:
            pass
    return dest


# ---------------------------------------------------------------------------
# Degrade ladder
# ---------------------------------------------------------------------------


def _ladder(config, dtype) -> list:
    """(config, dtype) rungs, mildest first (module docstring). The
    reference also carries a flag that scopes JAX's x64 mode around rung 1,
    since a float64 request silently becomes float32 without it; torch has
    no such switch (``torch.float64`` is float64 on every device), so the
    port has no counterpart of that context."""
    tight = dataclasses.replace(config, bisect_iters=max(config.bisect_iters * 2, 90))
    return [(config, dtype), (tight, torch.float64)]


def repair_divergent(
    beta_values,
    u_values,
    base,
    config,
    dtype,
    arrays: dict,
    flags,
    scope: str = "tile",
    device=None,
) -> list:
    """Re-run every divergent cell of one tile up the degrade ladder on
    ``device`` (default: the CUDA card), patching ``arrays`` (the tile's
    host field dict, in place) where a rung gives a non-divergent
    replacement.

    ``flags`` is the tile's host health-flag grid. Returns the repairs
    report: one dict a divergent cell with its index (``cell``), its
    ``flags``, the ``rung`` that fixed it (or None), ``repaired`` and, when
    repaired, the recompute's ``new_flags``. ``scope`` is the reference's
    obs label, unused until obs is ported."""
    from sbr_tpu_torch.diag.health import DIVERGENT_MASK
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid
    from sbr_tpu_torch.utils.checkpoint import to_host

    flags = np.asarray(flags)
    divergent = np.argwhere((flags & DIVERGENT_MASK) != 0)
    if divergent.size == 0:
        return []
    beta_values = np.asarray(beta_values)
    u_values = np.asarray(u_values)
    names = list(arrays)
    report = []
    for i, j in divergent:
        i, j = int(i), int(j)
        entry = {"cell": [i, j], "flags": int(flags[i, j]), "rung": None, "repaired": False}
        for rung, (cfg, dt) in enumerate(_ladder(config, dtype)):
            cell = beta_u_grid(beta_values[i : i + 1], u_values[j : j + 1], base,
                               config=cfg, dtype=dt, device=device)
            leaves = [getattr(cell, f) for f in names]
            if cell.health is not None:
                leaves.append(cell.health.flags)
            host = to_host(*leaves)
            new_flags = int(host[-1].reshape(())) if cell.health is not None else 0
            if new_flags & DIVERGENT_MASK:
                continue  # still divergent: climb the ladder
            for f, v in zip(names, host):
                arrays[f][i, j] = v.reshape(())
            entry.update(rung=rung, repaired=True, new_flags=new_flags)
            break
        report.append(entry)
    return report
