"""Integrity sidecars and quarantine: the port of the sidecar helpers of
``sbr_tpu.resilience.heal`` (`sidecar_path`, `write_sidecar`,
`verify_file`, `quarantine`). The serving engine's disk result cache
verifies on read with them.

Every written file gains a ``<file>.sha256`` sidecar (hex digest of its
bytes, written after the file's atomic rename). `verify_file` re-hashes
on read: a mismatch means torn or bit-rotted storage, and the file is
quarantined (moved into ``quarantine/`` beside it, never deleted: it is
evidence) and the value recomputed. Files without a sidecar verify as
``"legacy"`` and are trusted. The degrade ladder of that module
(`repair_divergent`) is not ported yet (ROADMAP item E.19), nor its obs
``repair`` events.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional


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
