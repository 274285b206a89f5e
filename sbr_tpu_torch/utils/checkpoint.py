"""Canonical parameter fingerprints: the port of the keying helpers of
``sbr_tpu.utils.checkpoint`` (`canonicalize`, `params_fingerprint`).

The canonical form is the reference's, character for character, so the
port's `ModelParams` (whose class and field names are the reference's)
fingerprints to the same sha256 hex as ``sbr_tpu``'s on the same values.
The tiled sweep runner of that module (`TileRunner`, `run_tiled_grid`)
is not ported yet (ROADMAP item E.19).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def canonicalize(obj) -> str:
    """Deterministic textual form of a parameter pytree — the canonical
    input to `params_fingerprint`.

    The same logical structure gives the same string across processes,
    interpreter restarts and dict insertion orders. Dataclasses render as
    ``TypeName(field=..., ...)`` with fields sorted by name; dicts sort by
    key; floats use Python's shortest round-trip ``repr``; numpy scalars
    and arrays hash dtype + raw bytes. Any other type raises
    ``TypeError``, a ``torch.Tensor`` included: a cache key must never
    depend on a ``repr`` that holds a memory address or a device.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        inner = ",".join(
            f"{name}={canonicalize(getattr(obj, name))}"
            for name in sorted(f.name for f in dataclasses.fields(obj))
        )
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: canonicalize(kv[0]))
        return "{" + ",".join(f"{canonicalize(k)}:{canonicalize(v)}" for k, v in items) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ",".join(canonicalize(v) for v in obj) + "]"
    if obj is None or isinstance(obj, (bool, int, str, bytes, float)):
        return repr(obj)
    if isinstance(obj, np.generic):
        return f"{obj.dtype.name}:{obj.item()!r}"
    if isinstance(obj, np.ndarray):
        return (
            f"ndarray{tuple(obj.shape)}:{obj.dtype.name}:"
            f"{np.ascontiguousarray(obj).tobytes().hex()}"
        )
    raise TypeError(
        f"canonicalize: unsupported type {type(obj).__name__} — extend the "
        "canonical form rather than falling back to repr (addresses would "
        "make fingerprints process-local)"
    )


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float32", "float64"): the
    form the reference's fingerprints render a dtype in."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def params_fingerprint(params) -> str:
    """Stable sha256 hex of a parameter pytree (`ModelParams`,
    `SolverConfig`, or any nesting of dataclasses, dicts, sequences and
    scalars); see `canonicalize` for the stability contract. The serving
    engine's result cache keys on it."""
    return hashlib.sha256(canonicalize(params).encode()).hexdigest()
