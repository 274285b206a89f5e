"""Structured status accounting: the port of ``sbr_tpu.utils.status``.
Every sweep returns an int32 status tensor (`models.results.Status`); these
helpers turn it into the reference's accounting on the host."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sbr_tpu_torch.models.results import Status

# Codes outside the Status enum are counted under this key, so counts
# always sum to the grid size.
UNKNOWN_KEY = "UNKNOWN"


def _host(status) -> np.ndarray:
    if isinstance(status, torch.Tensor):
        return status.detach().cpu().numpy()
    return np.asarray(status)


def status_counts(status) -> Dict[str, int]:
    """Histogram of `Status` codes, in enum declaration order, then
    ``UNKNOWN`` (out-of-enum codes) last."""
    status = _host(status)
    counts = {s.name: int((status == int(s)).sum()) for s in Status}
    unknown = int(status.size) - sum(counts.values())
    if unknown:
        counts[UNKNOWN_KEY] = unknown
    return counts


def status_summary(status) -> str:
    """One-line summary: run cells against the no-run region, e.g.
    ``"3/4 run, 1 no_crossing"``."""
    counts = status_counts(status)
    total = int(_host(status).size)
    run = counts.get("RUN", 0)
    parts = [f"{run}/{total} run"]
    parts += [f"{v} {k.lower()}" for k, v in counts.items() if k != "RUN" and v]
    return ", ".join(parts)
