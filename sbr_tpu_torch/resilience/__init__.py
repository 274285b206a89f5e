"""Resilience layer of the port (``sbr_tpu.resilience``):

- ``faults``: seeded fault plans (``SBR_FAULT_PLAN``) fired at named
  points of the tile loop, checkpoint IO, the tile cache, the multi-process
  barrier, the sweeps and the serving dispatch;
- ``retry``: the one retry policy (exponential backoff with jitter,
  deterministic against transient errors, shared budgets);
- ``heal``: sha256 sidecars with quarantine, and the degrade ladder that
  re-runs divergent cells at float64 with tightened tolerances;
- ``shutdown``: graceful SIGTERM/SIGINT, which removes partial temp files
  and hands back held leases and heartbeats;
- ``elastic``: the elastic sweep scheduler (heartbeats, throughput-weighted
  claim plans, leases) and the cross-run tile cache
  (``SBR_TILE_CACHE_DIR``);
- ``chaos``: the five recovery drills (``python -m
  sbr_tpu_torch.resilience.chaos [--churn|--fleet|--audit|--prewarm]``),
  which drive the tiled sweep, the elastic scheduler, the serving fleet,
  the numerics audit and the prefetch controller as worker processes and
  gate on the obs report CLI.

`faults`, `retry`, `shutdown` and `chaos` are standard library (and numpy)
only. The submodules and the names below load on first use, so the chaos
drills' own process, like the reference's, never imports torch: its
workers do.
"""

import importlib

_SUBMODULES = ("chaos", "elastic", "faults", "heal", "retry", "shutdown")
_NAMES = {
    "TileCache": "elastic",
    "FaultPlan": "faults",
    "InjectedFault": "faults",
    "RetryBudget": "retry",
    "RetryError": "retry",
    "RetryPolicy": "retry",
    "policy_from_env": "retry",
    "graceful_shutdown": "shutdown",
}

__all__ = sorted(set(_SUBMODULES) | set(_NAMES))


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAMES:
        return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
