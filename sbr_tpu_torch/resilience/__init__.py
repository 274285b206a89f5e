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
  (``SBR_TILE_CACHE_DIR``).

The chaos drills of the reference (``resilience.chaos``) gate on its obs
report CLI and on the serving fleet, and wait for ROADMAP 1.A items 9 and
10; the obs events of every module here wait for item 9.

`faults` and `retry` are standard library only.
"""

from sbr_tpu_torch.resilience import elastic, faults, heal, retry, shutdown
from sbr_tpu_torch.resilience.elastic import TileCache
from sbr_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from sbr_tpu_torch.resilience.retry import RetryBudget, RetryError, RetryPolicy, policy_from_env
from sbr_tpu_torch.resilience.shutdown import graceful_shutdown

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "RetryBudget",
    "RetryError",
    "RetryPolicy",
    "TileCache",
    "elastic",
    "faults",
    "graceful_shutdown",
    "heal",
    "policy_from_env",
    "retry",
    "shutdown",
]
