"""Host-side helpers of the port (``sbr_tpu.utils``): status accounting,
the canonical parameter fingerprints and the tiled, checkpointed β×u
sweep."""

from sbr_tpu_torch.utils.checkpoint import canonicalize, params_fingerprint, run_tiled_grid
from sbr_tpu_torch.utils.status import status_counts, status_summary

__all__ = [
    "canonicalize",
    "params_fingerprint",
    "run_tiled_grid",
    "status_counts",
    "status_summary",
]
