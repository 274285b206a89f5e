"""Host-side helpers of the port (``sbr_tpu.utils``): status accounting
and the canonical parameter fingerprints."""

from sbr_tpu_torch.utils.checkpoint import canonicalize, params_fingerprint
from sbr_tpu_torch.utils.status import status_counts, status_summary

__all__ = ["canonicalize", "params_fingerprint", "status_counts", "status_summary"]
