"""Host-side helpers of the port (``sbr_tpu.utils``): status accounting."""

from sbr_tpu_torch.utils.status import status_counts, status_summary

__all__ = ["status_counts", "status_summary"]
