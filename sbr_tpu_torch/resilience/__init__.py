"""Resilience helpers of the port (``sbr_tpu.resilience``): the unified
retry policy (`retry`) and the integrity sidecars with quarantine
(`heal`). Fault injection, the degrade ladder, the elastic tile cache and
graceful shutdown are not ported yet (ROADMAP item E.19)."""

from sbr_tpu_torch.resilience import heal, retry

__all__ = ["heal", "retry"]
