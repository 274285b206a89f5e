"""Observability helpers of the port (``sbr_tpu.obs``): so far only the
log-bucketed latency histograms of `metrics`, which the serving engine's
live metrics fold. The run log, tracing, profiling counters, the flight
recorder, demand and audit wait for ROADMAP item 1.A 9."""

from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LogHistogram, log_bounds

__all__ = ["DEFAULT_LATENCY_BOUNDS_MS", "LogHistogram", "log_bounds"]
