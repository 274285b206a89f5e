"""Run telemetry of the port: the port of ``sbr_tpu.obs``'s run-log core.

- ``obs.timing``  — `fence` (waits for the CUDA devices of its tensors),
  `StageTimer`, and `trace`, a `torch.profiler` capture.
- ``obs.metrics`` — the process-global counters/gauges/timers registry
  (``obs.metrics.metrics()``) and the log-bucketed latency histograms
  that the serving engine folds.
- ``obs.runlog``  — `RunContext` per-run directories (``events.jsonl`` +
  ``manifest.json``), `span` stage tracing, `jit_call` program-call
  attribution, status and numerical-health censuses (`log_status`,
  `log_health`), memory snapshots and run-directory retention (`gc_runs`,
  ``SBR_OBS_KEEP``).
- ``obs.prof``    — the trace registry (`note_trace`, `note_call`, the
  ``retrace`` warning) and opt-in profiler capture (`profile`,
  ``SBR_OBS_PROFILE=1``) with `annotate` / `step_annotation` ranges.
- ``obs.mem``     — memory attribution (``mem`` events), the fail-closed
  OOM preflight over measured footprints, and the ``tile_shape="auto"``
  capacity planner.

Unlike the reference, ``obs.metrics`` here is the module; the registry is
``obs.metrics.metrics()``. The reference's ``history``, ``trace``,
``report``, ``flight``, ``demand`` and ``audit`` are not ported yet.

Enabling telemetry: set ``SBR_OBS=1`` (run directories land under
``SBR_OBS_DIR``, default ``obs_runs/``), or::

    from sbr_tpu_torch import obs
    with obs.run_context(label="sweep") as run:
        grid = beta_u_grid(...)
    print(run.run_dir)  # manifest.json + events.jsonl

Disabled (the default), every instrumentation site is one global read: no
events, no fences, no extra device work.
"""

from sbr_tpu_torch.obs import mem, metrics, prof
from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LogHistogram, MetricsRegistry, log_bounds
from sbr_tpu_torch.obs.prof import annotate, note_call, note_trace, profile, step_annotation
from sbr_tpu_torch.obs.runlog import (
    RunContext,
    active_run,
    active_span,
    current_run,
    enabled,
    end_run,
    event,
    gc_runs,
    interrupt_all,
    jit_call,
    log_audit,
    log_cache,
    log_demand,
    log_fault,
    log_fleet,
    log_health,
    log_infomodel,
    log_prewarm,
    log_repair,
    log_retry,
    log_scheduler,
    log_status,
    log_tile_mem,
    program,
    run_context,
    span,
    start_run,
    suspended,
)
from sbr_tpu_torch.obs.timing import StageTimer, fence

__all__ = [
    "DEFAULT_LATENCY_BOUNDS_MS",
    "LogHistogram",
    "MetricsRegistry",
    "RunContext",
    "StageTimer",
    "active_run",
    "active_span",
    "annotate",
    "current_run",
    "enabled",
    "end_run",
    "event",
    "fence",
    "gc_runs",
    "interrupt_all",
    "jit_call",
    "log_audit",
    "log_bounds",
    "log_cache",
    "log_demand",
    "log_fault",
    "log_fleet",
    "log_health",
    "log_infomodel",
    "log_prewarm",
    "log_repair",
    "log_retry",
    "log_scheduler",
    "log_status",
    "log_tile_mem",
    "mem",
    "metrics",
    "note_call",
    "note_trace",
    "prof",
    "profile",
    "program",
    "run_context",
    "span",
    "start_run",
    "step_annotation",
    "suspended",
]
