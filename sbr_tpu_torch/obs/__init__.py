"""Run telemetry of the port: the port of ``sbr_tpu.obs``'s run-log core.

- ``obs.timing``  — `fence` (waits for the CUDA devices of its tensors)
  and `StageTimer`.
- ``obs.metrics`` — the process-global counters/gauges/timers registry
  (``obs.metrics.metrics()``) and the log-bucketed latency histograms
  that the serving engine folds.
- ``obs.runlog``  — `RunContext` per-run directories (``events.jsonl`` +
  ``manifest.json``), `span` stage tracing, `jit_call` program-call
  attribution, status and numerical-health censuses (`log_status`,
  `log_health`), memory snapshots and run-directory retention (`gc_runs`,
  ``SBR_OBS_KEEP``).
- ``obs.prof``    — the trace registry (`note_trace`, `note_call`, the
  ``retrace`` warning), the port's one profiler capture (`profile`,
  ``SBR_OBS_PROFILE=1``), and the `annotate` / `step_annotation` ranges
  that every span opens while any torch profiler records.
- ``obs.mem``     — memory attribution (``mem`` events), the fail-closed
  OOM preflight over measured footprints, and the ``tile_shape="auto"``
  capacity planner.

- ``obs.trace``   — the request-tracing module: per-query spans across the
  endpoint and the engine's layers, committed to the run's ``trace.jsonl``
  (``SBR_TRACE_SAMPLE``), and the per-layer span histograms on ``/metrics``.
- ``obs.flight``  — the dispatch-pipeline flight recorder (``SBR_FLIGHT``):
  a lock-free ring of engine, sweep and barrier spans folded into
  device-busy and host-gap fractions (``flight.json``).
- ``obs.demand``  — the workload demand observatory (``SBR_DEMAND``): the
  (β, u) demand histogram, the heavy-hitter sketch and the prefetch
  advisor's plan (``demand.json``, ``advisor_plan.json``).
- ``obs.audit``   — the numerics audit: the versioned golden-surface
  registry, the canary battery (``python -m sbr_tpu_torch.obs.audit``),
  the serving engine's ``SBR_AUDIT`` scheduler and `run_legacy_cli`, the
  protocol of the four parity CLIs. It imports no torch until a probe
  runs, and loads on first use.
- ``obs.history`` — the append-only perf history (``bench_history.jsonl``,
  the port's own file) and the trend gate (``report trend --check``).
- ``obs.report``  — ``python -m sbr_tpu_torch.obs.report RUN_DIR [OTHER]``
  renders or diffs runs; its subcommands (``health``, ``resilience``,
  ``elastic``, ``infomodel``, ``grad``, ``memory``, ``serve``, ``fleet``,
  ``trace``, ``slo``, ``util``, ``demand``, ``prewarm``, ``audit``,
  ``summary``, ``trend``, ``gc``) gate on them with the reference's
  documents and exit codes; ``fleet`` reads a router run's rolling
  ``fleet.json`` and ``fleet`` events (exit 1 on a lost query or a breaker
  stuck open), ``summary`` folds every gate over one run directory.

As in the reference, ``obs.trace`` is the request-tracing module; the
profiler capture is ``obs.prof.profile``. Unlike the reference,
``obs.metrics`` here is the module; the registry is
``obs.metrics.metrics()``. ``trace``, ``flight``, ``demand``, ``audit``,
``history`` and ``report`` import no torch (nor does this package until
`fence` or `StageTimer` is used), so a report never pays for a device
runtime; ``trace``, ``flight``, ``demand``, ``audit`` and ``report`` load
on first use, so a serving engine with ``SBR_FLIGHT``, ``SBR_DEMAND`` and
``SBR_AUDIT`` off never imports those three.

Enabling telemetry: set ``SBR_OBS=1`` (run directories land under
``SBR_OBS_DIR``, default ``obs_runs/``), or::

    from sbr_tpu_torch import obs
    with obs.run_context(label="sweep") as run:
        grid = beta_u_grid(...)
    print(run.run_dir)  # manifest.json + events.jsonl

Disabled (the default), every instrumentation site is one global read: no
events, no fences, no extra device work.
"""

import importlib
import os


def switch_on(var: str) -> bool:
    """Whether the on/off switch ``var`` (``SBR_FLIGHT``, ``SBR_DEMAND``, ...)
    is on: set to anything but empty or ``0``. The engine and the tile
    runner read their recorders' switches through it, so an off switch
    never imports the recorder's module."""
    return os.environ.get(var, "").strip() not in ("", "0")


from sbr_tpu_torch.obs import history, mem, metrics, prof
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


def __getattr__(name: str):
    # ``obs.timing`` imports torch, so its names load on first use; so do
    # ``report`` (which ``python -m`` must find unimported) and the
    # switch-gated ``flight`` and ``demand`` (off, they stay unimported).
    if name in ("StageTimer", "fence"):
        return getattr(importlib.import_module(f"{__name__}.timing"), name)
    if name in ("audit", "demand", "flight", "report", "trace"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_LATENCY_BOUNDS_MS",
    "LogHistogram",
    "MetricsRegistry",
    "RunContext",
    "StageTimer",
    "active_run",
    "active_span",
    "annotate",
    "audit",
    "current_run",
    "demand",
    "enabled",
    "end_run",
    "event",
    "fence",
    "flight",
    "gc_runs",
    "history",
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
    "report",
    "run_context",
    "span",
    "start_run",
    "step_annotation",
    "suspended",
    "switch_on",
    "trace",
]
