"""Equilibrium serving layer of the port (``sbr_tpu.serve``): a
long-lived query engine with live, queryable-while-alive metrics, and the
multi-process serving fleet in front of it.

- ``serve.engine``: `Engine`, micro-batched (`ModelParams`, scenario)
  queries padded to a bucket ladder, one CUDA graph captured per bucket
  of the sweeps' `solve_param_cell`, an LRU and an on-disk result cache
  keyed by `utils.checkpoint.params_fingerprint` and the backend tag;
  composed-scenario and population queries (`Engine.query_scenario`,
  `Engine.query_population`) in the same caches;
- ``serve.live``: `LiveMetrics`, windowed and lifetime counters,
  log-bucket latency histograms and the CUDA-graph counters;
- ``serve.endpoint``: `ServeEndpoint`, stdlib HTTP ``/metrics``,
  ``/healthz``, ``/statz`` and ``POST /query``;
- ``serve.fleet``: fleet membership (elastic heartbeats in a shared
  ``SBR_FLEET_DIR``), the `CircuitBreaker`, the `TileCacheBridge` rung of
  the degradation ladder, and the worker process (``python -m
  sbr_tpu_torch.serve.fleet``) with its graceful SIGTERM drain;
- ``serve.router``: `Router`, throughput-weighted routing over the live
  workers with failover, hedging, deadline propagation, per-worker
  breakers and the audit quarantine (``python -m
  sbr_tpu_torch.serve.router``);
- ``serve.prewarm``: the prefetch controller (``SBR_PREWARM``) and the
  standalone sweeper (``python -m sbr_tpu_torch.serve.prewarm``);
- ``serve.loadgen``: ``python -m sbr_tpu_torch.serve.loadgen``, the
  seeded query mix in direct mode, and through a fleet of worker
  processes with ``--fleet N``.

Request tracing, the flight recorder, the demand observatory and the
numerics audit of the query path live in ``obs.trace``, ``obs.flight``,
``obs.demand`` and ``obs.audit``. Gate a served run with ``python -m
sbr_tpu_torch.obs.report serve RUN_DIR``, a router run with ``... fleet
RUN_DIR`` and a prewarm run with ``... prewarm RUN_DIR``.

The names below load on first use (PEP 562), so ``python -m
sbr_tpu_torch.serve.fleet`` (or ``.router``) runs its module once, and the
router imports no engine.
"""

import importlib

_EXPORTS = {
    "ServeEndpoint": "sbr_tpu_torch.serve.endpoint",
    "DeadlineExceeded": "sbr_tpu_torch.serve.engine",
    "Engine": "sbr_tpu_torch.serve.engine",
    "QueryResult": "sbr_tpu_torch.serve.engine",
    "ServeConfig": "sbr_tpu_torch.serve.engine",
    "SolverUnavailable": "sbr_tpu_torch.serve.engine",
    "CircuitBreaker": "sbr_tpu_torch.serve.fleet",
    "TileCacheBridge": "sbr_tpu_torch.serve.fleet",
    "LiveMetrics": "sbr_tpu_torch.serve.live",
    "Router": "sbr_tpu_torch.serve.router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
