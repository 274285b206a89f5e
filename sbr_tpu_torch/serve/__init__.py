"""Equilibrium serving layer of the port (``sbr_tpu.serve``): a
long-lived query engine with live, queryable-while-alive metrics.

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
- ``serve.fleet``: the dispatch `CircuitBreaker` and the default deadline;
- ``serve.loadgen``: ``python -m sbr_tpu_torch.serve.loadgen``, the
  seeded query mix in direct mode.

Request tracing, the flight recorder, the demand observatory and the
numerics audit of the query path live in ``obs.trace``, ``obs.flight``,
``obs.demand`` and ``obs.audit``. The router, the fleet workers (with the
audit's heartbeat block and quarantine) and prewarm are not ported yet
(ROADMAP 1.A item 10).
"""

from sbr_tpu_torch.serve.endpoint import ServeEndpoint
from sbr_tpu_torch.serve.engine import (
    DeadlineExceeded,
    Engine,
    QueryResult,
    ServeConfig,
    SolverUnavailable,
)
from sbr_tpu_torch.serve.fleet import CircuitBreaker
from sbr_tpu_torch.serve.live import LiveMetrics

__all__ = [
    "CircuitBreaker",
    "DeadlineExceeded",
    "Engine",
    "LiveMetrics",
    "QueryResult",
    "ServeConfig",
    "ServeEndpoint",
    "SolverUnavailable",
]
