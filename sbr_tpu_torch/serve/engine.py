"""Long-lived equilibrium query engine: the port of the core of
``sbr_tpu.serve.engine``.

- **Queries** are (`ModelParams`, scenario tag) pairs. `query` and
  `query_many` are synchronous; `submit` returns a ticket. A background
  micro-batcher thread drains the queue and batches concurrent queries
  into ONE dispatch of the same `solve_param_cell` the β×u grid sweeps
  run, every parameter per lane, so a served query and a sweep cell can
  never drift.
- **Pad-to-bucket batching**: batches are padded up to a fixed bucket
  ladder (``SBR_SERVE_BUCKETS``, default 1,8,64,512) with copies of their
  first query, and the padded lanes are discarded. Lanes are independent,
  so an answer is bitwise the same in every bucket.
- **One CUDA graph per bucket** in place of the reference's compiled
  executables: the first dispatch of a bucket on the card captures the
  solve, reading a static (9, bucket) input buffer, into a
  ``torch.cuda.CUDAGraph``; later dispatches copy the columns in, replay,
  and fetch the six outputs (ξ, τ̄_IN, AW_max, status, flags, residual) in
  one device-to-host copy. The adaptive root-find runs its whole budget
  inside the graph (`core.rootfind.no_host_reads`), with results bitwise
  equal to the eager solve. On the CPU the same program runs eagerly. A
  capture that fails raises; the engine never falls back to eager on the
  card. A CUDA graph cannot be serialized across processes, so the
  reference's reload of executables from the cache directory has no
  counterpart (``statz`` says so).
- **Result cache**: an in-memory LRU plus an optional on-disk layer
  (``SBR_SERVE_CACHE_DIR``, sha256 sidecars verified on read, pruned at
  ``SBR_SERVE_DISK_CAP``), keyed by `utils.checkpoint.params_fingerprint`
  of the params with the solver config, the dtype, the program version
  and the backend tag ``"torch"``: a torch answer can never be served as
  an ``sbr_tpu`` one.
- **Resilience**: dispatches run under the retry policy
  (``SBR_SERVE_RETRY_*``) with a shared, refilling `RetryBudget`
  (``SBR_SERVE_RETRY_BUDGET``, ``SBR_SERVE_RETRY_REFILL_S``) and a
  circuit breaker (``SBR_BREAKER_*``); admission sheds queries whose
  deadline (``SBR_SERVE_DEADLINE_MS``) has passed or is shorter than the
  measured service time.
- **Degradation ladder**: when a dispatch fails (breaker open, retry
  budget exhausted, a fault injected at ``serve.dispatch``), each of its
  queries is looked up in the cross-run tile cache
  (``SBR_TILE_CACHE_DIR``, `fleet.TileCacheBridge`): a swept cell whose
  tag and (β, u) match the query exactly answers it, with source
  ``"tilecache"`` and ``degraded`` set; otherwise the ticket fails and the
  ladder counts it ``ladder_exhausted``. Degraded answers are never
  cached.

- **Sensitivities** (``grads=True``): the answer carries dξ/dβ, dξ/du and
  dξ/dκ, the IFT gradients of `grad.api.cell_value_and_grads`, and their
  grad-trust flags beside ξ. Grads queries dispatch through their own
  program per bucket: the plain `solve_param_cell` (so the served ξ,
  status and flags are the plain program's bit for bit) plus the
  differentiable cell's forward and backward. That program is captured
  into a CUDA graph on the card exactly as the plain one is, the autograd
  backward inside the capture (the IFT backward reads nothing on the
  host); there is no eager fallback. Its results are keyed apart from the
  plain ones, by the grads bit and the resolved `grad.cell.aprime_tol`.

- **Composed scenarios and population what-ifs** (`query_scenario`,
  `query_population`) run in the calling thread, one solve a query (their
  programs differ by spec, so they do not micro-batch), under the same
  admission control and in the same LRU + verified disk cache, keyed by
  `scenario.spec_fingerprint` / `infomodels.population_fingerprint` of the
  query with the engine's tag. Their device work holds the dispatch lock,
  so it never overlaps a bucket's capture or replay. A population query
  launches the CUDA infection or belief kernel every step of every member.

**Run directory.** ``Engine(run_dir=...)`` (or ``run=``, or an active obs
run) writes the rolling ``live.json`` and the obs events of the serving
path: ``fleet`` events for sheds (``expired``, ``unmeetable``,
``queue-expired``), breaker transitions and the ladder's ``degraded`` /
``ladder_exhausted``, a ``serve.compile[...]`` span around each bucket's
first build (on the card its capture), ``serve_batch`` per dispatch and a
``serve_summary`` at close; ``python -m sbr_tpu_torch.obs.report serve``
gates on it.

**Telemetry of the query path**, each off by default:

- request tracing (`obs.trace`): a query given a ``TraceContext``
  (``trace=`` on `submit` and `query`, ``traces=`` on `query_many`) gets
  the spans ``engine.admission``, ``engine.queue``, ``engine.cache``
  (``lru`` and ``disk`` outcomes), ``engine.batch`` and
  ``engine.dispatch`` (or ``engine.tilecache`` on the ladder) under its
  ``engine.query`` span, which closes when the ticket is fulfilled, shed
  or failed. The root owner commits them through `trace_writer`;
- the flight recorder (``SBR_FLIGHT``, `obs.flight`): admission, queue,
  cache, batch, dispatch and unpack spans, the occupancy, queue-depth and
  shed points, into ``flight.json``. The dispatch span closes after the
  program's device-to-host copy, the port's fence;
- the demand observatory (``SBR_DEMAND``, `obs.demand`): every answered
  query, with its source, into ``demand.json`` and, at close,
  ``advisor_plan.json`` (coverage from the bridged tile cache);
- the numerics audit (``SBR_AUDIT``, `obs.audit`): an `AuditScheduler`
  runs the canary battery on the engine's device in its dtype while the
  engine is idle, each probe under the dispatch lock; ``/statz`` gains its
  ``audit`` snapshot, ``/metrics`` ``sbr_audit_status`` and the per-probe
  ``sbr_audit_probe_ms`` histograms, and a drift verdict latches
  ``/healthz`` degraded with an ``audit_drift: <probes>`` reason.

- the prefetch controller (``SBR_PREWARM``, `serve.prewarm`): a
  `PrewarmController` drains the demand advisor's tile plan into the tile
  cache on the engine's device while the engine is idle, each tile under
  the dispatch lock; ``/statz`` gains its ``prewarm`` snapshot and
  ``/metrics`` the ``sbr_prewarm_*`` lines.

With a switch off its module is never imported and ``/metrics`` carries
none of its bytes; answers are bit-identical either way.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.core.rootfind import no_host_reads
from sbr_tpu_torch.diag.health import DIVERGENT_MASK
from sbr_tpu_torch.grad.api import WRT_DEFAULT, cell_value_and_grads
from sbr_tpu_torch.grad.cell import BASE_KEYS, aprime_tol
from sbr_tpu_torch.models.params import ModelParams, SolverConfig
from sbr_tpu_torch.resilience import faults, heal, retry
from sbr_tpu_torch.serve.fleet import CircuitBreaker, TileCacheBridge, default_deadline_ms
from sbr_tpu_torch.serve.live import GraphCounters, LiveMetrics
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.sweeps.baseline_sweeps import solve_param_cell
from sbr_tpu_torch.utils.checkpoint import BACKEND as _BACKEND
from sbr_tpu_torch.utils.checkpoint import canonicalize, params_fingerprint

# Bump when the batch program's semantics change: invalidates cached
# results (the reference's version, beside the backend tag).
_PROGRAM_VERSION = 1

_SHUTDOWN = object()

# The outputs of one dispatch, rows of the program's (6, bucket) result;
# a grads program appends four rows.
_OUTPUTS = ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual")
_GRAD_OUTPUTS = _OUTPUTS + ("dxi_dbeta", "dxi_du", "dxi_dkappa", "grad_flags")
_INT_OUTPUTS = ("status", "flags", "grad_flags")
# The demand kind of a keyed record's tag (`Engine._serve_record`).
_RECORD_KINDS = {"spec": "scenario", "pop": "population"}

class DeadlineExceeded(RuntimeError):
    """Query shed at admission: its deadline has already passed, or the
    engine's measured service time says it cannot be met (HTTP 429 +
    ``Retry-After`` at the endpoint). ``retry_after_s`` is the engine's
    service-time estimate."""

    def __init__(self, msg: str, retry_after_s: float = 0.1) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class SolverUnavailable(RuntimeError):
    """The dispatch circuit breaker is open: the solver path is presumed
    down, and batches fail fast instead of burning the retry budget."""


def default_buckets() -> Tuple[int, ...]:
    """Batch-size bucket ladder from ``SBR_SERVE_BUCKETS`` (comma-separated;
    default 1,8,64,512). Queries are padded up to the smallest bucket that
    fits, so at most ``len(buckets)`` graphs are ever captured. A malformed
    value falls back to the default ladder with a warning on stderr."""
    env = os.environ.get("SBR_SERVE_BUCKETS", "").strip()
    if env:
        try:
            vals = sorted({int(v) for v in env.split(",") if v.strip()})
            if vals and all(v > 0 for v in vals):
                return tuple(vals)
            raise ValueError("buckets must be positive integers")
        except ValueError as err:
            print(
                f"[sbr_tpu_torch.serve] ignoring invalid SBR_SERVE_BUCKETS={env!r} "
                f"({err}); using default ladder",
                file=sys.stderr,
            )
    return (1, 8, 64, 512)


def slo_ms() -> Optional[float]:
    """The p99 latency SLO (``SBR_SERVE_SLO_MS``); None when unset."""
    env = os.environ.get("SBR_SERVE_SLO_MS", "").strip()
    return float(env) if env else None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (env defaults resolved at construction)."""

    buckets: Tuple[int, ...] = dataclasses.field(default_factory=default_buckets)
    max_wait_ms: float = 2.0  # micro-batch assembly window
    lru_max: int = 4096
    cache_dir: Optional[str] = None  # on-disk result cache
    # Upper bound on on-disk result-cache entries, checked every 512 disk
    # writes; oldest entries (mtime) pruned first. 0 disables.
    disk_cap: int = 100_000

    def __post_init__(self):
        # _bucket_for assumes an ascending ladder
        buckets = tuple(sorted({int(b) for b in self.buckets}))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"buckets must be positive integers, got {self.buckets!r}")
        object.__setattr__(self, "buckets", buckets)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        kw = dict(
            buckets=default_buckets(),
            cache_dir=os.environ.get("SBR_SERVE_CACHE_DIR", "").strip() or None,
        )
        env_lru = os.environ.get("SBR_SERVE_LRU", "").strip()
        if env_lru:
            kw["lru_max"] = int(env_lru)
        env_cap = os.environ.get("SBR_SERVE_DISK_CAP", "").strip()
        if env_cap:
            kw["disk_cap"] = int(env_cap)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One served equilibrium: the lean per-cell outputs plus provenance.
    ``degraded`` marks a degradation-ladder answer (source "tilecache"):
    a swept cell of the tile cache, with ``tau_bar_in`` and ``residual``
    NaN (tiles do not store them).
    ``grads`` maps β, u and κ to dξ/dθ when the query asked for them, with
    ``grad_flags`` the grad-trust bitmask (`diag.health.GRAD_*`)."""

    xi: float
    tau_bar_in: float
    aw_max: float
    status: int
    flags: int
    residual: float
    source: str  # "lru" | "disk" | "coalesced" | "computed" | "tilecache"
    scenario: str
    latency_s: float
    degraded: bool = False
    grads: Optional[dict] = None  # {"beta": .., "u": .., "kappa": ..}
    grad_flags: Optional[int] = None

    @property
    def divergent(self) -> bool:
        return bool(self.flags & DIVERGENT_MASK)


class _Ticket:
    __slots__ = ("params", "scenario", "key", "grads", "t0", "t_wall0", "t_popped",
                 "deadline", "event", "result", "error", "trace", "span_id", "tparent")

    def __init__(self, params: ModelParams, scenario: str, key: str,
                 deadline: Optional[float] = None, grads: bool = False,
                 trace=None) -> None:
        self.params = params
        self.scenario = scenario
        self.key = key
        self.grads = grads
        self.t0 = time.monotonic()
        # `trace` is an `obs.trace.TraceContext`, or None (untraced: every
        # site below is one None check). The engine's spans of this query
        # hang off `span_id` ("engine.query", added when the ticket ends),
        # which hangs off the caller's `parent_id`.
        self.trace = trace
        self.span_id = trace.alloc_id() if trace is not None else None
        self.tparent = trace.parent_id if trace is not None else None
        # wall-clock twin of t0: spans join on the wall axis (`wall`)
        self.t_wall0 = time.time()
        self.t_popped: Optional[float] = None  # when the batcher took it
        # Absolute monotonic deadline, or None. A ticket whose deadline
        # expires while QUEUED is shed at batch formation; one whose batch
        # is already dispatched still gets its answer.
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[QueryResult] = None
        self.error: Optional[BaseException] = None

    def wall(self, mono: float) -> float:
        """Wall-clock time of the monotonic instant ``mono`` (span starts)."""
        return self.t_wall0 + (mono - self.t0)

    def wait(self, timeout: Optional[float] = None) -> QueryResult:
        if not self.event.wait(timeout):
            raise TimeoutError(f"query not fulfilled within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


def _query_columns(params_list: List[ModelParams], np_dtype) -> np.ndarray:
    """The 9 per-lane parameter rows in `solve_param_cell` order: (9, n)."""
    rows = [
        (
            p.learning.beta,
            p.economic.u,
            p.economic.p,
            p.economic.kappa,
            p.economic.lam,
            p.economic.eta,
            p.learning.tspan[0],
            p.learning.tspan[1],
            p.learning.x0,
        )
        for p in params_list
    ]
    return np.ascontiguousarray(np.asarray(rows, dtype=np_dtype).T)


class BucketProgram:
    """The served solve of one bucket: `solve_param_cell` over ``bucket``
    lanes, every parameter per lane, read from one static (9, bucket)
    input buffer, and its six outputs stacked into one (6, bucket) tensor
    (status and flags are small integers, exact in either float type).
    With ``aprime_tol`` set it is the grads program: four more rows, dξ/dβ,
    dξ/du, dξ/dκ and the grad flags, from `grad.api.cell_value_and_grads`
    on the same lanes.

    On a CUDA device construction captures the program into a CUDA graph
    (after a warm-up on a side stream with ``cols`` as inputs, into the
    engine's shared memory pool; a failure raises), and every call replays
    it; the outputs are copied to the host before the call returns, since
    the next replay overwrites them. On the CPU the program runs eagerly.
    Not thread-safe: the engine serializes calls."""

    def __init__(self, bucket: int, config: SolverConfig, dtype: torch.dtype,
                 device: torch.device, counters: GraphCounters, cols: np.ndarray,
                 pool=None, aprime_tol: Optional[float] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.device = device
        self.counters = counters
        self.aprime_tol = aprime_tol
        self.inputs = torch.tensor(cols, device=device)  # a copy: the static buffer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[torch.Tensor] = None
        if device.type == "cuda":
            t0 = time.perf_counter()
            self._capture(pool)
            captured = counters.captured if aprime_tol is None else counters.captured_grads
            captured[bucket] = captured.get(bucket, 0) + 1
            counters.capture_s += time.perf_counter() - t0

    def solve(self) -> torch.Tensor:
        """One eager run of the program on the input buffer."""
        with no_host_reads():
            xi, tau_in, aw_max, status, health = solve_param_cell(
                *self.inputs, self.config, self.dtype, self.device
            )
            rows = [xi, tau_in, aw_max, status.to(self.dtype), health.flags.to(self.dtype),
                    health.residual]
            if self.aprime_tol is not None:
                _, _, grads, _, _, gflags = cell_value_and_grads(
                    dict(zip(BASE_KEYS, self.inputs)), WRT_DEFAULT, self.config, self.dtype,
                    aprime_tol_=self.aprime_tol,
                )
                rows += [grads["beta"], grads["u"], grads["kappa"], gflags.to(self.dtype)]
        return torch.stack(rows)

    def _capture(self, pool) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):  # warm the allocator and the libraries
                self.solve()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            self.outputs = self.solve()
        obs.prof.note_capture("serve.bucket", time.perf_counter() - t0)
        self.graph = graph

    def __call__(self, cols: np.ndarray) -> np.ndarray:
        """Solve the (9, bucket) columns; returns the (6, bucket) outputs
        (10 rows for the grads program)."""
        self.inputs.copy_(torch.from_numpy(cols))
        if self.graph is None:
            self.counters.eager_runs += 1
            return self.solve().numpy()
        self.graph.replay()
        self.counters.replays += 1
        return self.outputs.cpu().numpy()


class Engine:
    """The long-lived serving engine (see module docstring).

    Construction is cheap (no capture, no dispatch); a bucket's graph is
    captured on its first dispatch. Use as a context manager, or call
    `start()` / `close()`. Without `start()` the engine still serves
    `query_many` synchronously in the calling thread. Runs on ``device``
    (default: the CUDA card) in ``dtype`` (default: float64)."""

    def __init__(
        self,
        config: Optional[SolverConfig] = None,
        dtype=None,
        serve: Optional[ServeConfig] = None,
        run=None,
        run_dir: Optional[str] = None,
        device=None,
    ) -> None:
        # Sweep-default numerics (refinement OFF), matching beta_u_grid.
        self.config = config if config is not None else SolverConfig(refine_crossings=False)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {self.dtype}")
        self.dtype_name = str(self.dtype).removeprefix("torch.")
        self._np_dtype = np.dtype(self.dtype_name)
        self.device = torch.device(device) if device is not None else default_device()
        if self.device.type == "cuda" and self.device.index is None:
            # the batcher thread sets its device, which needs an index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.serve = serve or ServeConfig.from_env()
        self.graphs = GraphCounters()
        self.live = LiveMetrics(graphs=self.graphs)

        self._owned_run = None
        if run is None and run_dir is not None:
            run = self._owned_run = obs.start_run(label="serve", run_dir=run_dir)
        self._run = run if run is not None else obs.active_run()

        self._lru: "OrderedDict[str, dict]" = OrderedDict()
        self._lru_lock = threading.Lock()
        self._disk_writes = 0
        self._programs: dict = {}
        self._programs_built = 0
        self._graph_pool = None
        # One dispatch at a time: a program's buffers and graph are shared.
        self._dispatch_lock = threading.Lock()
        self._cfg_tag = canonicalize((self.config, self.dtype_name, _PROGRAM_VERSION, _BACKEND))

        self._retry = retry.policy_from_env(
            "SBR_SERVE_RETRY", max_attempts=2, base_delay_s=0.05,
            multiplier=2.0, max_delay_s=2.0,
        )
        budget_env = os.environ.get("SBR_SERVE_RETRY_BUDGET", "").strip()
        self._budget_total = int(budget_env) if budget_env else 8
        # A server lives for days: the budget refreshes every
        # SBR_SERVE_RETRY_REFILL_S (default 900 s), so recovered hiccups
        # spread over a week do not latch /healthz unhealthy, while a dead
        # backend (many failures inside one refill window) still fails fast.
        refill_env = os.environ.get("SBR_SERVE_RETRY_REFILL_S", "").strip()
        self._budget_refill_s = float(refill_env) if refill_env else 900.0
        self.retry_budget = retry.RetryBudget(
            self._budget_total, refill_s=self._budget_refill_s or None
        )
        # transitions land as obs ``fleet`` events
        self.breaker = CircuitBreaker(on_transition=self._on_breaker)
        # The degradation ladder's tile-cache rung (SBR_TILE_CACHE_DIR) and
        # the tally of its outcomes (each also a ``fleet`` event).
        self.bridge = TileCacheBridge()
        self.ladder = {"degraded": 0, "ladder_exhausted": 0}
        self._ladder_lock = threading.Lock()
        # Per-query deadline default and the admission-control service-time
        # estimate (an EWMA of measured dispatch durations).
        self.default_deadline_ms = default_deadline_ms()
        self._service_ewma_s: Optional[float] = None

        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Serializes submit's closed-check + enqueue against close(), so no
        # ticket can land after the batcher's final drain.
        self._close_lock = threading.Lock()

        # The numerics-audit canaries, the demand observatory and the
        # flight recorder: off (the default) their modules are never
        # imported, /metrics carries none of their bytes, and answers are
        # bit-identical. The audit's probes run on this engine's device in
        # its dtype, only while the engine is idle.
        self.audit = None
        if obs.switch_on("SBR_AUDIT"):
            from sbr_tpu_torch.obs import audit as _audit

            self.audit = _audit.AuditScheduler(engine=self)
        self.demand = None
        if obs.switch_on("SBR_DEMAND"):
            from sbr_tpu_torch.obs import demand as _demand

            self.demand = _demand.DemandTracker(run=self._run, coverage_fn=self._demand_coverage)
        self.flight = None
        if obs.switch_on("SBR_FLIGHT"):
            from sbr_tpu_torch.obs import flight as _flight

            # the process-wide recorder: the tiled sweep's and the barriers'
            # records land on the same timeline
            self.flight = _flight.shared()
        # The prefetch controller: tiles of the advisor's plan into the tile
        # cache, on this engine's device in its dtype, in idle windows.
        self.prewarm = None
        if obs.switch_on("SBR_PREWARM"):
            from sbr_tpu_torch.serve import prewarm as _prewarm

            self.prewarm = _prewarm.PrewarmController(
                engine=self, config=self.config, dtype=self.dtype, device=self.device,
            )

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Engine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sbr-serve-batcher", daemon=True
            )
            self._thread.start()
        if self.audit is not None:
            self.audit.start()
        if self.prewarm is not None:
            self.prewarm.start()
        return self

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self._stop.set()
            self._queue.put(_SHUTDOWN)
            self._thread.join(timeout=30.0)
            # A submit that raced close() may have slipped a ticket in after
            # the batcher drained; fail it rather than strand its waiter.
            while True:
                try:
                    t = self._queue.get_nowait()
                except queue.Empty:
                    break
                if t is not _SHUTDOWN:
                    t.error = RuntimeError("engine is closed before the query was served")
                    t.event.set()
        if self.prewarm is not None:
            self.prewarm.close()
        if self.audit is not None:
            self.audit.close()
        with self._dispatch_lock:
            self._programs.clear()  # releases the captured graphs
        if self.demand is not None:
            self.demand.close(self._run)
        if self.flight is not None:
            self.flight.close(self._run)
        if self._run is not None:
            w = self.live.window()
            self.live.maybe_write(self._run, self._live_extra(window=w), window=w, force=True)
            self._log("event", "serve_summary", **self.live.snapshot())
        if self._owned_run is not None:
            from sbr_tpu_torch.obs import runlog

            runlog._finalize_if_active(self._owned_run)

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _log(self, method: str, *args, **fields) -> None:
        """One event on the engine's run (``method`` of `obs.RunContext`),
        if it has one; telemetry never sinks the serving path."""
        if self._run is None:
            return
        try:
            getattr(self._run, method)(*args, **fields)
        except Exception:
            pass

    def _on_breaker(self, old: str, new: str) -> None:
        """Breaker transition observer: one obs ``fleet`` event."""
        self._log("log_fleet", f"breaker_{new}", scope="serve.dispatch", previous=old,
                  failures=self.breaker.consecutive_failures)

    def _maybe_write_live(self) -> None:
        if self._run is not None and self.live.write_due():
            w = self.live.window()
            self.live.maybe_write(self._run, self._live_extra(window=w), window=w)
            if self.demand is not None:
                self.demand.maybe_write(self._run)
            if self.flight is not None:
                self.flight.maybe_write(self._run)

    # -- deadlines / admission ----------------------------------------------
    def service_estimate_s(self) -> Optional[float]:
        """EWMA of measured dispatch durations (None before any dispatch)."""
        return self._service_ewma_s

    def _retry_after(self) -> float:
        return round(max(self._service_ewma_s or 0.05, 0.05), 3)

    def _admit(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Admission control: resolve the query's deadline (explicit, else
        ``SBR_SERVE_DEADLINE_MS``, else none) and shed it with
        `DeadlineExceeded`, at zero solver cost, when it has already
        expired or is shorter than the measured service time. Returns the
        absolute monotonic deadline (None: no deadline)."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if deadline_ms is None:
            return None
        est = self._service_ewma_s
        if deadline_ms <= 0:
            self.live.record_shed()
            if self.flight is not None:
                self.flight.point("engine", "shed", tag="expired")
            self._log("log_fleet", "shed", reason="expired", deadline_ms=float(deadline_ms))
            raise DeadlineExceeded(
                f"deadline already expired ({deadline_ms:g} ms)",
                retry_after_s=self._retry_after(),
            )
        if est is not None and deadline_ms / 1e3 < est:
            self.live.record_shed()
            if self.flight is not None:
                self.flight.point("engine", "shed", tag="unmeetable")
            self._log("log_fleet", "shed", reason="unmeetable", deadline_ms=float(deadline_ms),
                      service_est_s=round(est, 4))
            raise DeadlineExceeded(
                f"deadline {deadline_ms:g} ms under the measured service "
                f"time ({est * 1e3:.1f} ms)",
                retry_after_s=self._retry_after(),
            )
        return time.monotonic() + deadline_ms / 1e3

    # -- public query API ---------------------------------------------------
    def submit(self, params: ModelParams, scenario: str = "default",
               deadline_ms: Optional[float] = None, grads: bool = False,
               trace=None) -> _Ticket:
        """Enqueue one query for the micro-batcher (requires `start()`).
        Raises once the engine is closed, and sheds (`DeadlineExceeded`)
        when the deadline cannot be met. With ``grads`` the answer carries
        dξ/d{β, u, κ} beside ξ, cached under its own key. ``trace`` (an
        `obs.trace.TraceContext`) hangs the engine's spans of this query
        under the caller's span."""
        t_adm_w = time.time() if trace is not None else 0.0
        t_adm = time.monotonic()
        try:
            deadline = self._admit(deadline_ms)
        except DeadlineExceeded:
            if trace is not None:
                trace.add("engine.admission", t_adm_w, time.monotonic() - t_adm,
                          parent=trace.parent_id, shed=True)
            raise
        ticket = _Ticket(params, scenario, self._result_key(params, grads), deadline, grads,
                         trace=trace)
        if trace is not None:
            trace.add("engine.admission", t_adm_w, time.monotonic() - t_adm,
                      parent=ticket.span_id)
        if self.flight is not None:
            self.flight.mark("engine", "admission", t_adm, time.monotonic())
        with self._close_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.put(ticket)
        self.live.queue_depth = self._queue.qsize()
        return ticket

    def query(
        self, params: ModelParams, scenario: str = "default",
        timeout: Optional[float] = None, deadline_ms: Optional[float] = None,
        grads: bool = False, trace=None,
    ) -> QueryResult:
        """Synchronous single query. Batched with concurrent submitters
        when the engine is started; solved inline otherwise."""
        if self._thread is None:
            return self.query_many(
                [params], scenario=scenario, deadline_ms=deadline_ms, grads=grads,
                traces=[trace] if trace is not None else None,
            )[0]
        return self.submit(params, scenario, deadline_ms=deadline_ms, grads=grads,
                           trace=trace).wait(timeout)

    def query_many(
        self, params_list: List[ModelParams], scenario: str = "default",
        timeout: Optional[float] = None, deadline_ms: Optional[float] = None,
        grads: bool = False, traces=None,
    ) -> List[QueryResult]:
        """Solve a list of queries. Started engine: all enqueue at once (the
        natural micro-batch). Unstarted: processed inline in this thread,
        the deterministic, thread-free path. ``traces`` (optional, parallel
        to ``params_list``) holds one `obs.trace.TraceContext`, or None, a
        query."""
        if self._closed:
            raise RuntimeError("engine is closed")
        any_trace = traces is not None and any(tr is not None for tr in traces)
        t_adm_w = time.time() if any_trace else 0.0
        t_adm = time.monotonic()
        try:
            deadline = self._admit(deadline_ms)
        except DeadlineExceeded:
            if any_trace:
                dur = time.monotonic() - t_adm
                for tr in traces:
                    if tr is not None:
                        tr.add("engine.admission", t_adm_w, dur, parent=tr.parent_id, shed=True)
            raise
        tickets = [_Ticket(p, scenario, self._result_key(p, grads), deadline, grads,
                           trace=traces[i] if traces is not None else None)
                   for i, p in enumerate(params_list)]
        if any_trace:
            dur = time.monotonic() - t_adm
            for t in tickets:
                if t.trace is not None:
                    t.trace.add("engine.admission", t_adm_w, dur, parent=t.span_id)
        if self.flight is not None:
            self.flight.mark("engine", "admission", t_adm, time.monotonic())
        if self._thread is None:
            self._process(tickets)
        else:
            with self._close_lock:
                if self._closed:
                    raise RuntimeError("engine is closed")
                for t in tickets:
                    self._queue.put(t)
            self.live.queue_depth = self._queue.qsize()
        return [t.wait(timeout) for t in tickets]

    # -- composed scenarios and population what-ifs ---------------------------
    def query_scenario(self, params, spec, deadline_ms: Optional[float] = None) -> dict:
        """Serve one composed-scenario query (`scenario.ScenarioSpec`), the
        `POST /query` route of a ``scenario`` object. Returns a JSON-ready
        record (per-bank lists for a multi-bank spec, scalars otherwise)
        with ``scenario_fingerprint``, ``source`` and ``latency_ms``. A spec
        the params cannot serve raises ValueError."""
        from sbr_tpu_torch.scenario import spec_fingerprint

        self._admit(deadline_ms)
        key = spec_fingerprint(spec, (params, self._cfg_tag), self.config, self.dtype_name)
        return self._serve_record(params, key, "scenario_fingerprint", "spec",
                                  lambda: self._solve_scenario(params, spec))

    def query_population(self, params, pop_doc: dict,
                         deadline_ms: Optional[float] = None) -> dict:
        """Serve one population what-if query (`POST /query` with a
        ``population`` object): S agent populations under an
        `infomodels.InfoModelSpec` on a graphgen spec, reduced to
        crossing-time quantiles and a run probability against the model's
        mean-field fixed point (`infomodels.population_query`). Returns the
        JSON-ready record with ``population_fingerprint``, ``source`` and
        ``latency_ms``. A malformed ``pop_doc`` raises ValueError. Every
        information model is served, the rewire dynamics included."""
        from sbr_tpu_torch.infomodels import population as pop

        kw = pop.parse_population_doc(pop_doc)
        self._admit(deadline_ms)
        key = pop.population_fingerprint(kw, (params, self._cfg_tag), self.config,
                                         self.dtype_name)
        g0 = {"g0": kw["g0"]} if "g0" in kw else {}
        return self._serve_record(params, key, "population_fingerprint", "pop", lambda: (
            pop.population_query(
                kw["spec"], kw["graph"], params, seeds=kw["seeds"], vary=kw["vary"],
                seed=kw["seed"], dt=kw["dt"], config=self.config, device=self.device, **g0,
            )))

    def _serve_record(self, params, key: str, field: str, tag: str, compute) -> dict:
        """A record from the cache, else ``compute()``d with the device held
        and stored verbatim with its fingerprint in ``field``; returned with
        its ``source`` and ``latency_ms``."""
        t0 = time.monotonic()
        rec, source = self._cache_probe(key, self._parse_keyed_record(field))
        if rec is None:
            with self._on_device():
                rec = compute()
            rec[field] = key
            self._store(key, rec)
            source = "computed"
        latency = time.monotonic() - t0
        self.live.record_query(latency, source, scenario=f"{tag}:{key[:12]}")
        if self.demand is not None:
            self.demand.record_params(params, scenario=f"{tag}:{key[:12]}", source=source,
                                      kind=_RECORD_KINDS[tag])
        return {**rec, "source": source, "latency_ms": round(latency * 1e3, 3)}

    @contextmanager
    def _on_device(self):
        """The dispatch lock, with the engine's card current: device work
        never overlaps a bucket's capture or replay."""
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()
        with self._dispatch_lock, on_card:
            yield

    def _solve_scenario(self, params, spec) -> dict:
        """One composed solve → the cacheable JSON record (non-finite
        floats as None, the wire convention)."""
        from sbr_tpu_torch import scenario

        res = scenario.solve(spec, params, config=self.config, dtype=self.dtype,
                             device=self.device)

        def safe(v):
            v = float(v)
            return v if math.isfinite(v) else None

        def host(t):
            return t.detach().cpu().numpy()

        if spec.banks > 1:
            return {
                "xi": [safe(v) for v in host(res.xi)],
                "status": [int(v) for v in host(res.status)],
                "aw_max": [safe(v) for v in host(res.aw_max)],
                "flags": [int(v) for v in host(res.health.flags)],
                "kappa_eff": [safe(v) for v in host(res.kappa_eff)],
                "iterations": int(res.iterations),
                "converged": bool(res.converged),
                "banks": spec.banks,
            }
        return {
            "xi": safe(res.xi),
            "status": int(res.status),
            "flags": int(res.health.flags),
            "residual": safe(res.health.residual),
            "banks": 1,
        }

    # -- health / exposition -------------------------------------------------
    def healthz(self, window: Optional[dict] = None) -> dict:
        """Ready/degraded/unhealthy verdict with reasons — `/healthz` body.

        unhealthy: the batcher thread died, or the shared retry budget is
        exhausted until its next refill. degraded: divergent cells,
        dispatch errors, sheds or ladder answers in the current window, a
        partially used retry budget, a breaker that is not closed, a
        window p99 over ``SBR_SERVE_SLO_MS``, or a latched audit drift. ``window`` (a prior `LiveMetrics.window()`)
        lets a caller share one fold between the verdict and the window it
        embeds."""
        self.retry_budget.maybe_refill()
        reasons = []
        status = "ready"
        if self._thread is not None and not self._thread.is_alive() and not self._closed:
            status = "unhealthy"
            reasons.append("batcher thread dead")
        if self.retry_budget.total > 0 and self.retry_budget.remaining == 0:
            status = "unhealthy"
            reasons.append("retry budget exhausted")
        if status != "unhealthy":
            if window is None:
                window = self.live.window()
            if window.get("divergent_cells", 0):
                status = "degraded"
                reasons.append(f"{int(window['divergent_cells'])} divergent cell(s) in window")
            if window.get("errors", 0):
                status = "degraded"
                reasons.append(f"{int(window['errors'])} dispatch error(s) in window")
            if window.get("shed", 0):
                status = "degraded"
                reasons.append(f"{int(window['shed'])} shed quer(ies) in window")
            if window.get("degraded", 0):
                status = "degraded"
                reasons.append(
                    f"{int(window['degraded'])} degraded-ladder answer(s) in window"
                )
            if self.breaker.state != "closed":
                status = "degraded"
                reasons.append(
                    f"dispatch breaker {self.breaker.state} "
                    f"({self.breaker.consecutive_failures} consecutive failure(s))"
                )
            if self.retry_budget.used > 0:
                status = "degraded"
                reasons.append(
                    f"retry budget {self.retry_budget.used}/{self.retry_budget.total} consumed"
                )
            slo = slo_ms()
            p99 = (window.get("latency_ms") or {}).get("p99")
            if slo is not None and p99 is not None and p99 > slo:
                status = "degraded"
                reasons.append(f"window p99 {p99:.3f} ms over SLO {slo:g} ms")
            if self.audit is not None and self.audit.status == "drift":
                status = "degraded"
                reasons.append("audit_drift: " + (",".join(self.audit.drift_probes) or "?"))
        return {"status": status, "reasons": reasons}

    def statz(self) -> dict:
        """Full live snapshot — the `/statz` body. The embedded window and
        the healthz verdict come from ONE fold of the slot ring."""
        window = self.live.window()
        return self.live.snapshot(self._live_extra(window=window), window=window)

    def prometheus(self) -> str:
        from sbr_tpu_torch.obs import trace as qtrace

        extra = {
            "sbr_serve_lru_entries": ("gauge", len(self._lru)),
            "sbr_serve_retry_budget_remaining": ("gauge", self.retry_budget.remaining),
        }
        slo = slo_ms()
        if slo is not None:
            extra["sbr_serve_slo_ms"] = ("gauge", slo)
        text = self.live.to_prometheus(extra)
        # the per-layer span histograms (committed spans only: empty while
        # tracing is off), then the audit, demand, prewarm and flight lines,
        # which exist only while their switches are on
        lines = list(qtrace.layer_prometheus())
        if self.audit is not None:
            lines += self.audit.prometheus_lines()
        if self.demand is not None:
            lines += self.demand.prometheus_lines()
        if self.prewarm is not None:
            lines += self.prewarm.prometheus_lines()
        if self.flight is not None:
            lines += self.flight.prometheus_lines()
        if lines:
            text = text.rstrip("\n") + "\n" + "\n".join(lines) + "\n"
        return text

    def trace_writer(self):
        """This engine's span sink (`obs.trace.TraceWriter`), or None when
        the engine has no run directory: the root-span owner (the endpoint,
        loadgen) commits finished traces here."""
        from sbr_tpu_torch.obs import trace as qtrace

        return qtrace.writer_for(self._run)

    def _demand_coverage(self) -> Optional[dict]:
        """The advisor's coverage input: the cell index of the bridged tile
        cache (None when none is bridged, which is not an empty cache)."""
        if self.demand is None or not self.bridge.available:
            return None
        from sbr_tpu_torch.obs import demand as _demand

        return _demand.coverage_from_cache_dir(self.bridge.cache.root)

    def _live_extra(self, window: Optional[dict] = None) -> dict:
        return {
            "healthz": self.healthz(window=window),
            "retry_budget": {
                "total": self.retry_budget.total,
                "used": self.retry_budget.used,
                "remaining": self.retry_budget.remaining,
            },
            "slo": {"slo_ms": slo_ms()},
            "breaker": {
                "state": self.breaker.state,
                "consecutive_failures": self.breaker.consecutive_failures,
            },
            "ladder": {"tile_cache": self.bridge.available, **self.ladder},
            "deadline": {
                "default_ms": self.default_deadline_ms,
                "service_est_s": (
                    round(self._service_ewma_s, 6)
                    if self._service_ewma_s is not None
                    else None
                ),
            },
            "engine": {
                "buckets": list(self.serve.buckets),
                "dtype": self.dtype_name,
                "device": str(self.device),
                "backend": _BACKEND,
                "lru_entries": len(self._lru),
                "lru_max": self.serve.lru_max,
                "cache_dir": self.serve.cache_dir,
                "aot": "unsupported (CUDA graphs are per-process)",
                # the reference's executable counts: bucket programs built
                # (captured on the card), none reloaded from disk
                "compiled": self._programs_built,
                "loaded": 0,
            },
            **({"audit": self.audit.snapshot()} if self.audit is not None else {}),
            **({"demand": self.demand.snapshot()} if self.demand is not None else {}),
            **({"prewarm": self.prewarm.snapshot()} if self.prewarm is not None else {}),
            **({"flight": self.flight.heartbeat_block()} if self.flight is not None else {}),
        }

    # -- batcher loop --------------------------------------------------------
    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        max_bucket = max(self.serve.buckets)
        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    break
                self._maybe_write_live()
                continue
            batch, shutdown = [], item is _SHUTDOWN
            if not shutdown:
                item.t_popped = time.monotonic()
                batch.append(item)
                deadline = time.monotonic() + self.serve.max_wait_ms / 1e3
                while len(batch) < max_bucket:
                    budget = deadline - time.monotonic()
                    try:
                        nxt = self._queue.get(timeout=max(budget, 0.0))
                    except queue.Empty:
                        break
                    if nxt is _SHUTDOWN:
                        shutdown = True
                        break
                    nxt.t_popped = time.monotonic()
                    batch.append(nxt)
            else:
                # Drain everything still queued so no ticket hangs forever.
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is not _SHUTDOWN:
                        nxt.t_popped = time.monotonic()
                        batch.append(nxt)
            self.live.queue_depth = self._queue.qsize()
            if self.flight is not None:
                self.flight.point("engine", "queue_depth", val=self.live.queue_depth)
            if batch:
                self.live.inflight = len(batch)
                try:
                    self._process(batch)
                finally:
                    self.live.inflight = 0
                self._maybe_write_live()
            if shutdown:
                break

    # -- processing ----------------------------------------------------------
    def _process(self, tickets: List[_Ticket]) -> None:
        """Serve a batch of tickets: cache lookups first, then the misses in
        bucket-padded dispatches. Identical queries inside one batch are
        coalesced into a single lane. Never raises: failures land on
        tickets."""
        groups: "OrderedDict[str, List[_Ticket]]" = OrderedDict()
        t_proc = time.monotonic()
        fl = self.flight
        for t in tickets:
            # queue wait: enqueue to the batcher taking the ticket (an
            # inline query_many never queues: about 0)
            popped = t.t_popped if t.t_popped is not None else t_proc
            if fl is not None:
                fl.mark("engine", "queue", t.t0, popped)
            if t.trace is not None:
                t.trace.add("engine.queue", t.wall(t.t0), popped - t.t0, parent=t.span_id)
            t_lk = time.monotonic()
            rec, source = self._lookup(t.key)
            if fl is not None:
                fl.mark("engine", "cache", t_lk, time.monotonic(), tag=source or "miss")
            if t.trace is not None:
                # the LRU is always probed; the disk only on an LRU miss (no
                # attribute when not consulted, "off" without a cache dir)
                disk = (None if source == "lru" else "hit" if source == "disk"
                        else "miss" if self.serve.cache_dir else "off")
                t.trace.add("engine.cache", t.wall(t_lk), time.monotonic() - t_lk,
                            parent=t.span_id, lru="hit" if source == "lru" else "miss",
                            disk=disk)
            if rec is not None:
                # A cache hit is free: serve it even past its deadline.
                self._fulfill(t, rec, source)
            elif t.deadline is not None and time.monotonic() > t.deadline:
                # Expired while queued: shed now instead of burning a
                # dispatch on a dead query.
                self.live.record_shed()
                if fl is not None:
                    fl.point("engine", "shed", tag="queue-expired")
                self._log("log_fleet", "shed", reason="queue-expired", scenario=t.scenario)
                t.error = DeadlineExceeded(
                    "deadline expired while queued", retry_after_s=self._retry_after(),
                )
                if t.trace is not None:
                    t.trace.add("engine.query", t.t_wall0, time.monotonic() - t.t0,
                                parent=t.tparent, span_id=t.span_id, shed="queue-expired")
                t.event.set()
            else:
                groups.setdefault(t.key, []).append(t)
        unique = [g[0] for g in groups.values()]
        max_bucket = max(self.serve.buckets)
        # plain and grads queries run different programs: partition first
        # (their keys already keep cache entries and coalescing apart)
        for part in ([t for t in unique if not t.grads], [t for t in unique if t.grads]):
            for i in range(0, len(part), max_bucket):
                self._process_chunk(part[i : i + max_bucket], groups)

    def _process_chunk(self, chunk: List[_Ticket], groups) -> None:
        fl = self.flight
        n = len(chunk)
        bucket = self._bucket_for(n)
        t_d0w, t_d0m = time.time(), time.monotonic()
        if fl is not None:
            # batch formation: the first pop to the dispatch's start (what
            # the device waits out between dispatches)
            popped0 = min((t.t_popped for t in chunk if t.t_popped is not None), default=t_d0m)
            fl.mark("engine", "batch", popped0, t_d0m, tag=f"b{bucket}")
        try:
            # positional for the plain path: `_dispatch(params)` is a
            # stubbing point of the failure-injection tests
            records = (
                self._dispatch([t.params for t in chunk], grads=True)
                if chunk[0].grads
                else self._dispatch([t.params for t in chunk])
            )
        except BaseException as err:
            # The degradation ladder: the solver path is down, and the exact
            # LRU and disk rungs already missed, so the next rung is the
            # tile cache. Only then does the ticket fail (the endpoint's
            # 503). Degraded answers are never cached: once the solver
            # recovers, fresh dispatches take over.
            for t in chunk:
                t_lad = time.monotonic()
                rec = self._degraded_rec(t)
                lad_dur = time.monotonic() - t_lad
                for dup in groups[t.key]:
                    if dup.trace is not None:
                        # the ladder's tile-cache rung: a cache-layer span
                        dup.trace.add("engine.tilecache", dup.wall(t_lad), lad_dur,
                                      parent=dup.span_id, hit=rec is not None)
                    if rec is not None:
                        self._fulfill(dup, dict(rec), "tilecache", degraded=True)
                    else:
                        self.live.record_error()
                        if dup.trace is not None:
                            dup.trace.add("engine.query", dup.t_wall0, time.monotonic() - dup.t0,
                                          parent=dup.tparent, span_id=dup.span_id,
                                          error=type(err).__name__)
                        dup.error = err
                        dup.event.set()
            return
        t_up = time.monotonic()
        for t, rec in zip(chunk, records):
            # A divergent result is served (the caller sees the flags) but
            # never cached: a cached hit would replay the poisoned numbers
            # after /healthz recovered.
            if not (rec["flags"] & DIVERGENT_MASK):
                self._store(t.key, rec)
            disp_dur = time.monotonic() - t_d0m
            for j, dup in enumerate(groups[t.key]):
                if dup.trace is not None:
                    # batch formation (pop to dispatch start, earlier chunks
                    # included) and the dispatch, with this bucket's padding
                    popped = dup.t_popped if dup.t_popped is not None else t_d0m
                    dup.trace.add("engine.batch", dup.wall(popped), max(t_d0m - popped, 0.0),
                                  parent=dup.span_id, n=n, coalesced=True if j else None)
                    dup.trace.add("engine.dispatch", t_d0w, disp_dur, parent=dup.span_id,
                                  bucket=bucket, padded_lanes=bucket - n,
                                  padded_share=round((bucket - n) / bucket, 4))
                self._fulfill(dup, rec, "computed" if j == 0 else "coalesced")
        if fl is not None:
            # result unpack: store and fulfil after the device fence
            fl.mark("engine", "unpack", t_up, time.monotonic(), tag=f"b{bucket}")

    def _degraded_rec(self, t: _Ticket) -> Optional[dict]:
        """The tile-cache rung for one ticket: the matching swept cell's
        record, or None (counted ``ladder_exhausted``)."""
        try:
            rec = self.bridge.lookup(t.params, self.config, self.dtype_name)
        except Exception:
            rec = None  # a broken bridge must never mask the real error
        outcome = "degraded" if rec is not None else "ladder_exhausted"
        with self._ladder_lock:
            self.ladder[outcome] += 1
        self._log("log_fleet", outcome, scenario=t.scenario, key=t.key[:12])
        return rec

    def _fulfill(self, t: _Ticket, rec: dict, source: str, degraded: bool = False) -> None:
        latency = time.monotonic() - t.t0
        rec = dict(rec)
        # a grads record is a superset of the plain one: fold its dξ/dθ
        # keys into the structured ``grads`` field
        grads = None
        grad_flags = rec.pop("grad_flags", None)
        if "dxi_dbeta" in rec:
            grads = {"beta": rec.pop("dxi_dbeta"), "u": rec.pop("dxi_du"),
                     "kappa": rec.pop("dxi_dkappa")}
        t.result = QueryResult(source=source, scenario=t.scenario, latency_s=latency,
                               degraded=degraded, grads=grads, grad_flags=grad_flags, **rec)
        if t.trace is not None:
            # the query's engine span: every span above hangs off it
            t.trace.add("engine.query", t.t_wall0, latency, parent=t.tparent,
                        span_id=t.span_id, source=source,
                        degraded=True if degraded else None,
                        divergent=True if t.result.divergent else None)
        self.live.record_query(
            latency, source, scenario=t.scenario, divergent=t.result.divergent
        )
        if self.demand is not None:
            self.demand.record_params(t.params, scenario=t.scenario, source=source,
                                      grads=t.grads)
        t.event.set()

    def _bucket_for(self, n: int) -> int:
        for b in self.serve.buckets:
            if b >= n:
                return b
        return max(self.serve.buckets)

    def _program(self, bucket: int, cols: np.ndarray, grads: bool = False) -> BucketProgram:
        """The bucket's program, made (and on the card captured) on first
        use, with ``cols`` as the warm-up's inputs. A grads program is kept
        per resolved ill-conditioning tolerance, which its flags bake in."""
        tol = self._aprime_tol() if grads else None
        key = bucket if tol is None else ("grads", bucket, tol)
        program = self._programs.get(key)
        if program is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            t0 = time.monotonic()
            with obs.span(f"serve.compile[{bucket}{'g' if grads else ''}]"):
                program = BucketProgram(bucket, self.config, self.dtype, self.device,
                                        self.graphs, cols, self._graph_pool, aprime_tol=tol)
            self._programs[key] = program
            self._programs_built += 1
            self._log("event", "serve_exec", bucket=bucket, source="compiled", grads=grads,
                      compile_s=round(time.monotonic() - t0, 3))
        return program

    def capture_programs(self) -> int:
        """Build every bucket's program now, so that no query waits on its
        capture: on the card each is captured into a CUDA graph, seconds a
        bucket, and a process cannot reload a graph from a cache as the
        reference reloads its compiled executables. The warm-up inputs are
        the default model's columns. Call it before `start`. Returns the
        programs built; on the CPU, where programs run eagerly, none."""
        if self.device.type != "cuda":
            return 0
        from sbr_tpu_torch.models.params import make_model_params

        one = _query_columns([make_model_params()], self._np_dtype)
        built = 0
        with self._on_device():
            for bucket in self.serve.buckets:
                if bucket not in self._programs:
                    self._program(bucket, np.ascontiguousarray(np.repeat(one, bucket, axis=1)))
                    built += 1
        return built

    def _aprime_tol(self) -> float:
        return aprime_tol(self.dtype)

    def _dispatch(self, params_list: List[ModelParams], grads: bool = False) -> List[dict]:
        """One padded dispatch under the retry policy; returns one
        plain-float record per query (the cacheable form; with ``grads``
        the grads program's, dξ/dθ and the grad flags included). While the
        breaker is open it raises `SolverUnavailable` without touching the
        device, until the cooldown lets one half-open probe through."""
        self.retry_budget.maybe_refill()
        if not self.breaker.allow():
            raise SolverUnavailable(
                f"dispatch breaker open "
                f"({self.breaker.consecutive_failures} consecutive failure(s))"
            )
        n = len(params_list)
        bucket = self._bucket_for(n)
        cols = _query_columns(params_list, self._np_dtype)
        if bucket > n:
            cols = np.ascontiguousarray(
                np.concatenate([cols, np.repeat(cols[:, :1], bucket - n, axis=1)], axis=1)
            )
        t_disp = time.monotonic()
        try:
            with self._on_device():
                # `_program(bucket, cols)` is a stubbing point of the tests
                program = (self._program(bucket, cols, grads=True) if grads
                           else self._program(bucket, cols))

                def run(c):
                    # the fault point inside the retried scope: injected
                    # transients are retried first, then exhaust into an
                    # outage the breaker and the ladder answer
                    faults.fire("serve.dispatch", target=f"bucket{bucket}")
                    return program(c)

                out = self._retry.call(
                    run, cols, scope=f"serve.dispatch[{bucket}]", budget=self.retry_budget
                )
        except BaseException:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        # Admission control's service-time estimate (includes retry backoff).
        dur = time.monotonic() - t_disp
        self._service_ewma_s = (
            dur if self._service_ewma_s is None
            else 0.3 * dur + 0.7 * self._service_ewma_s
        )
        if self.flight is not None:
            # the program returns only after its one device-to-host copy, so
            # the span covers copy-in, the solve or replay and the fetch
            # (and any retry backoff): what the device path occupied
            self.flight.mark("engine", "dispatch", t_disp, t_disp + dur, tag=f"b{bucket}")
            self.flight.point("engine", "occupancy", tag=f"b{bucket}", val=round(n / bucket, 4))
        self.live.record_batch(n, bucket)
        names = _GRAD_OUTPUTS if grads else _OUTPUTS
        if self._run is not None:
            flags_row = out[names.index("flags"), :n].astype(np.int64)
            self._log("event", "serve_batch", n=n, bucket=bucket,
                      divergent=int(((flags_row & DIVERGENT_MASK) != 0).sum()))
        records = []
        for i in range(n):
            rec = {name: float(out[k, i]) for k, name in enumerate(names)}
            for name in _INT_OUTPUTS:
                if name in rec:
                    rec[name] = int(rec[name])
            records.append(rec)
        return records

    # -- result cache --------------------------------------------------------
    def _result_key(self, params: ModelParams, grads: bool = False) -> str:
        # a grads record's flags depend on the resolved ill-conditioning
        # tolerance, which joins its key: a cached answer never replays
        # flags made under another SBR_GRAD_APRIME_TOL
        tag = (self._cfg_tag, "grads", self._aprime_tol()) if grads else self._cfg_tag
        return params_fingerprint((params, tag))

    def _result_path(self, key: str) -> Optional[Path]:
        if not self.serve.cache_dir:
            return None
        return Path(self.serve.cache_dir) / "results" / key[:2] / f"{key}.json"

    def _cache_probe(self, key: str, parse_disk) -> tuple:
        """The LRU + verified-disk probe every record kind shares: an LRU
        hit first; else the disk layer, sha256-verified on read (a mismatch
        is quarantined beside the cache and the query recomputes;
        sidecar-less entries verify as "legacy" and stay trusted), then
        ``parse_disk(path)``. A parser returning None or raising (an
        unreadable or wrong-shaped entry: a torn write can leave valid
        non-dict JSON) makes it a miss."""
        with self._lru_lock:
            rec = self._lru.get(key)
            if rec is not None:
                self._lru.move_to_end(key)
                return dict(rec), "lru"
        path = self._result_path(key)
        if path is None or not path.exists():
            return None, None
        try:
            if heal.verify_file(path) == "mismatch":
                heal.quarantine(path, reason="serve-cache-mismatch")
                return None, None
            rec = parse_disk(path)
        except (OSError, ValueError, KeyError, TypeError):
            return None, None
        if rec is None:
            return None, None
        self._store(key, rec, write_disk=False)
        return dict(rec), "disk"

    def _lookup(self, key: str) -> tuple:
        return self._cache_probe(key, self._parse_plain_record)

    @staticmethod
    def _parse_keyed_record(field: str):
        """The disk parser of scenario and population records, stored
        verbatim (their shape varies by query): a dict carrying ``field``,
        its fingerprint, else a miss."""
        def parse(path: Path):
            rec = json.loads(path.read_text())
            return rec if isinstance(rec, dict) and field in rec else None

        return parse

    @staticmethod
    def _parse_plain_record(path: Path) -> dict:
        raw = json.loads(path.read_text())
        rec = {
            "xi": float(raw["xi"]),
            "tau_bar_in": float(raw["tau_bar_in"]),
            "aw_max": float(raw["aw_max"]),
            "status": int(raw["status"]),
            "flags": int(raw["flags"]),
            "residual": float(raw["residual"]),
        }
        # a grads record keeps its sensitivities across a restart
        for k in ("dxi_dbeta", "dxi_du", "dxi_dkappa"):
            if k in raw:
                rec[k] = float(raw[k])
        if "grad_flags" in raw:
            rec["grad_flags"] = int(raw["grad_flags"])
        return rec

    def _store(self, key: str, rec: dict, write_disk: bool = True) -> None:
        with self._lru_lock:
            self._lru[key] = dict(rec)
            self._lru.move_to_end(key)
            while len(self._lru) > self.serve.lru_max:
                self._lru.popitem(last=False)
        path = self._result_path(key)
        if write_disk and path is not None:
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(rec))
                os.replace(tmp, path)
                # sha256 sidecar for verify-on-read, after the rename (the
                # window leaves a "legacy"-trusted entry)
                try:
                    heal.write_sidecar(path)
                except OSError:
                    pass
                self._disk_writes += 1
                if self._disk_writes % 512 == 0:
                    self._prune_disk_cache()
            except OSError:
                pass  # the disk layer is best-effort; the LRU already has it

    def _prune_disk_cache(self) -> None:
        """Bound the results/ tree at ``disk_cap`` entries, evicting the
        oldest by mtime (with their sidecars). Quarantined evidence neither
        counts nor is pruned. Best-effort: a concurrent reader of a pruned
        entry just recomputes."""
        cap = self.serve.disk_cap
        if cap <= 0 or not self.serve.cache_dir:
            return
        try:
            root = Path(self.serve.cache_dir) / "results"
            entries = [
                (p.stat().st_mtime, p)
                for p in root.rglob("*.json")
                if "quarantine" not in p.parts
            ]
            if len(entries) <= cap:
                return
            entries.sort()
            for _, p in entries[: len(entries) - cap]:
                for victim in (p, heal.sidecar_path(p)):
                    try:
                        victim.unlink()
                    except OSError:
                        pass
            self._log("event", "serve_cache_prune", removed=len(entries) - cap, cap=cap)
        except OSError:
            pass
