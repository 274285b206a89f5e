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

Not ported yet, each raising `NotImplementedError` with its ROADMAP item:
run directories (1.A item 9), and the audit, demand, prewarm and
flight-recorder switches (1.A items 9 and 10).
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

# Switches of the reference's engine that need modules not ported yet.
_UNPORTED_ENV = {
    "SBR_AUDIT": "1.A 9", "SBR_DEMAND": "1.A 9", "SBR_PREWARM": "1.A 10", "SBR_FLIGHT": "1.A 9",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to sbr_tpu_torch yet (ROADMAP item {item})")


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
    __slots__ = ("params", "scenario", "key", "grads", "t0", "t_popped", "deadline",
                 "event", "result", "error")

    def __init__(self, params: ModelParams, scenario: str, key: str,
                 deadline: Optional[float] = None, grads: bool = False) -> None:
        self.params = params
        self.scenario = scenario
        self.key = key
        self.grads = grads
        self.t0 = time.monotonic()
        self.t_popped: Optional[float] = None  # when the batcher took it
        # Absolute monotonic deadline, or None. A ticket whose deadline
        # expires while QUEUED is shed at batch formation; one whose batch
        # is already dispatched still gets its answer.
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[QueryResult] = None
        self.error: Optional[BaseException] = None

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
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            self.outputs = self.solve()
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
        if run is not None or run_dir is not None:
            raise _not_ported("a serving run directory (run=, run_dir=)", "1.A 9")
        for var, item in _UNPORTED_ENV.items():
            if os.environ.get(var, "").strip() not in ("", "0"):
                raise _not_ported(f"{var}={os.environ[var]!r}", item)
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

        self._lru: "OrderedDict[str, dict]" = OrderedDict()
        self._lru_lock = threading.Lock()
        self._disk_writes = 0
        self._programs: dict = {}
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
        self.breaker = CircuitBreaker()
        # The degradation ladder's tile-cache rung (SBR_TILE_CACHE_DIR) and
        # the tally of its outcomes, which the reference logs as obs
        # ``fleet`` events (the port's run log is ROADMAP 1.A item 9).
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

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Engine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sbr-serve-batcher", daemon=True
            )
            self._thread.start()
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
        with self._dispatch_lock:
            self._programs.clear()  # releases the captured graphs

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- deadlines / admission ----------------------------------------------
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
            raise DeadlineExceeded(
                f"deadline already expired ({deadline_ms:g} ms)",
                retry_after_s=self._retry_after(),
            )
        if est is not None and deadline_ms / 1e3 < est:
            self.live.record_shed()
            raise DeadlineExceeded(
                f"deadline {deadline_ms:g} ms under the measured service "
                f"time ({est * 1e3:.1f} ms)",
                retry_after_s=self._retry_after(),
            )
        return time.monotonic() + deadline_ms / 1e3

    # -- public query API ---------------------------------------------------
    def submit(self, params: ModelParams, scenario: str = "default",
               deadline_ms: Optional[float] = None, grads: bool = False) -> _Ticket:
        """Enqueue one query for the micro-batcher (requires `start()`).
        Raises once the engine is closed, and sheds (`DeadlineExceeded`)
        when the deadline cannot be met. With ``grads`` the answer carries
        dξ/d{β, u, κ} beside ξ, cached under its own key."""
        deadline = self._admit(deadline_ms)
        ticket = _Ticket(params, scenario, self._result_key(params, grads), deadline, grads)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.put(ticket)
        self.live.queue_depth = self._queue.qsize()
        return ticket

    def query(
        self, params: ModelParams, scenario: str = "default",
        timeout: Optional[float] = None, deadline_ms: Optional[float] = None,
        grads: bool = False,
    ) -> QueryResult:
        """Synchronous single query. Batched with concurrent submitters
        when the engine is started; solved inline otherwise."""
        if self._thread is None:
            return self.query_many(
                [params], scenario=scenario, deadline_ms=deadline_ms, grads=grads,
            )[0]
        return self.submit(params, scenario, deadline_ms=deadline_ms, grads=grads).wait(timeout)

    def query_many(
        self, params_list: List[ModelParams], scenario: str = "default",
        timeout: Optional[float] = None, deadline_ms: Optional[float] = None,
        grads: bool = False,
    ) -> List[QueryResult]:
        """Solve a list of queries. Started engine: all enqueue at once (the
        natural micro-batch). Unstarted: processed inline in this thread,
        the deterministic, thread-free path."""
        if self._closed:
            raise RuntimeError("engine is closed")
        deadline = self._admit(deadline_ms)
        tickets = [_Ticket(p, scenario, self._result_key(p, grads), deadline, grads)
                   for p in params_list]
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
        return self._serve_record(key, "scenario_fingerprint", "spec",
                                  lambda: self._solve_scenario(params, spec))

    def query_population(self, params, pop_doc: dict,
                         deadline_ms: Optional[float] = None) -> dict:
        """Serve one population what-if query (`POST /query` with a
        ``population`` object): S agent populations under an
        `infomodels.InfoModelSpec` on a graphgen spec, reduced to
        crossing-time quantiles and a run probability against the model's
        mean-field fixed point (`infomodels.population_query`). Returns the
        JSON-ready record with ``population_fingerprint``, ``source`` and
        ``latency_ms``. A malformed ``pop_doc`` raises ValueError; a rewire
        information model raises NotImplementedError (not ported)."""
        from sbr_tpu_torch.infomodels import population as pop

        kw = pop.parse_population_doc(pop_doc)
        self._admit(deadline_ms)
        key = pop.population_fingerprint(kw, (params, self._cfg_tag), self.config,
                                         self.dtype_name)
        g0 = {"g0": kw["g0"]} if "g0" in kw else {}
        return self._serve_record(key, "population_fingerprint", "pop", lambda: (
            pop.population_query(
                kw["spec"], kw["graph"], params, seeds=kw["seeds"], vary=kw["vary"],
                seed=kw["seed"], dt=kw["dt"], config=self.config, device=self.device, **g0,
            )))

    def _serve_record(self, key: str, field: str, tag: str, compute) -> dict:
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
        partially used retry budget, a breaker that is not closed, or a
        window p99 over ``SBR_SERVE_SLO_MS``. ``window`` (a prior `LiveMetrics.window()`)
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
        return {"status": status, "reasons": reasons}

    def statz(self) -> dict:
        """Full live snapshot — the `/statz` body. The embedded window and
        the healthz verdict come from ONE fold of the slot ring."""
        window = self.live.window()
        return self.live.snapshot(self._live_extra(window=window), window=window)

    def prometheus(self) -> str:
        extra = {
            "sbr_serve_lru_entries": ("gauge", len(self._lru)),
            "sbr_serve_retry_budget_remaining": ("gauge", self.retry_budget.remaining),
        }
        slo = slo_ms()
        if slo is not None:
            extra["sbr_serve_slo_ms"] = ("gauge", slo)
        return self.live.to_prometheus(extra)

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
            },
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
            if batch:
                self.live.inflight = len(batch)
                try:
                    self._process(batch)
                finally:
                    self.live.inflight = 0
            if shutdown:
                break

    # -- processing ----------------------------------------------------------
    def _process(self, tickets: List[_Ticket]) -> None:
        """Serve a batch of tickets: cache lookups first, then the misses in
        bucket-padded dispatches. Identical queries inside one batch are
        coalesced into a single lane. Never raises: failures land on
        tickets."""
        groups: "OrderedDict[str, List[_Ticket]]" = OrderedDict()
        for t in tickets:
            rec, source = self._lookup(t.key)
            if rec is not None:
                # A cache hit is free: serve it even past its deadline.
                self._fulfill(t, rec, source)
            elif t.deadline is not None and time.monotonic() > t.deadline:
                # Expired while queued: shed now instead of burning a
                # dispatch on a dead query.
                self.live.record_shed()
                t.error = DeadlineExceeded(
                    "deadline expired while queued", retry_after_s=self._retry_after(),
                )
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
                rec = self._degraded_rec(t)
                for dup in groups[t.key]:
                    if rec is not None:
                        self._fulfill(dup, dict(rec), "tilecache", degraded=True)
                    else:
                        self.live.record_error()
                        dup.error = err
                        dup.event.set()
            return
        for t, rec in zip(chunk, records):
            # A divergent result is served (the caller sees the flags) but
            # never cached: a cached hit would replay the poisoned numbers
            # after /healthz recovered.
            if not (rec["flags"] & DIVERGENT_MASK):
                self._store(t.key, rec)
            for j, dup in enumerate(groups[t.key]):
                self._fulfill(dup, rec, "computed" if j == 0 else "coalesced")

    def _degraded_rec(self, t: _Ticket) -> Optional[dict]:
        """The tile-cache rung for one ticket: the matching swept cell's
        record, or None (counted ``ladder_exhausted``)."""
        try:
            rec = self.bridge.lookup(t.params, self.config, self.dtype_name)
        except Exception:
            rec = None  # a broken bridge must never mask the real error
        with self._ladder_lock:
            self.ladder["degraded" if rec is not None else "ladder_exhausted"] += 1
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
        self.live.record_query(
            latency, source, scenario=t.scenario, divergent=t.result.divergent
        )
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
            program = BucketProgram(bucket, self.config, self.dtype, self.device,
                                    self.graphs, cols, self._graph_pool, aprime_tol=tol)
            self._programs[key] = program
        return program

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
        self.live.record_batch(n, bucket)
        names = _GRAD_OUTPUTS if grads else _OUTPUTS
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
        except OSError:
            pass
