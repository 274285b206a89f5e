"""Fleet router: throughput-weighted query routing with failover, hedged
retries, deadline propagation, and per-worker circuit breaking; the port
of ``sbr_tpu.serve.router``, the same routing decisions, counters, events
and exposition.

The same stdlib-http shape as `serve.endpoint` — one daemon-thread
``ThreadingHTTPServer`` — but in front of N workers instead of one engine:

- **Routing.** The worker table comes from the shared fleet dir's
  heartbeats (`serve.fleet.live_workers`, refreshed at most every
  ``SBR_FLEET_POLL_S``). Each worker carries an EWMA service-latency
  estimate, seeded from the perf history's ``serve_p50_ms``
  (`obs.history.recent_median`) so a cold router starts from the
  fleet-typical rate, then updated from measured forwards. A query goes
  to the admissible (breaker-closed, heartbeat-live) worker with the
  lowest projected finish time ``ewma_ms × (1 + inflight)`` — fast idle
  workers absorb proportionally more traffic, ties break by host id so
  every router instance ranks identically.
- **Failover.** A forward that fails (connection refused/reset, timeout,
  worker 5xx) records a breaker failure and re-dispatches to the next
  best worker — at-most-once side effects are structural: results are
  pure and fingerprint-keyed, so a duplicate dispatch can only produce
  the identical bytes (loadgen's ``--fleet-kill-after`` drill asserts
  byte-identity under a mid-run worker kill). A worker 429 is NOT failed over: shedding is
  deliberate backpressure and re-trying it elsewhere would defeat it.
- **Hedging.** With ``SBR_ROUTER_HEDGE_MS`` set, a forward that has not
  returned within the hedge budget launches ONE secondary request on the
  next-best peer; the first response wins, and exactly one latency
  sample is recorded per query (hedged wins never double-count — tested
  deadline semantics).
- **Deadlines.** The client's deadline (``X-SBR-Deadline-Ms`` header or
  body field, else ``SBR_SERVE_DEADLINE_MS``) is decremented by elapsed
  routing time and propagated to the worker on every attempt; expired
  deadlines shed with 429 + ``Retry-After`` at the router without
  touching a worker.
- **Breakers.** One `serve.fleet.CircuitBreaker` per worker: consecutive
  forward failures open it (the worker stops absorbing traffic), a
  cooldown later one half-open probe decides. Transitions are obs
  ``fleet`` events and `/healthz` degraded reasons.

Telemetry: every failover/hedge/shed/loss is an obs ``fleet`` event
(manifest roll-up included), and a rolling ``fleet.json`` snapshot lands
in the run dir via `RunContext.live_snapshot` — ``python -m
sbr_tpu_torch.obs.report fleet RUN_DIR`` renders and GATES it (exit 1 on lost
queries or a breaker stuck open).

No torch import in this module: the router is pure host networking. The
workers behind it hold the card.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from sbr_tpu_torch.obs import trace as qtrace
from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LogHistogram
from sbr_tpu_torch.serve.fleet import (
    CircuitBreaker,
    _env_float,
    default_deadline_ms,
    live_workers,
)

SCHEMA = "sbr-fleet/1"


class _Worker:
    """Router-side view of one fleet worker."""

    __slots__ = ("host", "url", "ewma_ms", "inflight", "breaker", "forwards",
                 "failures", "last_hb", "quarantined")

    def __init__(self, host: str, url: str, ewma_ms: float, breaker: CircuitBreaker):
        self.host = host
        self.url = url
        self.ewma_ms = ewma_ms
        self.inflight = 0
        self.breaker = breaker
        self.forwards = 0
        self.failures = 0
        self.last_hb: dict = {}
        # Numerics-audit quarantine: set while the worker's
        # heartbeat reports audit status "drift" — treated exactly like an
        # open breaker by _candidates (routed around, capacity not
        # correctness), cleared only when a heartbeat reads clean again
        # (drift latches worker-side, so in practice: a worker restart).
        self.quarantined = False

    def score(self) -> float:
        return self.ewma_ms * (1.0 + self.inflight)


class _ForwardError(RuntimeError):
    """One failed forward attempt (connection error, timeout, worker 5xx)."""


class _Shed(RuntimeError):
    """A 429 from admission (router-side deadline check or a worker)."""

    def __init__(self, msg: str, retry_after_s: float = 0.1) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Router:
    """The fleet front door (see module docstring).

    Construction binds the listen socket; `start()` serves on a daemon
    thread. ``run_dir`` starts an owned obs run (like `Engine`) whose
    events + rolling ``fleet.json`` are what ``report fleet`` gates.
    """

    def __init__(self, fleet_root, host: str = "127.0.0.1", port: int = 0,
                 run=None, run_dir: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 forward_timeout_s: Optional[float] = None) -> None:
        self.fleet_root = fleet_root
        self.poll_s = poll_s if poll_s is not None else _env_float("SBR_FLEET_POLL_S", 0.5)
        self.hedge_ms = hedge_ms if hedge_ms is not None else _env_float("SBR_ROUTER_HEDGE_MS", None)
        self.forward_timeout_s = (
            forward_timeout_s if forward_timeout_s is not None
            else _env_float("SBR_ROUTER_TIMEOUT_S", 30.0)
        )
        self.default_deadline_ms = default_deadline_ms()

        self._owned_run = None
        if run is None and run_dir is not None:
            from sbr_tpu_torch import obs

            run = self._owned_run = obs.start_run(label="router", run_dir=run_dir)
        if run is None:
            from sbr_tpu_torch import obs

            run = obs.active_run()
        self._run = run

        self._workers: Dict[str, _Worker] = {}
        self._workers_lock = threading.Lock()
        self._scanned_at = 0.0
        self._seed_ms = self._seed_latency_ms()

        # Counters under a lock: unlike LiveMetrics (whose hot path runs on
        # the single batcher thread and tolerates a dropped WINDOW count),
        # these are mutated by N concurrent handler threads and "failed"
        # gates the zero-lost-queries contract — a torn increment there
        # would be a silent pass on a run that lost a query.
        self.counters: Dict[str, int] = {
            k: 0
            for k in (
                "queries", "completed", "failed", "shed", "degraded",
                "failover", "hedged", "hedge_wins", "forward_errors",
                "client_errors",
            )
        }
        self._counters_lock = threading.Lock()
        self.latency_hist = LogHistogram(DEFAULT_LATENCY_BOUNDS_MS)
        self.started_at = time.time()
        self._last_write = 0.0

        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                print(f"[serve.router] {fmt % args}", file=sys.stderr)

            def _send(self, code: int, body: bytes, ctype="application/json",
                      headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                try:
                    if self.path.split("?", 1)[0] != "/query":
                        self._send(404, b'{"error": "not found"}')
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(n)
                    code, out, headers = router.handle_query(
                        body, self.headers.get("X-SBR-Deadline-Ms"),
                        trace_header=self.headers.get(qtrace.TRACE_HEADER),
                        parent_header=self.headers.get(qtrace.PARENT_HEADER),
                    )
                    self._send(code, out, headers=headers)
                except BrokenPipeError:
                    pass
                except Exception as err:
                    try:
                        self._send(500, json.dumps({"error": repr(err)}).encode())
                    except Exception:
                        pass

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/healthz":
                        doc = router.healthz()
                        code = 503 if doc["status"] == "unhealthy" else 200
                        self._send(code, json.dumps(doc).encode())
                    elif path == "/statz":
                        self._send(200, json.dumps(router.statz(), default=str).encode())
                    elif path == "/metrics":
                        self._send(
                            200, router.prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    else:
                        self._send(404, b'{"error": "not found"}')
                except BrokenPipeError:
                    pass
                except Exception as err:
                    try:
                        self._send(500, json.dumps({"error": repr(err)}).encode())
                    except Exception:
                        pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = int(self.httpd.server_address[1])
        self._started = False
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="sbr-router-http", daemon=True
        )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Router":
        self._started = True
        self._thread.start()
        return self

    def close(self) -> None:
        try:
            if self._started:
                self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        self._write_fleet_snapshot(force=True)
        if self._owned_run is not None:
            from sbr_tpu_torch.obs import runlog

            runlog._finalize_if_active(self._owned_run)

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- membership / cost model ---------------------------------------------
    def _seed_latency_ms(self) -> float:
        """Cold-start EWMA seed: the fleet-typical serve p50 from the perf
        history (`history.recent_median`), else 50 ms. Deterministic — the
        same history seeds every router instance identically."""
        try:
            from sbr_tpu_torch.obs import history

            med = history.recent_median("serve_p50_ms")
            if med is not None and med > 0:
                return float(med)
        except Exception:
            pass
        return 50.0

    def refresh_workers(self, force: bool = False) -> None:
        """Sync the worker table with the fleet dir's live heartbeats (at
        most every ``poll_s`` unless forced). Vanished heartbeats (expired
        TTL or a graceful drain's withdrawal) drop the worker — reclaim is
        instant for drained workers, TTL-bounded for silent deaths."""
        now = time.monotonic()
        if not force and now - self._scanned_at < self.poll_s:
            return
        with self._workers_lock:
            if not force and now - self._scanned_at < self.poll_s:
                return
            self._scanned_at = now
            live = live_workers(self.fleet_root)
            for host, rec in live.items():
                w = self._workers.get(host)
                if w is None:
                    w = self._workers[host] = _Worker(
                        host, str(rec["url"]), self._seed_ms,
                        CircuitBreaker(
                            on_transition=self._breaker_logger(host)
                        ),
                    )
                    self._log_fleet("worker_join", worker=host, url=w.url)
                w.url = str(rec["url"])
                w.last_hb = rec
                drifted = (rec.get("audit") or {}).get("status") == "drift"
                if drifted and not w.quarantined:
                    w.quarantined = True
                    self._log_fleet(
                        "audit_quarantine", worker=host,
                        probes=",".join(
                            (rec.get("audit") or {}).get("drift_probes") or []
                        ),
                    )
                elif w.quarantined and not drifted:
                    w.quarantined = False
                    self._log_fleet("audit_unquarantine", worker=host)
            for host in list(self._workers):
                if host not in live:
                    self._log_fleet("worker_lost", worker=host)
                    del self._workers[host]

    def _breaker_logger(self, host: str):
        def on_transition(old: str, new: str) -> None:
            self._log_fleet(f"breaker_{new}", worker=host, previous=old)

        return on_transition

    def _candidates(self, exclude=()) -> list:
        """Admissible workers, best first (see module docstring). Uses the
        breaker's side-effect-free `admissible()` — `allow()` (which grants
        the single half-open probe) is called by `_forward` only for the
        worker actually sent to, so ranking can never strand a breaker in
        half-open with a probe nobody owns."""
        self.refresh_workers()
        with self._workers_lock:
            workers = [
                w for h, w in self._workers.items() if h not in exclude
            ]
        # An audit-quarantined worker is handled like an open breaker:
        # numerically drifted answers must not reach clients, so the
        # worker keeps serving canaries but receives no queries.
        admissible = [
            w for w in workers if w.breaker.admissible() and not w.quarantined
        ]
        return sorted(admissible, key=lambda w: (w.score(), w.host))

    # -- the query path ------------------------------------------------------
    def handle_query(self, body: bytes, deadline_header: Optional[str],
                     trace_header: Optional[str] = None,
                     parent_header: Optional[str] = None) -> tuple:
        """Route one query; returns (status_code, body_bytes, headers).

        Distributed tracing: the router MINTS the trace here
        (or adopts an inbound ``X-SBR-Trace-Id``), owns the
        ``router.request`` root span, propagates the id on every forward,
        and commits the finished trace to its own run dir — SLO breaches
        (``SBR_SERVE_SLO_MS`` as resolved at the router) always kept as
        tail-latency exemplars. The trace id is echoed as a response
        header on every outcome, including sheds and failures."""
        ctx = qtrace.from_headers(trace_header, parent_header, service="router")
        root_id = ctx.alloc_id() if ctx is not None else None
        t0w, t0 = time.time(), time.monotonic()
        code, out, headers = self._handle_routed(body, deadline_header, t0,
                                                 ctx, root_id)
        if ctx is not None:
            dur = time.monotonic() - t0
            outcome = (
                "completed" if code == 200
                else "shed" if code == 429
                else "client_error" if 400 <= code < 500
                else "failed"
            )
            ctx.add("router.request", t0w, dur, parent=ctx.remote_parent,
                    span_id=root_id, status=code, outcome=outcome)
            try:
                writer = qtrace.writer_for(self._run)
                if writer is not None:
                    slo = qtrace.slo_ms()
                    breach = slo is not None and dur * 1e3 > slo
                    writer.commit(ctx, exemplar=breach)
            except Exception:
                pass  # tracing must never break routing
            headers = dict(headers)
            headers[qtrace.TRACE_HEADER] = ctx.trace_id
        return code, out, headers

    def _handle_routed(self, body: bytes, deadline_header: Optional[str],
                       t0: float, trace=None, parent=None) -> tuple:
        """The routing body behind `handle_query` (deadline resolution,
        failover loop, counters); returns (status_code, body_bytes,
        headers)."""
        self._inc("queries")
        deadline_ms = None
        try:
            if deadline_header is not None:
                deadline_ms = float(deadline_header)
            else:
                try:
                    doc = json.loads(body.decode() or "{}")
                    if isinstance(doc, dict) and doc.get("deadline_ms") is not None:
                        deadline_ms = float(doc["deadline_ms"])
                except (ValueError, UnicodeDecodeError):
                    pass  # the worker 400s malformed bodies — not our job
        except (TypeError, ValueError):
            # A malformed header is the CLIENT's error, never a routing
            # loss — `report fleet` gates on "failed", and one typo must
            # not trip a zero-lost-queries gate on a healthy fleet.
            self._inc("client_errors")
            return 400, b'{"error": "bad deadline"}', {}
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (
            t0 + deadline_ms / 1e3 if deadline_ms is not None else None
        )

        try:
            code, out = self._route(body, deadline, t0, trace=trace,
                                    parent=parent)
        except _Shed as err:
            self._inc("shed")
            self._log_fleet("shed", reason=str(err))
            self._write_fleet_snapshot()
            return (
                429,
                json.dumps({"error": "deadline", "detail": str(err),
                            "retry_after_s": err.retry_after_s}).encode(),
                {"Retry-After": f"{err.retry_after_s:g}"},
            )
        except Exception as err:
            self._inc("failed")
            self._log_fleet("lost", error=repr(err))
            self._write_fleet_snapshot()
            return 503, json.dumps({"error": repr(err)}).encode(), {}
        if 400 <= code < 500:
            # Worker-answered client error, passed through verbatim: not a
            # completion, not a loss, and not a latency sample.
            self._inc("client_errors")
            self._write_fleet_snapshot()
            return code, out, {}
        self._inc("completed")
        try:
            if json.loads(out.decode()).get("degraded"):
                self._inc("degraded")
        except (ValueError, UnicodeDecodeError, AttributeError):
            pass
        # Exactly ONE latency sample per query — a hedged win must not
        # record both racers (tested deadline/hedging semantics).
        self.latency_hist.record((time.monotonic() - t0) * 1e3)
        self._write_fleet_snapshot()
        return code, out, {}

    def _remaining_ms(self, deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        return (deadline - time.monotonic()) * 1e3

    def _route(self, body: bytes, deadline: Optional[float], t0: float,
               trace=None, parent=None) -> tuple:
        """Failover loop: try admissible workers best-first until one
        answers, hedging stragglers when configured."""
        remaining = self._remaining_ms(deadline)
        if remaining is not None and remaining <= 0:
            raise _Shed("deadline expired before routing", retry_after_s=0.1)
        tried: set = set()
        last_err: Optional[Exception] = None
        while True:
            candidates = self._candidates(exclude=tried)
            if not candidates:
                if last_err is not None:
                    raise last_err
                raise RuntimeError("no admissible fleet workers")
            worker = candidates[0]
            hedge_peer = candidates[1] if len(candidates) > 1 else None
            tried.add(worker.host)
            try:
                if self.hedge_ms is not None and hedge_peer is not None:
                    code, out = self._forward_hedged(
                        worker, hedge_peer, body, deadline,
                        trace=trace, parent=parent,
                    )
                else:
                    code, out = self._forward(worker, body, deadline,
                                              trace=trace, parent=parent)
            except _Shed:
                raise
            except Exception as err:
                last_err = err
                self._inc("forward_errors")
                if self._candidates(exclude=tried):
                    self._inc("failover")
                    self._log_fleet(
                        "failover", worker=worker.host, error=repr(err),
                    )
                    continue
                raise
            return code, out

    def _forward(self, worker: _Worker, body: bytes,
                 deadline: Optional[float], trace=None, parent=None,
                 role: Optional[str] = None) -> tuple:
        """One forward attempt to one worker; raises `_ForwardError` on
        anything failover-able, `_Shed` on a worker 429.

        With ``trace`` set, the attempt propagates ``X-SBR-Trace-Id`` (and
        this span's id as ``X-SBR-Parent-Span`` — the worker's request span
        parents to it) and records one ``router.forward`` span per attempt,
        outcome-labeled, so the aggregator sees failover and hedge
        causality per query. ``role`` labels hedge racers
        ("primary"/"hedge")."""
        from sbr_tpu_torch.resilience import faults
        from sbr_tpu_torch.resilience.faults import InjectedFault

        remaining = self._remaining_ms(deadline)
        if remaining is not None and remaining <= 0:
            raise _Shed("deadline expired mid-routing", retry_after_s=0.1)
        # Take the breaker's admission at SEND time (this may be the one
        # half-open probe — from here on this forward owes an outcome). A
        # False means another thread won the probe between ranking and
        # sending: move on without charging a failure.
        if not worker.breaker.allow():
            raise _ForwardError(f"worker {worker.host} breaker not admitting")
        timeout = self.forward_timeout_s
        if remaining is not None:
            timeout = min(timeout, max(remaining / 1e3, 0.05))
        headers = {"Content-Type": "application/json"}
        if remaining is not None:
            headers["X-SBR-Deadline-Ms"] = f"{remaining:g}"
        fid = None
        if trace is not None:
            fid = trace.alloc_id()
            headers[qtrace.TRACE_HEADER] = trace.trace_id
            headers[qtrace.PARENT_HEADER] = fid
        req = urllib.request.Request(
            worker.url + "/query", data=body, headers=headers, method="POST"
        )
        worker.inflight += 1
        worker.forwards += 1
        t0w, t0 = time.time(), time.monotonic()
        outcome, err_name, code = "ok", None, None
        try:
            faults.fire("router.forward", target=worker.host)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out = resp.read()
                code = resp.status
        except InjectedFault as err:
            outcome, err_name = "error", "injected"
            worker.failures += 1
            worker.breaker.record_failure()
            raise _ForwardError(f"injected forward fault: {err}") from err
        except urllib.error.HTTPError as err:
            body_bytes = err.read()
            code = err.code
            if err.code == 429:
                # Backpressure is deliberate: pass it through, don't dodge
                # it by hammering a peer with the same unmeetable deadline.
                outcome = "shed"
                retry_after = 0.1
                try:
                    retry_after = float(err.headers.get("Retry-After") or 0.1)
                except (TypeError, ValueError):
                    pass
                worker.breaker.record_success()  # the worker is healthy
                raise _Shed(
                    f"worker {worker.host} shed the query",
                    retry_after_s=retry_after,
                ) from err
            if 400 <= err.code < 500:
                # A client error (bad params, bad body) is the CLIENT's
                # fault: re-sending the same bytes to a peer would 4xx
                # everywhere, charge every breaker, and finally read as a
                # "lost" query on a healthy fleet. Pass it through — the
                # worker answered correctly.
                outcome = "client_error"
                worker.breaker.record_success()
                return err.code, body_bytes
            outcome, err_name = "error", f"http_{err.code}"
            worker.failures += 1
            worker.breaker.record_failure()
            raise _ForwardError(
                f"worker {worker.host} returned {err.code}: "
                f"{body_bytes[:200]!r}"
            ) from err
        except (OSError, urllib.error.URLError) as err:
            rem = self._remaining_ms(deadline)
            if rem is not None and rem <= 1.0:
                # The QUERY's deadline clamped this forward's timeout and
                # has now run out: the deadline expired in flight — that is
                # the client's budget, not evidence against the worker.
                # Charging the breaker here would let a burst of
                # tight-deadline traffic open breakers on healthy workers;
                # crediting a success would be equally unearned — release
                # any held probe with no verdict.
                outcome, err_name = "shed", "deadline_in_flight"
                worker.breaker.record_abandoned()
                raise _Shed(
                    f"deadline exhausted in flight on {worker.host}",
                    retry_after_s=0.1,
                ) from err
            outcome, err_name = "error", type(err).__name__
            worker.failures += 1
            worker.breaker.record_failure()
            raise _ForwardError(f"worker {worker.host} unreachable: {err}") from err
        finally:
            worker.inflight = max(worker.inflight - 1, 0)
            if trace is not None:
                trace.add(
                    "router.forward", t0w, time.monotonic() - t0,
                    parent=parent, span_id=fid, worker=worker.host,
                    outcome=outcome, status=code, role=role, error=err_name,
                )
        worker.breaker.record_success()
        dur_ms = (time.monotonic() - t0) * 1e3
        worker.ewma_ms = 0.3 * dur_ms + 0.7 * worker.ewma_ms
        return code, out

    def _forward_hedged(self, worker: _Worker, peer: _Worker, body: bytes,
                        deadline: Optional[float], trace=None,
                        parent=None) -> tuple:
        """Primary forward with one hedge: if the primary hasn't answered
        within ``hedge_ms``, race a secondary on ``peer``; first response
        wins. The loser is abandoned (its duplicate dispatch is benign —
        results are pure and fingerprint-keyed)."""
        import queue as _queue

        outcomes: "_queue.Queue" = _queue.Queue()

        def attempt(w: _Worker, role: str) -> None:
            try:
                code, out = self._forward(w, body, deadline,
                                          trace=trace, parent=parent,
                                          role=role)
            except Exception as err:  # noqa: BLE001 — collected, not dropped
                outcomes.put(("error", err, w, role))
            else:
                outcomes.put(("ok", (code, out), w, role))

        threading.Thread(target=attempt, args=(worker, "primary"), daemon=True).start()
        try:
            first = outcomes.get(timeout=self.hedge_ms / 1e3)
        except _queue.Empty:
            first = None
        if first is not None:
            kind, payload, _, _ = first
            if kind == "ok":
                return payload
            raise payload
        # Primary is a straggler: hedge on the peer; first response wins,
        # the loser is abandoned (benign duplicate — pure results).
        self._inc("hedged")
        self._log_fleet("hedge", worker=worker.host, peer=peer.host)
        threading.Thread(target=attempt, args=(peer, "hedge"), daemon=True).start()
        first = outcomes.get()
        kind, payload, w, role = first
        if kind == "error":
            # The first finisher failed; the other racer decides.
            kind, payload, w, role = outcomes.get()
        if kind == "ok":
            if role == "hedge":
                self._inc("hedge_wins")
                self._log_fleet("hedge_win", worker=w.host)
            return payload
        raise payload

    # -- exposition ----------------------------------------------------------
    def healthz(self) -> dict:
        self.refresh_workers()
        with self._workers_lock:
            workers = dict(self._workers)
        open_breakers = [h for h, w in workers.items() if w.breaker.state == "open"]
        quarantined = [h for h, w in workers.items() if w.quarantined]
        routable = [
            h for h, w in workers.items()
            if w.breaker.state != "open" and not w.quarantined
        ]
        reasons = []
        status = "ready"
        if not routable:
            status = "unhealthy"
            reasons.append("no routable workers")
        elif open_breakers:
            status = "degraded"
            reasons.append(f"breaker open for: {', '.join(sorted(open_breakers))}")
        if quarantined and status != "unhealthy":
            status = "degraded"
            reasons.append(
                f"audit quarantine for: {', '.join(sorted(quarantined))}"
            )
        if self.counters["failed"]:
            status = "unhealthy" if status == "unhealthy" else "degraded"
            reasons.append(f"{self.counters['failed']} lost quer(ies)")
        return {"status": status, "reasons": reasons,
                "workers": len(workers), "routable": len(routable),
                "quarantined": len(quarantined)}

    def statz(self) -> dict:
        self.refresh_workers()
        with self._workers_lock:
            workers = {
                h: {
                    "url": w.url,
                    "ewma_ms": round(w.ewma_ms, 3),
                    "inflight": w.inflight,
                    "forwards": w.forwards,
                    "failures": w.failures,
                    "breaker": w.breaker.state,
                    "breaker_age_s": (
                        round(w.breaker.age_s(), 3)
                        if w.breaker.age_s() is not None else None
                    ),
                    "healthz": (w.last_hb or {}).get("healthz"),
                    "qps": (w.last_hb or {}).get("qps"),
                    "quarantined": w.quarantined,
                    "audit": (w.last_hb or {}).get("audit"),
                    "prewarm": (w.last_hb or {}).get("prewarm"),
                    "flight": (w.last_hb or {}).get("flight"),
                }
                for h, w in self._workers.items()
            }
        fleet_demand = self.fleet_demand()
        fleet_prewarm = self.fleet_prewarm()
        fleet_flight = self.fleet_flight()
        return {
            "schema": SCHEMA,
            "ts": round(time.time(), 3),
            "started_at": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(self.started_at)
            ),
            "counters": dict(self.counters),
            "latency_ms": self.latency_hist.summary(),
            "workers": workers,
            "healthz": self.healthz(),
            "hedge_ms": self.hedge_ms,
            "default_deadline_ms": self.default_deadline_ms,
            # Fleet demand surface: absent — not null-valued —
            # when no worker heartbeats a demand block, so a demand-off
            # fleet's /statz and fleet.json stay byte-free of the key.
            **({"demand": fleet_demand} if fleet_demand is not None else {}),
            # Fleet prewarm roll-up: same absent-when-off
            # contract — a prewarm-off fleet's /statz stays byte-free.
            **({"prewarm": fleet_prewarm} if fleet_prewarm is not None else {}),
            # Fleet utilization roll-up: same absent-when-off
            # contract — a flight-off fleet's /statz stays byte-free.
            **({"flight": fleet_flight} if fleet_flight is not None else {}),
        }

    def fleet_flight(self) -> "Optional[dict]":
        """Roll the workers' heartbeat flight blocks up into
        one fleet utilization view: dispatch-weighted mean device-busy /
        host-gap fractions plus summed dispatch and dropped-record
        counts. Returns None when no worker published a block — a
        flight-off fleet keeps the structural no-op."""
        with self._workers_lock:
            blocks = [
                ((w.last_hb or {}).get("flight"), h)
                for h, w in sorted(self._workers.items())
            ]
        blocks = [(b, h) for b, h in blocks if isinstance(b, dict)]
        if not blocks:
            return None
        dispatches = sum(int(b.get("dispatches") or 0) for b, _ in blocks)
        dropped = sum(int(b.get("dropped_records") or 0) for b, _ in blocks)
        weighted = [
            (float(b["device_busy_frac"]),
             max(int(b.get("dispatches") or 0), 1))
            for b, _ in blocks if b.get("device_busy_frac") is not None
        ]
        busy = None
        if weighted:
            wsum = sum(w for _, w in weighted)
            busy = round(sum(f * w for f, w in weighted) / wsum, 4)
        return {
            "workers": [h for _, h in blocks],
            "dispatches": dispatches,
            "dropped_records": dropped,
            "device_busy_frac": busy,
            "host_gap_frac": (
                round(1.0 - busy, 4) if busy is not None else None
            ),
        }

    def fleet_prewarm(self) -> "Optional[dict]":
        """Roll the workers' heartbeat prewarm blocks up into
        one fleet view: per-plan progress summed across sweepers plus the
        worst per-worker status. Returns None when no worker published a
        block — a prewarm-off fleet keeps the structural no-op."""
        with self._workers_lock:
            blocks = [
                ((w.last_hb or {}).get("prewarm"), h)
                for h, w in sorted(self._workers.items())
            ]
        blocks = [(b, h) for b, h in blocks if isinstance(b, dict)]
        if not blocks:
            return None
        plans: Dict[str, dict] = {}
        worst, worst_rank = "idle", 0
        ranks = {"rejected": 3, "budget_exhausted": 3, "sweeping": 2,
                 "done": 1, "no_cache": 1, "idle": 0}
        for b, host in blocks:
            status = str(b.get("status") or "idle")
            if ranks.get(status, 0) > worst_rank:
                worst, worst_rank = status, ranks.get(status, 0)
            fp = b.get("plan")
            if fp:
                p = plans.setdefault(
                    str(fp),
                    {"tiles_done": 0, "tiles_total": 0, "abandoned": 0,
                     "workers": []},
                )
                p["tiles_done"] += int(b.get("tiles_done") or 0)
                p["tiles_total"] = max(
                    p["tiles_total"], int(b.get("tiles_total") or 0)
                )
                p["abandoned"] += int(b.get("abandoned") or 0)
                p["workers"].append(host)
        return {
            "status": worst,
            "workers": [h for _, h in blocks],
            "plans": plans,
        }

    def fleet_demand(self) -> "Optional[dict]":
        """Merge the workers' heartbeat demand surfaces into
        the fleet demand surface — the prefetch advisor's fleet-wide
        input. Workers are folded in sorted-host order, so the merged
        sketch is deterministic for a given set of heartbeats. Returns
        None (and, deliberately, does not even import `obs.demand`) when
        no worker published a block: a demand-off fleet keeps the
        structural no-op."""
        with self._workers_lock:
            blocks = [
                ((w.last_hb or {}).get("demand"), h)
                for h, w in sorted(self._workers.items())
            ]
        blocks = [(b, h) for b, h in blocks if isinstance(b, dict)]
        if not blocks:
            return None
        from sbr_tpu_torch.obs import demand as _demand

        merged = _demand.merge_surfaces([b for b, _ in blocks])
        merged["workers"] = [h for _, h in blocks]
        merged["hot_bins"] = _demand.hot_bins(merged)
        return merged

    def prometheus(self) -> str:
        lines = []
        for k, v in sorted(self.counters.items()):
            name = f"sbr_fleet_{k}_total"
            lines += [f"# TYPE {name} counter", f"{name} {int(v)}"]
        with self._workers_lock:
            workers = dict(self._workers)
        lines.append("# TYPE sbr_fleet_workers gauge")
        lines.append(f"sbr_fleet_workers {len(workers)}")
        lines.append("# TYPE sbr_fleet_worker_ewma_ms gauge")
        for h, w in sorted(workers.items()):
            lines.append(f'sbr_fleet_worker_ewma_ms{{worker="{h}"}} {w.ewma_ms:g}')
        lines += self.latency_hist.to_prometheus("sbr_fleet_latency_ms")
        # Fleet demand surface gauges: appended only when some
        # worker heartbeats a demand block — a demand-off fleet's
        # exposition stays byte-free of sbr_demand.
        demand = self.fleet_demand()
        if demand is not None:
            hot = demand.get("hot_bins") or []
            hot_q = sum(h.get("count", 0) for h in hot)
            hot_warm = sum(h.get("warm", 0) for h in hot)
            cov = hot_warm / hot_q if hot_q else 0.0
            lines += [
                "# TYPE sbr_demand_fleet_window_queries gauge",
                f"sbr_demand_fleet_window_queries {int(demand.get('queries') or 0)}",
                "# TYPE sbr_demand_fleet_workers gauge",
                f"sbr_demand_fleet_workers {len(demand.get('workers') or [])}",
                "# TYPE sbr_demand_fleet_hot_bins gauge",
                f"sbr_demand_fleet_hot_bins {len(hot)}",
                "# TYPE sbr_demand_fleet_hot_warm_coverage gauge",
                f"sbr_demand_fleet_hot_warm_coverage {cov:g}",
            ]
        # Fleet prewarm gauges: same byte-free-when-off rule.
        prewarm = self.fleet_prewarm()
        if prewarm is not None:
            plans = prewarm.get("plans") or {}
            lines += [
                "# TYPE sbr_prewarm_fleet_workers gauge",
                f"sbr_prewarm_fleet_workers {len(prewarm.get('workers') or [])}",
                "# TYPE sbr_prewarm_fleet_tiles_done gauge",
                "sbr_prewarm_fleet_tiles_done "
                f"{sum(p['tiles_done'] for p in plans.values())}",
                "# TYPE sbr_prewarm_fleet_tiles_abandoned gauge",
                "sbr_prewarm_fleet_tiles_abandoned "
                f"{sum(p['abandoned'] for p in plans.values())}",
            ]
        # Fleet utilization gauges: same byte-free-when-off rule.
        flight = self.fleet_flight()
        if flight is not None:
            busy = flight.get("device_busy_frac")
            lines += [
                "# TYPE sbr_flight_fleet_workers gauge",
                f"sbr_flight_fleet_workers {len(flight.get('workers') or [])}",
                "# TYPE sbr_flight_fleet_dispatches gauge",
                f"sbr_flight_fleet_dispatches {int(flight.get('dispatches') or 0)}",
                "# TYPE sbr_flight_fleet_dropped_records gauge",
                "sbr_flight_fleet_dropped_records "
                f"{int(flight.get('dropped_records') or 0)}",
                "# TYPE sbr_flight_fleet_device_busy_frac gauge",
                f"sbr_flight_fleet_device_busy_frac "
                f"{busy if busy is not None else 0:g}",
            ]
        return "\n".join(lines) + "\n"


    def _inc(self, name: str, n: int = 1) -> None:
        """Locked counter increment (see the counters comment in __init__)."""
        with self._counters_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- telemetry -----------------------------------------------------------
    def _log_fleet(self, action: str, **fields) -> None:
        if self._run is None:
            return
        try:
            self._run.log_fleet(action, **fields)
        except Exception:
            pass

    def _write_fleet_snapshot(self, force: bool = False,
                              min_interval_s: float = 0.5) -> None:
        """Rolling ``fleet.json`` in the run dir (atomic rename via
        `live_snapshot`) — what ``report fleet`` reads on a RUNNING or
        finished router."""
        if self._run is None:
            return
        now = time.monotonic()
        if not force and now - self._last_write < min_interval_s:
            return
        self._last_write = now
        try:
            self._run.live_snapshot(self.statz(), name="fleet.json")
        except Exception:
            pass


def main(argv=None) -> int:
    """Run a standalone router: ``python -m sbr_tpu_torch.serve.router
    --fleet-dir DIR [--port P] [--run-dir D]``. Prints one JSON readiness
    line and serves until SIGTERM/SIGINT (graceful shutdown finalizes the
    obs run and the final fleet.json)."""
    import argparse

    from sbr_tpu_torch.resilience.shutdown import graceful_shutdown

    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.serve.router",
        description="Serving-fleet router (throughput-weighted routing, "
        "failover, hedging, deadlines)",
    )
    parser.add_argument("--fleet-dir", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--run-dir", default=None)
    args = parser.parse_args(argv)

    router = Router(args.fleet_dir, port=args.port, run_dir=args.run_dir).start()
    print(json.dumps({"url": f"http://127.0.0.1:{router.port}"}), flush=True)
    with graceful_shutdown(label="serve_router"):
        try:
            while True:
                time.sleep(1.0)
        finally:
            router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
