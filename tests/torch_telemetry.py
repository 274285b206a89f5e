"""One served query sequence through either package's engine, with every
query traced, for the telemetry tests of the port (tests/test_torch_trace.py,
test_torch_flight.py, test_torch_demand.py).

`drive(pkg)` runs, on an unstarted engine (the inline, thread-free path):
two misses and a duplicate in one batch (computed, computed, coalesced),
an LRU hit, an admission shed for an expired deadline, one for an
unmeetable deadline, a query that expires while queued, then, with the
breaker open, a degraded answer from a stubbed tile-cache rung and a
query the ladder cannot answer. It returns the spans of every query's
context, the engine's answers, its demand snapshot (``SBR_DEMAND``) and
its flight records (``SBR_FLIGHT``), whichever switches the caller set.

`span_structure` drops what differs by design between two runs (span and
trace ids, times) and keeps each span's name, its parent's name and its
attributes.
"""

import numpy as np
import pytest

WAIT = 120  # seconds: every wait is bounded
REMOTE = "00c0ffee"  # the caller's span every engine.query hangs under
DEGRADED = {"xi": 3.5, "tau_bar_in": float("nan"), "aw_max": 0.25, "status": 0, "flags": 0,
            "residual": float("nan")}


def packages(pkg):
    """(params, engine, trace, flight) modules of ``pkg`` ("ref" or "port")."""
    if pkg == "ref":
        from sbr_tpu.models import params
        from sbr_tpu.obs import flight, trace
        from sbr_tpu.serve import engine
    else:
        from sbr_tpu_torch.models import params
        from sbr_tpu_torch.obs import flight, trace
        from sbr_tpu_torch.serve import engine
    return params, engine, trace, flight


def make_engine(pkg, **kw):
    P, E, _, _ = packages(pkg)
    cfg = P.SolverConfig(n_grid=64, bisect_iters=30, refine_crossings=False, numerics="fixed")
    extra = {} if pkg == "ref" else {"device": "cpu"}
    return E.Engine(config=cfg, serve=E.ServeConfig(buckets=(1, 8)), **kw, **extra)


def drive(pkg, run_dir=None):
    """The query sequence of the module docstring; see there."""
    P, E, T, F = packages(pkg)
    F.reset_shared()
    ctxs = []

    def ctx():
        c = T.TraceContext(f"{len(ctxs):016x}", service="worker")
        c.parent_id = REMOTE
        ctxs.append(c)
        return c

    p0, p1 = P.make_model_params(), P.make_model_params(u=0.2)
    p2, p3, p4 = (P.make_model_params(u=u) for u in (0.3, 0.35, 0.4))
    engine = make_engine(pkg, **({"run_dir": str(run_dir)} if run_dir is not None else {}))
    answers = []
    try:
        answers += engine.query_many([p0, p1, p0], traces=[ctx(), ctx(), ctx()], timeout=WAIT)
        answers += engine.query_many([p0], traces=[ctx()], timeout=WAIT)
        for deadline_ms in (-1.0, 1e-9):  # expired; under the service estimate
            with pytest.raises(E.DeadlineExceeded):
                engine.query(p2, deadline_ms=deadline_ms, trace=ctx())
        engine._service_ewma_s = None  # admits a 1 ns deadline, which then expires queued
        with pytest.raises(E.DeadlineExceeded):
            engine.query(p2, deadline_ms=1e-6, trace=ctx())
        for _ in range(engine.breaker.threshold):
            engine.breaker.record_failure()
        engine.bridge.lookup = lambda params, config, dtype: (
            dict(DEGRADED) if params.economic.u == 0.35 else None)
        answers += engine.query_many([p3], traces=[ctx()], timeout=WAIT)
        with pytest.raises(E.SolverUnavailable):
            engine.query(p4, trace=ctx())
        demand = engine.demand.snapshot() if engine.demand is not None else None
        flight = engine.flight.snapshot() if engine.flight is not None else None
    finally:
        engine.close()
    return {"spans": [c.spans for c in ctxs], "answers": answers, "demand": demand,
            "flight": flight}


def answer_bits(answers):
    return [(np.float64(r.xi).tobytes(), np.float64(r.aw_max).tobytes(), r.status, r.flags,
             r.source, r.degraded) for r in answers]


def span_structure(spans):
    """Each span as (name, parent's name, attributes): ids and times dropped.
    A parent outside the list shows as its id (the caller's span)."""
    names = {s["span"]: s["name"] for s in spans}
    out = []
    for s in spans:
        parent = s.get("parent")
        attrs = {k: v for k, v in s.items()
                 if k not in ("trace", "span", "parent", "ts", "dur_ms")}
        out.append((s["name"], names.get(parent, parent), attrs))
    return out


def flight_structure(snap):
    """The ring's records without their times, (stream, kind, tag, seq,
    phase, val), in write order: by stream, then seq, a begin before its
    end."""
    return [tuple(r[1:]) for r in sorted(snap["records"], key=lambda r: (r[1], r[4], r[5] == "e"))]
