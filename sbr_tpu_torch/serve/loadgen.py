"""Seeded deterministic load generator for the serving engine, direct
mode: the port of ``sbr_tpu.serve.loadgen`` without its fleet.

``python -m sbr_tpu_torch.serve.loadgen`` drives a reproducible query mix
against an in-process `Engine` + `ServeEndpoint` (on the CUDA card unless
``--device cpu``), scrapes its own ``/metrics``, ``/healthz`` and
``/statz`` over HTTP, and prints ONE JSON summary line:

- the query stream is a seeded sample over a fixed parameter pool, so the
  same ``--seed``/``--pool``/``--queries`` always gives the same mix (and
  the same cache-hit trajectory);
- a **warm-up phase** queries every pool member once (each miss captures
  its bucket's graph or computes), then the **measured phase** replays
  the seeded mix. With ``--assert-warm`` the run exits 1 unless the
  measured phase shows a cache hit rate >= the floor AND zero new CUDA
  graph captures on the scraped counters.

``--fleet``, ``--trace-out``, ``--run-dir`` and the audit flags wait for
the fleet, tracing and the obs run log (ROADMAP 1.A items 9 and 10): they
exit 2 with a "not ported" message.

Exit codes: 0 ok, 1 failed assertion (--assert-warm), 2 setup error.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import urllib.error
import urllib.request
from typing import List

import torch

from sbr_tpu_torch.models.params import ModelParams, SolverConfig, make_model_params
from sbr_tpu_torch.serve.endpoint import ServeEndpoint
from sbr_tpu_torch.serve.engine import Engine, ServeConfig, default_buckets

# Flags of the reference's loadgen whose machinery is not ported yet.
_UNPORTED_FLAGS = {
    "fleet": ("--fleet", "1.A 10"),
    "fleet_dir": ("--fleet-dir", "1.A 10"),
    "fleet_kill_after": ("--fleet-kill-after", "1.A 10"),
    "answers_out": ("--answers-out", "1.A 10"),
    "trace_out": ("--trace-out", "1.A 9"),
    "run_dir": ("--run-dir", "1.A 9"),
    "audit_fault": ("--audit-fault", "1.A 9"),
    "audit_wait": ("--audit-wait", "1.A 9"),
}


def build_pool(seed: int, pool: int) -> List[ModelParams]:
    """``pool`` distinct parameter points, deterministically derived from
    ``seed``: β and u swept over their Figure-4/5 ranges, everything else
    at the reference defaults. The same values as the reference's."""
    rng = random.Random(seed)
    out = []
    for _ in range(pool):
        out.append(
            make_model_params(
                beta=round(rng.uniform(0.5, 4.0), 6),
                u=round(rng.uniform(0.02, 0.9), 6),
            )
        )
    return out


def query_mix(seed: int, pool_size: int, n: int) -> List[int]:
    """Seeded stream of pool indices (each drawn uniformly): repeated-mix
    traffic, the shape a warm cache should mostly absorb."""
    rng = random.Random(seed + 1)
    return [rng.randrange(pool_size) for _ in range(n)]


def params_doc(p: ModelParams) -> dict:
    """The /query wire form of one pool member, at full precision (repr
    round-trips floats exactly)."""
    return {
        "beta": p.learning.beta,
        "u": p.economic.u,
        "p": p.economic.p,
        "kappa": p.economic.kappa,
        "lam": p.economic.lam,
        "eta": p.economic.eta,
        "tspan": list(p.learning.tspan),
        "x0": p.learning.x0,
    }


def http_request(port: int, path: str, doc=None, headers=None, timeout: float = 120.0) -> tuple:
    """One request to a local endpoint: GET ``path``, or POST the JSON
    ``doc``. Returns (status code, body text, response headers), error
    statuses included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if doc is None else json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if doc is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode(), dict(err.headers or {})


def _scrape(port: int, path: str) -> tuple:
    code, body, _ = http_request(port, path, timeout=10)
    return code, body


def _metric_value(text: str, name: str) -> float:
    """Parse one un-labeled sample from Prometheus exposition text."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return float("nan")


def _parse_buckets(text: str) -> tuple:
    buckets = tuple(sorted({int(v) for v in text.split(",") if v.strip()}))
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"buckets must be positive ints, got {text!r}")
    return buckets


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.serve.loadgen",
        description="Drive a seeded deterministic query mix against an "
        "in-process serving engine; scrape /metrics, /healthz and /statz; "
        "print one JSON summary line",
    )
    parser.add_argument("--queries", type=int, default=200, help="measured-phase queries")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pool", type=int, default=24, help="distinct parameter points")
    parser.add_argument("--group", type=int, default=16,
                        help="queries submitted per query_many group")
    parser.add_argument("--n-grid", type=int, default=192, dest="n_grid")
    parser.add_argument("--bisect-iters", type=int, default=40, dest="bisect_iters")
    parser.add_argument("--buckets", default=None,
                        help="comma-separated batch buckets (default: SBR_SERVE_BUCKETS or 1,8,64)")
    parser.add_argument("--cache-dir", default=None,
                        help="on-disk result cache (default: SBR_SERVE_CACHE_DIR)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs eagerly)")
    parser.add_argument("--assert-warm", action="store_true",
                        help="exit 1 unless measured-phase hit rate >= floor and "
                        "zero new CUDA graph captures after warm-up (scraped from /metrics)")
    parser.add_argument("--hit-floor", type=float, default=0.5,
                        help="cache-hit-rate floor for --assert-warm (default 0.5)")
    parser.add_argument("--fleet", type=int, default=0, metavar="N", help="not ported")
    parser.add_argument("--fleet-dir", default=None, help="not ported")
    parser.add_argument("--fleet-kill-after", type=int, default=None, dest="fleet_kill_after",
                        help="not ported")
    parser.add_argument("--answers-out", default=None, dest="answers_out", help="not ported")
    parser.add_argument("--trace-out", default=None, dest="trace_out", help="not ported")
    parser.add_argument("--run-dir", default=None, help="not ported")
    parser.add_argument("--audit-fault", default=None, dest="audit_fault", help="not ported")
    parser.add_argument("--audit-wait", type=int, default=0, dest="audit_wait",
                        help="not ported")
    args = parser.parse_args(argv)

    for dest, (flag, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest):
            print(f"[loadgen] {flag} is not ported to sbr_tpu_torch yet (ROADMAP item {item})",
                  file=sys.stderr)
            return 2

    if args.buckets:
        try:
            buckets = _parse_buckets(args.buckets)
        except ValueError as err:
            print(f"[loadgen] bad --buckets: {err}", file=sys.stderr)
            return 2
    else:
        buckets = default_buckets() if os.environ.get("SBR_SERVE_BUCKETS") else (1, 8, 64)
    serve_cfg = ServeConfig.from_env(buckets=buckets, **(
        {"cache_dir": args.cache_dir} if args.cache_dir else {}
    ))
    config = SolverConfig(
        n_grid=args.n_grid, bisect_iters=args.bisect_iters, refine_crossings=False
    )

    pool = build_pool(args.seed, args.pool)
    mix = query_mix(args.seed, args.pool, args.queries)

    try:
        engine = Engine(config=config, serve=serve_cfg, device=args.device)
    except RuntimeError as err:  # no card and no --device cpu
        print(f"[loadgen] {err}", file=sys.stderr)
        return 2
    engine.start()
    endpoint = None
    try:
        endpoint = ServeEndpoint(engine).start()
        print(f"[loadgen] endpoint on 127.0.0.1:{endpoint.port}", file=sys.stderr)
        # Warm-up: every pool member once, which captures the buckets'
        # graphs and fills the result cache. Its counters are the baseline
        # of the measured phase.
        t0 = time.perf_counter()
        for i in range(0, len(pool), args.group):
            engine.query_many(pool[i : i + args.group], scenario="warmup", timeout=600)
        warmup_s = time.perf_counter() - t0
        _, warm_metrics = _scrape(endpoint.port, "/metrics")
        warm_captures = _metric_value(warm_metrics, "sbr_serve_graph_captures_total")
        warm_queries = _metric_value(warm_metrics, "sbr_serve_queries_total")
        warm_hits = _metric_value(warm_metrics, "sbr_serve_cache_hits_total")
        # Measured-phase quantiles via the histogram delta: lifetime
        # quantiles would be dominated by the warm-up's captures.
        hist_before = engine.live.total_hist.copy()
        t0 = time.perf_counter()
        for i in range(0, len(mix), args.group):
            engine.query_many([pool[j] for j in mix[i : i + args.group]], scenario="mix",
                              timeout=600)
        measured_s = time.perf_counter() - t0

        _, metrics_text = _scrape(endpoint.port, "/metrics")
        health_code, health_body = _scrape(endpoint.port, "/healthz")
        try:  # /statz must serve a coherent document
            statz = json.loads(_scrape(endpoint.port, "/statz")[1])
            statz_ok = isinstance((statz.get("totals") or {}).get("queries"), (int, float))
        except (OSError, ValueError):
            statz, statz_ok = {}, False

        post_captures = _metric_value(metrics_text, "sbr_serve_graph_captures_total")
        queries_total = _metric_value(metrics_text, "sbr_serve_queries_total")
        hits_total = _metric_value(metrics_text, "sbr_serve_cache_hits_total")
        measured_queries = queries_total - warm_queries
        measured_hits = hits_total - warm_hits
        hit_rate = measured_hits / measured_queries if measured_queries else 0.0
        capture_delta = post_captures - warm_captures

        lat = engine.live.total_hist.delta(hist_before).summary()
        summary = {
            "queries": int(measured_queries),
            "warmup_queries": int(warm_queries),
            "pool": args.pool,
            "seed": args.seed,
            "buckets": list(buckets),
            "device": str(engine.device),
            "device_name": (torch.cuda.get_device_name(engine.device)
                            if engine.device.type == "cuda" else "cpu"),
            "dtype": engine.dtype_name,
            "numerics": config.numerics,
            "cache_hit_rate": round(hit_rate, 4),
            "graph_captures": int(post_captures),
            "post_warmup_graph_captures": int(capture_delta),
            "p50_ms": lat.get("p50"),
            "p99_ms": lat.get("p99"),
            "qps": measured_queries / measured_s if measured_s else 0.0,
            "warmup_s": warmup_s,
            "healthz": json.loads(health_body),
            "healthz_http": health_code,
            "statz_ok": statz_ok,
            "occupancy": (statz.get("totals") or {}).get("occupancy"),
            "endpoint_port": endpoint.port,
        }
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()

    failures = []
    if args.assert_warm:
        if hit_rate < args.hit_floor:
            failures.append(
                f"measured cache hit rate {hit_rate:.3f} < floor {args.hit_floor}"
            )
        if capture_delta != 0:
            failures.append(
                f"{int(capture_delta)} CUDA graph capture(s) after warm-up (expected 0)"
            )
        if health_code != 200:
            failures.append(f"/healthz returned {health_code}")
        if not statz_ok:
            failures.append("/statz did not serve a coherent snapshot")
    summary["failures"] = failures
    print(json.dumps(summary))
    for f in failures:
        print(f"[loadgen] ASSERTION FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
