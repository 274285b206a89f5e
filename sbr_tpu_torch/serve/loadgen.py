"""Seeded deterministic load generator for the serving engine and the
multi-process serving fleet; the port of ``sbr_tpu.serve.loadgen``.

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

``--run-dir`` lands the engine's rolling ``live.json`` and its events in an
obs run directory that ``python -m sbr_tpu_torch.obs.report serve``
renders and gates. ``--trace-out PATH`` writes one JSONL row per measured
query: trace id, client latency, source, degraded, status, (β, u),
scenario and kind. With ``SBR_TRACE_SAMPLE`` > 0 loadgen mints one trace
a query (fleet mode: the router mints it), and the rows are the client
half that ``report trace`` joins, and the input ``python -m
sbr_tpu_torch.obs.demand replay`` rebuilds a demand surface from.

**Fleet mode** (``--fleet N``): spawn N worker processes (``python -m
sbr_tpu_torch.serve.fleet``, heartbeats in a scratch fleet dir; on the
card unless ``--device cpu``), front them with an in-process
`serve.router.Router`, and drive the SAME seeded mix over HTTP through
the router, ``--group`` queries at a time. The summary gains the fleet
headline (``fleet_p99_ms``, ``fleet_p50_ms``, ``fleet_qps``,
``fleet_failover_count``, ``fleet_shed_rate``, ``fleet_lost``: the keys of
history schema 7, appended to the port's own history with
``--history``), and fleet mode always asserts ZERO lost queries.
``--fleet-kill-after K`` SIGKILLs the router's favourite worker after K
measured queries (the router must fail over with zero lost queries and
byte-identical answers); ``--answers-out`` writes the per-query answers
for byte-identity comparisons; ``--audit-fault PLAN`` plants a fault plan
in worker 0 only and ``--audit-wait N`` holds the fleet until every
worker's heartbeat shows N audit cycles or a drift verdict (the router
then quarantines the drifted worker). ``--run-dir`` is the ROUTER's obs
run dir (``report fleet`` gates it); workers land theirs beside it.

Exit codes: 0 ok, 1 failed assertion (--assert-warm, a fleet loss), 2
setup error.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

import torch

from sbr_tpu_torch.models.params import ModelParams, SolverConfig, make_model_params
from sbr_tpu_torch.obs import trace as qtrace
from sbr_tpu_torch.serve.endpoint import ServeEndpoint
from sbr_tpu_torch.serve.engine import Engine, ServeConfig, default_buckets

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


# ---------------------------------------------------------------------------
# Fleet mode: N worker processes behind an in-process router
# ---------------------------------------------------------------------------


def spawn_worker(fleet_dir: str, n_grid: int, bisect_iters: int, buckets: str,
                 run_dir: Optional[str] = None, cache_dir: Optional[str] = None,
                 device: Optional[str] = None, heartbeat_ttl: float = 30.0,
                 timeout_s: float = 180.0,
                 extra_env: Optional[dict] = None) -> dict:
    """Spawn one fleet worker process and wait for its readiness line.
    Returns ``{"proc", "url", "host", "pid", "device"}``; raises on a
    worker that exits or is not ready within ``timeout_s`` (it is killed
    first): with no card and no ``device="cpu"`` the worker exits 2, so
    this raises. ``extra_env`` overlays the inherited environment for THIS
    worker only (``--audit-fault`` plants worker 0's fault plan through
    it)."""
    argv = [
        sys.executable, "-m", "sbr_tpu_torch.serve.fleet",
        "--fleet-dir", str(fleet_dir),
        "--n-grid", str(n_grid),
        "--bisect-iters", str(bisect_iters),
        "--buckets", buckets,
        "--heartbeat-ttl", str(heartbeat_ttl),
    ]
    if device:
        argv += ["--device", str(device)]
    if run_dir:
        argv += ["--run-dir", str(run_dir)]
    if cache_dir:
        argv += ["--cache-dir", str(cache_dir)]
    env = {**os.environ, **{k: str(v) for k, v in extra_env.items()}} if extra_env else None
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=sys.stderr.fileno(), text=True, env=env,
    )
    line: dict = {}
    err: Optional[str] = None

    def read_ready():
        nonlocal err
        raw = ""
        try:
            raw = proc.stdout.readline()
            line.update(json.loads(raw))
        except Exception as e:  # noqa: BLE001 (surfaced below)
            err = f"{e!r} (raw={raw!r})"

    t = threading.Thread(target=read_ready, daemon=True)
    t.start()
    t.join(timeout_s)
    if not line.get("url"):
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(
            f"fleet worker failed to become ready within {timeout_s:.0f}s "
            f"(exit code {proc.returncode})" + (f": {err}" if err else "")
        )
    return {"proc": proc, "url": line["url"], "host": line.get("host"),
            "pid": line.get("pid", proc.pid), "device": line.get("device")}


def spawn_workers(fleet_dir: str, n_grid: int, bisect_iters: int, buckets: str,
                  run_dirs: list, envs: list, **kw) -> list:
    """`spawn_worker` once a ``run_dirs`` entry, all at once (each worker's
    CUDA start-up overlaps the others'), worker i with ``run_dirs[i]`` and
    ``envs[i]``; the list is in worker order. On any failure the workers
    that did start are stopped and the first error raises."""
    n = len(run_dirs)
    out: List[Optional[dict]] = [None] * n
    errors: List[BaseException] = []

    def one(i):
        try:
            out[i] = spawn_worker(fleet_dir, n_grid, bisect_iters, buckets,
                                  run_dir=run_dirs[i], extra_env=envs[i], **kw)
        except BaseException as err:  # noqa: BLE001 (raised below)
            errors.append(err)

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        stop_workers([w for w in out if w is not None])
        raise errors[0]
    return out


def stop_workers(workers: list, skip_pid=None) -> None:
    """SIGTERM every worker (but ``skip_pid``, already dead) and wait for
    each; a worker still running after 30 s is killed."""
    for w in workers:
        if w["pid"] != skip_pid:
            try:
                w["proc"].terminate()
            except OSError:
                pass
    for w in workers:
        try:
            w["proc"].wait(timeout=30)
        except Exception:
            w["proc"].kill()
            w["proc"].wait(timeout=30)


def run_fleet(args) -> dict:
    """Fleet mode, behind ``--fleet``: N worker processes and an
    in-process router, the seeded warm-up and measured mix over HTTP, an
    optional mid-run worker kill. Returns the summary dict (``failures``
    included); the per-query answers go to ``--answers-out``."""
    from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LogHistogram
    from sbr_tpu_torch.serve.router import Router

    pool = build_pool(args.seed, args.pool)
    mix = query_mix(args.seed, args.pool, args.queries)
    docs = [json.dumps(params_doc(p)).encode() for p in pool]

    scratch = tempfile.mkdtemp(prefix="sbr_fleet_")
    fleet_dir = args.fleet_dir or os.path.join(scratch, "fleet")
    workers: list = []
    router = None
    failures: List[str] = []
    answers: List[Optional[dict]] = [None] * len(mix)
    trace_rows: List[Optional[dict]] = [None] * len(mix)
    hist = LogHistogram(DEFAULT_LATENCY_BOUNDS_MS)
    killed: dict = {}
    ready_s = None
    try:
        audit_fault = getattr(args, "audit_fault", None)
        run_dirs = [os.path.join(args.run_dir + "_workers", f"w{i}") if args.run_dir else None
                    for i in range(args.fleet)]
        # --audit-fault plants the fault plan in worker 0 ONLY: one worker's
        # canaries drift, and the peers must stay clean
        envs = [{"SBR_FAULT_PLAN": audit_fault} if (audit_fault and i == 0) else None
                for i in range(args.fleet)]
        t0 = time.perf_counter()
        workers = spawn_workers(fleet_dir, args.n_grid, args.bisect_iters,
                                args.buckets or "1,8,64", run_dirs, envs,
                                cache_dir=args.cache_dir, device=args.device)
        ready_s = time.perf_counter() - t0
        router = Router(fleet_dir, run_dir=args.run_dir, poll_s=0.2).start()
        base = f"http://127.0.0.1:{router.port}/query"
        print(f"[loadgen] fleet of {len(workers)} worker(s) behind {base}", file=sys.stderr)

        def post(doc: bytes, timeout: float = 300.0) -> tuple:
            req = urllib.request.Request(
                base, data=doc, headers={"Content-Type": "application/json"}, method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.status, json.loads(resp.read()), dict(resp.headers)
            except urllib.error.HTTPError as e:
                hdrs = dict(e.headers or {})
                try:
                    return e.code, json.loads(e.read()), hdrs
                except ValueError:
                    return e.code, {}, hdrs
            except OSError as e:
                # connection reset or refused, client timeout: a counted
                # failure (an exception escaping the recording thread would
                # vanish and let the zero-lost assertion pass)
                return 599, {"error": repr(e)}, {}

        def run_group(indices, record):
            threads = [threading.Thread(target=record, args=(pos, idx), daemon=True)
                       for pos, idx in indices]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        def warm_one(pos, pool_idx):
            code, _, _ = post(docs[pool_idx])
            if code != 200:
                failures.append(f"warmup query {pos} (pool {pool_idx}) -> {code}")

        # Warm-up: every pool member, --group at a time (the concurrency
        # spreads the pool over the workers, so each captures its buckets)
        for i in range(0, len(pool), args.group):
            run_group([(j, j) for j in range(i, min(i + args.group, len(pool)))], warm_one)

        completed = [0]
        kill_lock = threading.Lock()

        def maybe_kill():
            if args.fleet_kill_after is None or killed or len(workers) < 2:
                return
            with kill_lock:
                if killed or completed[0] < args.fleet_kill_after:
                    return
                # the router's FAVOURITE worker: the lowest routing score
                # (EWMA × (1 + in flight), most forwards on a tie), so the
                # router keeps preferring it after its death until its
                # breaker opens, the hardest failover case
                stats = router.statz()["workers"]

                def favourite(w):
                    st = stats.get(w["host"], {})
                    score = st.get("ewma_ms", float("inf")) * (1 + st.get("inflight", 0))
                    return score, -st.get("forwards", 0)

                victim = min(workers, key=favourite)
                killed.update(host=victim["host"], pid=victim["pid"])
                os.kill(victim["pid"], signal.SIGKILL)
                # the kill is complete once the process is gone: from here on
                # its address refuses connections instead of accepting into a
                # dying socket
                victim["proc"].wait(timeout=30)
                print(f"[loadgen] SIGKILLed worker {victim['host']} (pid {victim['pid']}) "
                      f"after {completed[0]} queries", file=sys.stderr)

        def measured_one(pos, pool_idx):
            t0 = time.monotonic()
            code, doc, hdrs = post(docs[pool_idx])
            dur_ms = (time.monotonic() - t0) * 1e3
            if code == 200:
                hist.record(dur_ms)
                answers[pos] = doc
            elif code == 429:
                answers[pos] = {"shed": True}
            else:
                failures.append(f"measured query {pos} (pool {pool_idx}) -> {code}: {doc}")
            # the trace id from the body when a worker answered, else the
            # router's echoed header (sheds and errors carry it too)
            tid = doc.get("trace_id") if isinstance(doc, dict) else None
            if tid is None:
                tid = hdrs.get(qtrace.TRACE_HEADER)
            trace_rows[pos] = {
                "query": pos, "pool": pool_idx, "trace_id": tid,
                "latency_ms": round(dur_ms, 3), "status": code,
                "source": doc.get("source") if isinstance(doc, dict) else None,
                "degraded": bool(doc.get("degraded")) if isinstance(doc, dict) else None,
                "beta": pool[pool_idx].learning.beta,
                "u": pool[pool_idx].economic.u,
                "scenario": "mix",
                "kind": "plain",
            }
            completed[0] += 1
            maybe_kill()

        t0 = time.monotonic()
        for i in range(0, len(mix), args.group):
            run_group([(j, mix[j]) for j in range(i, min(i + args.group, len(mix)))],
                      measured_one)
        measured_s = time.monotonic() - t0

        # --audit-wait N: hold the (idle) fleet until every worker's
        # heartbeat shows >= N canary cycles or a drift verdict, so the
        # router's next refresh applies the quarantine. The cadence comes
        # from SBR_AUDIT_INTERVAL_S in the workers' environment.
        audit_wait = int(getattr(args, "audit_wait", 0) or 0)
        if audit_wait > 0:
            deadline = time.monotonic() + float(getattr(args, "audit_wait_s", None) or 120.0)
            while time.monotonic() < deadline:
                blocks = {h: (w.get("audit") or {})
                          for h, w in router.statz()["workers"].items()}
                if blocks and all(b.get("status") == "drift"
                                  or int(b.get("cycles") or 0) >= audit_wait
                                  for b in blocks.values()):
                    break
                time.sleep(0.25)
            else:
                failures.append(f"audit-wait: not every worker reached {audit_wait} "
                                "canary cycle(s) in time")

        router_stats = router.statz()
    finally:
        if router is not None:
            router.close()
        stop_workers(workers, skip_pid=killed.get("pid"))
        import shutil

        # the scratch dir (and the fleet dir inside it, unless the caller
        # gave one) is ours: repeated runs leave no debris
        shutil.rmtree(scratch, ignore_errors=True)

    counters = router_stats["counters"]
    shed = counters.get("shed", 0)
    summary = {
        "fleet": args.fleet,
        "queries": len(mix),
        "answered": sum(1 for a in answers if a is not None and "shed" not in a),
        "pool": args.pool,
        "seed": args.seed,
        "device": workers[0]["device"] if workers else None,
        "workers_ready_s": ready_s,
        "fleet_p99_ms": hist.quantile(0.99),
        "fleet_p50_ms": hist.quantile(0.5),
        "fleet_failover_count": counters.get("failover", 0),
        "fleet_shed_rate": round(shed / max(len(mix), 1), 4),
        "fleet_qps": len(mix) / measured_s if measured_s else 0.0,
        "fleet_lost": counters.get("failed", 0),
        "fleet_degraded": counters.get("degraded", 0),
        "killed_worker": killed.get("host"),
        "router_counters": counters,
        "run_dir": args.run_dir,
    }
    # the audit census: each worker's final heartbeat block and the
    # router's quarantine, absent when no worker reported one (SBR_AUDIT off)
    audit_blocks = {h: w.get("audit") for h, w in (router_stats.get("workers") or {}).items()
                    if w.get("audit")}
    if audit_blocks:
        summary["audit"] = {
            "workers": audit_blocks,
            "quarantined": sorted(h for h, w in router_stats["workers"].items()
                                  if w.get("quarantined")),
        }
    summary["failures"] = list(failures)
    if args.answers_out:
        with open(args.answers_out, "w") as fh:
            json.dump(answers, fh)
    if getattr(args, "trace_out", None):
        _write_trace_rows(args.trace_out, trace_rows)
        summary["trace_out"] = args.trace_out
        summary["traced_queries"] = sum(
            1 for r in trace_rows if r is not None and r.get("trace_id"))
    return summary


def _append_history(path, summary: dict, label: str, platform: str) -> str:
    """Append the summary's history keys (schema 7's fleet keys, or the
    serving ones) to the port's history file; returns its path."""
    from sbr_tpu_torch.obs import history

    return str(history.append(history.bench_metrics({"extra": summary}), label=label,
                              platform=platform, path=path or None))


def _write_trace_rows(path: str, rows: List[Optional[dict]]) -> None:
    """``--trace-out``: one JSONL row per measured query (trace id, client
    latency, source, degraded, status, (β, u), scenario and kind)."""
    with open(path, "w") as fh:
        for row in rows:
            if row is not None:
                fh.write(json.dumps(row) + "\n")


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
    parser.add_argument("--fleet", type=int, default=0, metavar="N",
                        help="fleet mode: N worker processes behind an in-process "
                        "router; asserts zero lost queries")
    parser.add_argument("--fleet-dir", default=None,
                        help="shared fleet rendezvous dir (default: scratch)")
    parser.add_argument("--fleet-kill-after", type=int, default=None, metavar="K",
                        dest="fleet_kill_after",
                        help="SIGKILL one worker after K measured queries "
                        "(fleet mode; needs >= 2 workers)")
    parser.add_argument("--answers-out", default=None, dest="answers_out",
                        help="write the per-query answer list (JSON) here "
                        "(fleet mode; byte-identity comparisons)")
    parser.add_argument("--history", default=None, nargs="?", const="", metavar="PATH",
                        help="fleet mode: append the fleet keys (history schema 7) "
                        "to the port's history (default SBR_OBS_HISTORY or "
                        "output_torch/bench_history.jsonl)")
    parser.add_argument("--trace-out", default=None, dest="trace_out",
                        help="write per-measured-query JSONL rows (trace id, latency, source, "
                        "degraded, beta, u) here; trace ids are null unless SBR_TRACE_SAMPLE > 0")
    parser.add_argument("--run-dir", default=None,
                        help="obs run dir for the rolling live.json (report serve reads it)")
    parser.add_argument("--audit-fault", default=None, dest="audit_fault",
                        help="fault plan (inline JSON or path) planted as "
                        "SBR_FAULT_PLAN in worker 0 ONLY (fleet mode)")
    parser.add_argument("--audit-wait", type=int, default=0, dest="audit_wait", metavar="N",
                        help="after the measured phase, wait until every worker "
                        "heartbeat shows >= N audit canary cycles or a drift verdict "
                        "(fleet mode; needs SBR_AUDIT=1 in the workers' env)")
    parser.add_argument("--audit-wait-s", type=float, default=120.0, dest="audit_wait_s",
                        help="timeout for --audit-wait (default 120 s)")
    args = parser.parse_args(argv)

    if args.fleet:
        try:
            summary = run_fleet(args)
        except Exception as err:  # noqa: BLE001 (set-up failures exit 2)
            print(f"[loadgen] fleet setup failed: {err!r}", file=sys.stderr)
            return 2
        failures = list(summary["failures"])
        if summary.get("fleet_lost", 0) > 0:
            failures.append(f"router lost {summary['fleet_lost']} quer(ies)")
        summary["failures"] = failures
        if args.history is not None:
            summary["history"] = _append_history(
                args.history, summary, "loadgen_fleet",
                "gpu" if str(summary.get("device") or "").startswith("cuda") else "cpu")
        print(json.dumps(summary))
        for f in failures:
            print(f"[loadgen] ASSERTION FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    if args.history is not None:
        print("[loadgen] --history needs --fleet", file=sys.stderr)
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
        engine = Engine(config=config, serve=serve_cfg, run_dir=args.run_dir, device=args.device)
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
        tracing = qtrace.sample_rate() > 0
        trace_rows: List[Optional[dict]] = [None] * len(mix)
        writer = engine.trace_writer() if tracing else None
        t_slo = qtrace.slo_ms()
        t0 = time.perf_counter()
        for i in range(0, len(mix), args.group):
            span_pos = list(range(i, min(i + args.group, len(mix))))
            ctxs = None
            if tracing:
                # loadgen is the trace minter: its ``loadgen.query`` root
                # stands where the endpoint's worker.request would
                ctxs = [qtrace.mint(service="loadgen") for _ in span_pos]
                for c in ctxs:
                    if c is not None:
                        c.parent_id = c.alloc_id()
            t0g_w, t0g_m = time.time(), time.monotonic()
            results = engine.query_many([pool[mix[p]] for p in span_pos], scenario="mix",
                                        timeout=600, traces=ctxs)
            dur_g = time.monotonic() - t0g_m
            for k, p in enumerate(span_pos):
                r = results[k]
                row = {
                    "query": p, "pool": mix[p], "trace_id": None,
                    "latency_ms": round(dur_g * 1e3, 3), "status": 200,
                    "source": r.source, "degraded": bool(r.degraded),
                    # the demand replay's input
                    "beta": pool[mix[p]].learning.beta,
                    "u": pool[mix[p]].economic.u,
                    "scenario": "mix",
                    "kind": "plain",
                }
                c = ctxs[k] if ctxs is not None else None
                if c is not None:
                    c.add("loadgen.query", t0g_w, dur_g, parent=c.remote_parent,
                          span_id=c.parent_id, pool=mix[p], source=r.source)
                    row["trace_id"] = c.trace_id
                    if writer is not None:
                        writer.commit(c, exemplar=t_slo is not None and dur_g * 1e3 > t_slo)
                trace_rows[p] = row
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
            "run_dir": args.run_dir,
        }
        if args.trace_out:
            _write_trace_rows(args.trace_out, trace_rows)
            summary["trace_out"] = args.trace_out
            summary["traced_queries"] = sum(
                1 for r in trace_rows if r is not None and r.get("trace_id")
            )
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
