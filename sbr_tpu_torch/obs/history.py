"""Append-only performance history and the trend/regression gate; the
port of ``sbr_tpu.obs.history``.

Every bench run appends one line of headline metrics to an append-only
``bench_history.jsonl`` (path from ``SBR_OBS_HISTORY``, default
``output_torch/bench_history.jsonl``, the port's own file), and the
``report trend`` CLI renders per-metric timelines (sparkline and rolling-
median baseline) and gates:

    python -m sbr_tpu_torch.obs.report trend [HISTORY]            # timelines
    python -m sbr_tpu_torch.obs.report trend --check --tolerance 0.15
    # exit 0 flat/improving · 1 regression beyond tolerance · 3 missing or
    # short history (a gate with nothing to compare must not pass silently)

Regression semantics: the latest record is compared per metric against the
rolling median of up to ``--window`` prior records from the same platform
(a CPU run must never read as a 100× regression of the card). Polarity is
inferred from the metric's name: ``*_per_sec``, throughput, hit rates and
speedups are higher-better; ``*_s``/``*_ms`` durations, byte counts,
divergent cells, failovers, sheds and overhead ratios lower-better. A
lower-better metric whose baseline is 0 regresses on any increase.

The elastic scheduler's throughput records live in a sidecar
(``<history>.elastic.jsonl``, `resilience.elastic.seed_rate_from_history`),
so cost-model lines never displace bench lines.

Standard library only: no ``torch`` import, so the gate never pays for a
device runtime.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

# The record schema is the reference's (``sbr_tpu.obs.history.SCHEMA``), so
# one gate reads both packages' histories; readers accept every version
# (the key set only grows, and `load` stamps schema-less lines as 1).
SCHEMA = 14
_SPARK = "▁▂▃▄▅▆▇█"
DEFAULT_PATH = "output_torch/bench_history.jsonl"


def history_path(path=None) -> Path:
    """Resolve the history file: explicit arg > SBR_OBS_HISTORY env >
    ``output_torch/bench_history.jsonl`` (the port's own; never the
    reference's ``benchmarks/bench_history.jsonl``)."""
    if path:
        return Path(path)
    env = os.environ.get("SBR_OBS_HISTORY", "").strip()
    return Path(env) if env else Path(DEFAULT_PATH)


def append(metrics: dict, label: str = "bench", platform: Optional[str] = None,
           path=None, meta: Optional[dict] = None) -> Path:
    """Append one history record (single buffered write — concurrent
    appenders interleave whole lines on POSIX). Non-finite and non-numeric
    metric values are dropped: the history carries only gateable numbers."""
    clean = {}
    for k, v in (metrics or {}).items():
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)) and math.isfinite(v):
            clean[str(k)] = v
    rec = {
        "schema": SCHEMA,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "label": label,
        "platform": platform,
        "metrics": clean,
    }
    if meta:
        rec["meta"] = meta
    p = history_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return p


def load(path=None) -> list:
    """Parse a history file into record dicts, in file order; unparseable
    or schema-less lines are skipped (an append-only log must tolerate a
    torn tail write)."""
    p = history_path(path)
    records = []
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return records
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and isinstance(rec.get("metrics"), dict):
            # Schema-less lines predate versioning (= schema 1); schemas
            # 2-8 are pure supersets, so every known version loads
            # uniformly and older lines keep gating newer appends.
            rec.setdefault("schema", 1)
            records.append(rec)
    return records


def bench_metrics(result: dict) -> dict:
    """Headline metrics from one bench-JSON result dict (the ``extra``
    layout of bench.py / benchmarks/*.py): primary metric under its own
    name, throughput/duration extras, and the obs compile/execute split."""
    out = {}
    value = result.get("value")
    if isinstance(value, (int, float)):
        out[str(result.get("metric") or "value")] = value
    extra = result.get("extra") or {}
    for key in (
        "agent_steps_per_sec",
        "grid_first_call_s",
        "grid_dispatch_s",
        "grid_pipelined_s",
        "agents_steady_s",
        "agents_prep_s",
        # schema 2: per-workload allocator peaks (absent on CPU backends
        # without memory_stats — the gate simply has no memory series there)
        "grid_mem_peak_bytes",
        "agents_mem_peak_bytes",
        # schema 3: the serving workload (bench.py bench_serve / loadgen):
        # latency quantiles are lower-better (_ms polarity), hit rate higher
        "serve_p50_ms",
        "serve_p99_ms",
        "serve_cache_hit_rate",
        # schema 4: the tiled-sweep workload (bench.py bench_sweep): cold
        # compute throughput, warm cross-run-cache re-sweep throughput, and
        # the warm hit rate (all higher-better by polarity)
        "sweep_cold_cells_per_sec",
        "sweep_warm_cells_per_sec",
        "sweep_warm_hit_rate",
        # schema 5: the adaptive-numerics split (bench.py bench_grid):
        # speedup of the default adaptive program over the bit-exact fixed
        # control (higher-better) and mean effective root-find iterations
        # per cell (lower-better by the _iters polarity rule)
        "grid_adaptive_speedup",
        "grid_mean_effective_iters",
        # schema 6: the mega-scale agents generation split (bench.py
        # bench_agents on graphgen): build duration lower-better by the _s
        # rule, generation throughput and device-vs-host speedup higher
        "agents_graph_build_s",
        "agents_graph_gen_edges_per_sec",
        "agents_graph_gen_speedup",
        # schema 7: the serving-fleet workload (loadgen --fleet / bench.py
        # bench_fleet): client p99 through the router, failover count, and
        # the admission shed rate (all lower-better by polarity)
        "fleet_p99_ms",
        "fleet_failover_count",
        "fleet_shed_rate",
        # schema 8: the differentiable-equilibria workload (bench.py
        # bench_grad): sensitivity-surface gradient throughput and
        # calibration step rate (both higher-better by the per_sec rule)
        "grads_per_sec",
        "calib_steps_per_sec",
        # schema 9: the composable-scenario workload (bench.py
        # bench_scenario): composed-over-legacy grid overhead ratio
        # (lower-better by the overhead rule) and multi-bank contagion
        # throughput (higher-better by the per_sec rule)
        "scenario_overhead_ratio",
        "scenario_multibank_cells_per_sec",
        # schema 10: the information-model workload (bench.py
        # bench_infomodels): fused belief-update throughput and population
        # what-if query rate (both higher-better by the per_sec rule)
        "infomodel_belief_updates_per_sec",
        "infomodel_population_queries_per_sec",
        # schema 11: the numerics-audit workload (bench.py bench_audit):
        # canary-battery probe throughput (higher-better by the per_sec
        # rule) and serve-loop audit-on/off overhead ratio (lower-better
        # by the overhead rule)
        "audit_probes_per_sec",
        "audit_overhead_ratio",
        # schema 12: the workload-demand observatory (bench.py
        # bench_demand): streaming sketch/histogram update throughput
        # (higher-better by the per_sec rule) and the router-side fleet
        # merge cost (lower-better by the _ms rule)
        "demand_updates_per_sec",
        "demand_merge_ms",
        # schema 13: the self-healing prefetch workload (bench.py
        # bench_prewarm): outage warm hit rate from prefetched tiles
        # (higher-better by the hit_rate rule), degraded-answer p99
        # (lower-better by the _ms rule), and controller sweep throughput
        # (higher-better by the per_sec rule)
        "prewarm_warm_hit_rate",
        "prewarm_outage_p99_ms",
        "prewarm_tiles_per_sec",
        # schema 14: the dispatch-pipeline flight recorder (bench.py
        # bench_flight): recorder-on over recorder-off serve latency
        # (lower-better by the overhead rule), device-busy fraction of
        # the engine window (higher-better — default polarity), and the
        # host-gap complement (lower-better by the host_gap rule)
        "flight_overhead_ratio",
        "flight_device_busy_frac",
        "flight_host_gap_frac",
    ):
        v = extra.get(key)
        if isinstance(v, (int, float)):
            # A zero byte-peak means "no allocator stats", not "used zero
            # bytes" — recording it would arm the zero-baseline regression
            # rule on noise. Durations/throughputs keep their raw value.
            if key.endswith("_bytes") and v <= 0:
                continue
            out[key] = v
    obs_blk = extra.get("obs") or {}
    for src, dst in (
        ("compile_s", "obs_compile_s"),
        ("execute_s", "obs_execute_s"),
        ("xla_backend_compile_s", "xla_backend_compile_s"),
        # schema 2: the run's overall peak (live-buffer based on CPU, so
        # memory regressions gate even without allocator stats)
        ("memory_peak_bytes", "mem_peak_bytes"),
    ):
        v = obs_blk.get(src)
        if isinstance(v, (int, float)):
            if dst.endswith("_bytes") and v <= 0:
                continue  # zero byte-peak = no data, not a clean baseline
            out[dst] = v
    return out


# ---------------------------------------------------------------------------
# Trend analysis
# ---------------------------------------------------------------------------


def polarity(metric: str) -> int:
    """+1 when higher is better (throughput, cache hit rates, speedups), -1
    when lower is better (durations, latencies, byte counts, divergence,
    effective-iteration, failover/shed counts, overhead ratios)."""
    m = metric.lower()
    if (
        m.endswith("_per_sec")
        or "per_sec" in m
        or "throughput" in m
        or "hit_rate" in m
        or "speedup" in m
    ):
        return 1
    if (
        m.endswith("_s")
        or m.endswith("_ms")
        or m.endswith("_bytes")
        or m.endswith("_iters")
        or m.endswith("_count")
        or "latency" in m
        or "divergent" in m
        or "retrace" in m
        or "shed" in m
        or "failover" in m
        # schema 9: a composed pipeline's cost over its legacy control —
        # growing overhead is a regression even though it's a ratio
        or "overhead" in m
        # schema 14: the host-side bubble fraction of the engine window —
        # a rising gap means the device is starving behind the host
        or "host_gap" in m
    ):
        return -1
    return 1


def _median(vals: list) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _same_platform(records: list, platform) -> list:
    """Records comparable to ``platform``: exact matches, plus records
    that never recorded one (legacy lines gate against everything)."""
    return [r for r in records if r.get("platform") in (platform, None)]


def recent_median(metric: str, path=None, platform=None, window: int = 8):
    """Median of the most recent ``window`` values of one metric in the
    history (optionally restricted to ``platform``), or None when the
    metric has never been recorded — the deterministic seed the elastic
    scheduler's cost model reads (`resilience.elastic`). torch-free, like
    everything in this module."""
    records = load(path)
    if platform is not None:
        records = _same_platform(records, platform)
    vals = [
        r["metrics"][metric]
        for r in records
        if isinstance(r.get("metrics", {}).get(metric), (int, float))
        and math.isfinite(r["metrics"][metric])
    ]
    if not vals:
        return None
    return _median(vals[-window:])


def check(records: list, tolerance: float = 0.15, min_points: int = 3,
          window: int = 5, metrics_filter=None) -> tuple:
    """Regression verdicts for the latest record vs a rolling-median
    baseline of up to ``window`` prior same-platform records.

    Returns ``(verdicts, status)`` where status is "ok", "regression", or
    "short" (no metric reached ``min_points`` records — the gate has
    nothing trustworthy to compare). Per-metric verdicts carry latest /
    baseline / signed relative change / direction / status.
    """
    if not records:
        return {}, "short"
    latest = records[-1]
    prior = _same_platform(records[:-1], latest.get("platform"))
    verdicts = {}
    gateable = 0
    for metric, value in sorted((latest.get("metrics") or {}).items()):
        if metrics_filter and metric not in metrics_filter:
            continue
        hist = [
            r["metrics"][metric]
            for r in prior
            if isinstance(r["metrics"].get(metric), (int, float))
        ]
        n = len(hist) + 1
        if n < min_points:
            verdicts[metric] = {"latest": value, "n": n, "status": "short"}
            continue
        gateable += 1
        base = _median(hist[-window:])
        pol = polarity(metric)
        direction = "higher_better" if pol > 0 else "lower_better"
        if base == 0:
            # Relative change is undefined; for lower-better counts (e.g.
            # health_divergent) any increase from a clean baseline regresses.
            change = None
            regressed = pol < 0 and value > 0
        else:
            change = (value - base) / abs(base)
            worsening = -change if pol > 0 else change
            regressed = worsening > tolerance
        verdicts[metric] = {
            "latest": value,
            "baseline": base,
            "n": n,
            "change": None if change is None else round(change, 4),
            "direction": direction,
            "status": "regression" if regressed else "ok",
        }
    if gateable == 0:
        return verdicts, "short"
    status = (
        "regression"
        if any(v["status"] == "regression" for v in verdicts.values())
        else "ok"
    )
    return verdicts, status


def sparkline(values: list, width: int = 24) -> str:
    """Unicode sparkline of a series, downsampled to ``width`` points."""
    vals = [v for v in values if isinstance(v, (int, float)) and math.isfinite(v)]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[min(int(i * step), len(vals) - 1)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    if hi == lo:
        return _SPARK[3] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))] for v in vals)


def _fmt_val(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_trend(records: list, window: int = 5, metrics_filter=None) -> str:
    """Per-metric timeline table, grouped by platform: count, latest value,
    rolling-median baseline of the prior window, signed change, sparkline."""
    if not records:
        return "no history records"
    from sbr_tpu_torch.obs.report import _table  # shared table renderer (torch-free)

    out = [
        f"history  {len(records)} record(s)   "
        f"{records[0].get('ts', '?')} .. {records[-1].get('ts', '?')}"
    ]
    platforms = sorted({r.get("platform") or "-" for r in records})
    for platform in platforms:
        recs = [r for r in records if (r.get("platform") or "-") == platform]
        metric_names = sorted({m for r in recs for m in (r.get("metrics") or {})})
        rows = []
        for metric in metric_names:
            if metrics_filter and metric not in metrics_filter:
                continue
            series = [
                r["metrics"][metric]
                for r in recs
                if isinstance(r["metrics"].get(metric), (int, float))
            ]
            if not series:
                continue
            base = _median(series[:-1][-window:]) if len(series) > 1 else None
            change = (
                f"{100 * (series[-1] - base) / abs(base):+.1f}%"
                if base not in (None, 0)
                else "-"
            )
            arrow = "↑" if polarity(metric) > 0 else "↓"
            rows.append(
                [
                    metric,
                    arrow,
                    len(series),
                    _fmt_val(series[-1]),
                    _fmt_val(base),
                    change,
                    sparkline(series),
                ]
            )
        if rows:
            out += ["", f"PLATFORM {platform}"]
            out.append(
                _table(
                    ["metric", "good", "n", "latest", "baseline", "change", "trend"],
                    rows,
                )
            )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI (dispatched from `python -m sbr_tpu_torch.obs.report trend ...`)
# ---------------------------------------------------------------------------


def main_trend(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report trend",
        description="Render the perf history; with --check, gate on regressions "
        "(exit 1 regression, 3 missing/short history)",
    )
    parser.add_argument(
        "history", nargs="?", default=None,
        help="history JSONL (default: $SBR_OBS_HISTORY or " + DEFAULT_PATH + ")",
    )
    parser.add_argument("--check", action="store_true",
                        help="gate: exit 1 on regression beyond tolerance")
    parser.add_argument("--tolerance", type=float, default=0.15, metavar="FRAC",
                        help="allowed relative worsening vs baseline (default 0.15)")
    parser.add_argument("--window", type=int, default=5, metavar="N",
                        help="rolling-median baseline window (default 5)")
    parser.add_argument("--min-points", type=int, default=3, metavar="N",
                        help="records required before a metric gates (default 3)")
    parser.add_argument("--metric", action="append", default=None, metavar="NAME",
                        help="restrict to metric NAME (repeatable)")
    parser.add_argument("--platform", default=None,
                        help="restrict to records from one platform")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    path = history_path(args.history)
    records = load(path)
    if args.platform:
        records = _same_platform(records, args.platform)
    if not records:
        # Missing/empty history only FAILS the gate (--check exit 3); a
        # render-only invocation on a fresh checkout is not an error.
        code = 3 if args.check else 0
        if args.json:
            print(json.dumps({"history": str(path), "n_records": 0, "status": "short",
                              "verdicts": {}, "exit": code}))
        else:
            print(f"no perf history at {path} — nothing to trend or gate",
                  file=sys.stderr)
        return code

    verdicts, status = check(
        records,
        tolerance=args.tolerance,
        min_points=args.min_points,
        window=args.window,
        metrics_filter=set(args.metric) if args.metric else None,
    )
    code = {"ok": 0, "regression": 1, "short": 3}[status] if args.check else 0
    if args.json:
        print(json.dumps({
            "history": str(path),
            "n_records": len(records),
            "platform": records[-1].get("platform"),
            "tolerance": args.tolerance,
            "window": args.window,
            "status": status,
            "verdicts": verdicts,
            "exit": code,
        }))
        return code

    print(render_trend(records, window=args.window,
                       metrics_filter=set(args.metric) if args.metric else None))
    if args.check:
        print()
        if status == "short":
            print(f"GATE: history too short (<{args.min_points} comparable records) "
                  "— not gateable (exit 3)")
        else:
            bad = [m for m, v in verdicts.items() if v["status"] == "regression"]
            for m in bad:
                v = verdicts[m]
                print(
                    f"REGRESSION  {m}: {_fmt_val(v['latest'])} vs baseline "
                    f"{_fmt_val(v['baseline'])} ({100 * v['change']:+.1f}%, "
                    f"{v['direction']}, tolerance {100 * args.tolerance:.0f}%)"
                )
            if not bad:
                print(f"GATE: ok — no metric regressed beyond "
                      f"{100 * args.tolerance:.0f}% of its rolling-median baseline")
    return code
