"""Render an obs run directory as a timing/throughput table, diff two
runs, gate on numerical health, resilience, memory, serving or the perf
history, or garbage-collect old runs; the port of ``sbr_tpu.obs.report``.

Usage:
    python -m sbr_tpu_torch.obs.report RUN_DIR            # render one run
    python -m sbr_tpu_torch.obs.report RUN_DIR OTHER_DIR  # diff two runs
    python -m sbr_tpu_torch.obs.report RUN_DIR --events 20  # also tail events
    python -m sbr_tpu_torch.obs.report health RUN_DIR     # exit 1 on divergent
                                                          # cells, 3 no data
    python -m sbr_tpu_torch.obs.report resilience RUN_DIR # exit 1 on an
                                                          # unrecovered failure
    python -m sbr_tpu_torch.obs.report elastic RUN_DIR    # scheduler census;
                                                          # exit 3 no events
    python -m sbr_tpu_torch.obs.report infomodel RUN_DIR  # exit 1 on a failed
                                                          # fixed point or a
                                                          # closure breach
    python -m sbr_tpu_torch.obs.report grad RUN_DIR       # exit 1 on an
                                                          # untrusted gradient
    python -m sbr_tpu_torch.obs.report memory RUN_DIR     # exit 1 when a tile
                                                          # passes the headroom
    python -m sbr_tpu_torch.obs.report serve RUN_DIR      # live.json; exit 1
                                                          # on an SLO breach
    python -m sbr_tpu_torch.obs.report fleet RUN_DIR      # fleet.json; exit 1
                                                          # on a lost query or
                                                          # a breaker stuck open
    python -m sbr_tpu_torch.obs.report prewarm RUN_DIR    # exit 1 on budget
                                                          # abandonment or a
                                                          # plan done cold
    python -m sbr_tpu_torch.obs.report trace RUN_DIR...   # per-query waterfalls;
                                                          # exit 1 on an
                                                          # unjoined trace
    python -m sbr_tpu_torch.obs.report slo RUN_DIR...     # per-layer latency;
                                                          # exit 1 on a breach
    python -m sbr_tpu_torch.obs.report util RUN_DIR       # flight.json; exit 1
                                                          # under the busy floor
    python -m sbr_tpu_torch.obs.report demand RUN_DIR...  # demand.json; exit 1
                                                          # under the coverage
                                                          # floor
    python -m sbr_tpu_torch.obs.report audit RUN_DIR      # exit 1 on a drift
                                                          # verdict, 3 no data
    python -m sbr_tpu_torch.obs.report summary RUN_DIR    # every gate above on
                                                          # one dir; the worst
                                                          # exit code
    python -m sbr_tpu_torch.obs.report trend [HISTORY] [--check]
    python -m sbr_tpu_torch.obs.report gc [ROOT] --keep N [--tile-cache DIR]
        [--trace-keep N] [--audit-keep N] [--demand-keep N] [--prewarm-keep N]
        [--flight-keep N]

Every subcommand takes ``--json`` and then prints one JSON document; its
fields, verdicts and exit codes are the reference's, so the same gates read
either package's runs.

Reads only ``manifest.json``, ``events.jsonl``, ``live.json``,
``fleet.json``, ``trace.jsonl``, ``flight.json`` and ``demand.json`` (or the history
JSONL), tolerating torn event and span lines. Nothing here imports
``torch``, so a report never pays for a device runtime.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def load_run(run_dir) -> dict:
    """Load a run directory: manifest (required) + parsed events (optional).

    Tolerates torn event lines: a process killed
    mid-write leaves a truncated final line — possibly cut inside a UTF-8
    multibyte sequence, so even ``read_text()`` can raise — or a line that
    parses but is not an event object. Every such line is counted in
    ``bad_event_lines`` (surfaced in report headers) instead of crashing
    the report, and folding continues over the intact events.
    """
    run_dir = Path(run_dir)
    manifest_path = run_dir / "manifest.json"
    if not manifest_path.exists():
        raise FileNotFoundError(f"{manifest_path} not found — not an obs run directory")
    manifest = json.loads(manifest_path.read_text())
    events = []
    bad_lines = 0
    events_path = run_dir / "events.jsonl"
    if events_path.exists():
        # bytes + replace: a torn multibyte character must not take down
        # the whole log (strict read_text raises UnicodeDecodeError).
        text = events_path.read_bytes().decode("utf-8", errors="replace")
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                bad_lines += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                bad_lines += 1  # parseable but not an event object
    return {
        "dir": str(run_dir),
        "manifest": manifest,
        "events": events,
        "bad_event_lines": bad_lines,
    }


def _bad_lines_note(run: dict) -> str:
    """Header suffix surfacing tolerated torn event lines (empty if none)."""
    n = run.get("bad_event_lines", 0)
    return f"   ({n} unparseable event line(s) skipped — torn write?)" if n else ""


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    return f"{v * 1e3:.1f} ms" if v < 1.0 else f"{v:.3f} s"


# obs.mem imports torch only inside its functions, so this import loads no
# device runtime.
from sbr_tpu_torch.obs.mem import fmt_bytes as _fmt_bytes, tile_peak as _tile_peak  # noqa: E402


def _table(headers, rows) -> str:
    widths = [len(h) for h in headers]
    rows = [[str(c) for c in r] for r in rows]
    for r in rows:
        widths = [max(w, len(c)) for w, c in zip(widths, r)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*r) for r in rows]
    return "\n".join(lines)


def _jit_by_name(events) -> dict:
    """Aggregate jit_call events by name."""
    agg: dict = {}
    for ev in events:
        if ev.get("kind") != "jit_call":
            continue
        a = agg.setdefault(
            ev.get("name", "?"),
            {"calls": 0, "trace_s": 0.0, "compile_s": 0.0, "execute_s": 0.0, "flops": 0.0},
        )
        a["calls"] += 1
        for k in ("trace_s", "compile_s", "execute_s"):
            a[k] += float(ev.get(k, 0.0))
        if ev.get("flops") is not None:
            # accumulate per event: one name can cover several compiled
            # shapes, so a single per-call flops value is not representative
            a["flops"] += float(ev["flops"])
    return agg


def _status_by_stage(events) -> dict:
    out: dict = {}
    for ev in events:
        if ev.get("kind") == "status":
            out[ev.get("stage", "?")] = ev.get("counts", {})
    return out


def render(run: dict) -> str:
    m = run["manifest"]
    events = run["events"]
    out = []
    dev = m.get("device") or {}
    rt = "torch" if "torch_version" in dev else "jax"  # which package wrote the run
    out.append(f"run      {run['dir']}")
    out.append(
        f"label    {m.get('label')}   status {m.get('status')}   "
        f"started {m.get('started_at')}   duration {_fmt_s(m.get('duration_s'))}"
    )
    out.append(
        f"device   {dev.get('device_kind', '?')} ({dev.get('platform', '?')} ×"
        f"{dev.get('device_count', '?')})   {rt} {dev.get(rt + '_version', '?')}"
    )
    mem = m.get("memory") or {}
    out.append(
        f"memory   peak live buffers {_fmt_bytes(mem.get('peak_live_buffer_bytes'))}"
        + (
            f"   device peak {_fmt_bytes(mem.get('peak_device_bytes'))}"
            if mem.get("peak_device_bytes")
            else ""
        )
        + (f"   peak span {mem['peak_span']}" if mem.get("peak_span") else "")
        + ("   (details: report memory RUN_DIR)" if mem.get("tiles") or mem.get("plan") else "")
    )
    out.append(f"events   {m.get('n_events')}{_bad_lines_note(run)}")

    stages = m.get("stages") or {}
    if stages:
        total = sum(v["total_s"] for v in stages.values()) or 1.0
        out += ["", "STAGES"]
        out.append(
            _table(
                ["stage", "count", "total", "share"],
                [
                    [k, v["count"], _fmt_s(v["total_s"]), f"{100 * v['total_s'] / total:.1f}%"]
                    for k, v in stages.items()
                ],
            )
        )

    jit = _jit_by_name(events)
    if jit:
        out += ["", "JIT (compile vs execute)"]
        rows = []
        for name, a in sorted(jit.items()):
            rate = ""
            if a["flops"] and a["execute_s"]:
                rate = f"{a['flops'] / a['execute_s'] / 1e9:.2f} GFLOP/s"
            rows.append(
                [name, a["calls"], _fmt_s(a["trace_s"]), _fmt_s(a["compile_s"]), _fmt_s(a["execute_s"]), rate]
            )
        out.append(_table(["program", "calls", "trace", "compile", "execute", "throughput"], rows))
        j = m.get("jit") or {}
        out.append(
            f"totals: {j.get('calls', 0)} calls ({j.get('cache_hits', 0)} cache hits), "
            f"compile {_fmt_s(j.get('compile_s'))}, execute {_fmt_s(j.get('execute_s'))}"
        )

    status = _status_by_stage(events)
    if status:
        out += ["", "STATUS GRIDS"]
        rows = [
            [stage, ", ".join(f"{k}={v}" for k, v in counts.items() if v)]
            for stage, counts in status.items()
        ]
        out.append(_table(["stage", "counts"], rows))

    health = m.get("health") or {}
    if health:
        worst = sum(v.get("divergent", 0) for v in health.values())
        out += ["", f"HEALTH ({'DIVERGENT' if worst else 'ok'})"]
        out.append(
            _table(
                ["stage", "cells", "divergent", "max residual"],
                [
                    [k, v.get("cells", "-"), v.get("divergent", 0), _fmt_resid(v.get("max_residual"))]
                    for k, v in sorted(health.items())
                ],
            )
        )
        out.append("(details: python -m sbr_tpu_torch.obs.report health RUN_DIR)")

    xla = m.get("xla") or {}
    if xla.get("compiles"):
        out += ["", "XLA COMPILES (jax.monitoring)"]
        out.append(
            f"{xla['compiles']} backend compile(s): "
            f"jaxpr trace {_fmt_s(xla.get('jaxpr_trace_s'))}, "
            f"mlir lowering {_fmt_s(xla.get('mlir_lowering_s'))}, "
            f"backend compile {_fmt_s(xla.get('backend_compile_s'))}"
        )
        by_span = xla.get("by_span") or {}
        if by_span:
            out.append(
                _table(
                    ["span", "compiles", "backend compile"],
                    [
                        [k, v.get("compiles", 0), _fmt_s(v.get("backend_compile_s"))]
                        for k, v in by_span.items()
                    ],
                )
            )
    elif xla and not xla.get("monitoring", True) and rt == "jax":
        out += ["", "XLA COMPILES: jax.monitoring unavailable on this jax build"]

    retraces = m.get("retraces") or {}
    if retraces:
        over = [k for k, v in retraces.items() if v.get("over_budget")]
        out += ["", f"RETRACES{' (OVER BUDGET: ' + ', '.join(over) + ')' if over else ''}"]
        out.append(
            _table(
                ["program", "traces", "budget", "over budget"],
                [
                    [k, v.get("traces"), v.get("budget"), "YES" if v.get("over_budget") else "-"]
                    for k, v in retraces.items()
                ],
            )
        )

    profiles = m.get("profiles") or []
    if profiles:
        out += ["", "PROFILER CAPTURES"]
        out.append(
            _table(
                ["label", "files", "size", "window", "trace dir"],
                [
                    [
                        p.get("label"),
                        p.get("files"),
                        ("pruned" if p.get("pruned") else _fmt_bytes(p.get("bytes"))),
                        _fmt_s(p.get("window_s")),
                        p.get("trace_dir"),
                    ]
                    for p in profiles
                ],
            )
        )

    mx = m.get("metrics") or {}
    if mx.get("counters") or mx.get("timers") or mx.get("gauges"):
        out += ["", "METRICS"]
        rows = [["counter", k, v] for k, v in (mx.get("counters") or {}).items()]
        rows += [["gauge", k, v] for k, v in (mx.get("gauges") or {}).items()]
        rows += [
            ["timer", k, f"n={h['count']} total={_fmt_s(h['total_s'])} p50={_fmt_s(h['p50_s'])}"]
            for k, h in (mx.get("timers") or {}).items()
        ]
        out.append(_table(["type", "name", "value"], rows))

    return "\n".join(out)


def _fmt_resid(v) -> str:
    return "-" if v is None else f"{float(v):.2e}"


def _health_by_stage(events) -> dict:
    """Fold `health` events per stage: summed cells/divergent/flag counts,
    max residual, last worst-cells table and residual histogram."""
    out: dict = {}
    for ev in events:
        if ev.get("kind") != "health":
            continue
        stage = ev.get("stage", "?")
        agg = out.setdefault(
            stage,
            {
                "events": 0,
                "cells": 0,
                "divergent": 0,
                "max_residual": None,
                "flag_counts": {},
                "worst_cells": [],
                "residual_hist": {},
                "iterations_total": 0,
                "iterations_max": 0,
            },
        )
        agg["events"] += 1
        agg["cells"] += int(ev.get("cells", 0))
        agg["divergent"] += int(ev.get("divergent", 0))
        agg["iterations_total"] += int(ev.get("iterations_total", 0))
        agg["iterations_max"] = max(agg["iterations_max"], int(ev.get("iterations_max", 0)))
        mr = ev.get("max_residual")
        if mr is not None:
            prev = agg["max_residual"]
            agg["max_residual"] = mr if prev is None else max(prev, mr)
        for name, n in (ev.get("flag_counts") or {}).items():
            agg["flag_counts"][name] = agg["flag_counts"].get(name, 0) + int(n)
        if ev.get("worst_cells"):
            agg["worst_cells"] = ev["worst_cells"]
        if ev.get("residual_hist"):
            agg["residual_hist"] = ev["residual_hist"]
    return out


def _ascii_hist(hist: dict, width: int = 40) -> list:
    """Render a {bucket_label: count} histogram as aligned ASCII bars."""
    if not hist:
        return []
    peak = max(hist.values()) or 1
    label_w = max(len(k) for k in hist)
    lines = []
    for label, count in hist.items():
        bar = "#" * max(1, round(width * count / peak)) if count else ""
        lines.append(f"  {label:>{label_w}}  {count:>8}  {bar}")
    return lines


def render_health(run: dict) -> tuple:
    """Numerical-health report; returns (text, exit_code). Exit codes:
    0 healthy, 1 divergence detected, 3 no health data recorded (a run
    that was supposed to carry diagnostics but emitted none must not pass
    a CI gate silently)."""
    events = run["events"]
    stages = _health_by_stage(events)
    out = [f"run      {run['dir']}{_bad_lines_note(run)}"]
    if not stages:
        out.append("no health events recorded — was the run produced by an "
                    "instrumented solver/sweep with telemetry on?")
        return "\n".join(out), 3

    total_divergent = sum(v["divergent"] for v in stages.values())
    total_cells = sum(v["cells"] for v in stages.values())
    out.append(
        f"health   {'DIVERGENCE DETECTED' if total_divergent else 'OK'}: "
        f"{total_divergent}/{total_cells} divergent cells across {len(stages)} stage(s)"
    )

    out += ["", "STAGES"]
    rows = []
    for name, v in sorted(stages.items()):
        flags = ", ".join(f"{k}={n}" for k, n in sorted(v["flag_counts"].items())) or "-"
        # effective iterations (adaptive numerics): mean/max of
        # what cells ACTUALLY ran — under numerics="fixed" this just echoes
        # the constant budget
        iters = (
            f"{v['iterations_total'] / v['cells']:.1f}/{v['iterations_max']}"
            if v["cells"]
            else "-"
        )
        rows.append(
            [name, v["cells"], v["divergent"], _fmt_resid(v["max_residual"]), iters, flags]
        )
    out.append(
        _table(["stage", "cells", "divergent", "max resid", "eff iters μ/max", "flags"], rows)
    )

    # Per-scenario census: health events tagged by the composed
    # scenario engine carry ``scenario`` (and ``bank`` for multi-bank
    # contagion). The stage fold above already keeps them separate — the
    # tags suffix the stage key — but this roll-up answers the operator
    # question directly: which SCENARIO is divergent, across however many
    # banks/stages it spanned, instead of one census mixing all banks.
    scen_agg: dict = {}
    for ev in events:
        if ev.get("kind") != "health" or "scenario" not in ev:
            continue
        agg = scen_agg.setdefault(
            str(ev["scenario"]),
            {"events": 0, "cells": 0, "divergent": 0, "banks": set()},
        )
        agg["events"] += 1
        agg["cells"] += int(ev.get("cells", 0))
        agg["divergent"] += int(ev.get("divergent", 0))
        if "bank" in ev:
            agg["banks"].add(int(ev["bank"]))
    if scen_agg:
        out += ["", "SCENARIOS"]
        out.append(
            _table(
                ["scenario", "events", "cells", "divergent", "banks"],
                [
                    [name, v["events"], v["cells"], v["divergent"],
                     len(v["banks"]) or "-"]
                    for name, v in sorted(scen_agg.items())
                ],
            )
        )

    # NaN census: the poison-tracking subset of the flag counts.
    nan_rows = []
    for name, v in sorted(stages.items()):
        fc = v["flag_counts"]
        nan_in, nan_out, nonf = (
            fc.get("nan_input", 0), fc.get("nan_output", 0), fc.get("nonfinite_residual", 0),
        )
        if nan_in or nan_out or nonf:
            nan_rows.append([name, nan_in, nan_out, nonf])
    if nan_rows:
        out += ["", "NaN CENSUS"]
        out.append(_table(["stage", "nan_input", "nan_output", "nonfinite_residual"], nan_rows))

    for name, v in sorted(stages.items()):
        if v["worst_cells"]:
            out += ["", f"WORST CELLS — {name}"]
            out.append(
                _table(
                    ["index", "residual", "status", "flags"],
                    [
                        [
                            ",".join(str(i) for i in c.get("index", [])),
                            _fmt_resid(c.get("residual")),
                            c.get("status", "-"),
                            ",".join(c.get("flags", [])) or "-",
                        ]
                        for c in v["worst_cells"]
                    ],
                )
            )
        if v["residual_hist"]:
            out += ["", f"RESIDUAL HISTOGRAM — {name} (|f(x*)| by decade)"]
            out += _ascii_hist(v["residual_hist"])

    return "\n".join(out), 1 if total_divergent else 0


def _resilience_by_kind(events) -> dict:
    """Fold fault/retry/repair events (the `sbr_tpu_torch.resilience` emissions)
    from the event log — the source of truth even when a kill -9 meant the
    manifest roll-up was never finalized."""
    faults: dict = {}
    retries: dict = {}
    repairs: dict = {}
    failed_repairs = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "fault":
            key = f"{ev.get('point', '?')}:{ev.get('fault', '?')}"
            faults[key] = faults.get(key, 0) + 1
        elif kind == "retry":
            agg = retries.setdefault(
                ev.get("scope", "?"), {"attempts": 0, "recovered": 0, "gave_up": 0}
            )
            agg["attempts"] = max(agg["attempts"], int(ev.get("attempt", 0)))
            outcome = ev.get("outcome")
            if outcome == "recovered":
                agg["recovered"] += 1
            elif outcome in ("gave_up", "budget_exhausted"):
                agg["gave_up"] += 1
        elif kind == "repair":
            agg = repairs.setdefault(ev.get("action", "?"), {"count": 0, "failed": 0})
            agg["count"] += 1
            if not ev.get("ok", True):
                agg["failed"] += 1
                failed_repairs.append(ev.get("target", "?"))
    return {
        "faults": faults,
        "retries": retries,
        "repairs": repairs,
        "failed_repairs": failed_repairs,
    }


def _resilience_gate(folded: dict) -> tuple:
    """(unrecovered_count, exit_code): nonzero exit whenever a retry scope
    gave up or a repair failed. A manifest status of "interrupted" is
    reported but NOT gated — a graceful preemption is recorded evidence,
    not an unrecovered failure (the resumed run completes elsewhere)."""
    unrecovered = sum(v["gave_up"] for v in folded["retries"].values()) + sum(
        v["failed"] for v in folded["repairs"].values()
    )
    return unrecovered, 1 if unrecovered else 0


def render_resilience(run: dict) -> tuple:
    """Fault/retry/repair report; returns (text, exit_code). Unlike
    `health` (exit 3 when diagnostics never flowed), an empty resilience
    log is a CLEAN run — nothing failed — and exits 0."""
    folded = _resilience_by_kind(run["events"])
    status = run["manifest"].get("status")
    unrecovered, code = _resilience_gate(folded)
    out = [f"run      {run['dir']}{_bad_lines_note(run)}"]
    out.append(f"status   {status}" + ("   (graceful preemption)" if status == "interrupted" else ""))
    if not any((folded["faults"], folded["retries"], folded["repairs"])):
        out.append("resilience  clean: no fault, retry, or repair events recorded")
        return "\n".join(out), code
    out.append(
        f"resilience  {'UNRECOVERED FAILURES: ' + str(unrecovered) if unrecovered else 'recovered'}: "
        f"{sum(folded['faults'].values())} fault(s) injected, "
        f"{len(folded['retries'])} retried scope(s), "
        f"{sum(v['count'] for v in folded['repairs'].values())} repair action(s)"
    )
    if folded["faults"]:
        out += ["", "INJECTED FAULTS"]
        out.append(
            _table(
                ["point:kind", "count"],
                [[k, v] for k, v in sorted(folded["faults"].items())],
            )
        )
    if folded["retries"]:
        out += ["", "RETRIES"]
        out.append(
            _table(
                ["scope", "max attempt", "recovered", "gave up"],
                [
                    [k, v["attempts"], v["recovered"], v["gave_up"] or "-"]
                    for k, v in sorted(folded["retries"].items())
                ],
            )
        )
    if folded["repairs"]:
        out += ["", "REPAIRS"]
        out.append(
            _table(
                ["action", "count", "failed"],
                [
                    [k, v["count"], v["failed"] or "-"]
                    for k, v in sorted(folded["repairs"].items())
                ],
            )
        )
        for target in folded["failed_repairs"]:
            out.append(f"  FAILED: {target}")
    return "\n".join(out), code


def resilience_json(run: dict) -> tuple:
    """Machine-readable equivalent of `render_resilience` (--json)."""
    folded = _resilience_by_kind(run["events"])
    unrecovered, code = _resilience_gate(folded)
    return {
        "dir": run["dir"],
        "status": run["manifest"].get("status"),
        **folded,
        "unrecovered": unrecovered,
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }, code


def render_json(run: dict) -> dict:
    """Machine-readable equivalent of `render` (--json): the manifest plus
    the per-name jit aggregation and per-stage status counts from events."""
    return {
        "dir": run["dir"],
        "manifest": run["manifest"],
        "jit_by_name": _jit_by_name(run["events"]),
        "status_by_stage": _status_by_stage(run["events"]),
        "bad_event_lines": run.get("bad_event_lines", 0),
    }


def health_json(run: dict) -> tuple:
    """Machine-readable equivalent of `render_health` (--json); returns
    (doc, exit_code) with the same exit-code contract."""
    stages = _health_by_stage(run["events"])
    bad = run.get("bad_event_lines", 0)
    if not stages:
        return {"dir": run["dir"], "stages": {}, "bad_event_lines": bad, "exit": 3}, 3
    total_divergent = sum(v["divergent"] for v in stages.values())
    code = 1 if total_divergent else 0
    return {
        "dir": run["dir"],
        "stages": stages,
        "total_cells": sum(v["cells"] for v in stages.values()),
        "total_divergent": total_divergent,
        "bad_event_lines": bad,
        "exit": code,
    }, code


def diff_json(a: dict, b: dict) -> dict:
    """Machine-readable equivalent of `diff` (--json)."""
    ma, mb = a["manifest"], b["manifest"]
    ja, jb = ma.get("jit") or {}, mb.get("jit") or {}
    sa, sb = ma.get("stages") or {}, mb.get("stages") or {}
    stages = {}
    for n in sorted(set(sa) | set(sb)):
        ta = sa.get(n, {}).get("total_s")
        tb = sb.get(n, {}).get("total_s")
        stages[n] = {
            "a_s": ta,
            "b_s": tb,
            "ratio": (tb / ta) if (ta and tb is not None) else None,
        }
    return {
        "a": a["dir"],
        "b": b["dir"],
        "duration": {"a_s": ma.get("duration_s"), "b_s": mb.get("duration_s")},
        "compile": {"a_s": ja.get("compile_s"), "b_s": jb.get("compile_s")},
        "execute": {"a_s": ja.get("execute_s"), "b_s": jb.get("execute_s")},
        "stages": stages,
    }


def diff(a: dict, b: dict) -> str:
    """Stage/jit-level diff of two runs (b relative to a)."""
    ma, mb = a["manifest"], b["manifest"]
    out = [f"A: {a['dir']}", f"B: {b['dir']}", ""]
    out.append(
        f"duration  A {_fmt_s(ma.get('duration_s'))}   B {_fmt_s(mb.get('duration_s'))}"
    )
    ja, jb = ma.get("jit") or {}, mb.get("jit") or {}
    out.append(
        f"compile   A {_fmt_s(ja.get('compile_s'))}   B {_fmt_s(jb.get('compile_s'))}"
    )
    out.append(
        f"execute   A {_fmt_s(ja.get('execute_s'))}   B {_fmt_s(jb.get('execute_s'))}"
    )
    sa, sb = ma.get("stages") or {}, mb.get("stages") or {}
    names = sorted(set(sa) | set(sb))
    if names:
        rows = []
        for n in names:
            ta = sa.get(n, {}).get("total_s")
            tb = sb.get(n, {}).get("total_s")
            if ta is not None and tb is not None:
                # presence, not truthiness: a sub-µs span rounds to 0.0 in
                # the manifest but is still in both runs
                ratio = f"{tb / ta:.2f}x" if ta else "-"
            else:
                ratio = "only A" if ta is not None else ("only B" if tb is not None else "-")
            rows.append([n, _fmt_s(ta), _fmt_s(tb), ratio])
        out += ["", "STAGES (B vs A)", _table(["stage", "A", "B", "B/A"], rows)]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Elastic report (`elastic` subcommand — the scheduler/cache renderer/gate)
# ---------------------------------------------------------------------------


def _elastic_fold(events) -> dict:
    """Fold ``scheduler`` + ``cache`` events (the `resilience.elastic`
    emissions): per-host membership/throughput, scheduler action counts,
    tile counts by source, and cache outcome counts. The event log is the
    source of truth even when a kill -9 meant the manifest roll-up was
    never finalized (same contract as the resilience report)."""
    hosts: dict = {}
    scheduler: dict = {}
    cache: dict = {}
    tiles: dict = {}
    for ev in events:
        kind = ev.get("kind")
        if kind == "scheduler":
            action = ev.get("action", "?")
            scheduler[action] = scheduler.get(action, 0) + 1
            host = ev.get("host")
            if host:
                h = hosts.setdefault(
                    host,
                    {"tiles_done": 0, "computed": 0, "cached": 0,
                     "compute_s": 0.0, "compute_cells": 0,
                     "joined": False, "left": False, "reclaims": 0},
                )
                if action == "join":
                    h["joined"] = True
                elif action == "leave":
                    h["left"] = True
                elif action == "reclaim":
                    h["reclaims"] += 1
                elif action == "done":
                    h["tiles_done"] += 1
                    source = str(ev.get("source", "?"))
                    tiles[source] = tiles.get(source, 0) + 1
                    if source == "computed":
                        h["computed"] += 1
                        h["compute_s"] += float(ev.get("dur_s", 0.0))
                        h["compute_cells"] += int(ev.get("cells", 0))
                    else:
                        h["cached"] += 1
        elif kind == "cache":
            action = ev.get("action", "?")
            cache[action] = cache.get(action, 0) + 1
    for h in hosts.values():
        h["cells_per_sec"] = (
            round(h["compute_cells"] / h["compute_s"], 2) if h["compute_s"] > 0 else None
        )
    return {"hosts": hosts, "scheduler": scheduler, "cache": cache, "tiles": tiles}


def elastic_doc(run: dict) -> tuple:
    """Machine-readable elastic-scheduler report; returns (doc, exit_code).
    Exit 0 when scheduler events were recorded, 3 when the run carries no
    elastic data at all (a churn gate with nothing to read must not pass
    silently) — there is no failure exit here: unrecovered failures gate
    via ``report resilience``; this report is the membership/cache census
    CI asserts counts against (e.g. warm re-sweep ⇒ tiles.computed == 0)."""
    folded = _elastic_fold(run["events"])
    manifest_blk = run["manifest"].get("elastic") or {}
    # Scheduler events (or their manifest roll-up) are the signal that the
    # run WAS elastic — a cache-only block (plain run_tiled_grid with
    # SBR_TILE_CACHE_DIR) must not satisfy a churn gate's exit-0 check.
    code = 3 if not folded["scheduler"] and not manifest_blk.get("scheduler") else 0
    doc = {
        "dir": run["dir"],
        **folded,
        "manifest": manifest_blk or None,
        "tiles_computed": folded["tiles"].get("computed", 0),
        "tiles_from_cache": folded["tiles"].get("cache", 0)
        + folded["tiles"].get("local", 0),
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }
    return doc, code


def render_elastic(run: dict) -> tuple:
    """Human-readable elastic report; same exit contract as `elastic_doc`."""
    doc, code = elastic_doc(run)
    out = [f"run      {run['dir']}{_bad_lines_note(run)}"]
    if code == 3:
        out.append(
            "no scheduler events recorded — was the sweep run through the "
            "elastic scheduler (run_tiled_grid_multihost, SBR_ELASTIC unset/1)?"
        )
        return "\n".join(out), code
    tiles = doc["tiles"]
    out.append(
        "elastic  "
        + ", ".join(f"{tiles.get(k, 0)} {k}" for k in ("computed", "cache", "local"))
        + f" tile(s) across {len(doc['hosts'])} host(s)"
    )
    if doc["hosts"]:
        out += ["", "HOSTS"]
        out.append(
            _table(
                ["host", "tiles", "computed", "cached", "cells/s", "reclaims", "join", "leave"],
                [
                    [
                        h,
                        v["tiles_done"],
                        v["computed"],
                        v["cached"],
                        v["cells_per_sec"] if v["cells_per_sec"] is not None else "-",
                        v["reclaims"] or "-",
                        "yes" if v["joined"] else "-",
                        "yes" if v["left"] else "-",
                    ]
                    for h, v in sorted(doc["hosts"].items())
                ],
            )
        )
    if doc["scheduler"]:
        out += ["", "SCHEDULER EVENTS"]
        out.append(
            _table(
                ["action", "count"],
                [[k, v] for k, v in sorted(doc["scheduler"].items())],
            )
        )
    if doc["cache"]:
        out += ["", "GLOBAL TILE CACHE"]
        out.append(
            _table(
                ["outcome", "count"],
                [[k, v] for k, v in sorted(doc["cache"].items())],
            )
        )
    return "\n".join(out), code


def _main_elastic(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report elastic",
        description="Elastic-scheduler report for one run (hosts, claims, "
        "tile sources, global-cache outcomes); exit 3 when no scheduler "
        "events were recorded",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.json:
        doc, code = elastic_doc(run)
        print(json.dumps(doc, default=str))
        return code
    text, code = render_elastic(run)
    print(text)
    return code

# ---------------------------------------------------------------------------
# Infomodel report (`infomodel` subcommand — information-model gate)
# ---------------------------------------------------------------------------


def infomodel_doc(run_dir) -> tuple:
    """Machine-readable information-model report (`sbr_tpu_torch.infomodels`):
    the manifest ``infomodel`` roll-up plus the per-event fold (rewire
    epochs, belief censuses, fixed-point solves, closure comparisons,
    population queries). Returns (doc, exit_code).

    Exit codes: 0 healthy; 1 when a mean-field fixed point failed to
    converge (``nonconverged``) or a closure comparison exceeded its
    RECORDED tolerance (``breaches`` — closure events carry err_aw_sup +
    tolerance when the caller supplied one); 3 when the run recorded no
    infomodel data at all (a gate with nothing to read must not pass
    silently); 2 when ``run_dir`` is not a directory."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    try:
        run = load_run(run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        return {"dir": str(run_dir), "error": str(err), "exit": 2}, 2
    manifest_blk = run["manifest"].get("infomodel") or {}
    events = [ev for ev in run["events"] if ev.get("kind") == "infomodel"]
    if not manifest_blk and not events:
        return {
            "dir": str(run_dir),
            "error": "no infomodel data (no manifest roll-up, no infomodel events)",
            "exit": 3,
        }, 3
    # The event fold is the kill -9 fallback (a process that died before
    # finalize wrote no manifest roll-up): take the max of the two views
    # per action, the `report fleet` discipline.
    fold: dict = {}
    fixed_points = []
    closures = []
    populations = []
    epochs_by_channel: dict = {}
    for ev in events:
        action = str(ev.get("action", "?"))
        fold[action] = fold.get(action, 0) + 1
        if action == "fixed_point":
            fixed_points.append(
                {k: ev.get(k) for k in (
                    "channel", "dynamics", "groups", "converged", "aborted",
                    "iterations", "xi", "bankrun",
                )}
            )
            if ev.get("converged") is False:
                fold["nonconverged"] = fold.get("nonconverged", 0) + 1
        elif action == "closure":
            rec = {k: ev.get(k) for k in (
                "channel", "dynamics", "n_agents", "n_reps", "err_aw_sup",
                "err_g_rms", "tolerance",
            )}
            err, tol = rec.get("err_aw_sup"), rec.get("tolerance")
            rec["breach"] = (
                isinstance(err, (int, float))
                and isinstance(tol, (int, float))
                and err > tol
            )
            if rec["breach"]:
                fold["breaches"] = fold.get("breaches", 0) + 1
            closures.append(rec)
        elif action == "population_query":
            populations.append(
                {k: ev.get(k) for k in (
                    "channel", "dynamics", "vary", "seeds", "n_agents",
                    "run_probability",
                )}
            )
        elif action == "rewire_epoch":
            ch = str(ev.get("channel", "?"))
            epochs_by_channel[ch] = epochs_by_channel.get(ch, 0) + 1
    counts = {
        k: max(int(manifest_blk.get(k, 0)), int(fold.get(k, 0)))
        for k in set(manifest_blk) | set(fold)
    }
    nonconverged = counts.get("nonconverged", 0)
    breaches = counts.get("breaches", 0)
    breach_msgs = []
    if nonconverged:
        breach_msgs.append(f"{nonconverged} non-converged fixed point(s)")
    if breaches:
        breach_msgs.append(f"{breaches} closure comparison(s) over tolerance")
    code = 1 if breach_msgs else 0
    doc = {
        "dir": str(run_dir),
        "counts": counts,
        "manifest_infomodel": manifest_blk or None,
        "fixed_points": fixed_points,
        "closures": closures,
        "population_queries": populations,
        "rewire_epochs": epochs_by_channel,
        "nonconverged": nonconverged,
        "breaches_count": breaches,
        "breaches": breach_msgs,
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }
    return doc, code


def render_infomodel(doc: dict) -> str:
    """Human-readable information-model report; same exit contract as
    `infomodel_doc`."""
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no infomodel data"))
        if doc["exit"] == 3:
            out.append(
                "was the run produced with sbr_tpu_torch.infomodels telemetry on "
                "(fixed points / simulate_info / close_loop emit infomodel "
                "events)?"
            )
        return "\n".join(out)
    c = doc["counts"]
    out.append(
        "infomodel "
        + ", ".join(
            f"{int(c.get(k, 0))} {k}" for k in (
                "fixed_point", "closure", "population_query", "rewire_epoch",
                "belief_census",
            ) if c.get(k)
        )
    )
    if doc["fixed_points"]:
        out += ["", "FIXED POINTS"]
        out.append(
            _table(
                ["channel", "dynamics", "groups", "converged", "iters", "xi", "bankrun"],
                [
                    [
                        fp.get("channel", "?"), fp.get("dynamics", "?"),
                        fp.get("groups", 1),
                        fp.get("converged"), fp.get("iterations"),
                        "-" if fp.get("xi") is None else f"{fp['xi']:.4f}",
                        fp.get("bankrun"),
                    ]
                    for fp in doc["fixed_points"]
                ],
            )
        )
    if doc["closures"]:
        out += ["", "CLOSURES"]
        out.append(
            _table(
                ["channel", "dynamics", "agents", "reps", "err_aw_sup", "tol", "ok"],
                [
                    [
                        cl.get("channel", "?"), cl.get("dynamics", "?"),
                        cl.get("n_agents"), cl.get("n_reps"),
                        "-" if cl.get("err_aw_sup") is None else f"{cl['err_aw_sup']:.4f}",
                        "-" if cl.get("tolerance") is None else f"{cl['tolerance']:g}",
                        "BREACH" if cl.get("breach") else "ok",
                    ]
                    for cl in doc["closures"]
                ],
            )
        )
    if doc["population_queries"]:
        out += ["", "POPULATION QUERIES"]
        out.append(
            _table(
                ["channel", "dynamics", "vary", "seeds", "agents", "run_p"],
                [
                    [
                        p.get("channel", "?"), p.get("dynamics", "?"),
                        p.get("vary", "?"), p.get("seeds"), p.get("n_agents"),
                        "-" if p.get("run_probability") is None
                        else f"{p['run_probability']:.3f}",
                    ]
                    for p in doc["population_queries"]
                ],
            )
        )
    if doc["rewire_epochs"]:
        out.append(
            "epochs   "
            + ", ".join(f"{ch}: {n}" for ch, n in sorted(doc["rewire_epochs"].items()))
        )
    if doc["breaches"]:
        out += [""] + [f"BREACH   {b}" for b in doc["breaches"]]
    if doc.get("bad_event_lines"):
        out.append(f"warning  {doc['bad_event_lines']} unparseable event line(s)")
    return "\n".join(out)


def _main_infomodel(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report infomodel",
        description="Information-model report for one run (fixed points, "
        "closure comparisons, rewire epochs, population queries); exit 1 "
        "on a non-converged fixed point or a closure comparison over its "
        "recorded tolerance, 3 when no infomodel data was recorded",
    )
    parser.add_argument("run_dir", help="run directory (contains events.jsonl)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = infomodel_doc(args.run_dir)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_infomodel(doc))
    return code


# ---------------------------------------------------------------------------
# Memory report (`memory` subcommand — the obs.mem attribution renderer/gate)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Grad report (`grad` subcommand — differentiable-equilibria renderer/gate)
# ---------------------------------------------------------------------------


def _grad_fold(events) -> dict:
    """Fold ``grad`` events (the `sbr_tpu_torch.grad` emissions): calibration
    runs (start/step/done series), gradient-flag censuses per stage, and
    stress-search outcomes."""
    calibrations = []
    current = None
    censuses = []
    stress = []
    for ev in events:
        if ev.get("kind") != "grad":
            continue
        action = ev.get("action")
        if action == "calib_start":
            current = {
                "wrt": ev.get("wrt"), "budget": ev.get("steps"),
                "n_obs": ev.get("n_obs"), "with_xi": ev.get("with_xi"),
                "losses": [],
            }
            calibrations.append(current)
        elif action == "calib_step":
            if current is not None:
                current["losses"].append(float(ev.get("loss", float("nan"))))
        elif action == "calib_done":
            rec = current if current is not None else {"losses": []}
            rec["steps"] = ev.get("steps")
            rec["loss"] = ev.get("loss")
            rec["converged"] = bool(ev.get("converged"))
            rec["fit"] = {
                k[len("fit_"):]: v for k, v in ev.items() if k.startswith("fit_")
            }
            if current is None:
                calibrations.append(rec)
            current = None
        elif action == "flags":
            censuses.append({
                k: ev.get(k)
                for k in ("stage", "cells", "run_cells", "at_nonequilibrium",
                          "ill_conditioned", "nonfinite", "nonfinite_run",
                          "untrusted")
            })
        elif action == "stress_done":
            stress.append({
                k: v for k, v in ev.items()
                if k not in ("kind", "ts", "mono", "action")
            })
    return {"calibrations": calibrations, "censuses": censuses, "stress": stress}


def grad_doc(run: dict) -> tuple:
    """Machine-readable differentiable-equilibria report; (doc, exit_code).

    Exit contract (matching the other subcommands): 0 healthy, 1 when a
    calibration finished unconverged or any flag census recorded NONFINITE
    gradients AT RUN CELLS (``nonfinite_run`` — NaN sensitivities on
    no-run lanes are the expected face of degenerate brackets, and
    at_nonequilibrium / ill_conditioned are informational: a sensitivity
    surface legitimately spans no-run cells), 3 when the run carries no
    grad data at all (a gate with nothing to read must not pass
    silently); the CLI returns 2 on an unreadable run dir.
    """
    folded = _grad_fold(run["events"])
    has_data = any(folded.values())
    if not has_data:
        code = 3
    else:
        # `converged is False` only: a record without the key is a
        # calibration still RUNNING (calib_start seen, calib_done not yet)
        # — reading a live run dir must not produce a false-red gate.
        bad_calib = any(
            c.get("converged") is False for c in folded["calibrations"]
        )
        bad_grads = any(
            int(c.get("nonfinite_run") or 0) > 0 for c in folded["censuses"]
        )
        code = 1 if (bad_calib or bad_grads) else 0
    doc = {
        "dir": run["dir"],
        **folded,
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }
    return doc, code


def render_grad(run: dict) -> tuple:
    """Human-readable grad report; same exit contract as `grad_doc`."""
    from sbr_tpu_torch.obs.history import sparkline

    doc, code = grad_doc(run)
    out = [f"run      {run['dir']}{_bad_lines_note(run)}"]
    if code == 3:
        out.append(
            "no grad events recorded — did the run use sbr_tpu_torch.grad "
            "(xi_and_grad / sensitivity_surface / fit_withdrawals)?"
        )
        return "\n".join(out), code
    if doc["calibrations"]:
        out += ["", "CALIBRATIONS"]
        rows = []
        for c in doc["calibrations"]:
            fit = c.get("fit") or {}
            rows.append([
                ",".join(c.get("wrt") or fit.keys()),
                c.get("steps", "-"),
                f"{c['loss']:.3e}" if isinstance(c.get("loss"), float) else "-",
                "yes" if c.get("converged") else "NO",
                sparkline(c.get("losses") or []) or "-",
                " ".join(f"{k}={v:.4g}" for k, v in fit.items()) or "-",
            ])
        out.append(_table(["wrt", "steps", "loss", "converged", "trend", "fitted"], rows))
    if doc["censuses"]:
        out += ["", "GRADIENT FLAG CENSUS"]
        out.append(
            _table(
                ["stage", "cells", "run", "non-eq", "ill-cond", "nonfinite", "nonfin@run"],
                [
                    [
                        c.get("stage", "?"), c.get("cells", "-"),
                        c.get("run_cells", "-"), c.get("at_nonequilibrium", 0),
                        c.get("ill_conditioned", 0), c.get("nonfinite", 0),
                        c.get("nonfinite_run", 0),
                    ]
                    for c in doc["censuses"]
                ],
            )
        )
    if doc["stress"]:
        out += ["", "STRESS SEARCHES"]
        out.append(
            _table(
                ["flipped", "validated", "steps", "shock", "margin0", "margin*"],
                [
                    [
                        "yes" if s.get("flipped") else "no",
                        "yes" if s.get("validated") else "-",
                        s.get("steps", "-"),
                        f"{s['shock_norm']:.4g}" if isinstance(s.get("shock_norm"), float) else "-",
                        f"{s['margin0']:.3g}" if isinstance(s.get("margin0"), float) else "-",
                        f"{s['margin_final']:.3g}" if isinstance(s.get("margin_final"), float) else "-",
                    ]
                    for s in doc["stress"]
                ],
            )
        )
    if code == 1:
        out += ["", "GATE: unconverged calibration or non-finite gradients (exit 1)"]
    return "\n".join(out), code


def _main_grad(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report grad",
        description="Differentiable-equilibria report for one run "
        "(calibration convergence, gradient-flag census, stress searches); "
        "exit 1 on unconverged calibration / non-finite gradients, 3 when "
        "no grad data was recorded",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.json:
        doc, code = grad_doc(run)
        print(json.dumps(doc, default=str))
        return code
    text, code = render_grad(run)
    print(text)
    return code


def _mem_fold(events) -> dict:
    """Fold ``mem`` events: per-where maxima for span attribution, per-tile
    peaks, and the last observed device capacity. The event log is the
    source of truth even when a kill -9 meant the manifest roll-up was
    never finalized (same contract as the resilience report)."""
    spans: dict = {}
    tiles: dict = {}
    capacity = None
    for ev in events:
        if ev.get("kind") != "mem":
            continue
        if isinstance(ev.get("bytes_limit"), (int, float)) and ev["bytes_limit"] > 0:
            capacity = int(ev["bytes_limit"])
        tile = ev.get("tile")
        if tile:
            tiles[tile] = max(tiles.get(tile, 0), _tile_peak(ev))
            continue
        agg = spans.setdefault(
            ev.get("where", "?"),
            {"events": 0, "live_buffer_bytes": 0, "bytes_in_use": 0, "peak_bytes_in_use": 0},
        )
        agg["events"] += 1
        for k in ("live_buffer_bytes", "bytes_in_use", "peak_bytes_in_use"):
            if isinstance(ev.get(k), (int, float)):
                agg[k] = max(agg[k], int(ev[k]))
    return {"spans": spans, "tiles": tiles, "capacity_bytes": capacity}


def memory_doc(run: dict, headroom_override=None) -> tuple:
    """Machine-readable memory report; returns (doc, exit_code). Exit
    codes: 0 within budget, 1 when any tile's peak exceeds the headroom
    threshold (or a preflight verdict was "exceeds"), 3 when the run
    carries no memory data at all (an instrumented run that was supposed
    to attribute memory but emitted nothing must not pass a gate
    silently)."""
    m = run["manifest"].get("memory") or {}
    folded = _mem_fold(run["events"])
    tiles = {k: int(v) for k, v in (m.get("tiles") or {}).items()}
    for t, p in folded["tiles"].items():
        tiles[t] = max(tiles.get(t, 0), p)
    capacity = m.get("capacity_bytes") or folded["capacity_bytes"]
    headroom = (
        float(headroom_override)
        if headroom_override is not None
        else float(m.get("headroom") or 0.8)
    )
    preflight = m.get("preflight") or [
        {k: v for k, v in ev.items() if k not in ("mono", "ts", "kind")}
        for ev in run["events"]
        if ev.get("kind") == "preflight"
    ]
    plan = m.get("plan")
    has_data = bool(
        folded["spans"]
        or tiles
        or m.get("peak_live_buffer_bytes")
        or m.get("peak_device_bytes")
        or plan
        or preflight
    )
    threshold = int(capacity * headroom) if capacity else None
    over = sorted(t for t, p in tiles.items() if threshold is not None and p > threshold)
    preflight_exceeded = any(p.get("verdict") == "exceeds" for p in preflight)
    code = 3 if not has_data else (1 if (over or preflight_exceeded) else 0)
    doc = {
        "dir": run["dir"],
        "memory": m,
        "spans": folded["spans"],
        "tiles": tiles,
        "capacity_bytes": capacity,
        "headroom": headroom,
        "threshold_bytes": threshold,
        "over_tiles": over,
        "preflight": preflight,
        "plan": plan,
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }
    return doc, code


def render_memory(run: dict, headroom_override=None) -> tuple:
    """Human-readable memory report; same exit-code contract as
    `memory_doc`."""
    doc, code = memory_doc(run, headroom_override)
    m = doc["memory"]
    out = [f"run      {run['dir']}{_bad_lines_note(run)}"]
    if code == 3:
        out.append(
            "no memory data recorded — was the run produced by an "
            "instrumented sweep/solve with telemetry on?"
        )
        return "\n".join(out), code
    peak = m.get("peak_device_bytes") or m.get("peak_live_buffer_bytes") or 0
    out.append(
        f"memory   peak {_fmt_bytes(peak)}"
        + (f"   in span {m['peak_span']}" if m.get("peak_span") else "")
    )
    if doc["capacity_bytes"]:
        out.append(
            f"capacity {_fmt_bytes(doc['capacity_bytes'])}   headroom "
            f"{doc['headroom']:.0%} → threshold {_fmt_bytes(doc['threshold_bytes'])}"
        )
    else:
        out.append("capacity unknown (no allocator stats — CPU backend?)")

    if doc["plan"]:
        p = doc["plan"]
        out += ["", "CAPACITY PLAN"]
        out.append(
            f"tile_shape auto → {tuple(p.get('tile_shape', []))} "
            f"(verdict {p.get('verdict')}"
            + (
                f", modeled {_fmt_bytes(p['modeled_bytes'])} of budget "
                f"{_fmt_bytes(p['budget_bytes'])}"
                if p.get("modeled_bytes") is not None
                else ""
            )
            + ")"
        )
    if doc["preflight"]:
        out += ["", "PREFLIGHT"]
        out.append(
            _table(
                ["label", "verdict", "footprint", "budget"],
                [
                    [
                        p.get("label", "-"),
                        p.get("verdict", "-").upper()
                        if p.get("verdict") == "exceeds"
                        else p.get("verdict", "-"),
                        _fmt_bytes(p.get("footprint_bytes")),
                        _fmt_bytes(p.get("budget_bytes")),
                    ]
                    for p in doc["preflight"]
                ],
            )
        )
    if doc["spans"]:
        out += ["", "SPANS (peak bytes observed at span/jit boundaries)"]
        out.append(
            _table(
                ["where", "events", "live buffers", "in use", "device peak"],
                [
                    [
                        k,
                        v["events"],
                        _fmt_bytes(v["live_buffer_bytes"]),
                        _fmt_bytes(v["bytes_in_use"]),
                        _fmt_bytes(v["peak_bytes_in_use"]),
                    ]
                    for k, v in sorted(doc["spans"].items())
                ],
            )
        )
    if doc["tiles"]:
        out += ["", f"TILES{' (OVER THRESHOLD: ' + ', '.join(doc['over_tiles']) + ')' if doc['over_tiles'] else ''}"]
        rows = []
        for tile, peak_b in sorted(doc["tiles"].items(), key=lambda kv: -kv[1]):
            share = (
                f"{100 * peak_b / doc['capacity_bytes']:.1f}%"
                if doc["capacity_bytes"]
                else "-"
            )
            rows.append(
                [tile, _fmt_bytes(peak_b), share, "OVER" if tile in doc["over_tiles"] else "-"]
            )
        out.append(_table(["tile", "peak", "of capacity", "flag"], rows))
    top = m.get("top_programs") or []
    if top:
        out += ["", "TOP PROGRAMS (by XLA temp size)"]
        out.append(
            _table(
                ["program", "temp", "output", "arguments"],
                [
                    [
                        p.get("name", "-"),
                        _fmt_bytes(p.get("temp_bytes")),
                        _fmt_bytes(p.get("out_bytes")),
                        _fmt_bytes(p.get("arg_bytes")),
                    ]
                    for p in top
                ],
            )
        )
    return "\n".join(out), code


# ---------------------------------------------------------------------------
# Serve report (`serve` subcommand — the live serving-telemetry renderer/gate)
# ---------------------------------------------------------------------------


def _env_float(name: str, default) -> float:
    import os

    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def serve_doc(run_dir, slo_ms=None, cache_floor=None, warmup=None) -> tuple:
    """Machine-readable serve report from a run dir's rolling ``live.json``
    (written by `sbr_tpu_torch.serve.engine` — atomic rename, so a RUNNING server
    can be read mid-flight); returns (doc, exit_code).

    Exit codes: 0 within SLO, 1 on a breach — window p99 over
    ``SBR_SERVE_SLO_MS`` (when set), or cache hit rate under the floor
    (``SBR_SERVE_CACHE_FLOOR``, default 0 = disabled) after warmup
    (``SBR_SERVE_WARMUP`` lifetime queries, default 50) — 2 when
    ``run_dir`` does not exist, 3 when no live serving data was recorded
    (a serve gate with nothing to read must not pass silently).
    """
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    live_path = run_dir / "live.json"
    try:
        live = json.loads(live_path.read_text())
    except (OSError, json.JSONDecodeError) as err:
        return {
            "dir": str(run_dir),
            "error": f"no readable live.json ({err})",
            "exit": 3,
        }, 3

    slo_ms = _env_float("SBR_SERVE_SLO_MS", None) if slo_ms is None else slo_ms
    cache_floor = (
        _env_float("SBR_SERVE_CACHE_FLOOR", 0.0) if cache_floor is None else cache_floor
    )
    warmup = int(_env_float("SBR_SERVE_WARMUP", 50)) if warmup is None else int(warmup)

    totals = live.get("totals") or {}
    window = live.get("window") or {}
    # The rolling window is the live view; when it has drained (a finished
    # server read post-hoc after >window_s), fall back to lifetime numbers.
    in_window = bool(window.get("queries"))
    scope = window if in_window else totals
    scope_name = "window" if in_window else "lifetime"
    p99 = (scope.get("latency_ms") or {}).get("p99")
    hit_rate = scope.get("hit_rate")
    scope_queries = scope.get("queries", 0)

    breaches = []
    if slo_ms is not None and p99 is not None and p99 > slo_ms:
        breaches.append(f"p99 {p99:.3f} ms over SLO {slo_ms:g} ms ({scope_name})")
    # The rate and the arming count come from the SAME scope: a quiet
    # window holding two fresh queries on a long-warm server must not read
    # as a cold cache (the lifetime count would arm the gate while the
    # window rate tanks on two samples).
    if cache_floor > 0 and scope_queries >= warmup and (hit_rate or 0.0) < cache_floor:
        breaches.append(
            f"cache hit rate {0.0 if hit_rate is None else hit_rate:.3f} "
            f"under floor {cache_floor:g} after warmup "
            f"({int(scope_queries)} {scope_name} queries)"
        )
    code = 1 if breaches else 0
    doc = {
        "dir": str(run_dir),
        "live": live,
        "scope": "window" if in_window else "lifetime",
        "slo_ms": slo_ms,
        "cache_floor": cache_floor,
        "warmup": warmup,
        "p99_ms": p99,
        "hit_rate": hit_rate,
        "breaches": breaches,
        "exit": code,
    }
    return doc, code


def render_serve(doc: dict) -> str:
    """Human-readable serve report; same exit contract as `serve_doc`."""
    live = doc.get("live") or {}
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no serving data"))
        if doc["exit"] == 3:
            out.append(
                "was the run produced by sbr_tpu_torch.serve (the engine writes a "
                "rolling live.json)?"
            )
        return "\n".join(out)
    out.append(
        f"serving  started {live.get('started_at')}   uptime "
        f"{_fmt_s(live.get('uptime_s'))}   snapshot age "
        f"{_fmt_s(max(0.0, time.time() - live.get('ts', 0)))}"
    )
    healthz = live.get("healthz") or {}
    out.append(
        f"health   {healthz.get('status', '?')}"
        + (f"   ({'; '.join(healthz.get('reasons', []))})" if healthz.get("reasons") else "")
    )
    engine = live.get("engine") or {}
    if engine:
        out.append(
            f"engine   buckets {engine.get('buckets')}   dtype {engine.get('dtype')}   "
            f"execs {engine.get('compiled', 0)} compiled / {engine.get('loaded', 0)} reloaded   "
            f"lru {engine.get('lru_entries', 0)}/{engine.get('lru_max', '?')}"
        )
    rows = []
    for label, scope in (("window", live.get("window") or {}), ("lifetime", live.get("totals") or {})):
        lat = scope.get("latency_ms") or {}
        rows.append(
            [
                label,
                int(scope.get("queries", 0)),
                "-" if scope.get("hit_rate") is None else f"{scope['hit_rate']:.1%}",
                "-" if scope.get("occupancy") is None else f"{scope['occupancy']:.1%}",
                int(scope.get("divergent_cells", 0)),
                *(
                    "-" if lat.get(q) is None else f"{lat[q]:.2f}"
                    for q in ("p50", "p95", "p99")
                ),
            ]
        )
    out += ["", "TRAFFIC"]
    out.append(
        _table(
            ["scope", "queries", "hit rate", "occupancy", "divergent",
             "p50 ms", "p95 ms", "p99 ms"],
            rows,
        )
    )
    compile_blk = live.get("compile") or {}
    out.append(
        f"\ncompiles {int(compile_blk.get('compiles', 0))} XLA backend compile(s), "
        f"traces " + (
            ", ".join(f"{k}={v}" for k, v in (compile_blk.get("traces") or {}).items())
            or "-"
        )
    )
    hist = ((live.get("window") or {}).get("latency_hist_ms")) or {}
    bounds, counts = hist.get("bounds") or [], hist.get("counts") or []
    if bounds and counts and sum(counts):
        buckets = {}
        for i, c in enumerate(counts):
            if not c:
                continue
            label = f"<={bounds[i]:g}ms" if i < len(bounds) else f">{bounds[-1]:g}ms"
            buckets[label] = c
        out += ["", "WINDOW LATENCY HISTOGRAM"]
        out += _ascii_hist(buckets)
    gate_bits = []
    if doc.get("slo_ms") is not None:
        gate_bits.append(f"SLO p99 <= {doc['slo_ms']:g} ms")
    if doc.get("cache_floor"):
        gate_bits.append(f"hit rate >= {doc['cache_floor']:g} after {doc['warmup']} queries")
    out.append("")
    if doc["breaches"]:
        out.append("GATE: SLO BREACH")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append(
            "GATE: ok" + (f" ({'; '.join(gate_bits)})" if gate_bits else " (no SLO configured)")
        )
    return "\n".join(out)


def _main_serve(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report serve",
        description="Render a serving run's rolling live telemetry "
        "(live.json); exit 1 on SLO breach (p99 over SBR_SERVE_SLO_MS or "
        "cache hit rate under the floor after warmup), 3 when no live "
        "serving data was recorded",
    )
    parser.add_argument("run_dir", help="run directory (contains live.json)")
    parser.add_argument("--slo-ms", type=float, default=None, dest="slo_ms",
                        help="p99 latency SLO in ms (default: $SBR_SERVE_SLO_MS)")
    parser.add_argument("--cache-floor", type=float, default=None, dest="cache_floor",
                        help="minimum cache hit rate after warmup "
                        "(default: $SBR_SERVE_CACHE_FLOOR, else 0 = disabled)")
    parser.add_argument("--warmup", type=int, default=None,
                        help="lifetime queries before the cache floor applies "
                        "(default: $SBR_SERVE_WARMUP, else 50)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = serve_doc(args.run_dir, args.slo_ms, args.cache_floor, args.warmup)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_serve(doc))
    return code


def _main_memory(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report memory",
        description="Per-span/per-tile peak-memory attribution for one run; "
        "exit 1 when any tile exceeds the headroom threshold (or a preflight "
        "failed), 3 when no memory data was recorded",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument(
        "--headroom", type=float, default=None, metavar="FRAC",
        help="override the flagging threshold as a fraction of device "
        "capacity (default: the run's recorded SBR_MEM_HEADROOM, else 0.8)",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.json:
        doc, code = memory_doc(run, args.headroom)
        print(json.dumps(doc, default=str))
        return code
    text, code = render_memory(run, args.headroom)
    print(text)
    return code


def _main_health(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report health",
        description="Numerical-health report for one run; nonzero exit on divergence",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.json:
        doc, code = health_json(run)
        print(json.dumps(doc, default=str))
        return code
    text, code = render_health(run)
    print(text)
    return code


def _main_resilience(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report resilience",
        description="Fault/retry/repair report for one run; nonzero exit on "
        "unrecovered failures (a retry scope that gave up, a repair that failed)",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.json:
        doc, code = resilience_json(run)
        print(json.dumps(doc, default=str))
        return code
    text, code = render_resilience(run)
    print(text)
    return code


def _main_gc(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report gc",
        description="Prune old obs run directories (keeping the N most "
        "recent) plus checkpoint debris left by aborted multihost runs: "
        "quarantine/ directories and stale tile_*.lease files",
    )
    parser.add_argument(
        "root", nargs="?", default=None,
        help="run root to prune (default: $SBR_OBS_DIR or obs_runs/)",
    )
    parser.add_argument("--keep", type=int, required=True, metavar="N",
                        help="number of most-recent run directories to keep")
    parser.add_argument(
        "--checkpoints", action="append", default=[], metavar="DIR",
        help="additional checkpoint root(s) to sweep for quarantine/ dirs "
        "and stale tile_*.lease files (the run root is always swept)",
    )
    parser.add_argument(
        "--lease-ttl", type=float, default=900.0, metavar="S",
        help="age (s) past which a lease with no recorded TTL counts as "
        "stale (default 900, matching SBR_STEAL_LEASE_TTL_S)",
    )
    parser.add_argument(
        "--tile-cache", action="append", default=[], metavar="DIR",
        help="cross-run global tile cache root(s) (SBR_TILE_CACHE_DIR) to "
        "prune of COLD entries — not read/written for --keep-days (cache "
        "hits refresh an entry's mtime, so warm regions are never evicted)",
    )
    parser.add_argument(
        "--keep-days", type=float, default=30.0, metavar="N",
        help="age (days) past which an unused tile-cache entry is pruned "
        "(default 30; only with --tile-cache)",
    )
    parser.add_argument(
        "--trace-keep", type=int, default=None, metavar="N", dest="trace_keep",
        help="also prune rotated trace span files (trace.NNN.jsonl) inside "
        "kept run dirs down to the N most recent per dir; live runs and "
        "the active trace.jsonl are never touched",
    )
    parser.add_argument(
        "--audit-keep", type=int, default=None, metavar="N", dest="audit_keep",
        help="also prune audit battery artifacts (audit/battery_NNNN.json) "
        "inside kept run dirs down to the N most recent per dir, plus "
        "archived golden snapshots (goldens_*.NNN.json) in the audit "
        "registry down to N per key; live runs and the active goldens "
        "are never touched",
    )
    parser.add_argument(
        "--demand-keep", type=int, default=None, metavar="N", dest="demand_keep",
        help="also prune rotated demand snapshots (demand.NNN.json) and "
        "aged advisor plans (advisor_plan.NNN.json) inside kept run dirs "
        "down to the N most recent per dir; live runs and the active "
        "demand.json / advisor_plan.json are never touched",
    )
    parser.add_argument(
        "--flight-keep", type=int, default=None, metavar="N", dest="flight_keep",
        help="also prune rotated flight-recorder snapshots "
        "(flight.NNN.json) inside kept run dirs down to the N most recent "
        "per dir; live runs and the active flight.json are never touched",
    )
    parser.add_argument(
        "--prewarm-keep", type=int, default=None, metavar="N", dest="prewarm_keep",
        help="also prune completed prewarm plan-state dirs "
        "(plan_*/ under SBR_PREWARM_STATE_DIR) down to the N most recent, plus "
        "leases whose tile already carries a done marker; epochs with live "
        "leases or sweeper heartbeats and the newest (active) plan are never "
        "touched",
    )
    args = parser.parse_args(argv)
    import os

    from sbr_tpu_torch.obs import mem
    from sbr_tpu_torch.obs.runlog import gc_runs

    root = args.root or os.environ.get("SBR_OBS_DIR", "obs_runs")
    removed = gc_runs(root, args.keep)
    print(f"removed {len(removed)} run dir(s) under {root} (keep {args.keep})")
    for d in removed:
        print(f"  {d}")
    debris = []
    for r in [root, *args.checkpoints]:
        debris.extend(mem.gc_debris(r, lease_ttl_s=args.lease_ttl))
    print(f"removed {len(debris)} checkpoint-debris path(s) "
          "(quarantine/, stale tile_*.lease, expired host_*.hb)")
    for p in debris:
        print(f"  {p}")
    if args.tile_cache:
        from sbr_tpu_torch.resilience.elastic import gc_tile_cache

        pruned = []
        for c in args.tile_cache:
            pruned.extend(gc_tile_cache(c, keep_days=args.keep_days))
        print(f"removed {len(pruned)} cold tile-cache entr(ies) "
              f"(unused for {args.keep_days:g} days)")
        for p in pruned:
            print(f"  {p}")
    if args.trace_keep is not None:
        from sbr_tpu_torch.obs.trace import gc_trace_files

        pruned = gc_trace_files(root, keep_rotated=args.trace_keep)
        print(f"removed {len(pruned)} rotated trace span file(s) "
              f"(keep {args.trace_keep} per run dir)")
        for p in pruned:
            print(f"  {p}")
    if args.audit_keep is not None:
        from sbr_tpu_torch.obs.audit import gc_audit_files

        pruned = gc_audit_files(root, keep=args.audit_keep)
        print(f"removed {len(pruned)} audit artifact file(s) "
              f"(keep {args.audit_keep} per run dir / golden key)")
        for p in pruned:
            print(f"  {p}")
    if args.demand_keep is not None:
        from sbr_tpu_torch.obs.demand import gc_demand_files

        pruned = gc_demand_files(root, keep=args.demand_keep)
        print(f"removed {len(pruned)} demand artifact file(s) "
              f"(keep {args.demand_keep} per run dir)")
        for p in pruned:
            print(f"  {p}")
    if args.prewarm_keep is not None:
        from sbr_tpu_torch.serve.prewarm import gc_prewarm_files

        pruned = gc_prewarm_files(keep=args.prewarm_keep)
        print(f"removed {len(pruned)} prewarm state path(s) "
              f"(keep {args.prewarm_keep} plan epoch(s))")
        for p in pruned:
            print(f"  {p}")
    if args.flight_keep is not None:
        from sbr_tpu_torch.obs.flight import gc_flight_files

        pruned = gc_flight_files(root, keep=args.flight_keep)
        print(f"removed {len(pruned)} flight artifact file(s) "
              f"(keep {args.flight_keep} per run dir)")
        for p in pruned:
            print(f"  {p}")
    return 0


# ---------------------------------------------------------------------------
# Fleet report (`fleet` subcommand: the serving-fleet renderer and gate)
# ---------------------------------------------------------------------------


def fleet_doc(run_dir, stuck_after_s: float = 600.0) -> tuple:
    """Machine-readable serving-fleet report from a ROUTER run dir: the
    rolling ``fleet.json`` snapshot (`sbr_tpu_torch.serve.router`, atomic
    rename — readable mid-flight) plus the obs ``fleet`` event fold.
    Returns (doc, exit_code).

    Exit codes: 0 healthy; 1 on LOST queries (a client got a non-200,
    non-429 answer — failover exists precisely so this never happens) or
    a breaker STUCK open (state "open" in the final snapshot for longer
    than ``stuck_after_s`` — a breaker parked over a dead worker clears
    when the heartbeat TTL reaps the worker from the table, so keep
    ``stuck_after_s`` at or above the fleet's heartbeat TTL); 2 when
    ``run_dir`` is not a directory; 3 when no fleet data was recorded
    (a fleet gate with nothing to read must not pass silently)."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    snapshot = None
    try:
        snapshot = json.loads((run_dir / "fleet.json").read_text())
    except (OSError, json.JSONDecodeError):
        pass
    events_fold: dict = {}
    bad_lines = 0
    try:
        run = load_run(run_dir)
        bad_lines = run.get("bad_event_lines", 0)
        for ev in run["events"]:
            if ev.get("kind") == "fleet":
                action = str(ev.get("action", "?"))
                events_fold[action] = events_fold.get(action, 0) + 1
        manifest_fleet = run["manifest"].get("fleet") or {}
    except (FileNotFoundError, json.JSONDecodeError):
        manifest_fleet = {}
    if snapshot is None and not events_fold and not manifest_fleet:
        return {
            "dir": str(run_dir),
            "error": "no fleet data (no fleet.json, no fleet events)",
            "exit": 3,
        }, 3

    counters = (snapshot or {}).get("counters") or {}
    workers = (snapshot or {}).get("workers") or {}
    # The event fold is the kill -9 fallback (a router that died before
    # its throttled fleet.json caught up): take the max of the two views
    # for EVERY gated/asserted count, never the sum — and never trust the
    # snapshot alone, since Router initializes every counter key (a plain
    # dict.get fallback would always pick the stale snapshot zero).
    def _best(counter_key: str, event_key: str) -> int:
        return max(int(counters.get(counter_key, 0)),
                   int(events_fold.get(event_key, 0)))

    lost = _best("failed", "lost")
    stuck = sorted(
        h
        for h, w in workers.items()
        if w.get("breaker") == "open"
        and isinstance(w.get("breaker_age_s"), (int, float))
        and w["breaker_age_s"] > stuck_after_s
    )
    breaches = []
    if lost > 0:
        breaches.append(f"{lost} lost quer(ies) — failover failed to absorb")
    if stuck:
        breaches.append(
            f"breaker stuck open > {stuck_after_s:g}s for: {', '.join(stuck)}"
        )
    code = 1 if breaches else 0
    doc = {
        "dir": str(run_dir),
        "snapshot": snapshot,
        "counters": counters,
        "workers": workers,
        "events": events_fold,
        "manifest_fleet": manifest_fleet or None,
        "lost": lost,
        "failover_count": _best("failover", "failover"),
        "shed": _best("shed", "shed"),
        "degraded": _best("degraded", "degraded"),
        "stuck_breakers": stuck,
        "stuck_after_s": stuck_after_s,
        "breaches": breaches,
        "bad_event_lines": bad_lines,
        "exit": code,
    }
    return doc, code


def render_fleet(doc: dict) -> str:
    """Human-readable fleet report; same exit contract as `fleet_doc`."""
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no fleet data"))
        if doc["exit"] == 3:
            out.append(
                "was the run produced by sbr_tpu_torch.serve.router (it writes a "
                "rolling fleet.json + fleet events)?"
            )
        return "\n".join(out)
    snap = doc.get("snapshot") or {}
    c = doc["counters"]
    out.append(
        f"fleet    {int(c.get('queries', 0))} quer(ies): "
        f"{int(c.get('completed', 0))} completed, {doc['lost']} lost, "
        f"{doc['shed']} shed, {doc['degraded']} degraded"
    )
    out.append(
        f"routing  {doc['failover_count']} failover(s), "
        f"{int(c.get('hedged', 0))} hedge(s) ({int(c.get('hedge_wins', 0))} won), "
        f"{int(c.get('forward_errors', 0))} forward error(s)"
    )
    lat = snap.get("latency_ms") or {}
    if lat.get("count"):
        out.append(
            f"latency  p50 {_fmt_val_ms(lat.get('p50'))}   "
            f"p95 {_fmt_val_ms(lat.get('p95'))}   p99 {_fmt_val_ms(lat.get('p99'))}"
        )
    if doc["workers"]:
        out += ["", "WORKERS"]
        out.append(
            _table(
                ["worker", "breaker", "age s", "forwards", "failures",
                 "ewma ms", "healthz"],
                [
                    [
                        h,
                        (w.get("breaker") or "-").upper()
                        if h in doc["stuck_breakers"] else (w.get("breaker") or "-"),
                        "-" if w.get("breaker_age_s") is None else f"{w['breaker_age_s']:g}",
                        w.get("forwards", 0),
                        w.get("failures", 0),
                        w.get("ewma_ms", "-"),
                        w.get("healthz") or "-",
                    ]
                    for h, w in sorted(doc["workers"].items())
                ],
            )
        )
    if doc["events"]:
        out += ["", "FLEET EVENTS"]
        out.append(
            _table(
                ["action", "count"],
                [[k, v] for k, v in sorted(doc["events"].items())],
            )
        )
    out.append("")
    if doc["breaches"]:
        out.append("GATE: FLEET BREACH")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append("GATE: ok (zero lost queries, no breaker stuck open)")
    return "\n".join(out)


def _main_fleet(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report fleet",
        description="Serving-fleet report for one router run (rolling "
        "fleet.json + fleet events); exit 1 on lost queries or a breaker "
        "stuck open, 3 when no fleet data was recorded",
    )
    parser.add_argument("run_dir", help="router run directory (contains fleet.json)")
    parser.add_argument(
        "--stuck-after-s", type=float, default=600.0, dest="stuck_after_s",
        help="age (s) past which an open breaker counts as stuck (default "
        "600; keep >= the fleet heartbeat TTL so dead workers are reaped "
        "from the table before their breakers can read as stuck)",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = fleet_doc(args.run_dir, args.stuck_after_s)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_fleet(doc))
    return code


# ---------------------------------------------------------------------------
# Numerics-audit report (`audit` subcommand)
# ---------------------------------------------------------------------------


def audit_doc(run_dir) -> tuple:
    """Machine-readable numerics-audit report (`obs.audit` of either
    package): the manifest ``audit`` roll-up plus the per-event fold of
    canary probe verdicts and cycle summaries. Returns (doc, exit_code).

    Exit codes: 0 every probe passed; 1 on ANY drift verdict (probe event,
    cycle roll-up, manifest tally, or a scheduler ``error`` event — an
    audit that crashed mid-battery must not read as clean) — the manifest
    tally and the event fold are merged max-style, never summed, so a run
    killed before its manifest flushed still gates on its events; 3 when
    the run recorded no audit data at all (a drift gate with nothing to
    read must not pass silently); 2 when ``run_dir`` is not a directory."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    try:
        run = load_run(run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        return {"dir": str(run_dir), "error": str(err), "exit": 2}, 2
    manifest_blk = run["manifest"].get("audit") or {}
    events = [ev for ev in run["events"] if ev.get("kind") == "audit"]
    if not manifest_blk and not events:
        return {
            "dir": str(run_dir),
            "error": "no audit data (no audit events, no manifest roll-up)",
            "exit": 3,
        }, 3
    # Per-probe LAST verdict (later events supersede: a probe that drifted
    # once and then went green after --update-goldens reads as its final
    # state; the drift still counts in the drift tally below).
    probes: dict = {}
    drift_events = 0
    pass_events = 0
    errors = 0
    cycles: list = []
    for ev in events:
        action = str(ev.get("action", "?"))
        if action == "probe":
            name = str(ev.get("probe", "?"))
            verdict = str(ev.get("verdict", "?"))
            ent = probes.setdefault(name, {"events": 0})
            ent["events"] += 1
            ent["verdict"] = verdict
            ent["tier"] = ev.get("tier")
            ent["detail"] = ev.get("detail")
            ent["duration_ms"] = ev.get("duration_ms")
            if ev.get("cycle") is not None:
                ent["cycle"] = ev.get("cycle")
            if verdict == "drift":
                drift_events += 1
                ent["drift_cycle"] = ev.get("cycle")
            elif verdict == "pass":
                pass_events += 1
        elif action == "cycle":
            cycles.append({
                "cycle": ev.get("cycle"),
                "verdict": ev.get("verdict"),
                "probes": ev.get("probes"),
                "drift": ev.get("drift"),
                "missing": ev.get("missing"),
                "duration_s": ev.get("duration_s"),
                "key_hash": ev.get("key_hash"),
            })
        elif action == "error":
            errors += 1
    # Manifest tally vs event fold: max of the two views for every gated
    # count (the fleet report's rule — a worker killed before its manifest
    # flushed still has its events; a torn events.jsonl still has the
    # manifest), never the sum.
    drift = max(drift_events, int(manifest_blk.get("drift", 0)))
    passed = max(pass_events, int(manifest_blk.get("passed", 0)))
    errors = max(errors, int(manifest_blk.get("error", 0)))
    drifted = sorted(
        n for n, e in probes.items() if e.get("verdict") == "drift"
    )
    last_cycle = manifest_blk.get("last_cycle")
    last_verdict = manifest_blk.get("last_verdict")
    if cycles:
        last_cycle = cycles[-1].get("cycle", last_cycle)
        last_verdict = cycles[-1].get("verdict", last_verdict)
    breaches = []
    if drift > 0:
        who = f" ({', '.join(drifted)})" if drifted else ""
        breaches.append(f"{drift} drift verdict(s){who}")
    if last_verdict == "drift" and not breaches:
        breaches.append("last cycle verdict is drift")
    if errors > 0:
        breaches.append(f"{errors} audit error event(s) — battery crashed")
    code = 1 if breaches else 0
    doc = {
        "dir": str(run_dir),
        "manifest_audit": manifest_blk or None,
        "probes": probes,
        "cycles": cycles,
        "drift": drift,
        "passed": passed,
        "errors": errors,
        "drifted_probes": drifted,
        "last_cycle": last_cycle,
        "last_verdict": last_verdict,
        "breaches": breaches,
        "bad_event_lines": run.get("bad_event_lines", 0),
        "exit": code,
    }
    return doc, code


def render_audit(doc: dict) -> str:
    """Human-readable audit report; same exit contract as `audit_doc`."""
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no audit data"))
        if doc["exit"] == 3:
            out.append(
                "was the battery run with obs enabled (python -m "
                "sbr_tpu_torch.obs.audit --obs-dir DIR, or SBR_AUDIT=1 serving)?"
            )
        return "\n".join(out)
    out.append(
        f"audit    {doc['passed']} pass, {doc['drift']} drift, "
        f"{doc['errors']} error(s)"
        + (f"   last cycle {doc['last_cycle']} ({doc['last_verdict']})"
           if doc.get("last_cycle") is not None else "")
    )
    if doc.get("bad_event_lines"):
        out.append(f"warning  {doc['bad_event_lines']} torn event line(s) skipped")
    if doc["probes"]:
        out += ["", "PROBES"]
        out.append(
            _table(
                ["probe", "tier", "verdict", "runs", "last ms", "detail"],
                [
                    [
                        n,
                        e.get("tier") or "-",
                        str(e.get("verdict", "?")).upper()
                        if e.get("verdict") == "drift" else e.get("verdict", "?"),
                        e.get("events", 0),
                        "-" if e.get("duration_ms") is None
                        else f"{e['duration_ms']:.1f}",
                        (e.get("detail") or "-")[:60],
                    ]
                    for n, e in sorted(doc["probes"].items())
                ],
            )
        )
    if doc["cycles"]:
        out += ["", "CYCLES"]
        out.append(
            _table(
                ["cycle", "verdict", "probes", "drift", "missing", "s"],
                [
                    [
                        "-" if c.get("cycle") is None else c["cycle"],
                        c.get("verdict", "-"),
                        c.get("probes", "-"), c.get("drift", "-"),
                        c.get("missing", "-"),
                        "-" if c.get("duration_s") is None
                        else f"{c['duration_s']:.2f}",
                    ]
                    for c in doc["cycles"][-12:]
                ],
            )
        )
    out.append("")
    if doc["breaches"]:
        out.append("GATE: NUMERICS DRIFT")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append("GATE: ok (every audited probe matched its golden)")
    return "\n".join(out)


def _main_audit(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report audit",
        description="Numerics-audit report for one run (audit events + "
        "manifest roll-up from obs.audit canary batteries); exit 1 "
        "on any drift verdict, 3 when no audit data was recorded",
    )
    parser.add_argument("run_dir", help="obs run directory with audit events")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = audit_doc(args.run_dir)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_audit(doc))
    return code


# ---------------------------------------------------------------------------
# Workload-demand report (`demand` subcommand)
# ---------------------------------------------------------------------------


def demand_doc(run_dirs, floor=None, cache_dir=None) -> tuple:
    """Machine-readable workload-demand report (`sbr_tpu_torch.obs.demand`):
    merges the lifetime demand surfaces from each run's rolling
    ``demand.json`` (worker and single-engine runs alike) into hot-region
    tables, top-k heavy-hitter fingerprints, warm/cold coverage ratios,
    and a freshly ranked advisor plan (against ``cache_dir``'s tile-cache
    cell index when given). Returns (doc, exit_code).

    Exit codes: 0 healthy; 1 when hot-region warm coverage is under the
    floor (``--floor`` or ``SBR_DEMAND_COVERAGE_FLOOR``; no floor = gate
    disarmed); 3 when no run recorded demand data (a coverage gate with
    nothing to read must not pass silently); 2 when some ``run_dir`` is
    not a directory."""
    from sbr_tpu_torch.obs import demand as _demand

    if floor is None:
        floor = _demand.coverage_floor()
    surfaces, per_dir, bad = [], [], 0
    for d in run_dirs:
        d = Path(d)
        if not d.is_dir():
            return {"dir": str(d), "error": "not a directory", "exit": 2}, 2
        snap_path = d / "demand.json"
        if not snap_path.is_file():
            per_dir.append({"dir": str(d), "queries": 0, "demand_json": False})
            continue
        try:
            snap = json.loads(snap_path.read_text())
            surface = snap["totals"]
        except (OSError, ValueError, KeyError, TypeError):
            bad += 1
            per_dir.append({"dir": str(d), "queries": 0, "demand_json": False})
            continue
        surfaces.append(surface)
        per_dir.append({
            "dir": str(d),
            "queries": int(surface.get("queries") or 0),
            "demand_json": True,
        })
    merged = _demand.merge_surfaces(surfaces) if surfaces else None
    if merged is None or not merged.get("queries"):
        return {
            "dirs": [str(d) for d in run_dirs],
            "error": "no demand data (no demand.json with queries — was the "
            "run served with SBR_DEMAND=1?)",
            "bad_demand_files": bad,
            "exit": 3,
        }, 3
    hot = _demand.hot_bins(merged)
    hot_q = sum(h["count"] for h in hot)
    hot_warm = sum(h["warm"] for h in hot)
    hot_cov = round(hot_warm / hot_q, 4) if hot_q else 0.0
    coverage = _demand.coverage_from_cache_dir(cache_dir) if cache_dir else None
    plan = _demand.advisor_plan(merged, coverage, floor=floor)
    sketch = _demand.MisraGries.from_doc(merged.get("sketch") or {})
    top_fps = [
        {
            "fingerprint": item, "count": count,
            **({k: payload.get(k) for k in ("beta", "u", "scenario", "kind")}
               if isinstance(payload, dict) else {}),
        }
        for item, count, payload in sketch.top(_demand.topk())
    ]
    sources: dict = {}
    for cell in (merged.get("cells") or {}).values():
        for s, v in (cell.get("sources") or {}).items():
            sources[s] = sources.get(s, 0) + int(v)
    breaches = []
    if floor is not None and hot_cov < floor:
        breaches.append(
            f"hot-region warm coverage {hot_cov:.3f} under floor {floor:g}"
        )
    code = 1 if breaches else 0
    doc = {
        "dirs": [str(d) for d in run_dirs],
        "per_dir": per_dir,
        "queries": int(merged["queries"]),
        "bins": merged["bins"],
        "hot_bins": hot,
        "hot_warm_coverage": hot_cov,
        "floor": floor,
        "sources": {k: sources[k] for k in sorted(sources)},
        "top_fingerprints": top_fps,
        "advisor": plan,
        "cache_dir": str(cache_dir) if cache_dir else None,
        "bad_demand_files": bad,
        "breaches": breaches,
        "exit": code,
    }
    return doc, code


def render_demand(doc: dict) -> str:
    """Human-readable demand report; same exit contract as `demand_doc`."""
    if doc["exit"] == 2:
        return f"run      {doc['dir']}\n{doc.get('error', 'not a directory')}"
    if doc["exit"] == 3:
        out = [f"runs     {', '.join(doc['dirs'])}", doc.get("error", "no demand data")]
        return "\n".join(out)
    out = [f"runs     {', '.join(doc['dirs'])}"]
    out.append(
        f"demand   {doc['queries']} quer(ies) on a {doc['bins']}x{doc['bins']} "
        f"(beta, u) grid; hot region {len(doc['hot_bins'])} bin(s), "
        f"warm coverage {doc['hot_warm_coverage']:.3f}"
        + (f" (floor {doc['floor']:g})" if doc.get("floor") is not None else "")
    )
    if doc.get("bad_demand_files"):
        out.append(f"warning  {doc['bad_demand_files']} torn demand.json skipped")
    if doc["sources"]:
        out.append("sources  " + ", ".join(
            f"{k}={v}" for k, v in doc["sources"].items()
        ))
    if doc["hot_bins"]:
        out += ["", "HOT REGION (bins covering >= 50% of demand)"]
        out.append(_table(
            ["bin", "beta", "u", "count", "share", "warm", "coverage"],
            [
                [
                    h["bin"],
                    f"[{h['beta_lo']:g},{h['beta_hi']:g})",
                    f"[{h['u_lo']:g},{h['u_hi']:g})",
                    h["count"],
                    f"{h['share']:.2f}",
                    h["warm"],
                    f"{h['warm_coverage']:.2f}",
                ]
                for h in doc["hot_bins"]
            ],
        ))
    if doc["top_fingerprints"]:
        out += ["", "TOP FINGERPRINTS (Misra-Gries heavy hitters)"]
        out.append(_table(
            ["fingerprint", "count", "beta", "u", "scenario", "kind"],
            [
                [
                    f["fingerprint"],
                    f["count"],
                    "-" if f.get("beta") is None else f"{f['beta']:g}",
                    "-" if f.get("u") is None else f"{f['u']:g}",
                    f.get("scenario") or "-",
                    f.get("kind") or "-",
                ]
                for f in doc["top_fingerprints"][:12]
            ],
        ))
    plan = doc.get("advisor") or {}
    if plan.get("tiles"):
        out += ["", f"ADVISOR PLAN {plan.get('plan_fingerprint', '?')}"
                + (f" (cache {doc['cache_dir']})" if doc.get("cache_dir") else "")]
        out.append(_table(
            ["rank", "bin", "score", "count", "cells", "tile cov"],
            [
                [
                    t["rank"], t["bin"], f"{t['score']:g}", t["count"],
                    t["cells"], f"{t['tile_coverage']:.2f}",
                ]
                for t in plan["tiles"]
            ],
        ))
    out.append("")
    if doc["breaches"]:
        out.append("GATE: COLD HOT-REGION")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append("GATE: ok" + (
            " (hot-region warm coverage clears the floor)"
            if doc.get("floor") is not None else " (no coverage floor set)"
        ))
    return "\n".join(out)


def _main_demand(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report demand",
        description="Workload-demand report over one or more run dirs "
        "(rolling demand.json surfaces from sbr_tpu_torch.obs.demand): hot-region "
        "tables, top-k heavy-hitter fingerprints, warm/cold coverage, and "
        "the ranked prefetch-advisor plan; exit 1 when hot-region warm "
        "coverage is under the floor, 3 when no demand data was recorded",
    )
    parser.add_argument("run_dirs", nargs="+",
                        help="obs run director(ies) with demand.json")
    parser.add_argument("--floor", type=float, default=None,
                        help="warm-coverage gate floor (default "
                        "SBR_DEMAND_COVERAGE_FLOOR; unset = gate disarmed)")
    parser.add_argument("--cache-dir", default=None, dest="cache_dir",
                        help="tile-cache root (SBR_TILE_CACHE_DIR) whose "
                        "cell index feeds the advisor's coverage input")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = demand_doc(args.run_dirs, floor=args.floor,
                           cache_dir=args.cache_dir)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_demand(doc))
    return code



# ---------------------------------------------------------------------------
# Prefetch-controller report (`prewarm` subcommand)
# ---------------------------------------------------------------------------


def prewarm_doc(run_dir) -> tuple:
    """Machine-readable prefetch-controller report
    (`sbr_tpu_torch.serve.prewarm`): folds the run's ``prewarm`` events (with
    the manifest roll-up as fallback for a torn event log) into per-plan
    progress, tile sources, abandonment by reason, and the final warm
    verdict of every completed plan. Returns (doc, exit_code).

    Exit codes: 0 healthy; 1 when tiles were abandoned over budget or a
    plan completed COLD (``plan_done`` with warm < tiles — the sweep ran
    but the hot region still can't be served from cache); 3 when the run
    recorded no prewarm data (a prewarm gate with nothing to read must
    not pass silently); 2 when ``run_dir`` is not a directory."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    try:
        run = load_run(run_dir)
    except (OSError, ValueError):
        run = {"manifest": {}, "events": [], "bad_event_lines": 0}
    events = [e for e in run["events"] if e.get("kind") == "prewarm"]
    manifest_block = (run["manifest"] or {}).get("prewarm") or {}
    if not events and not manifest_block:
        return {
            "dir": str(run_dir),
            "error": "no prewarm data (no prewarm events or manifest "
            "roll-up — was the run served with SBR_PREWARM=1?)",
            "exit": 3,
        }, 3

    actions: dict = {}
    abandoned = {"stale": 0, "budget": 0}
    sources: dict = {}
    plans: dict = {}
    for e in events:
        a = str(e.get("action") or "?")
        actions[a] = actions.get(a, 0) + 1
        fp = e.get("fingerprint")
        if fp:
            p = plans.setdefault(str(fp), {
                "tiles": None, "tiles_done": 0, "failed_tiles": 0,
                "adopted": 0, "warm": None, "done": False,
                "rejected": False,
            })
        if a == "plan" and fp:
            p["tiles"] = e.get("tiles")
        elif a == "tile" and fp:
            p["tiles_done"] += 1
            src = str(e.get("source") or "?")
            sources[src] = sources.get(src, 0) + 1
        elif a == "tile_failed" and fp:
            p["failed_tiles"] += 1
        elif a == "adopt" and fp:
            p["adopted"] += 1
        elif a == "abandon":
            reason = str(e.get("reason") or "unknown")
            abandoned[reason] = abandoned.get(reason, 0) + int(e.get("count") or 1)
        elif a == "plan_done" and fp:
            p["done"] = True
            p["warm"] = e.get("warm")
            if e.get("tiles") is not None:
                p["tiles"] = e.get("tiles")
        elif a == "plan_reject" and fp:
            p["rejected"] = True
    if not events and manifest_block:
        # Torn/absent event log: the manifest roll-up still gates.
        actions = {k: v for k, v in manifest_block.items()
                   if isinstance(v, int) and not k.startswith("abandoned_")
                   and not k.startswith("last_")}
        for reason in ("stale", "budget"):
            abandoned[reason] = int(manifest_block.get(f"abandoned_{reason}") or 0)
        fp = manifest_block.get("last_plan")
        if fp:
            plans[str(fp)] = {
                "tiles": manifest_block.get("last_tiles"),
                "tiles_done": int(manifest_block.get("tile") or 0),
                "failed_tiles": int(manifest_block.get("tile_failed") or 0),
                "adopted": int(manifest_block.get("adopt") or 0),
                "warm": manifest_block.get("last_warm"),
                "done": bool(manifest_block.get("plan_done")),
                "rejected": bool(manifest_block.get("plan_reject")),
            }

    breaches = []
    if abandoned.get("budget"):
        breaches.append(
            f"{abandoned['budget']} tile(s) abandoned over the work budget "
            "(raise SBR_PREWARM_BUDGET_TILES/_SECONDS or shrink the plan)"
        )
    for fp, p in sorted(plans.items()):
        if p["done"] and p["warm"] is not None and p["tiles"] is not None \
                and int(p["warm"]) < int(p["tiles"]):
            breaches.append(
                f"plan {fp} completed cold: warm {p['warm']}/{p['tiles']} "
                "tile(s) in the cache"
            )
    code = 1 if breaches else 0
    doc = {
        "dir": str(run_dir),
        "actions": {k: actions[k] for k in sorted(actions)},
        "plans": {k: plans[k] for k in sorted(plans)},
        "sources": {k: sources[k] for k in sorted(sources)},
        "abandoned": abandoned,
        "bad_event_lines": run["bad_event_lines"],
        "breaches": breaches,
        "exit": code,
    }
    return doc, code


def render_prewarm(doc: dict) -> str:
    """Human-readable prewarm report; same exit contract as `prewarm_doc`."""
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no prewarm data"))
        return "\n".join(out)
    plans = doc["plans"]
    done = sum(1 for p in plans.values() if p["done"])
    out.append(
        f"prewarm  {len(plans)} plan(s) seen, {done} completed; "
        f"{sum(p['tiles_done'] for p in plans.values())} tile(s) swept"
    )
    if doc["sources"]:
        out.append("sources  " + ", ".join(
            f"{k}={v}" for k, v in doc["sources"].items()
        ))
    if any(doc["abandoned"].values()):
        out.append("abandoned " + ", ".join(
            f"{k}={v}" for k, v in sorted(doc["abandoned"].items()) if v
        ))
    if doc.get("bad_event_lines"):
        out.append(f"warning  {doc['bad_event_lines']} torn event line(s) skipped")
    if plans:
        out += ["", "PLANS"]
        out.append(_table(
            ["plan", "tiles", "done", "failed", "adopted", "warm", "status"],
            [
                [
                    fp,
                    "-" if p["tiles"] is None else p["tiles"],
                    p["tiles_done"],
                    p["failed_tiles"],
                    p["adopted"],
                    "-" if p["warm"] is None else p["warm"],
                    "rejected" if p["rejected"]
                    else ("done" if p["done"] else "in-flight"),
                ]
                for fp, p in sorted(plans.items())
            ],
        ))
    out.append("")
    if doc["breaches"]:
        out.append("GATE: PREWARM DEGRADED")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append("GATE: ok (no budget abandonment, completed plans warm)")
    return "\n".join(out)


def _main_prewarm(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report prewarm",
        description="Prefetch-controller report for one run dir "
        "(prewarm events from sbr_tpu_torch.serve.prewarm): per-plan sweep "
        "progress, tile sources, adoption and abandonment; exit 1 when "
        "tiles were abandoned over budget or a completed plan left the "
        "hot region cold, 3 when the run recorded no prewarm data",
    )
    parser.add_argument("run_dir", help="obs run directory of a prewarm-enabled "
                        "engine or standalone sweeper")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = prewarm_doc(args.run_dir)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_prewarm(doc))
    return code


# ---------------------------------------------------------------------------
# Pipeline-utilization report (`util` subcommand)
# ---------------------------------------------------------------------------


def util_doc(run_dir, floor=None, min_disp=None) -> tuple:
    """Machine-readable pipeline-utilization report (`sbr_tpu_torch.obs.flight`):
    reads the run's rolling ``flight.json`` and derives (or re-derives,
    when only raw records landed) the device-busy / host-gap surface with
    per-cause bubble attribution. Returns (doc, exit_code).

    Exit codes: 0 healthy; 1 when the device-busy fraction is under the
    floor (``--floor`` or ``SBR_FLIGHT_UTIL_FLOOR``) over a measured
    window with at least ``--min-dispatches`` dispatches (fewer disarms
    the gate — a one-dispatch window is compile shadow, not utilization);
    3 when the run recorded no flight data (a gate with nothing to read
    must not pass silently); 2 when ``run_dir`` is not a directory."""
    from sbr_tpu_torch.obs import flight as _flight

    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    if floor is None:
        floor = _flight.util_floor()
    if min_disp is None:
        min_disp = _flight.min_dispatches()
    try:
        snap = json.loads((run_dir / "flight.json").read_text())
    except (OSError, json.JSONDecodeError, ValueError):
        snap = None
    if not isinstance(snap, dict) or not snap.get("records"):
        return {
            "dir": str(run_dir),
            "error": "no flight data (no flight.json with records — was "
            "the run served with SBR_FLIGHT=1?)",
            "exit": 3,
        }, 3
    # Re-derive from the raw ring rather than trusting the embedded util
    # block: the gate must judge with ITS deriver, and a snapshot written
    # by an older process stays readable.
    util = _flight.derive_utilization(snap)

    breaches = []
    notes = []
    busy = util.get("device_busy_frac")
    dispatches = int(util.get("dispatches") or 0)
    if util.get("dropped_records"):
        notes.append(
            f"{util['dropped_records']} record(s) overwritten in the ring "
            "(raise SBR_FLIGHT_CAP for a wider window)"
        )
    if floor is not None:
        if dispatches < int(min_disp):
            notes.append(
                f"floor gate disarmed: {dispatches} dispatch(es) in the "
                f"window (< {int(min_disp)})"
            )
        elif busy is not None and busy < float(floor):
            causes = util.get("gap_causes") or {}
            top = max(causes.items(), key=lambda kv: kv[1]["s"])[0] \
                if causes else "?"
            breaches.append(
                f"device-busy fraction {busy:.4f} under floor "
                f"{float(floor):g} over {dispatches} dispatch(es) "
                f"(dominant gap cause: {top})"
            )
    code = 1 if breaches else 0
    doc = {
        "dir": str(run_dir),
        "floor": float(floor) if floor is not None else None,
        "min_dispatches": int(min_disp),
        "ts": snap.get("ts"),
        "util": util,
        "notes": notes,
        "breaches": breaches,
        "exit": code,
    }
    return doc, code


def render_util(doc: dict) -> str:
    """Human-readable utilization report; same exit contract as `util_doc`."""
    out = [f"run      {doc['dir']}"]
    if doc["exit"] in (2, 3):
        out.append(doc.get("error", "no flight data"))
        return "\n".join(out)
    u = doc["util"]
    busy = u.get("device_busy_frac")
    gap = u.get("host_gap_frac")
    out.append(
        f"flight   {u.get('records', 0)} record(s), "
        f"{u.get('dispatches', 0)} dispatch(es), "
        f"window {u.get('window_s') or 0:g} s"
    )
    out.append(
        "util     device-busy "
        + ("-" if busy is None else f"{busy:.4f}")
        + "  host-gap "
        + ("-" if gap is None else f"{gap:.4f}")
        + (f"  (floor {doc['floor']:g})" if doc.get("floor") is not None
           else "  (no floor set)")
    )
    causes = u.get("gap_causes") or {}
    if causes:
        out += ["", "GAP ATTRIBUTION"]
        out.append(_table(
            ["cause", "seconds", "share"],
            [
                [c, f"{v['s']:.6f}", f"{v['frac']:.4f}"]
                for c, v in sorted(causes.items(),
                                   key=lambda kv: -kv[1]["s"])
            ],
        ))
    qd = u.get("queue_depth")
    if qd:
        out.append(
            f"queue    p50={qd['p50']:g} p95={qd['p95']:g} "
            f"p99={qd['p99']:g} max={qd['max']:g} "
            f"({qd['samples']} sample(s))"
        )
    occ = u.get("occupancy")
    if occ:
        out.append(
            f"occupancy mean={occ['mean']:g} " + " ".join(
                f"{b}={v:g}" for b, v in occ["by_bucket"].items()
            )
        )
    sw = u.get("sweeps")
    if sw:
        out.append(
            f"sweeps   {sw['tiles']} tile(s), "
            + ", ".join(f"{k}={v:g}ms" for k, v in sw["by_kind_ms"].items())
            + f"; bubbles {sw['bubble_total_ms']:g} ms total"
        )
    col = u.get("collectives")
    if col:
        out.append("collectives " + ", ".join(
            f"{k}: {v['count']}x/{v['total_ms']:g}ms" for k, v in col.items()
        ))
    for n in doc.get("notes") or []:
        out.append(f"note     {n}")
    out.append("")
    if doc["breaches"]:
        out.append("GATE: UTILIZATION DEGRADED")
        for b in doc["breaches"]:
            out.append(f"  {b}")
    else:
        out.append("GATE: ok (device-busy fraction at or above floor)")
    return "\n".join(out)


def _main_util(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report util",
        description="Pipeline-utilization report for one run dir "
        "(flight.json from sbr_tpu_torch.obs.flight): device-busy fraction, "
        "host-gap attribution, queue depth, batch occupancy; exit 1 when "
        "device-busy is under the floor over a measured window, 3 when "
        "the run recorded no flight data",
    )
    parser.add_argument("run_dir", help="obs run directory of a "
                        "flight-enabled (SBR_FLIGHT=1) engine")
    parser.add_argument(
        "--floor", type=float, default=None,
        help="device-busy floor (default: SBR_FLIGHT_UTIL_FLOOR; "
        "unset = gate disarmed)",
    )
    parser.add_argument(
        "--min-dispatches", type=int, default=None, dest="min_dispatches",
        help="dispatches required before the floor gate arms "
        "(default: SBR_FLIGHT_MIN_DISPATCHES or 3)",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = util_doc(args.run_dir, floor=args.floor,
                         min_disp=args.min_dispatches)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_util(doc))
    return code


def _fmt_val_ms(v) -> str:
    return "-" if v is None else f"{v:.2f} ms"



# ---------------------------------------------------------------------------
# Distributed-trace reports (`trace` / `slo` subcommands)
# ---------------------------------------------------------------------------

#: Span names that root a trace in some process (used by `slo` to pick the
#: end-to-end measurement when the cross-process root is ambiguous).
_TRACE_ROOT_NAMES = ("router.request", "worker.request", "loadgen.query")


def _load_fleet_spans(run_dirs) -> tuple:
    """Spans from N run dirs, each tagged with its source dir.

    Returns ``(spans, bad_lines, per_dir)``; raises ``NotADirectoryError``
    for a missing dir (the exit-2 contract every run-dir subcommand keeps).
    """
    from sbr_tpu_torch.obs import trace as qtrace

    spans, bad, per_dir = [], 0, []
    for d in run_dirs:
        if not Path(d).is_dir():
            raise NotADirectoryError(str(d))
        got, b = qtrace.load_spans(d)
        for s in got:
            s["_dir"] = str(d)
        spans.extend(got)
        bad += b
        per_dir.append({"dir": str(d), "spans": len(got), "bad_span_lines": b})
    return spans, bad, per_dir


def _span_attrs(span: dict) -> dict:
    skip = {"trace", "span", "parent", "name", "svc", "ts", "dur_ms", "_dir"}
    return {k: v for k, v in span.items() if k not in skip}


def _join_trace(spans: list) -> dict:
    """Join one trace's spans into a tree; returns the join verdict.

    - root: the unique parentless span (earliest by ts when several claim
      it — a worker-side exemplar whose router half was head-dropped).
    - orphans: spans whose parent id exists nowhere in the trace AND is not
      the root's own remote parent (which legitimately lives upstream).
    - coverage: union of non-root span intervals clipped to the root's
      interval, over the root's duration — "how much of the end-to-end
      latency the waterfall explains".
    """
    ids = {s["span"] for s in spans}
    roots = [s for s in spans if not s.get("parent")]
    root = min(roots, key=lambda s: s.get("ts", 0.0)) if roots else None
    orphans = [
        s for s in spans
        if s.get("parent") and s["parent"] not in ids and s is not root
    ]
    coverage = None
    if root is not None and root.get("dur_ms"):
        r0 = root.get("ts", 0.0)
        r1 = r0 + root["dur_ms"] / 1e3
        ivals = []
        for s in spans:
            if s is root:
                continue
            a = max(s.get("ts", 0.0), r0)
            b = min(s.get("ts", 0.0) + s.get("dur_ms", 0.0) / 1e3, r1)
            if b > a:
                ivals.append((a, b))
        ivals.sort()
        covered, cur_a, cur_b = 0.0, None, None
        for a, b in ivals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    covered += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            covered += cur_b - cur_a
        coverage = round(covered / max(r1 - r0, 1e-12), 4)
    return {
        "root": root,
        "orphans": orphans,
        "rootless": root is None,
        "coverage": coverage,
        "exemplar": any(s.get("exemplar") for s in spans),
    }


def _waterfall_rows(spans: list, root: dict) -> list:
    """Depth-first waterfall rows (offset from the root's start)."""
    children: dict = {}
    for s in spans:
        children.setdefault(s.get("parent"), []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("ts", 0.0))
    r0 = root.get("ts", 0.0)
    rows, seen = [], set()

    def walk(span, depth):
        if id(span) in seen:  # defensive: a span cycle must not hang report
            return
        seen.add(id(span))
        rows.append({
            "name": span.get("name", "?"),
            "svc": span.get("svc", "?"),
            "offset_ms": round((span.get("ts", 0.0) - r0) * 1e3, 3),
            "dur_ms": span.get("dur_ms"),
            "depth": depth,
            "attrs": _span_attrs(span),
        })
        for kid in children.get(span["span"], []):
            walk(kid, depth + 1)

    walk(root, 0)
    # Joinable-but-detached spans (orphans) still show up, flattened at the
    # end, so the waterfall never silently hides data.
    for s in spans:
        if id(s) not in seen:
            rows.append({
                "name": s.get("name", "?"), "svc": s.get("svc", "?"),
                "offset_ms": round((s.get("ts", 0.0) - r0) * 1e3, 3),
                "dur_ms": s.get("dur_ms"), "depth": 1,
                "attrs": dict(_span_attrs(s), detached=True),
            })
    return rows


def trace_doc(run_dirs, max_waterfalls: int = 5) -> tuple:
    """Fleet-wide trace join: spans from the router's and every worker's run
    dir, joined by trace id into per-query waterfalls.

    Exit codes: 0 ok; 1 when a hash-sampled (non-exemplar) trace has
    orphaned or rootless spans — the join gate; 2 bad dir; 3 no spans.
    Exemplar-only traces may legitimately miss their upstream half (the
    other process head-dropped the trace), so they never trip the gate.
    """
    try:
        spans, bad, per_dir = _load_fleet_spans(run_dirs)
    except NotADirectoryError as err:
        return {"error": f"not a run directory: {err}", "exit": 2}, 2
    if not spans:
        return {
            "error": "no trace spans recorded (is SBR_TRACE_SAMPLE set?)",
            "dirs": per_dir, "bad_span_lines": bad, "exit": 3,
        }, 3

    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)

    traces, bad_joins = [], []
    for tid, group in sorted(by_trace.items()):
        verdict = _join_trace(group)
        root = verdict["root"]
        has_failover = any(
            s.get("name") == "router.forward" and s.get("outcome") == "error"
            for s in group
        )
        has_hedge = any(s.get("role") == "hedge" for s in group)
        entry = {
            "trace": tid,
            "spans": len(group),
            "services": sorted({s.get("svc", "?") for s in group}),
            "root": root.get("name") if root else None,
            "dur_ms": root.get("dur_ms") if root else None,
            "coverage": verdict["coverage"],
            "orphans": len(verdict["orphans"]),
            "rootless": verdict["rootless"],
            "exemplar": verdict["exemplar"],
            "failover": has_failover,
            "hedged": has_hedge,
        }
        traces.append(entry)
        if (verdict["orphans"] or verdict["rootless"]) and not verdict["exemplar"]:
            bad_joins.append(tid)

    # Waterfalls for the most interesting traces: every failover/hedge/
    # exemplar first, then the slowest — capped so --json stays bounded.
    def interest(e):
        return (e["failover"] or e["hedged"] or e["exemplar"],
                e["dur_ms"] or 0.0)

    picked = sorted(traces, key=interest, reverse=True)[:max_waterfalls]
    waterfalls = []
    for e in picked:
        group = by_trace[e["trace"]]
        root = _join_trace(group)["root"]
        if root is None:
            continue
        waterfalls.append({
            "trace": e["trace"], "dur_ms": root.get("dur_ms"),
            "coverage": e["coverage"],
            "rows": _waterfall_rows(group, root),
        })

    coverages = [e["coverage"] for e in traces if e["coverage"] is not None]
    # Duration-weighted coverage: share of TOTAL end-to-end latency that
    # the joined span trees explain.  Per-query coverage is noisy for
    # millisecond requests (fixed parse/respond slices loom large); the
    # weighted figure is the fleet-level acceptance number.
    wpairs = [
        (e["coverage"], e["dur_ms"])
        for e in traces
        if e["coverage"] is not None and e["dur_ms"]
    ]
    wtotal = sum(d for _, d in wpairs)
    coverage_weighted = (
        round(sum(c * d for c, d in wpairs) / wtotal, 4) if wtotal else None
    )
    code = 1 if bad_joins else 0
    doc = {
        "dirs": per_dir,
        "spans": len(spans),
        "bad_span_lines": bad,
        "traces": len(traces),
        "joined": len(traces) - len(bad_joins),
        "unjoined_traces": bad_joins,
        "exemplar_traces": sum(1 for e in traces if e["exemplar"]),
        "failover_traces": sum(1 for e in traces if e["failover"]),
        "hedged_traces": sum(1 for e in traces if e["hedged"]),
        "coverage_min": round(min(coverages), 4) if coverages else None,
        "coverage_mean": (
            round(sum(coverages) / len(coverages), 4) if coverages else None
        ),
        "coverage_weighted": coverage_weighted,
        "trace_table": traces,
        "waterfalls": waterfalls,
        "exit": code,
    }
    return doc, code


def render_trace(doc: dict) -> str:
    if "error" in doc:
        return f"TRACE REPORT\n  {doc['error']}"
    lines = ["TRACE REPORT (fleet-wide join)"]
    lines.append(
        f"  dirs {len(doc['dirs'])}  spans {doc['spans']}  "
        f"traces {doc['traces']}  joined {doc['joined']}  "
        f"bad span lines {doc['bad_span_lines']}"
    )
    lines.append(
        f"  failover {doc['failover_traces']}  hedged {doc['hedged_traces']}  "
        f"exemplars {doc['exemplar_traces']}  "
        f"coverage min {doc['coverage_min']} mean {doc['coverage_mean']} "
        f"weighted {doc['coverage_weighted']}"
    )
    if doc["unjoined_traces"]:
        lines.append(
            "  UNJOINED (orphaned/rootless sampled traces): "
            + ", ".join(doc["unjoined_traces"][:10])
        )
    rows = [
        [
            e["trace"][:12], e["root"] or "-", e["spans"],
            _fmt_val_ms(e["dur_ms"]),
            "-" if e["coverage"] is None else f"{e['coverage']:.0%}",
            ",".join(e["services"]),
            "".join([
                "F" if e["failover"] else "",
                "H" if e["hedged"] else "",
                "E" if e["exemplar"] else "",
                "!" if (e["orphans"] or e["rootless"]) else "",
            ]) or "-",
        ]
        for e in doc["trace_table"][:30]
    ]
    lines.append(_table(
        ["trace", "root", "spans", "e2e", "cover", "services", "flags"], rows
    ))
    for wf in doc["waterfalls"]:
        lines.append(
            f"\n  trace {wf['trace']}  {_fmt_val_ms(wf['dur_ms'])}  "
            f"coverage {'-' if wf['coverage'] is None else format(wf['coverage'], '.0%')}"
        )
        for r in wf["rows"]:
            attrs = " ".join(f"{k}={v}" for k, v in r["attrs"].items())
            pad = "  " * r["depth"]
            lines.append(
                f"    {r['offset_ms']:>9.2f}ms {pad}{r['name']} "
                f"[{r['svc']}] {_fmt_val_ms(r['dur_ms'])}"
                + (f"  {attrs}" if attrs else "")
            )
    verdict = "OK" if doc["exit"] == 0 else "JOIN GATE FAILED"
    lines.append(f"\n  {verdict} (exit {doc['exit']})")
    return "\n".join(lines)


def _main_trace(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report trace",
        description="Join trace spans across a router's and its workers' run "
        "dirs into per-query waterfalls; exit 1 when a sampled trace has "
        "orphaned/unjoinable spans, 2 on a bad dir, 3 when no spans exist",
    )
    parser.add_argument("run_dirs", nargs="+",
                        help="run directories (router + every worker)")
    parser.add_argument("--max-waterfalls", type=int, default=5,
                        dest="max_waterfalls",
                        help="waterfall trees to include (default 5)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = trace_doc(args.run_dirs, args.max_waterfalls)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_trace(doc))
    return code


def _dir_slo_ms(run_dir) -> tuple:
    """A run dir's resolved SLO: ``live.json`` ``slo.slo_ms`` (the worker
    wrote its own resolved value there), falling back to the manifest's
    copy; ``(slo_ms, found_live_doc)``."""
    for name in ("live.json", "fleet.json"):
        p = Path(run_dir) / name
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        slo = ((doc.get("slo") or {}).get("slo_ms")
               if isinstance(doc, dict) else None)
        return slo, True
    return None, False


def slo_doc(run_dirs, breach_limit: int = 10) -> tuple:
    """Fleet-wide SLO observatory: per-layer latency breakdowns from trace
    spans, per-dir resolved SLOs, breach exemplar tables, and hedge/failover
    causality for the breached tail.

    Exit codes: 0 ok; 1 when any end-to-end trace breaches its run dir's
    resolved SLO (or carries an ``exemplar`` mark — the writer's own breach
    verdict); 2 bad dir; 3 when neither spans nor any live/fleet snapshot
    exist to judge.
    """
    from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LogHistogram

    try:
        spans, bad, per_dir = _load_fleet_spans(run_dirs)
    except NotADirectoryError as err:
        return {"error": f"not a run directory: {err}", "exit": 2}, 2

    any_live = False
    for entry in per_dir:
        slo, found = _dir_slo_ms(entry["dir"])
        entry["slo_ms"] = slo
        any_live = any_live or found
    if not spans:
        code = 3 if not any_live else 0
        return {
            "error": "no trace spans recorded (is SBR_TRACE_SAMPLE set?)",
            "dirs": per_dir, "bad_span_lines": bad, "exit": code,
        }, code

    slo_by_dir = {e["dir"]: e["slo_ms"] for e in per_dir}

    # Per-layer duration histograms over every committed span.
    layers: dict = {}
    for s in spans:
        name = s.get("name", "?")
        h = layers.get(name)
        if h is None:
            h = layers[name] = LogHistogram(DEFAULT_LATENCY_BOUNDS_MS)
        h.record(s.get("dur_ms") or 0.0)
    layer_table = {name: h.summary() for name, h in sorted(layers.items())}

    # End-to-end verdict per trace: the root span's duration vs the SLO of
    # the dir that recorded it (each worker may serve under its own SLO).
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    breaches = []
    for tid, group in sorted(by_trace.items()):
        root = _join_trace(group)["root"]
        if root is None:
            continue
        slo = slo_by_dir.get(root.get("_dir"))
        dur = root.get("dur_ms") or 0.0
        marked = any(s.get("exemplar") for s in group)
        if marked or (slo is not None and dur > slo):
            by_layer: dict = {}
            for s in group:
                if s is not root:
                    by_layer[s["name"]] = round(
                        by_layer.get(s["name"], 0.0) + (s.get("dur_ms") or 0.0), 3
                    )
            slowest = max(by_layer.items(), key=lambda kv: kv[1])[0] \
                if by_layer else None
            breaches.append({
                "trace": tid, "dur_ms": dur, "slo_ms": slo,
                "root": root.get("name"), "exemplar": marked,
                "hedged": any(s.get("role") == "hedge" for s in group),
                "failover": any(
                    s.get("name") == "router.forward"
                    and s.get("outcome") == "error"
                    for s in group
                ),
                "degraded": any(s.get("degraded") for s in group),
                "slowest_layer": slowest,
                "by_layer_ms": by_layer,
            })
    breaches.sort(key=lambda b: b["dur_ms"], reverse=True)

    causality = {
        "breaches": len(breaches),
        "hedged": sum(1 for b in breaches if b["hedged"]),
        "failover": sum(1 for b in breaches if b["failover"]),
        "degraded": sum(1 for b in breaches if b["degraded"]),
    }
    code = 1 if breaches else 0
    doc = {
        "dirs": per_dir,
        "spans": len(spans),
        "bad_span_lines": bad,
        "traces": len(by_trace),
        "layers": layer_table,
        "breach_causality": causality,
        "breach_exemplars": breaches[:breach_limit],
        "exit": code,
    }
    return doc, code


def render_slo(doc: dict) -> str:
    if "error" in doc:
        return f"SLO REPORT\n  {doc['error']}"
    lines = ["SLO REPORT (per-layer latency observatory)"]
    for e in doc["dirs"]:
        slo = e.get("slo_ms")
        lines.append(
            f"  {e['dir']}: {e['spans']} span(s), "
            f"slo {'-' if slo is None else f'{slo:g} ms'}"
        )
    rows = [
        [
            name, s["count"], _fmt_val_ms(s.get("p50")),
            _fmt_val_ms(s.get("p95")), _fmt_val_ms(s.get("p99")),
            _fmt_val_ms(s.get("max")),
        ]
        for name, s in doc["layers"].items()
    ]
    lines.append(_table(["layer", "count", "p50", "p95", "p99", "max"], rows))
    c = doc["breach_causality"]
    lines.append(
        f"\n  SLO breaches {c['breaches']}  (hedged {c['hedged']}, "
        f"failover {c['failover']}, degraded {c['degraded']})"
    )
    if doc["breach_exemplars"]:
        rows = [
            [
                b["trace"][:12], _fmt_val_ms(b["dur_ms"]),
                "-" if b["slo_ms"] is None else f"{b['slo_ms']:g}",
                b["slowest_layer"] or "-",
                "".join([
                    "F" if b["failover"] else "",
                    "H" if b["hedged"] else "",
                    "D" if b["degraded"] else "",
                    "E" if b["exemplar"] else "",
                ]) or "-",
            ]
            for b in doc["breach_exemplars"]
        ]
        lines.append(_table(
            ["trace", "e2e", "slo_ms", "slowest layer", "flags"], rows
        ))
    verdict = "OK" if doc["exit"] == 0 else "SLO BREACHED"
    lines.append(f"\n  {verdict} (exit {doc['exit']})")
    return "\n".join(lines)


def _main_slo(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report slo",
        description="Fleet-wide SLO observatory over trace spans: per-layer "
        "latency breakdowns, breach exemplars, hedge/failover causality; "
        "exit 1 on an SLO breach, 2 on a bad dir, 3 with nothing to judge",
    )
    parser.add_argument("run_dirs", nargs="+",
                        help="run directories (router + every worker)")
    parser.add_argument("--breach-limit", type=int, default=10,
                        dest="breach_limit",
                        help="breach exemplar rows to include (default 10)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = slo_doc(args.run_dirs, args.breach_limit)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_slo(doc))
    return code


# ---------------------------------------------------------------------------
# Meta-gate (`summary` subcommand)
# ---------------------------------------------------------------------------

#: The subgates `report summary` folds, in display order. Each entry maps
#: the gate name to a callable of one run_dir returning (doc, code) —
#: kept lazy (lambdas) so a crashing gate is contained per-row.
_SUMMARY_GATES = (
    ("health", lambda d: health_json(load_run(d))),
    ("serve", lambda d: serve_doc(d)),
    ("fleet", lambda d: fleet_doc(d)),
    ("trace", lambda d: trace_doc([d])),
    ("slo", lambda d: slo_doc([d])),
    ("audit", lambda d: audit_doc(d)),
    ("demand", lambda d: demand_doc([d])),
    ("prewarm", lambda d: prewarm_doc(d)),
    ("util", lambda d: util_doc(d)),
)


def _gate_reason(doc, code: int) -> str:
    """One-line reason for a subgate row: 'ok' on 0, else the first
    breach/error the gate reported (truncated for the table)."""
    if code == 0:
        return "ok"
    reason = None
    if isinstance(doc, dict):
        for key in ("breaches", "reasons"):
            vals = doc.get(key)
            if vals:
                reason = str(vals[0])
                break
        if reason is None and doc.get("error"):
            reason = str(doc["error"])
        if reason is None and code == 1 and doc.get("total_divergent"):
            reason = f"{doc['total_divergent']} divergent cell(s)"
    if reason is None:
        reason = f"exit {code}"
    return reason if len(reason) <= 90 else reason[:87] + "..."


def summary_doc(run_dir) -> tuple:
    """The meta-gate: every observatory gate —
    health, serve, fleet, trace, slo, audit, demand, prewarm, util — run
    against ONE run dir, folded into a single table. Returns
    (doc, exit_code) where the merged exit is the MAX of the subgate
    exits (so a single breach (1) outranks ok (0), and a bad dir (2) /
    no-data (3) surfaces as itself — observatories that simply were not
    enabled show their honest 3 rather than silently passing). A subgate
    that CRASHES reads as exit 2 with the error as its reason: a broken
    gate must not read as clean."""
    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        return {"dir": str(run_dir), "error": "not a directory", "exit": 2}, 2
    gates = {}
    for name, fn in _SUMMARY_GATES:
        try:
            doc, code = fn(str(run_dir))
        except Exception as err:
            doc, code = {"error": f"{type(err).__name__}: {err}"}, 2
        gates[name] = {"exit": code, "reason": _gate_reason(doc, code)}
    merged = max(g["exit"] for g in gates.values())
    doc = {
        "dir": str(run_dir),
        "gates": gates,
        "exit": merged,
    }
    return doc, merged


def render_summary(doc: dict) -> str:
    """Human-readable meta-gate table; same exit contract as `summary_doc`."""
    out = [f"run      {doc['dir']}"]
    if "gates" not in doc:
        out.append(doc.get("error", "no data"))
        return "\n".join(out)
    out += ["", "GATES"]
    out.append(_table(
        ["gate", "exit", "reason"],
        [[name, g["exit"], g["reason"]]
         for name, g in doc["gates"].items()],
    ))
    out.append("")
    worst = doc["exit"]
    if worst == 0:
        out.append("GATE: ok (every subgate passed)")
    else:
        failing = [n for n, g in doc["gates"].items() if g["exit"] == worst]
        out.append(
            f"GATE: exit {worst} (worst subgate(s): {', '.join(failing)})"
        )
    return "\n".join(out)


def _main_summary(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report summary",
        description="Meta-gate: run every observatory gate (health, serve, "
        "fleet, trace, slo, audit, demand, prewarm, util) against one run "
        "dir and fold them into a single table; the merged exit code is "
        "the max of the subgate exits",
    )
    parser.add_argument("run_dir", help="obs run directory")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)
    doc, code = summary_doc(args.run_dir)
    if args.json:
        print(json.dumps(doc, default=str))
        return code
    print(render_summary(doc))
    return code


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Subcommand dispatch; a bare run-dir path keeps the render/diff
    # interface (a directory named "health"/"gc" can be reached as ./health).
    subcommands = {
        "health": _main_health,
        "resilience": _main_resilience,
        "memory": _main_memory,
        "elastic": _main_elastic,
        "serve": _main_serve,
        "fleet": _main_fleet,
        "prewarm": _main_prewarm,
        "summary": _main_summary,
        "grad": _main_grad,
        "infomodel": _main_infomodel,
        "demand": _main_demand,
        "audit": _main_audit,
        "util": _main_util,
        "trace": _main_trace,
        "slo": _main_slo,
        "gc": _main_gc,
    }
    if argv and argv[0] in subcommands:
        return subcommands[argv[0]](argv[1:])
    if argv and argv[0] == "trend":
        from sbr_tpu_torch.obs.history import main_trend

        return main_trend(argv[1:])

    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report",
        description="Render an obs run directory, diff two runs, or run the "
        "'health' / 'resilience' / 'memory' / 'elastic' / 'serve' / 'fleet' / "
        "'audit' / 'demand' / 'prewarm' / 'util' / 'summary' / 'grad' / "
        "'infomodel' / 'trace' / 'slo' / 'trend' / 'gc' subcommands",
    )
    parser.add_argument("run_dir", help="run directory (contains manifest.json)")
    parser.add_argument("other_dir", nargs="?", help="second run directory to diff against")
    parser.add_argument("--events", type=int, default=0, metavar="N", help="also print the last N raw events")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    try:
        run = load_run(args.run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    if args.other_dir:
        try:
            other = load_run(args.other_dir)
        except (FileNotFoundError, json.JSONDecodeError) as err:
            print(f"error: {err}", file=sys.stderr)
            return 1
        print(json.dumps(diff_json(run, other), default=str) if args.json else diff(run, other))
    else:
        if args.json:
            print(json.dumps(render_json(run), default=str))
            return 0
        print(render(run))
        if args.events:
            print(f"\nLAST {args.events} EVENTS")
            for ev in run["events"][-args.events :]:
                print(f"  {ev.get('mono', 0):>12.6f}  {ev.get('kind', '?'):<12} "
                      + " ".join(f"{k}={v}" for k, v in ev.items() if k not in ("mono", "ts", "kind")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
