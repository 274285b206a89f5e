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
    python -m sbr_tpu_torch.obs.report trend [HISTORY] [--check]
    python -m sbr_tpu_torch.obs.report gc [ROOT] --keep N [--tile-cache DIR]

Every subcommand takes ``--json`` and then prints one JSON document; its
fields, verdicts and exit codes are the reference's, so the same gates read
either package's runs. ``fleet``, ``audit``, ``demand``, ``prewarm``,
``util``, ``trace``, ``slo`` and ``summary``, and gc's ``--trace-keep``,
``--audit-keep``, ``--demand-keep``, ``--prewarm-keep`` and
``--flight-keep``, read modules not ported yet: each exits 2 naming its
ROADMAP item.

Reads only ``manifest.json``, ``events.jsonl`` and ``live.json`` (or the
history JSONL), tolerating torn event lines. Nothing here imports
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
    for dest in _GC_ITEMS:
        parser.add_argument("--" + dest.replace("_", "-"), type=int, default=None, metavar="N",
                            dest=dest, help="not ported yet: exits 2")
    args = parser.parse_args(argv)
    for dest, item in _GC_ITEMS.items():
        if getattr(args, dest) is not None:
            return _not_ported("gc --" + dest.replace("_", "-"), item)
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
    return 0


# ---------------------------------------------------------------------------
# Subcommands whose modules are not ported yet
# ---------------------------------------------------------------------------

# The ROADMAP item (queue 1.A) that brings each subcommand's module.
_NOT_PORTED = {
    "fleet": "1.A 10",  # serve/router.py writes fleet.json
    "audit": "1.A 9d",  # obs/audit.py
    "demand": "1.A 9c",  # obs/demand.py
    "prewarm": "1.A 10",  # serve/prewarm.py
    "util": "1.A 9c",  # obs/flight.py
    "trace": "1.A 9c",  # obs/trace.py
    "slo": "1.A 9c",  # obs/trace.py spans
    "summary": "1.A 10",  # folds every gate above
}
_GC_ITEMS = {
    "trace_keep": "1.A 9c",
    "audit_keep": "1.A 9d",
    "demand_keep": "1.A 9c",
    "prewarm_keep": "1.A 10",
    "flight_keep": "1.A 9c",
}


def _not_ported(what: str, item: str) -> int:
    print(f"report {what} is not ported to sbr_tpu_torch yet (ROADMAP item {item})",
          file=sys.stderr)
    return 2


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
        "grad": _main_grad,
        "infomodel": _main_infomodel,
        "gc": _main_gc,
    }
    if argv and argv[0] in subcommands:
        return subcommands[argv[0]](argv[1:])
    if argv and argv[0] in _NOT_PORTED:
        return _not_ported(argv[0], _NOT_PORTED[argv[0]])
    if argv and argv[0] == "trend":
        from sbr_tpu_torch.obs.history import main_trend

        return main_trend(argv[1:])

    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.report",
        description="Render an obs run directory, diff two runs, or run the "
        "'health' / 'resilience' / 'memory' / 'elastic' / 'serve' / 'grad' / "
        "'infomodel' / 'trend' / 'gc' subcommands",
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
