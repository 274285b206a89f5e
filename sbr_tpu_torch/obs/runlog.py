"""Structured run telemetry: `RunContext` event logs, per-stage spans and
program-call attribution: the port of ``sbr_tpu.obs.runlog``.

- A **RunContext** owns a per-run directory holding ``events.jsonl`` (one
  structured event per line: stage start/end, program calls, status and
  health censuses, device and memory snapshots) and ``manifest.json``, a
  machine-readable roll-up written at start (status "running") and
  rewritten atomically at finalize, so an interrupted run still leaves a
  parseable manifest. Event kinds, fields and manifest keys are the
  reference's.
- **Spans** (`obs.span`) time named stages at the host boundary, with an
  honest device fence (`obs.timing.fence`) on the tensors handed to
  ``.sync``.
- **jit_call** runs a program (a port function standing for one of the
  reference's jitted programs), fences its outputs and logs its execute
  time, with ``cache`` "miss" on the first abstract signature (shapes,
  dtypes, devices) within the run and "hit" after. ``trace_s`` is 0 and
  ``compile_s`` is the time spent capturing CUDA graphs during the call (0
  when none is captured): PyTorch compiles nothing else on this path.

**Where instrumentation is silent.** The reference's sites are no-ops
inside traced code. The port's counterparts of traced code are the body of
a `jit_call` program (and any `program()` block: the batched cell solves
that the reference jits) and a CUDA-graph capture, where a fence or a host
read would break the capture (`torch.cuda.is_current_stream_capturing`).
In those regions every module-level helper returns at once. (The
reference's spans inside a program fire once, while JAX first traces it in
a process; its steady state has none, and the port reproduces that steady
state.)

Zero-overhead contract when disabled: every module-level helper first
checks for an active run (one global read) and returns immediately.
Nothing here changes a computation, so telemetry on or off gives the same
bits.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from sbr_tpu_torch.obs.metrics import metrics

SCHEMA = "sbr-obs/1"

# Active run stack: module-level so instrumentation sites need one global
# read on the disabled path. The env var SBR_OBS=1 auto-starts a run lazily
# on the first instrumented call (dir from SBR_OBS_DIR, default obs_runs/).
_STACK: list = []
_ENV_CHECKED = False

# Innermost-open-span names.
_SPAN_NAMES: list = []

# Depth of program regions per thread (a jit_call body, a `program()`
# block): instrumentation inside is silent, as inside a traced program.
_LOCAL = threading.local()


def active_run():
    """The active RunContext WITHOUT the SBR_OBS auto-start side effect."""
    return _STACK[-1] if _STACK else None


def active_span() -> Optional[str]:
    """Name of the innermost open span, or None outside any span."""
    return _SPAN_NAMES[-1] if _SPAN_NAMES else None


class _Program:
    """Context manager marking a program region (see the module
    docstring); nestable, per thread."""

    __slots__ = ()

    def __enter__(self):
        _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.depth -= 1


_PROGRAM = _Program()


def program() -> _Program:
    """A program region: instrumentation inside it is silent, as it is
    inside the reference's traced programs. Costs two attribute updates."""
    return _PROGRAM


def _trace_clean() -> bool:
    """True when host instrumentation is allowed: outside every program
    region and not inside a CUDA-graph capture."""
    if getattr(_LOCAL, "depth", 0):
        return False
    try:
        import torch

        return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())
    except Exception:
        return True


def _json_default(obj):
    """Best-effort JSON coercion for numpy and torch scalars and arrays."""
    try:
        import numpy as np

        if isinstance(obj, np.generic):
            return obj.item()
    except Exception:
        pass
    if hasattr(obj, "tolist"):  # numpy arrays and torch tensors
        try:
            return obj.tolist()
        except Exception:
            pass
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return repr(obj)


class _Span:
    """Live span handle: accumulate tensors to fence at exit via `.sync()`."""

    __slots__ = ("_arrays",)

    def __init__(self) -> None:
        self._arrays: list = []

    def sync(self, *arrays) -> None:
        """Register tensors whose producing work must finish before the
        span's end time is taken (the honest-fence contract)."""
        self._arrays.extend(arrays)


class _NullSpan:
    """Disabled-path span: every method is a no-op."""

    __slots__ = ()

    def sync(self, *arrays) -> None:
        pass


_NULL_SPAN = _NullSpan()


class RunContext:
    """One telemetry run: a directory with `events.jsonl` + `manifest.json`.

    Construction touches only the filesystem, never the card; device info
    is captured lazily on the first instrumented call that already did
    device work.
    """

    def __init__(
        self,
        run_dir: Optional[str] = None,
        label: str = "run",
        root: Optional[str] = None,
        auto_prune_keep: Optional[int] = None,
    ) -> None:
        if run_dir is None:
            root = Path(root or os.environ.get("SBR_OBS_DIR", "obs_runs"))
            stamp = time.strftime("%Y%m%dT%H%M%S")
            base = root / f"{label}_{stamp}_p{os.getpid()}"
            # The stamp has second granularity: two same-label runs within
            # one second must not share a directory (interleaved events,
            # clobbered manifest) — claim a unique dir with exist_ok=False.
            run_dir, i = base, 0
            while True:
                try:
                    run_dir.mkdir(parents=True, exist_ok=False)
                    break
                except FileExistsError:
                    i += 1
                    run_dir = Path(f"{base}_{i}")
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.label = label
        self.t_wall0 = time.time()
        self.t_mono0 = time.monotonic()
        self._fh = open(self.run_dir / "events.jsonl", "a")
        self._n_events = 0
        self._closed = False
        # aggregates folded into the manifest
        self.stages: dict = {}  # name -> {count, total_s}
        self.jit: dict = {"calls": 0, "cache_hits": 0, "trace_s": 0.0, "compile_s": 0.0, "execute_s": 0.0}
        self.mem_peak_live = 0  # peak live-tensor bytes
        self.mem_peak_device = 0  # peak allocator peak_bytes_in_use (if exposed)
        # Memory observatory (obs.mem): per-span/per-tile attribution,
        # preflight verdicts, and the capacity-planner decision.
        self.mem_peak_span: Optional[str] = None  # span holding the peak snapshot
        self.mem_capacity: Optional[int] = None  # the card's memory, if in use
        self.mem_programs: dict = {}  # program -> footprint (arg/out/temp bytes)
        self.mem_tiles: dict = {}  # tile_id -> peak bytes
        self.mem_plan: Optional[dict] = None  # capacity-planner decision record
        self.mem_preflights: list = []  # preflight verdict records
        self._mem_last: dict = {}  # previous snapshot, for per-event deltas
        self.device: Optional[dict] = None
        self.health: dict = {}  # stage -> folded numerical-health roll-up
        # Resilience roll-ups (resilience): injected-fault firings,
        # retry-engine attempt outcomes, and self-healing repair actions.
        self.resilience: dict = {"faults": {}, "retries": {}, "repairs": {}}
        # Elastic-scheduler roll-ups (resilience.elastic): scheduler
        # actions (join/claim/reclaim/done/leave/plan), cross-run tile
        # cache outcomes (hit/miss/store/quarantine), and tiles by source.
        self.elastic: dict = {"scheduler": {}, "cache": {}, "tiles": {}}
        # Serving-fleet roll-up (serve.fleet/router): per-action
        # counts of fleet events (route failovers, hedges, sheds, degraded
        # ladder answers, breaker transitions, worker joins/losses) — what
        # `report fleet` gates on.
        self.fleet: dict = {}
        # Information-model roll-up (infomodels): per-action counts
        # of infomodel events (rewire epochs, belief censuses, fixed-point
        # solves, closure comparisons, population queries) plus the
        # nonconverged/breach tallies `report infomodel` gates on.
        self.infomodel: dict = {}
        # Numerics-audit roll-up (obs.audit): per-action counts of
        # audit events plus the drift/pass probe tallies and last cycle —
        # what `report audit` gates on.
        self.audit: dict = {}
        # Workload-demand roll-up (obs.demand): per-action counts
        # of demand lifecycle events (snapshot rotations, advisor-plan
        # writes) plus the last plan fingerprint. Deliberately NOT
        # per-query — the demand tracker aggregates in memory and only
        # its artifact writes land here.
        self.demand: dict = {}
        # Prefetch-controller roll-up (serve.prewarm): per-action
        # event counts, abandoned-tile counts by reason, and the last plan
        # fingerprint acted on — what `report prewarm` gates.
        self.prewarm: dict = {}
        # Flight-recorder roll-up (obs.flight): per-action counts
        # of flight lifecycle events (snapshot rotations, the final write)
        # plus the headline utilization fractions of the final snapshot —
        # what `report util` falls back on for a torn flight.json.
        self.flight: dict = {}
        self._seen_sigs: set = set()  # (program, abstract signature) seen by jit_call
        # Performance observatory (obs.prof): per-run retrace accounting and
        # profiler-capture summaries; the xla block stays zero with
        # "monitoring": false (no compile listeners on this path).
        from sbr_tpu_torch.obs import prof

        self.xla: dict = {
            "compiles": 0,
            "jaxpr_trace_s": 0.0,
            "mlir_lowering_s": 0.0,
            "backend_compile_s": 0.0,
            "by_span": {},
        }
        self._trace_counts0 = prof.trace_counts()
        self.profiles: list = []
        # Retention: prune sibling run dirs at finalize when a keep budget
        # is configured (SBR_OBS_KEEP env, or explicit ctor argument — the
        # bench harness and the SBR_OBS=1 auto-start path set one).
        if auto_prune_keep is None:
            env_keep = os.environ.get("SBR_OBS_KEEP", "").strip()
            auto_prune_keep = int(env_keep) if env_keep else None
        self._auto_prune_keep = auto_prune_keep
        self._metrics_was_on = metrics().enabled
        if not self._metrics_was_on:
            # This run owns the registry: start it from zero so the manifest
            # carries per-run metrics, not process-lifetime accumulation.
            metrics().reset()
        metrics().enable()
        self._write_manifest(status="running")
        self.event("run_start", label=label, argv=list(sys.argv), pid=os.getpid())

    # -- events -------------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one structured event line. `mono` is seconds since run
        start on the monotonic clock (orders events); `ts` is wall time."""
        if self._closed:
            return
        rec = {
            "mono": round(time.monotonic() - self.t_mono0, 9),
            "ts": round(time.time(), 6),
            "kind": kind,
        }
        rec.update(fields)
        self._fh.write(json.dumps(rec, default=_json_default) + "\n")
        self._fh.flush()
        self._n_events += 1

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Stage span: emits stage_start/stage_end events and accumulates
        per-stage totals. Yields a handle whose `.sync(*arrays)` registers
        arrays to fence before the end timestamp (device-honest timing)."""
        from sbr_tpu_torch.obs import prof

        self.event("stage_start", stage=name, **attrs)
        handle = _Span()
        _SPAN_NAMES.append(name)
        t0 = time.monotonic()
        err = None
        try:
            # With SBR_OBS_PROFILE=1 the stage also lands as a
            # TraceAnnotation on the xplane timeline; otherwise free.
            with prof.annotate(name):
                yield handle
        except BaseException as e:
            err = e
            raise
        finally:
            if _SPAN_NAMES and _SPAN_NAMES[-1] == name:
                _SPAN_NAMES.pop()
            if handle._arrays:
                try:
                    from sbr_tpu_torch.obs.timing import fence

                    fence(*handle._arrays)
                except Exception:
                    pass  # fencing must never sink the instrumented call
            dur = time.monotonic() - t0
            agg = self.stages.setdefault(name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += dur
            end_fields = dict(stage=name, dur_s=round(dur, 6), **attrs)
            if err is not None:
                end_fields["error"] = repr(err)
            self.event("stage_end", **end_fields)
            self._memory_event(name, handle._arrays)

    # -- program-call attribution -------------------------------------------
    def jit_call(self, name: str, fn, *args):
        """Call program ``fn(*args)``, fence its outputs and log the call:
        ``cache`` "miss" on the first abstract signature (shapes, dtypes,
        devices) of ``name`` in this run and "hit" after, ``execute_s``
        fenced, ``compile_s`` the CUDA-graph capture time inside the call.
        Instrumentation inside ``fn`` is silent (a program region)."""
        from sbr_tpu_torch.obs import prof
        from sbr_tpu_torch.obs.timing import fence, tensor_leaves

        key = (name, prof.abstract_signature(*args))
        cache = "hit" if key in self._seen_sigs else "miss"
        self._seen_sigs.add(key)
        captured0 = prof.capture_totals()["seconds"]
        t0 = time.monotonic()
        with _PROGRAM:
            out = fn(*args)
        leaves = tensor_leaves(out)
        try:
            fence(*leaves)
        except Exception:
            pass
        wall = time.monotonic() - t0
        compile_s = prof.capture_totals()["seconds"] - captured0
        execute_s = max(wall - compile_s, 0.0)
        self.jit["calls"] += 1
        self.jit["cache_hits"] += int(cache == "hit")
        self.jit["compile_s"] += compile_s
        self.jit["execute_s"] += execute_s
        self.event(
            "jit_call",
            name=name,
            cache=cache,
            trace_s=0.0,
            compile_s=round(compile_s, 6),
            execute_s=round(execute_s, 6),
        )
        self._device_event(leaves)
        self._memory_event(name)
        return out

    # -- device / memory snapshots ------------------------------------------
    def _device_event(self, tensors=()) -> None:
        """Record device info once: the device of the first tensor in
        ``tensors`` (the card when none is given and the card is in use,
        else the CPU), with the torch and CUDA versions."""
        if self.device is not None:
            return
        try:
            import torch

            from sbr_tpu_torch.obs.timing import tensor_leaves

            leaves = tensor_leaves(*tensors)
            if leaves:
                dev = leaves[0].device
            elif torch.cuda.is_available() and torch.cuda.is_initialized():
                dev = torch.device("cuda", torch.cuda.current_device())
            else:
                dev = torch.device("cpu")
            cuda = dev.type == "cuda"
            self.device = {
                "platform": dev.type,
                "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "device_count": torch.cuda.device_count() if cuda else 1,
                "process_count": 1,
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
            }
            self.event("device", **self.device)
        except Exception:
            pass

    def _memory_event(self, where: str, tensors=()) -> None:
        """Attribution snapshot (obs.mem): live-tensor bytes (gated by
        SBR_OBS_MEM_LIVE) plus the card's allocator figures when the card is
        in use, emitted as a ``mem`` event with deltas vs the previous
        snapshot and folded into the peak/peak-span roll-up."""
        try:
            # Only span ends and program calls land here, both after device
            # work, so recording the device info initializes nothing.
            self._device_event(tensors)
            from sbr_tpu_torch.obs import mem

            snap = mem.snapshot()
            if not snap:
                return
            ev = {"where": where, "span": active_span(), **snap}
            for k in ("live_buffer_bytes", "bytes_in_use"):
                if k in snap and k in self._mem_last:
                    ev["d_" + k] = snap[k] - self._mem_last[k]
            self._mem_last.update(snap)
            if "bytes_limit" in snap:
                self.mem_capacity = snap["bytes_limit"]
            live = snap.get("live_buffer_bytes")
            device_now = max(snap.get("peak_bytes_in_use", 0), snap.get("bytes_in_use", 0))
            if live is not None and live > self.mem_peak_live:
                self.mem_peak_live = live
                if not device_now:  # live sum is the only signal (CPU)
                    self.mem_peak_span = where
            if device_now > self.mem_peak_device:
                self.mem_peak_device = device_now
                self.mem_peak_span = where
            self.event("mem", **ev)
        except Exception:
            pass

    def _note_program_mem(self, name: str, info: dict) -> None:
        """Fold one program's footprint into the per-program registry — the
        manifest's top-programs-by-temp-size table reads from here."""
        keys = ("arg_bytes", "out_bytes", "temp_bytes", "code_bytes")
        fp = {k: int(info[k]) for k in keys if k in info}
        if not fp:
            return
        prev = self.mem_programs.get(name)
        if prev is None or fp.get("temp_bytes", 0) >= prev.get("temp_bytes", 0):
            self.mem_programs[name] = fp

    def log_tile_mem(self, tile: str, **snap) -> None:
        """Per-tile peak attribution (the tiled sweep loop calls this after
        each computed tile): one ``mem`` event with a ``tile`` field, folded
        into the manifest's per-tile peak table. The tile's figure is
        ``bytes_in_use`` at snapshot time (taken while the tile's buffers
        are live) — NOT ``peak_bytes_in_use``, which is a process-lifetime
        high-water mark: after one big tile (or a compile spike) it would
        attribute the global peak to every later tile and `report memory`
        would flag them all. The monotone counter is still recorded in the
        event and handled at run level (``peak_span``)."""
        from sbr_tpu_torch.obs import mem

        self.event("mem", where="tile", tile=tile, span=active_span(), **snap)
        self.mem_tiles[tile] = max(mem.tile_peak(snap), self.mem_tiles.get(tile, 0))
        if "bytes_limit" in snap:
            self.mem_capacity = int(snap["bytes_limit"])

    def log_preflight(self, rec: dict) -> None:
        """OOM-preflight verdict (obs.mem.preflight): one ``preflight``
        event + an entry in the manifest's ``memory.preflight`` list."""
        self.event("preflight", **rec)
        self.mem_preflights.append(dict(rec))

    def log_plan(self, rec: dict) -> None:
        """Capacity-planner decision (tile_shape="auto"): one ``plan``
        event; the manifest's ``memory.plan`` block records the last one."""
        self.event("plan", **rec)
        self.mem_plan = dict(rec)

    # -- performance observatory hooks (obs.prof) -----------------------------
    def _note_trace(self, name: str, total: int) -> None:
        """Per-run retrace accounting (obs.prof.note_trace): when the
        within-run trace count for ``name`` exceeds its budget, emit a
        ``retrace`` warning event — the signature of argument shape/dtype
        churn."""
        from sbr_tpu_torch.obs import prof

        count = total - self._trace_counts0.get(name, 0)
        budget = prof.trace_budget(name)
        if count > budget:
            self.event(
                "retrace",
                name=name,
                count=count,
                total=total,
                budget=budget,
                span=active_span(),
                hint="trace count exceeds budget — argument shape/dtype churn?",
            )

    def _retrace_summary(self) -> dict:
        """Per-name trace counts accumulated DURING this run (manifest
        roll-up; over_budget mirrors the retrace warning events)."""
        from sbr_tpu_torch.obs import prof

        out = {}
        for name, total in sorted(prof.trace_counts().items()):
            count = total - self._trace_counts0.get(name, 0)
            if count > 0:
                budget = prof.trace_budget(name)
                out[name] = {
                    "traces": count,
                    "budget": budget,
                    "over_budget": count > budget,
                }
        return out

    # -- summary / finalize ---------------------------------------------------
    def summary(self) -> dict:
        """Machine-readable roll-up (the bench JSON `obs` block)."""
        retraces = self._retrace_summary()
        return {
            "run_dir": str(self.run_dir),
            "device": (self.device or {}).get("device_kind"),
            "platform": (self.device or {}).get("platform"),
            "compile_s": round(self.jit["compile_s"], 4),
            "execute_s": round(self.jit["execute_s"], 4),
            "jit_calls": self.jit["calls"],
            "memory_peak_bytes": self.mem_peak_device or self.mem_peak_live,
            "n_events": self._n_events,
            "xla_compiles": self.xla["compiles"],
            "xla_backend_compile_s": round(self.xla["backend_compile_s"], 4),
            "retraces_over_budget": sum(1 for v in retraces.values() if v["over_budget"]),
        }

    def _xla_manifest(self) -> dict:
        """The reference's compile-attribution block. `monitoring: false`:
        the port has no compile listeners, so the zeroed block reads as
        "couldn't watch", not "nothing compiled"."""
        from sbr_tpu_torch.obs import prof

        return {
            "monitoring": prof.monitoring_available(),
            "compiles": self.xla["compiles"],
            **{
                k: round(self.xla[k], 6)
                for k in ("jaxpr_trace_s", "mlir_lowering_s", "backend_compile_s")
            },
            "by_span": {
                k: {"compiles": v["compiles"], "backend_compile_s": round(v["backend_compile_s"], 6)}
                for k, v in sorted(self.xla["by_span"].items())
            },
        }

    _MANIFEST_TILE_CAP = 512  # largest per-tile table the manifest carries

    def _memory_manifest(self) -> dict:
        """The manifest ``memory`` roll-up: peaks (+ the span holding the
        peak), device capacity, the top-5 programs by temp size, the
        per-tile peak table (size-capped — the event log keeps every tile),
        and the planner/preflight records."""
        from sbr_tpu_torch.obs import mem

        top = sorted(
            self.mem_programs.items(), key=lambda kv: -kv[1].get("temp_bytes", 0)
        )[:5]
        tiles = self.mem_tiles
        truncated = 0
        if len(tiles) > self._MANIFEST_TILE_CAP:
            truncated = len(tiles) - self._MANIFEST_TILE_CAP
            tiles = dict(
                sorted(tiles.items(), key=lambda kv: -kv[1])[: self._MANIFEST_TILE_CAP]
            )
        block = {
            "peak_live_buffer_bytes": self.mem_peak_live,
            "peak_device_bytes": self.mem_peak_device,
            "peak_bytes": self.mem_peak_device or self.mem_peak_live,
            "peak_span": self.mem_peak_span,
            "capacity_bytes": self.mem_capacity,
            "headroom": mem.headroom(),
            "top_programs": [{"name": k, **v} for k, v in top] or None,
            "tiles": tiles or None,
            "plan": self.mem_plan,
            "preflight": self.mem_preflights or None,
        }
        if truncated:
            block["tiles_truncated"] = truncated
        return block

    def _write_manifest(self, status: str) -> None:
        manifest = {
            "schema": SCHEMA,
            "label": self.label,
            "status": status,
            "started_at": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.t_wall0)),
            "duration_s": round(time.monotonic() - self.t_mono0, 6),
            "argv": list(sys.argv),
            "n_events": self._n_events,
            "device": self.device,
            "stages": {
                k: {"count": v["count"], "total_s": round(v["total_s"], 6)}
                for k, v in sorted(self.stages.items())
            },
            "jit": {
                **{k: self.jit[k] for k in ("calls", "cache_hits")},
                **{k: round(self.jit[k], 6) for k in ("trace_s", "compile_s", "execute_s")},
            },
            "memory": self._memory_manifest(),
            "health": self.health or None,
            "resilience": self._resilience_manifest(),
            "elastic": self._elastic_manifest(),
            "fleet": self.fleet or None,
            "infomodel": self.infomodel or None,
            "audit": self.audit or None,
            "demand": self.demand or None,
            "prewarm": self.prewarm or None,
            "flight": self.flight or None,
            "metrics": metrics().summary() if metrics().enabled else None,
            "xla": self._xla_manifest(),
            "retraces": self._retrace_summary() or None,
            "profiles": self.profiles or None,
            "trace": self._trace_manifest(),
        }
        tmp = self.run_dir / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=1, default=_json_default) + "\n")
        os.replace(tmp, self.run_dir / "manifest.json")

    def _trace_manifest(self) -> Optional[dict]:
        """The distributed-tracing roll-up; `obs.trace` is not ported, so
        there is none."""
        return None

    def live_snapshot(self, doc: dict, name: str = "live.json") -> Path:
        """Atomically rewrite a rolling snapshot file inside the run dir
        (tmp + ``os.replace``, the manifest discipline) — how a LONG-LIVED
        process (the serving engine's ``live.json``) exposes queryable
        state to `report` while still running. Readers always see a
        complete document; writers may call this at any cadence."""
        tmp = self.run_dir / (name + ".tmp")
        tmp.write_text(json.dumps(doc, default=_json_default) + "\n")
        dest = self.run_dir / name
        os.replace(tmp, dest)
        return dest

    def log_health(self, stage: str, summary: dict) -> None:
        """Emit one ``health`` event and fold it into the per-stage manifest
        roll-up (sum cells/divergent, max residual, summed flag counts)."""
        self.event("health", stage=stage, **summary)
        agg = self.health.setdefault(
            stage, {"cells": 0, "divergent": 0, "max_residual": None, "flag_counts": {}}
        )
        agg["cells"] += int(summary.get("cells", 0))
        agg["divergent"] += int(summary.get("divergent", 0))
        mr = summary.get("max_residual")
        if mr is not None:
            prev = agg["max_residual"]
            agg["max_residual"] = mr if prev is None else max(prev, mr)
        for name, n in (summary.get("flag_counts") or {}).items():
            agg["flag_counts"][name] = agg["flag_counts"].get(name, 0) + int(n)

    def log_fault(self, point: str, kind: str = "?", **fields) -> None:
        """Emit one injected-``fault`` event (`resilience.faults`) and count
        it per (point, kind) in the manifest roll-up."""
        self.event("fault", point=point, fault=kind, **fields)
        key = f"{point}:{kind}"
        agg = self.resilience["faults"]
        agg[key] = agg.get(key, 0) + 1

    def log_retry(self, scope: str, outcome: str, attempt: int = 0, **fields) -> None:
        """Emit one ``retry`` attempt-outcome event (`resilience.retry`) and
        fold it into the per-scope manifest roll-up. ``gave_up`` /
        ``budget_exhausted`` scopes are what `report resilience` gates on."""
        self.event("retry", scope=scope, outcome=outcome, attempt=attempt, **fields)
        agg = self.resilience["retries"].setdefault(
            scope, {"attempts": 0, "recovered": 0, "gave_up": 0}
        )
        agg["attempts"] = max(agg["attempts"], int(attempt))
        if outcome == "recovered":
            agg["recovered"] += 1
        elif outcome in ("gave_up", "budget_exhausted"):
            agg["gave_up"] += 1

    def log_repair(self, action: str, target: str = "?", ok: bool = True, **fields) -> None:
        """Emit one self-healing ``repair`` event (`resilience.heal`, the
        multihost work-stealing adoption) and count it per action."""
        self.event("repair", action=action, target=target, ok=bool(ok), **fields)
        agg = self.resilience["repairs"].setdefault(action, {"count": 0, "failed": 0})
        agg["count"] += 1
        agg["failed"] += int(not ok)

    def log_scheduler(self, action: str = "?", **fields) -> None:
        """Emit one elastic-scheduler ``scheduler`` event
        (`resilience.elastic`) and count it per action in the manifest
        roll-up; ``done`` events also count their tile ``source``
        (computed / cache / local) — what `report elastic` gates on."""
        self.event("scheduler", action=action, **fields)
        agg = self.elastic["scheduler"]
        agg[action] = agg.get(action, 0) + 1
        if action == "done":
            source = str(fields.get("source", "?"))
            tiles = self.elastic["tiles"]
            tiles[source] = tiles.get(source, 0) + 1

    def log_cache(self, action: str = "?", **fields) -> None:
        """Emit one cross-run tile-cache ``cache`` event
        (`resilience.elastic.TileCache`) and count it per action."""
        self.event("cache", action=action, **fields)
        agg = self.elastic["cache"]
        agg[action] = agg.get(action, 0) + 1

    def log_fleet(self, action: str = "?", **fields) -> None:
        """Emit one serving-fleet ``fleet`` event (router forwards,
        failovers, hedges, sheds, breaker transitions, degraded-ladder
        answers — `serve`) and count it per action in the manifest
        roll-up (`report fleet` gates on these counts)."""
        self.event("fleet", action=action, **fields)
        self.fleet[action] = self.fleet.get(action, 0) + 1

    def log_infomodel(self, action: str = "?", **fields) -> None:
        """Emit one information-model ``infomodel`` event
        (`infomodels`: rewire epochs, belief censuses, fixed-point
        solves, closure comparisons, population queries) and fold it into
        the manifest roll-up. Besides the per-action count, two gate
        tallies accumulate: ``nonconverged`` (fixed_point events with
        ``converged=False``) and ``breaches`` (closure events whose
        recorded error exceeds their recorded tolerance) — what
        `report infomodel` exits 1 on."""
        self.event("infomodel", action=action, **fields)
        self.infomodel[action] = self.infomodel.get(action, 0) + 1
        if action == "fixed_point" and fields.get("converged") is False:
            self.infomodel["nonconverged"] = self.infomodel.get("nonconverged", 0) + 1
        if action == "closure":
            err = fields.get("err_aw_sup")
            tol = fields.get("tolerance")
            if (
                isinstance(err, (int, float))
                and isinstance(tol, (int, float))
                and err > tol
            ):
                self.infomodel["breaches"] = self.infomodel.get("breaches", 0) + 1

    def log_audit(self, action: str = "?", **fields) -> None:
        """Emit one numerics-``audit`` event (`obs.audit`: canary
        probe verdicts, per-cycle roll-ups, scheduler errors) and fold it
        into the manifest roll-up. Besides the per-action count, the gate
        tallies accumulate: ``drift`` / ``passed`` (probe events by
        verdict) and ``last_cycle`` / ``last_verdict`` (cycle events) —
        what `report audit` exits 1 on."""
        self.event("audit", action=action, **fields)
        self.audit[action] = self.audit.get(action, 0) + 1
        if action == "probe":
            verdict = fields.get("verdict")
            if verdict == "drift":
                self.audit["drift"] = self.audit.get("drift", 0) + 1
            elif verdict == "pass":
                self.audit["passed"] = self.audit.get("passed", 0) + 1
        if action == "cycle":
            if fields.get("cycle") is not None:
                self.audit["last_cycle"] = fields["cycle"]
            if fields.get("verdict") is not None:
                self.audit["last_verdict"] = fields["verdict"]

    def log_demand(self, action: str = "?", **fields) -> None:
        """Emit one workload-``demand`` event (`obs.demand`:
        snapshot rotations, advisor-plan writes) and count it per action
        in the manifest roll-up; a plan event's ``fingerprint`` is kept as
        ``last_plan`` so the manifest names the artifact it produced."""
        self.event("demand", action=action, **fields)
        self.demand[action] = self.demand.get(action, 0) + 1
        if action == "plan" and fields.get("fingerprint") is not None:
            self.demand["last_plan"] = fields["fingerprint"]

    def log_prewarm(self, action: str = "?", **fields) -> None:
        """Emit one prefetch-controller ``prewarm`` event
        (`serve.prewarm`: plan adoption, tile completion,
        abandonment, plan verdicts) and fold it into the manifest
        roll-up: per-action counts, ``abandoned_<reason>`` tile totals
        (what `report prewarm` gates on for reason "budget"), the last
        plan fingerprint, and the final ``warm``/``tiles`` verdict of a
        completed plan."""
        self.event("prewarm", action=action, **fields)
        self.prewarm[action] = self.prewarm.get(action, 0) + 1
        if action == "abandon":
            reason = str(fields.get("reason") or "unknown")
            key = f"abandoned_{reason}"
            self.prewarm[key] = self.prewarm.get(key, 0) + int(
                fields.get("count") or 1
            )
        if action in ("plan", "plan_done") and fields.get("fingerprint"):
            self.prewarm["last_plan"] = fields["fingerprint"]
        if action == "plan_done":
            for k in ("tiles", "warm", "failed"):
                if fields.get(k) is not None:
                    self.prewarm[f"last_{k}"] = fields[k]

    def log_flight(self, action: str = "?", **fields) -> None:
        """Emit one flight-recorder ``flight`` event (`obs.flight`:
        snapshot rotations, the final close write) and fold it into the
        manifest roll-up: per-action counts plus the final snapshot's
        headline utilization numbers as ``last_*`` fields."""
        self.event("flight", action=action, **fields)
        self.flight[action] = self.flight.get(action, 0) + 1
        if action == "final":
            for k in ("records", "dispatches", "dropped_records",
                      "device_busy_frac", "host_gap_frac"):
                if fields.get(k) is not None:
                    self.flight[f"last_{k}"] = fields[k]

    def _resilience_manifest(self) -> Optional[dict]:
        if not any(self.resilience.values()):
            return None
        return {k: v for k, v in self.resilience.items() if v}

    def _elastic_manifest(self) -> Optional[dict]:
        if not any(self.elastic.values()):
            return None
        return {k: v for k, v in self.elastic.items() if v}

    def finalize(self, status: str = "complete") -> None:
        """Write the final manifest and close the event log (idempotent).
        ``status`` lets the graceful-shutdown handler land an
        ``"interrupted"`` manifest instead of ``"complete"``."""
        if self._closed:
            return
        self.event("run_end", n_events=self._n_events, status=status)
        self._write_manifest(status=status)
        self._closed = True
        self._fh.close()
        if not self._metrics_was_on:
            metrics().disable()
        if self._auto_prune_keep is not None:
            try:
                gc_runs(self.run_dir.parent, self._auto_prune_keep, skip=(self.run_dir,))
            except Exception:
                pass  # retention must never sink the run

    def __enter__(self) -> "RunContext":
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()


# ---------------------------------------------------------------------------
# Module-level API: instrumentation call sites use these; all are no-ops
# (one global read) when no run is active and SBR_OBS is unset.
# ---------------------------------------------------------------------------


def current_run() -> Optional[RunContext]:
    """The active RunContext, auto-starting one if SBR_OBS=1 in the
    environment (checked once per process). None when telemetry is off.
    Env-started runs get a retention budget (SBR_OBS_KEEP, default 32) so
    always-on telemetry cannot grow the run root without bound."""
    global _ENV_CHECKED
    if not _STACK and not _ENV_CHECKED:
        _ENV_CHECKED = True
        if os.environ.get("SBR_OBS", "").strip() not in ("", "0"):
            keep = os.environ.get("SBR_OBS_KEEP", "").strip()
            start_run(
                label=os.environ.get("SBR_OBS_LABEL", "run"),
                auto_prune_keep=int(keep) if keep else 32,
            )
    return _STACK[-1] if _STACK else None


def enabled() -> bool:
    return current_run() is not None


def start_run(
    label: str = "run",
    run_dir: Optional[str] = None,
    root: Optional[str] = None,
    auto_prune_keep: Optional[int] = None,
) -> RunContext:
    """Start (and stack) a run; finalized by `end_run`, `run_context`, or at
    interpreter exit — an abandoned run still lands a complete manifest."""
    global _ENV_CHECKED
    # An explicit run satisfies SBR_OBS's intent; without this, a later
    # empty-stack moment (obs.suspended, or after end_run) would auto-start
    # a surprise second run from the env var.
    _ENV_CHECKED = True
    run = RunContext(run_dir=run_dir, label=label, root=root, auto_prune_keep=auto_prune_keep)
    _STACK.append(run)
    atexit.register(_finalize_if_active, run)
    return run


def _finalize_if_active(run: RunContext) -> None:
    if run in _STACK:
        _STACK.remove(run)
    run.finalize()


def end_run() -> Optional[RunContext]:
    """Finalize and pop the innermost active run."""
    if not _STACK:
        return None
    run = _STACK.pop()
    run.finalize()
    return run


@contextlib.contextmanager
def run_context(label: str = "run", run_dir: Optional[str] = None, root: Optional[str] = None):
    run = start_run(label=label, run_dir=run_dir, root=root)
    try:
        yield run
    finally:
        _finalize_if_active(run)


@contextlib.contextmanager
def suspended():
    """Temporarily disable telemetry for a measurement-critical section.

    The bench harness's steady-state protocols (pipelined dispatch with one
    trailing fence) would be perturbed by `jit_call`'s per-call output fence
    and per-event file IO; inside this context every instrumentation site
    sees no active run and takes its untelemetered path, so measured numbers
    are identical to a telemetry-off process. The run itself stays open —
    events emitted after the block land in the same log."""
    # Resolve any pending SBR_OBS auto-start FIRST: otherwise the first
    # instrumented call inside the block would see an empty stack with
    # _ENV_CHECKED still unset and start a fresh (orphaned) run mid-section.
    current_run()
    saved = _STACK[:]
    _STACK.clear()
    try:
        yield
    finally:
        _STACK[:] = saved


@contextlib.contextmanager
def span(name: str, **attrs):
    """Module-level stage span: delegates to the active run; yields a no-op
    handle (still exposing `.sync`) when telemetry is off or in a program
    region or a CUDA-graph capture."""
    run = current_run()
    if run is None or not _trace_clean():
        yield _NULL_SPAN
        return
    with run.span(name, **attrs) as handle:
        yield handle


def event(kind: str, **fields) -> None:
    """Emit one event on the active run (no-op when off or in a program
    region or a capture)."""
    run = current_run()
    if run is not None and _trace_clean():
        run.event(kind, **fields)


def jit_call(name: str, fn, *args):
    """Call program ``fn(*args)`` with execute attribution when a run is
    active; otherwise exactly ``fn(*args)``."""
    run = current_run()
    if run is None or not _trace_clean():
        return fn(*args)
    return run.jit_call(name, fn, *args)


def log_status(stage: str, status) -> None:
    """Status-grid accounting event (utils.status codes) for a finished
    sweep/solve. Forces a device→host fetch of the status array — only when
    telemetry is on."""
    run = current_run()
    if run is None or not _trace_clean():
        return
    from sbr_tpu_torch.utils.status import status_counts

    total = int(status.numel()) if hasattr(status, "numel") else int(getattr(status, "size", 1))
    run.event("status", stage=stage, total=total, counts=status_counts(status))


def log_health(stage: str, health, status=None, scenario=None, bank=None) -> None:
    """Numerical-health census event (`diag`) for a finished
    sweep/solve: reduces the (possibly per-cell) Health pytree to flag
    counts, divergent-cell count, worst cells, and a residual histogram,
    and folds a roll-up into the run manifest. Forces a device→host fetch
    of the health leaves — only when telemetry is on; a no-op in a
    program region and when ``health`` is None (results assembled outside the
    solvers, e.g. tile checkpoints).

    ``scenario`` / ``bank`` : composed-scenario provenance tags.
    They ride the event as explicit fields AND suffix the fold key, so
    `report health` groups per scenario (and per bank in a multi-bank
    contagion run) instead of mixing banks into one census."""
    run = current_run()
    if run is None or health is None or not _trace_clean():
        return
    from sbr_tpu_torch.diag.health import summarize

    summary = summarize(health, status)
    key = stage
    if scenario is not None:
        summary["scenario"] = str(scenario)
        key = f"{key}[{scenario}]"
    if bank is not None:
        summary["bank"] = int(bank)
        key = f"{key}.bank{int(bank)}"
    run.log_health(key, summary)


def log_fault(point: str = "?", kind: str = "?", **fields) -> None:
    """Injected-fault event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `resilience.faults` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_fault(point, kind, **fields)


def log_retry(scope: str = "?", outcome: str = "?", attempt: int = 0, **fields) -> None:
    """Retry attempt-outcome event + manifest roll-up (no-op when telemetry
    is off or in a program region) — the `resilience.retry` default observer."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_retry(scope, outcome, attempt, **fields)


def log_tile_mem(tile: str = "?", **snap) -> None:
    """Per-tile peak-memory event + manifest roll-up (no-op when telemetry
    is off or in a program region) — the tiled sweep loop's emission hook. With
    no explicit ``snap`` fields, takes a fresh `obs.mem` snapshot."""
    run = current_run()
    if run is None or not _trace_clean():
        return
    if not snap:
        from sbr_tpu_torch.obs import mem

        snap = mem.snapshot()
        if not snap:
            return
    run.log_tile_mem(tile, **snap)


def log_repair(action: str = "?", target: str = "?", ok: bool = True, **fields) -> None:
    """Self-healing repair event + manifest roll-up (no-op when telemetry
    is off or in a program region) — the `resilience.heal` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_repair(action, target, ok, **fields)


def log_scheduler(action: str = "?", **fields) -> None:
    """Elastic-scheduler event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `resilience.elastic` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_scheduler(action, **fields)


def log_cache(action: str = "?", **fields) -> None:
    """Cross-run tile-cache event + manifest roll-up (no-op when telemetry
    is off or in a program region) — the `resilience.elastic.TileCache` hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_cache(action, **fields)


def log_fleet(action: str = "?", **fields) -> None:
    """Serving-fleet event + manifest roll-up (no-op when telemetry is off
    or in a program region) — the `serve` fleet/router emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_fleet(action, **fields)


def log_infomodel(action: str = "?", **fields) -> None:
    """Information-model event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `infomodels` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_infomodel(action, **fields)


def log_audit(action: str = "?", **fields) -> None:
    """Numerics-audit event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `obs.audit` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_audit(action, **fields)


def log_demand(action: str = "?", **fields) -> None:
    """Workload-demand event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `obs.demand` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_demand(action, **fields)


def log_prewarm(action: str = "?", **fields) -> None:
    """Prefetch-controller event + manifest roll-up (no-op when telemetry
    is off or in a program region) — the `serve.prewarm` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_prewarm(action, **fields)


def log_flight(action: str = "?", **fields) -> None:
    """Flight-recorder event + manifest roll-up (no-op when telemetry is
    off or in a program region) — the `obs.flight` emission hook."""
    run = current_run()
    if run is not None and _trace_clean():
        run.log_flight(action, **fields)


def interrupt_all() -> int:
    """Finalize every active run with manifest status ``"interrupted"`` —
    called by the graceful-shutdown handler (`resilience.shutdown`) on
    SIGTERM/SIGINT so a preempted process still leaves honest artifacts.
    Returns how many runs were finalized."""
    n = 0
    while _STACK:
        run = _STACK.pop()
        try:
            run.finalize(status="interrupted")
            n += 1
        except Exception:
            pass  # keep unwinding: one failing finalize must not strand the rest
    return n


def _run_mtime(d: Path) -> float:
    """Recency of a run directory: the newest of the dir and its log files.
    Appending to events.jsonl does NOT touch the directory mtime, so the
    dir stat alone would age a long-running live run into gc range."""
    ts = [d.stat().st_mtime]
    for name in ("events.jsonl", "manifest.json"):
        try:
            ts.append((d / name).stat().st_mtime)
        except OSError:
            pass
    return max(ts)


def _run_is_live(d: Path, grace_s: float) -> bool:
    """Heuristic cross-process liveness: a manifest still in status
    "running" with recent activity belongs to another process's open run —
    deleting it would crash that run's finalize and lose its telemetry. A
    "running" manifest with no activity for ``grace_s`` is a crashed run's
    leftovers and IS collectable."""
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False
    if manifest.get("status") != "running":
        return False
    return (time.time() - _run_mtime(d)) < grace_s


def gc_runs(root, keep: int, skip=(), running_grace_s: float = 6 * 3600.0) -> list:
    """Retention sweep for an obs run root: keep the ``keep`` most recently
    active run directories (dirs holding a ``manifest.json`` — anything
    else is not ours to delete), remove the rest. Never removed: ``skip``
    entries, this process's active runs, and other processes' apparently
    live runs (manifest status "running" with activity within
    ``running_grace_s``). Returns the removed paths."""
    import shutil

    root = Path(root)
    if keep < 0 or not root.is_dir():
        return []
    protected = {Path(p).resolve() for p in skip}
    protected.update(r.run_dir.resolve() for r in _STACK)
    runs = sorted(
        (
            d
            for d in root.iterdir()
            if d.is_dir()
            and (d / "manifest.json").exists()
            and d.resolve() not in protected
            and not _run_is_live(d, running_grace_s)
        ),
        key=_run_mtime,
    )
    doomed = runs[: max(len(runs) - keep, 0)]
    removed = []
    for d in doomed:
        try:
            shutil.rmtree(d)
            removed.append(d)
        except OSError:
            pass  # a concurrently-held run dir is not worth failing over
    return removed
