"""Request tracing for the serving stack: the port of
``sbr_tpu.obs.trace``.

A served query crosses the endpoint, the engine's admission, the
micro-batcher, the LRU and disk caches (and, when the solver is down, the
tile-cache rung of the degradation ladder) and the dispatch. This module
gives every hop a span, so ``report trace`` can join a trip into a
per-query waterfall and ``report slo`` can say which layer ate the budget
when p99 breaches.

- The minting side (loadgen, or the endpoint on a direct hit) makes a
  16-hex trace id; a caller that already has one sends it as
  ``X-SBR-Trace-Id``, with the parent span id in ``X-SBR-Parent-Span``.
  Header presence means the minting side decided to sample, so the
  endpoint honours it unconditionally.
- `TraceContext` is the per-query span buffer: spans accumulate with a
  plain ``list.append`` (atomic under CPython) and nothing is written
  until the root owner calls `TraceWriter.commit`.
- `TraceWriter` appends whole JSON lines to ``trace.jsonl`` in the run
  directory with one ``os.write`` on an ``O_APPEND`` fd per trace, the
  discipline ``events.jsonl`` keeps: a kill can tear at most the last
  line, and readers count such lines (``bad_span_lines``).
- Sampling: ``SBR_TRACE_SAMPLE`` in [0, 1]. 0 (the default) is off:
  `mint` returns None, every instrumentation site is a None check, no
  header is added and answers are bit-identical. For 0 < rate < 1 the
  keep decision is a hash of the trace id, so every process agrees;
  queries over the resolved SLO are always committed (``exemplar``).
- Spans are host ``time.time()`` starts with ``time.monotonic()``
  durations, taken at the boundaries the obs events already use. Nothing
  here touches a device or adds a synchronization.

Span record (one JSON object per line)::

    {"trace": "9f2c...", "span": "a1b2c3d4", "parent": "..."|null,
     "name": "engine.dispatch", "svc": "worker", "ts": <wall s>,
     "dur_ms": 3.21, ...free-form attrs..., "exemplar": true?}

Imports no torch, so ``report`` stays free of a device runtime.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LabeledHistograms

# Wire protocol -------------------------------------------------------------

TRACE_HEADER = "X-SBR-Trace-Id"
PARENT_HEADER = "X-SBR-Parent-Span"

#: Active span file name inside a run dir; rotated siblings match
#: ``trace.NNN.jsonl`` (see :meth:`TraceWriter._maybe_rotate`).
TRACE_FILE = "trace.jsonl"

_RESERVED_KEYS = ("trace", "span", "parent", "name", "svc", "ts", "dur_ms")


def sample_rate() -> float:
    """Resolved ``SBR_TRACE_SAMPLE`` in [0, 1]; 0 (default) disables tracing."""
    raw = os.environ.get("SBR_TRACE_SAMPLE", "").strip()
    if not raw:
        return 0.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def slo_ms() -> Optional[float]:
    """Resolved ``SBR_SERVE_SLO_MS`` (the torch-free twin of ``engine.slo_ms``)."""
    raw = os.environ.get("SBR_SERVE_SLO_MS", "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


def max_file_bytes() -> int:
    """Rotation threshold for ``trace.jsonl`` (``SBR_TRACE_MAX_MB``, default 64)."""
    raw = os.environ.get("SBR_TRACE_MAX_MB", "").strip()
    try:
        mb = float(raw) if raw else 64.0
    except ValueError:
        mb = 64.0
    return max(int(mb * 1024 * 1024), 1 << 16)


def new_trace_id() -> str:
    return os.urandom(8).hex()


_HASH_SPACE = float(0xFFFFFFFF + 1)


def keep_decision(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling verdict shared by every process.

    Hashing the id (rather than rolling a die per process) means the router
    and each worker reach the same keep/drop answer for the same trace, so a
    kept trace is never half-written.
    """
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        bucket = int(trace_id[:8], 16)
    except ValueError:
        return True  # un-parseable foreign id: keep rather than orphan
    return bucket / _HASH_SPACE < rate


class TraceContext:
    """Per-query span buffer. One context per in-flight request.

    Spans accumulate with ``list.append`` — atomic under CPython — so the
    request thread and hedge threads can both contribute without a lock.
    Nothing is persisted until the root owner calls ``TraceWriter.commit``.
    """

    __slots__ = ("trace_id", "keep", "remote_parent", "parent_id", "service", "spans")

    def __init__(
        self,
        trace_id: str,
        keep: bool = True,
        remote_parent: Optional[str] = None,
        service: str = "?",
    ) -> None:
        self.trace_id = trace_id
        self.keep = keep
        #: Parent span id received over the wire (the router's forward span).
        self.remote_parent = remote_parent
        #: Parent id the *next* layer down should attach to; the owner of the
        #: root span sets this before handing the context to the engine.
        self.parent_id = remote_parent
        self.service = service
        self.spans: List[dict] = []

    def alloc_id(self) -> str:
        return os.urandom(4).hex()

    def add(
        self,
        name: str,
        t0: float,
        dur_s: float,
        parent: Optional[str] = None,
        span_id: Optional[str] = None,
        **attrs,
    ) -> str:
        """Record one completed span; returns its id.

        ``t0`` is a wall-clock start (seconds since epoch) so spans written
        by different processes join on a shared axis; ``dur_s`` is measured
        with the monotonic clock by the caller.
        """
        sid = span_id if span_id is not None else self.alloc_id()
        rec = {
            "trace": self.trace_id,
            "span": sid,
            "parent": parent,
            "name": name,
            "svc": self.service,
            "ts": round(t0, 6),
            "dur_ms": round(max(dur_s, 0.0) * 1e3, 4),
        }
        for k, v in attrs.items():
            if k not in _RESERVED_KEYS and v is not None:
                rec[k] = v
        self.spans.append(rec)
        return sid


def mint(service: str) -> Optional[TraceContext]:
    """Mint a new trace, or ``None`` when tracing is off (the common case).

    A single env read and a float compare when disabled — the zero-overhead
    contract every other obs layer already honours.
    """
    rate = sample_rate()
    if rate <= 0.0:
        return None
    tid = new_trace_id()
    return TraceContext(tid, keep=keep_decision(tid, rate), service=service)


def from_headers(
    trace_id, parent_id=None, service: str = "worker"
) -> Optional[TraceContext]:
    """Adopt an inbound trace header, or mint locally on a direct hit.

    Header presence wins over the local sample rate: the minting side
    already decided to keep this trace, and honouring that is what makes
    cross-process joins complete.
    """
    if trace_id:
        tid = str(trace_id).strip()[:64]
        parent = str(parent_id).strip()[:64] if parent_id else None
        return TraceContext(tid, keep=True, remote_parent=parent, service=service)
    return mint(service)


# Per-layer span-duration histograms (exposed on /metrics) -------------------

_LAYER_HISTOGRAMS = LabeledHistograms(DEFAULT_LATENCY_BOUNDS_MS)


def layer_histograms() -> LabeledHistograms:
    """Process-global per-layer span-duration histograms (committed spans only)."""
    return _LAYER_HISTOGRAMS


def layer_prometheus() -> List[str]:
    """Prometheus exposition lines for the per-layer span histograms."""
    return _LAYER_HISTOGRAMS.to_prometheus("sbr_trace_span_ms", label_key="layer")


# Writer --------------------------------------------------------------------


class TraceWriter:
    """Span sink for one run directory (``trace.jsonl``).

    Each commit encodes the context's spans into one newline-terminated blob
    and lands it with a single ``os.write`` on an ``O_APPEND`` fd, so lines
    from concurrent commits (threads or processes sharing the dir) interleave
    at line granularity only.  Rotation renames the active file to
    ``trace.NNN.jsonl``; a racing write that lands on the just-rotated inode
    still reaches readers because ``load_spans`` reads rotated files too.
    """

    def __init__(self, run_dir) -> None:
        self.run_dir = Path(run_dir)
        self.path = self.run_dir / TRACE_FILE
        self._fd: Optional[int] = None
        self._rotate_lock = threading.Lock()
        self.counters = {"traces": 0, "spans": 0, "exemplars": 0, "dropped": 0}

    def _ensure_fd(self) -> Optional[int]:
        if self._fd is None:
            try:
                self.run_dir.mkdir(parents=True, exist_ok=True)
                self._fd = os.open(
                    str(self.path), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
                )
            except OSError:
                return None
        return self._fd

    def _maybe_rotate(self, incoming: int) -> None:
        fd = self._fd
        if fd is None:
            return
        try:
            size = os.fstat(fd).st_size
        except OSError:
            return
        if size + incoming <= max_file_bytes():
            return
        with self._rotate_lock:
            if self._fd is not fd:  # another thread already rotated
                return
            n = len(list(self.run_dir.glob("trace.*.jsonl"))) + 1
            rotated = self.run_dir / f"trace.{n:03d}.jsonl"
            try:
                os.replace(str(self.path), str(rotated))
                os.close(fd)
            except OSError:
                return
            self._fd = None

    def commit(self, ctx: Optional[TraceContext], exemplar: bool = False) -> bool:
        """Persist (or drop) a finished trace's spans.

        ``exemplar=True`` forces the write even when the head-sampling
        verdict said drop — the SLO-breach tail always keeps its waterfall.
        Returns True when spans were written.
        """
        if ctx is None or not ctx.spans:
            return False
        if not ctx.keep and not exemplar:
            self.counters["dropped"] += 1
            return False
        mark = exemplar and not ctx.keep
        lines = []
        for rec in ctx.spans:
            if mark:
                rec = dict(rec, exemplar=True)
            lines.append(json.dumps(rec, separators=(",", ":")))
            _LAYER_HISTOGRAMS.record(rec["name"], rec["dur_ms"])
        blob = ("\n".join(lines) + "\n").encode("utf-8")
        self._maybe_rotate(len(blob))
        fd = self._ensure_fd()
        if fd is None:
            return False
        try:
            os.write(fd, blob)
        except OSError:
            return False
        self.counters["traces"] += 1
        self.counters["spans"] += len(lines)
        if mark:
            self.counters["exemplars"] += 1
        return True

    def close(self) -> Dict[str, int]:
        fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        return dict(self.counters)


_WRITERS: Dict[str, TraceWriter] = {}
_WRITERS_LOCK = threading.Lock()


def writer_for(run) -> Optional[TraceWriter]:
    """Singleton :class:`TraceWriter` for a run's directory (or ``None``).

    Accepts a ``RunContext`` (anything with ``run_dir``) or a path.  Returns
    ``None`` when there is no run directory to write into — tracing requires
    a run dir, exactly like every other obs stream.
    """
    if run is None:
        return None
    run_dir = getattr(run, "run_dir", run)
    try:
        key = str(Path(run_dir).resolve())
    except OSError:
        key = str(run_dir)
    with _WRITERS_LOCK:
        w = _WRITERS.get(key)
        if w is None:
            w = TraceWriter(run_dir)
            _WRITERS[key] = w
        return w


def close_for(run_dir) -> Optional[Dict[str, int]]:
    """Close (and forget) the writer for ``run_dir``; returns its counters."""
    try:
        key = str(Path(run_dir).resolve())
    except OSError:
        key = str(run_dir)
    with _WRITERS_LOCK:
        w = _WRITERS.pop(key, None)
    return w.close() if w is not None else None


def summary_for(run_dir) -> Optional[Dict[str, int]]:
    """Live counter snapshot for ``run_dir``'s writer (manifest roll-up)."""
    try:
        key = str(Path(run_dir).resolve())
    except OSError:
        key = str(run_dir)
    with _WRITERS_LOCK:
        w = _WRITERS.get(key)
    return dict(w.counters) if w is not None else None


# Reading (report side; same torn-line tolerance as events.jsonl) ------------


def trace_files(run_dir) -> List[Path]:
    """Active + rotated span files for a run dir, oldest first."""
    d = Path(run_dir)
    rotated = sorted(d.glob("trace.*.jsonl"))
    active = d / TRACE_FILE
    return rotated + ([active] if active.exists() else [])


def load_spans(run_dir) -> Tuple[List[dict], int]:
    """Read every span line in a run dir; returns ``(spans, bad_span_lines)``.

    Byte-level read with ``errors="replace"`` decoding: a torn final line
    (kill -9 mid-append) or interleaved garbage is counted, never fatal —
    the ``bad_event_lines`` contract, applied to spans.
    """
    spans: List[dict] = []
    bad = 0
    for path in trace_files(run_dir):
        try:
            raw = path.read_bytes()
        except OSError:
            continue
        for line in raw.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                bad += 1
                continue
            if not isinstance(rec, dict) or "trace" not in rec or "span" not in rec:
                bad += 1
                continue
            spans.append(rec)
    return spans, bad


# GC ------------------------------------------------------------------------


def gc_trace_files(
    root, keep_rotated: int = 1, running_grace_s: float = 6 * 3600.0
) -> List[str]:
    """Prune rotated trace span files under an obs root; returns removed paths.

    Run directories that look live (manifest ``status: running`` with recent
    mtime — the same test ``gc_runs`` applies) are never touched, and the
    active ``trace.jsonl`` is never removed here: whole-dir retention stays
    ``gc_runs``'s job, this only bounds the rotated-file tail inside kept
    dirs under ``SBR_OBS_KEEP``.
    """
    from sbr_tpu_torch.obs import runlog  # local import: avoid a cycle at import time

    removed: List[str] = []
    rootp = Path(root)
    if not rootp.is_dir():
        return removed
    for run_dir in rootp.iterdir():
        if not run_dir.is_dir() or not (run_dir / "manifest.json").exists():
            continue
        if runlog._run_is_live(run_dir, running_grace_s):
            continue
        rotated = sorted(
            run_dir.glob("trace.*.jsonl"), key=lambda p: p.stat().st_mtime
        )
        excess = rotated[: max(len(rotated) - max(keep_rotated, 0), 0)]
        for path in excess:
            try:
                path.unlink()
                removed.append(str(path))
            except OSError:
                continue
    return removed
