"""Trace counting and profiler capture: the port of ``sbr_tpu.obs.prof``.

Three concerns, all host-side and all free when dormant:

- **Compile tracking.** The reference folds XLA's compile phases into the
  run through `jax.monitoring` listeners. PyTorch has no compile step on
  this path, so `monitoring_available` returns False and a run's manifest
  says ``"monitoring": false`` in its ``xla`` block, as the reference's
  does on a JAX build without the API.
  What the port does compile is a CUDA graph: `note_capture` counts each
  capture as a trace of its program and times it, and `obs.jit_call`
  reports that time as the call's ``compile_s``.
- **Trace registry** (`note_trace`, `note_call`). A "trace" of a program is
  its first call at a new abstract signature (shapes, dtypes, devices of
  its tensors, values of its plain arguments) or a new CUDA-graph capture.
  `note_call` derives the signature and counts a trace only when it is
  new, so the count is what a jit cache's misses would be. When a run is
  active and the within-run count exceeds the name's budget
  (``SBR_OBS_RETRACE_BUDGET``, default 3), a ``retrace`` warning event
  lands in the log: the signature of argument shape/dtype churn.
- **Profiler capture** (`profile`): the port's one `torch.profiler`
  capture, gated on ``SBR_OBS_PROFILE=1`` (or ``force=``), written as a
  Chrome trace inside the active run directory, so run retention prunes
  it; a capture larger than ``SBR_OBS_PROFILE_MAX_MB`` (default 256) is
  deleted on the spot and recorded as pruned.
- **Ranges** (`annotate`, `step_annotation`, `ranges`): the pipeline's
  stage names on the timeline (a profiler record function plus an NVTX
  range on the card) while any torch profiler records in the process,
  this module's or another's; silent otherwise and inside a CUDA-graph
  capture. `ranges_on` is the one query that gates them. A range's name
  never begins with ``cu``: trace readers take host events named so for
  the CUDA runtime's calls.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from pathlib import Path
from typing import Optional

# Per-program trace counts (process lifetime; runs snapshot at start and
# report deltas), per-name budgets, and the signatures seen per name.
_TRACE_COUNTS: dict = {}
_TRACE_BUDGETS: dict = {}
_SIGNATURES: dict = {}
# Seconds spent capturing CUDA graphs in this process (jit_call reads the
# delta across its call).
_CAPTURE = {"captures": 0, "seconds": 0.0}


# ---------------------------------------------------------------------------
# Compile tracking
# ---------------------------------------------------------------------------


def monitoring_available() -> bool:
    """Always False: no compile listeners exist on the port's path."""
    return False


def capture_totals() -> dict:
    """CUDA-graph captures in this process and their seconds."""
    return dict(_CAPTURE)


def note_capture(name: str, seconds: float) -> None:
    """Record one CUDA-graph capture of program ``name`` (``seconds`` from
    the start of the capture to its instantiation): a trace of the program,
    and compile time for the `obs.jit_call` it runs in."""
    _CAPTURE["captures"] += 1
    _CAPTURE["seconds"] += float(seconds)
    note_trace(name)


# ---------------------------------------------------------------------------
# Trace registry
# ---------------------------------------------------------------------------


def _default_budget() -> int:
    env = os.environ.get("SBR_OBS_RETRACE_BUDGET", "").strip()
    return int(env) if env else 3


def trace_budget(name: str) -> int:
    return _TRACE_BUDGETS.get(name, _default_budget())


def note_trace(name: str, budget: Optional[int] = None) -> int:
    """Record one trace of the named program; returns the new
    process-lifetime count. A ``budget`` given here sticks for the name."""
    n = _TRACE_COUNTS.get(name, 0) + 1
    _TRACE_COUNTS[name] = n
    if budget is not None:
        _TRACE_BUDGETS[name] = int(budget)
    try:
        from sbr_tpu_torch.obs import runlog

        run = runlog.active_run()
        if run is not None:
            run._note_trace(name, n)
    except Exception:
        pass
    return n


def abstract_signature(*args) -> tuple:
    """Hashable abstract signature of a call's arguments: (shape, dtype,
    device) per tensor, type and value per plain scalar or string, the
    type name otherwise; tuples, lists, dicts and dataclasses are walked."""
    import torch

    sig: list = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            sig.append((tuple(obj.shape), str(obj.dtype), str(obj.device)))
        elif isinstance(obj, (tuple, list)):
            sig.append(type(obj).__name__)
            for v in obj:
                walk(v)
        elif isinstance(obj, dict):
            for k in sorted(obj, key=str):
                sig.append(str(k))
                walk(obj[k])
        elif hasattr(obj, "__dataclass_fields__"):
            sig.append(type(obj).__name__)
            for k in obj.__dataclass_fields__:
                walk(getattr(obj, k, None))
        elif isinstance(obj, (int, float, bool, str, type(None))):
            sig.append((type(obj).__name__, obj))
        else:
            sig.append(type(obj).__name__)

    walk(args)
    return tuple(sig)


def note_call(name: str, *args, budget: Optional[int] = None) -> bool:
    """Count a trace of program ``name`` when ``args`` carry an abstract
    signature it has not been called with in this process (the port's
    counterpart of a jit cache miss). Returns whether it was new."""
    seen = _SIGNATURES.setdefault(name, set())
    sig = abstract_signature(*args)
    if sig in seen:
        if budget is not None:
            _TRACE_BUDGETS[name] = int(budget)
        return False
    seen.add(sig)
    note_trace(name, budget=budget)
    return True


def trace_counts() -> dict:
    """Snapshot of the per-name process-lifetime trace counts."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    """Test hook: forget all counts, budgets and seen signatures."""
    _TRACE_COUNTS.clear()
    _TRACE_BUDGETS.clear()
    _SIGNATURES.clear()


# ---------------------------------------------------------------------------
# Profiler capture + annotations
# ---------------------------------------------------------------------------


def profiling_enabled() -> bool:
    """Opt-in flag for `profile`'s capture (SBR_OBS_PROFILE=1), read per
    call so a shell or a test can toggle it live."""
    return os.environ.get("SBR_OBS_PROFILE", "").strip() not in ("", "0")


def _profile_budget_bytes() -> int:
    env = os.environ.get("SBR_OBS_PROFILE_MAX_MB", "").strip()
    return int(float(env) * 1024 * 1024) if env else 256 * 1024 * 1024


def _summarize_dir(d: Path) -> dict:
    files = 0
    total = 0
    try:
        for p in d.rglob("*"):
            if p.is_file():
                files += 1
                total += p.stat().st_size
    except OSError:
        pass
    return {"files": files, "bytes": total}


def ranges_on() -> bool:
    """Whether a torch profiler is recording in this process: the one
    query (a fraction of a microsecond) that gates every range. False
    while torch is not loaded, since then nothing can record."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


_NULL_RANGE = contextlib.nullcontext()


def _null_range(name: str):
    return _NULL_RANGE


@contextlib.contextmanager
def _range(name: str):
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        # a host operation on the profiler's timeline (category cpu_op), as
        # an aten operation is: `torch.profiler.record_function` makes a
        # user annotation, which the CUDA profiler copies as a device event
        # spanning the range's kernels, and trace readers would count it
        with torch._C._profiler._RecordFunctionFast(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def ranges():
    """The range maker for a hot loop, read once a call: ``ranges()(name)``
    is `annotate`'s range while a profiler records outside a CUDA-graph
    capture, and otherwise one shared null context, so a loop that no
    profiler watches creates no range and queries nothing more."""
    return _range if ranges_on() and not _capturing() else _null_range


def annotate(name: str):
    """A named range around a host-side stage: a record function on the
    profiler's timeline and an NVTX range on the card, while a profiler
    records (`ranges`); a shared null context otherwise."""
    return ranges()(name)


def step_annotation(step: int, name: str = "step"):
    """Per-rep/step framing in bench loops (``name#step``), as `annotate`."""
    return annotate(f"{name}#{int(step)}")


@contextlib.contextmanager
def profile(label: str = "capture", force: bool = False):
    """Capture a size-bounded `torch.profiler` trace of the enclosed block.

    Yields the trace directory (a Path) while capturing, or None when
    profiling is off (``SBR_OBS_PROFILE`` unset and not ``force``) or the
    profiler is unavailable. The directory lands inside the active run dir
    (``<run>/profile/``), else under ``SBR_OBS_PROFILE_DIR`` (default
    ``obs_profile/``); it receives ``trace.json`` (Chrome format) when the
    block ends. A summary (path, files, bytes, window) is emitted as a
    ``profile`` event and folded into the manifest; captures over
    ``SBR_OBS_PROFILE_MAX_MB`` are deleted and recorded as pruned.
    """
    if not (force or profiling_enabled()):
        yield None
        return
    from sbr_tpu_torch.obs import runlog

    run = runlog.active_run()
    root = (
        run.run_dir / "profile"
        if run is not None
        else Path(os.environ.get("SBR_OBS_PROFILE_DIR", "obs_profile"))
    )
    trace_dir = root / f"{label.replace('/', '_')}_{time.strftime('%Y%m%dT%H%M%S')}"
    i = 0
    while trace_dir.exists():
        i += 1
        trace_dir = Path(f"{trace_dir}_{i}")
    try:
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        ctx = torch.profiler.profile(activities=activities)
    except Exception as err:  # profiler unavailable: never sink the caller
        if run is not None:
            run.event("profile", label=label, error=repr(err))
        yield None
        return
    t0 = time.monotonic()
    started_at = time.strftime("%Y-%m-%dT%H:%M:%S")
    try:
        with ctx as captured:
            yield trace_dir
    finally:
        window_s = time.monotonic() - t0
        try:
            trace_dir.mkdir(parents=True, exist_ok=True)
            captured.export_chrome_trace(str(trace_dir / "trace.json"))
        except Exception:
            pass
        summary = _summarize_dir(trace_dir)
        budget = _profile_budget_bytes()
        pruned = summary["bytes"] > budget
        if pruned:
            import shutil

            shutil.rmtree(trace_dir, ignore_errors=True)
        rec = {
            "label": label,
            "trace_dir": str(trace_dir),
            "files": summary["files"],
            "bytes": summary["bytes"],
            "pruned": pruned,
            "max_bytes": budget,
            "window_s": round(window_s, 6),
            "started_at": started_at,
        }
        # `run` was resolved at entry: the capture belongs to the run that
        # owned it even if the block suspended telemetry inside.
        if run is not None:
            run.event("profile", **rec)
            run.profiles.append(rec)
