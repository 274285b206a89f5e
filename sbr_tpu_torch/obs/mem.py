"""Memory observatory: device-memory attribution, the OOM preflight and
capacity-planned tiling: the port of ``sbr_tpu.obs.mem``.

Three layers, all host-side and free when telemetry is off:

- **Attribution** (`snapshot` + the run log): every span end and program
  call emits a ``mem`` event with the live-tensor bytes (gated by
  ``SBR_OBS_MEM_LIVE``), the CUDA allocator's ``bytes_in_use`` /
  ``peak_bytes_in_use`` and the card's capacity when the card is in use,
  and deltas against the previous snapshot. The run manifest's ``memory``
  block rolls up the peak, the span holding it and per-tile peaks of the
  tiled sweep.
- **OOM preflight** (`measure_footprint` + `preflight`): before a tiled
  sweep dispatches, one tile's footprint is compared against the card's
  capacity scaled by ``SBR_MEM_HEADROOM`` (default 0.8); failure is CLOSED,
  a `MemoryPreflightError` before any tile runs. PyTorch has no
  ahead-of-time memory analysis (the reference's ``aot_footprint``), so
  the footprint is MEASURED: the program runs once at the probe shape and
  its peak of newly allocated bytes is read (the allocator's peak on the
  card; a dispatch-mode tally of live tensor storages on the CPU). Without
  a capacity (the CPU) the check skips, verdict ``"skipped"``, and pays no
  probe.
- **Capacity planner** (`plan_tile_shape` / `plan_from_probes`):
  ``tile_shape="auto"`` fits a linear footprint model (fixed + per-cell
  bytes, from two small probes) and picks the largest power-of-two square
  tile whose modelled footprint fits ``headroom × capacity``. The same
  capacity and model always give the same shape.

The planner, preflight and `gc_debris` are the reference's pure functions,
copied as they are.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
import weakref
from pathlib import Path
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Env knobs
# ---------------------------------------------------------------------------

DEFAULT_HEADROOM = 0.8


def headroom() -> float:
    """Fraction of device capacity the planner/preflight may budget
    (``SBR_MEM_HEADROOM``, default 0.8 — the rest absorbs allocator
    fragmentation and the framework's own persistent buffers)."""
    env = os.environ.get("SBR_MEM_HEADROOM", "").strip()
    try:
        v = float(env) if env else DEFAULT_HEADROOM
    except ValueError:
        return DEFAULT_HEADROOM
    return v if 0.0 < v <= 1.0 else DEFAULT_HEADROOM


def live_enabled() -> bool:
    """Whether snapshots read the live-tensor bytes (``SBR_OBS_MEM_LIVE``,
    default on). On the CPU the read walks the live objects, so bench
    timing loops turn it off (`live_disabled`)."""
    return os.environ.get("SBR_OBS_MEM_LIVE", "").strip() != "0"


@contextlib.contextmanager
def live_disabled():
    """Temporarily disable the live-tensor read (measurement-critical
    sections; restores the previous setting on exit)."""
    prev = os.environ.get("SBR_OBS_MEM_LIVE")
    os.environ["SBR_OBS_MEM_LIVE"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("SBR_OBS_MEM_LIVE", None)
        else:
            os.environ["SBR_OBS_MEM_LIVE"] = prev


def preflight_enabled() -> bool:
    """``SBR_MEM_PREFLIGHT`` (default on) gates the pre-dispatch OOM check;
    without a capacity the check is free either way."""
    return os.environ.get("SBR_MEM_PREFLIGHT", "").strip() != "0"


# ---------------------------------------------------------------------------
# Snapshots (attribution layer)
# ---------------------------------------------------------------------------


def _cuda_in_use() -> bool:
    """Whether this process has touched the card (never initializes it)."""
    try:
        import torch

        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:
        return False


def _cpu_tensor_bytes() -> int:
    """Bytes of the distinct storages of live CPU tensors (a walk of the
    garbage collector's objects)."""
    import gc

    import torch

    kinds = (torch.Tensor, torch.nn.Parameter)
    seen = set()
    total = 0
    for obj in gc.get_objects():
        try:
            if type(obj) in kinds and obj.device.type == "cpu" and not obj.is_meta:
                s = obj.untyped_storage()
                key = s.data_ptr()
                if key and key not in seen:
                    seen.add(key)
                    total += s.nbytes()
        except Exception:
            continue
    return total


def live_bytes() -> Optional[int]:
    """Bytes of live tensors: the CUDA allocator's allocated bytes once
    the card is in use, else the live CPU tensors' storages. None when
    gated off."""
    if not live_enabled():
        return None
    try:
        if _cuda_in_use():
            import torch

            return int(torch.cuda.memory_allocated())
        return _cpu_tensor_bytes()
    except Exception:
        return None


def allocator_stats() -> Optional[dict]:
    """The card's allocator figures under the reference's names
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), read from
    `torch.cuda.memory_stats`, plus the raw stats; None when the card is
    not in use (the CPU)."""
    if not _cuda_in_use():
        return None
    try:
        import torch

        raw = torch.cuda.memory_stats()
        return {
            "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(raw.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory),
        }
    except Exception:
        return None


_CAPACITY_KEYS = ("bytes_limit", "bytes_reservable_limit", "pool_bytes")


def device_capacity(stats: Optional[dict] = None) -> Optional[int]:
    """The card's total memory in bytes, or None without a card in use
    (the graceful-skip signal for preflight/planning)."""
    if stats is None:
        stats = allocator_stats()
    if not stats:
        return None
    for key in _CAPACITY_KEYS:
        v = stats.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return int(v)
    return None


def tile_peak(snap: dict) -> int:
    """The per-tile peak figure from one snapshot: ``bytes_in_use`` (the
    tile's own live footprint) over the live-buffer sum, with the
    process-lifetime ``peak_bytes_in_use`` high-water mark only as a last
    resort — preferring the monotone counter would attribute the global
    peak to every tile computed after it."""
    return int(
        snap.get("bytes_in_use")
        or snap.get("live_buffer_bytes")
        or snap.get("peak_bytes_in_use")
        or 0
    )


def host_available_bytes() -> Optional[int]:
    """Host ``MemAvailable`` in bytes (/proc/meminfo), or None where the
    kernel does not expose it (non-Linux)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def snapshot(stats: Optional[dict] = None) -> dict:
    """One attribution snapshot: whatever is observable right now. Keys are
    present only when their source answered (CPU runs carry only
    ``live_buffer_bytes``)."""
    snap: dict = {}
    live = live_bytes()
    if live is not None:
        snap["live_buffer_bytes"] = live
    if stats is None:
        stats = allocator_stats()
    if stats:
        for k in ("bytes_in_use", "peak_bytes_in_use"):
            if k in stats:
                snap[k] = int(stats[k])
        cap = device_capacity(stats)
        if cap is not None:
            snap["bytes_limit"] = cap
    return snap


# ---------------------------------------------------------------------------
# Measured footprints (preflight layer)
# ---------------------------------------------------------------------------


class _StoragePeak:
    """A dispatch mode that tallies the storages its ops allocate while
    they live, and their peak (the CPU's footprint measure)."""

    def __init__(self) -> None:
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outer._count(out)
                return out

        self.mode = Mode()
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _count(self, out) -> None:
        from sbr_tpu_torch.obs.timing import tensor_leaves

        for t in tensor_leaves(out):
            s = t.untyped_storage()
            key, n = s.data_ptr(), s.nbytes()
            if not n or key in self._seen:
                continue
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, n)


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            total += s.nbytes()
    return total


def measure_footprint(fn, *args) -> dict:
    """Measured footprint of one call ``fn(*args)`` on the device of its
    tensor arguments: ``arg_bytes`` (the inputs), ``out_bytes`` (the
    outputs), ``temp_bytes`` (the rest of the call's peak of newly
    allocated bytes) and ``total_bytes``, their sum, with ``source``
    "measured". On the card the peak is the allocator's
    (`torch.cuda.reset_peak_memory_stats` … `max_memory_allocated`); on the
    CPU, a dispatch-mode tally of the storages the call's ops allocate
    while they live."""
    import torch

    from sbr_tpu_torch.obs.timing import tensor_leaves

    inputs = tensor_leaves(*args)
    arg_bytes = _nbytes(inputs)
    device = next((t.device for t in inputs if t.device.type == "cuda"), None)
    if device is not None:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn(*args)
        torch.cuda.synchronize(device)
        new_peak = torch.cuda.max_memory_allocated(device) - base
    else:
        tally = _StoragePeak()
        with tally.mode:
            out = fn(*args)
        new_peak = tally.peak
    out_bytes = _nbytes(tensor_leaves(out))
    temp = max(0, int(new_peak) - out_bytes)
    return {
        "arg_bytes": arg_bytes,
        "out_bytes": out_bytes,
        "temp_bytes": temp,
        "code_bytes": 0,
        "total_bytes": arg_bytes + out_bytes + temp,
        "source": "measured",
    }


class MemoryPreflightError(RuntimeError):
    """A dispatch whose footprint exceeds the memory budget — raised BEFORE
    any tile runs (fail closed beats an out-of-memory error mid-sweep)."""


def preflight(
    label: str,
    footprint: Optional[dict],
    capacity: Optional[int] = None,
    headroom_frac: Optional[float] = None,
    skip_reason: Optional[str] = None,
) -> dict:
    """Compare a ``footprint`` against the device budget.

    Returns a verdict record ``{label, verdict, footprint_bytes,
    capacity_bytes, budget_bytes, headroom}`` with verdict ``"ok"``,
    ``"exceeds"``, or ``"skipped"`` (no capacity or no footprint — the
    CPU). The record is emitted as a ``preflight`` obs event and folded
    into the run manifest's ``memory`` block when telemetry is on. Callers
    that must fail closed raise `MemoryPreflightError` on ``"exceeds"``
    (see `check_preflight`).
    """
    if headroom_frac is None:
        headroom_frac = headroom()
    if capacity is None:
        capacity = device_capacity()
    rec: dict = {"label": label, "headroom": round(float(headroom_frac), 4)}
    if capacity is None or not footprint:
        rec["verdict"] = "skipped"
        rec["reason"] = skip_reason or ("no-capacity" if capacity is None else "no-footprint")
    else:
        budget = int(capacity * headroom_frac)
        need = int(footprint.get("total_bytes", 0))
        rec.update(
            verdict="ok" if need <= budget else "exceeds",
            footprint_bytes=need,
            capacity_bytes=int(capacity),
            budget_bytes=budget,
            arg_bytes=int(footprint.get("arg_bytes", 0)),
            out_bytes=int(footprint.get("out_bytes", 0)),
            temp_bytes=int(footprint.get("temp_bytes", 0)),
            # "measured" = one probe run's peak; "planner-model" = the
            # fitted fixed+per-cell extrapolation (tile_shape="auto" path)
            source=footprint.get("source", "measured"),
        )
    _log_preflight(rec)
    return rec


def check_preflight(rec: dict) -> dict:
    """Raise `MemoryPreflightError` on an ``"exceeds"`` verdict (the
    fail-closed wrapper); pass through ``ok``/``skipped`` records."""
    if rec.get("verdict") == "exceeds":
        raise MemoryPreflightError(
            f"{rec.get('label', 'dispatch')}: footprint "
            f"{_fmt_bytes(rec.get('footprint_bytes'))} exceeds the memory budget "
            f"{_fmt_bytes(rec.get('budget_bytes'))} "
            f"({rec.get('headroom'):.0%} of {_fmt_bytes(rec.get('capacity_bytes'))} "
            "device capacity). Shrink the tile (tile_shape=... or "
            "tile_shape=\"auto\"), lower the grid resolution, or raise "
            "SBR_MEM_HEADROOM if the budget is known-conservative."
        )
    return rec


def _log_preflight(rec: dict) -> None:
    """Emit the preflight record as an obs event + manifest roll-up entry
    (no-op when telemetry is off; must never sink the caller)."""
    try:
        from sbr_tpu_torch.obs import runlog

        run = runlog.current_run()
        if run is not None:
            run.log_preflight(rec)
    except Exception:
        pass


def fmt_bytes(v) -> str:
    """Human byte formatter shared with `obs.report` (missing/zero → "-")."""
    if not v or not isinstance(v, (int, float)):
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f} {unit}"
        v /= 1024
    return f"{v:.1f} GiB"


_fmt_bytes = fmt_bytes  # internal alias for the error-message paths above


# ---------------------------------------------------------------------------
# Capacity planner
# ---------------------------------------------------------------------------


def fit_linear_model(points) -> Tuple[float, float]:
    """Fit ``bytes ≈ fixed + per_cell * n_cells`` through two (or more)
    ``(n_cells, bytes)`` probe points (least-squares for >2). The linear
    shape is exact for embarrassingly-parallel vmap grids: per-cell working
    set × cells + program constants."""
    pts = [(float(n), float(b)) for n, b in points]
    if len(pts) == 1:
        n, b = pts[0]
        return 0.0, b / n if n else 0.0
    n_mean = sum(n for n, _ in pts) / len(pts)
    b_mean = sum(b for _, b in pts) / len(pts)
    denom = sum((n - n_mean) ** 2 for n, _ in pts)
    if denom == 0.0:
        return max(0.0, b_mean), 0.0
    per_cell = sum((n - n_mean) * (b - b_mean) for (n, b) in pts) / denom
    per_cell = max(0.0, per_cell)
    fixed = max(0.0, b_mean - per_cell * n_mean)
    return fixed, per_cell


def plan_tile_shape(
    n_b: int,
    n_u: int,
    model: Tuple[float, float],
    capacity: Optional[int],
    headroom_frac: Optional[float] = None,
    min_tile: int = 8,
    max_tile: int = 8192,
    fallback: Tuple[int, int] = (256, 256),
    multiple_of: Tuple[int, int] = (1, 1),
    per_device_divisor: int = 1,
) -> Tuple[Tuple[int, int], dict]:
    """Pick the largest power-of-two square tile whose modeled footprint
    fits within ``headroom × capacity``.

    ``model`` is ``(fixed_bytes, per_cell_bytes)`` from `fit_linear_model`.
    Deterministic by construction: same (grid, model, capacity, headroom)
    ⇒ same shape, so independently-planning multihost peers agree. With no
    ``capacity`` (CPU) the ``fallback`` shape is returned with verdict
    ``"skipped"``. Returns ``((tb, tu), plan_record)``; the record lands in
    the run manifest's ``memory.plan`` block.

    ``per_device_divisor`` (mesh size for sharded tiles) divides the
    modeled CELL count: a tile sharded evenly over N devices puts ~1/N of
    its cells — and hence per-cell working set — on each device, while the
    fixed program overhead stays per-device. Without it, an unsharded
    model vs single-device capacity would undersize sharded tiles by the
    device count.

    ``multiple_of`` carries mesh-axis divisibility (a sharded tile must
    split evenly over the mesh): candidates not divisible by it are
    rejected, and if NO candidate qualifies a `MemoryPreflightError` asks
    for an explicit tile_shape — better than silently violating the mesh
    contract.
    """
    if headroom_frac is None:
        headroom_frac = headroom()
    fixed, per_cell = (float(model[0]), float(model[1]))
    divisor = max(1, int(per_device_divisor))
    base_rec = {
        "requested": "auto",
        "grid": [int(n_b), int(n_u)],
        "model_fixed_bytes": int(fixed),
        "model_per_cell_bytes": round(per_cell, 3),
        "headroom": round(float(headroom_frac), 4),
    }
    if divisor > 1:
        base_rec["per_device_divisor"] = divisor
    if capacity is None:
        shape = (min(fallback[0], _pow2_ceil(n_b)), min(fallback[1], _pow2_ceil(n_u)))
        shape = _round_to_multiple(shape, multiple_of)
        return shape, {
            **base_rec,
            "tile_shape": list(shape),
            "verdict": "skipped",
            "reason": "no-capacity",
        }
    budget = int(capacity * headroom_frac)

    def fits(t: int) -> bool:
        cells = min(t, n_b) * min(t, n_u) / divisor
        return fixed + per_cell * cells <= budget

    candidates = []
    t = min_tile
    while t <= max_tile:
        if t % multiple_of[0] == 0 and t % multiple_of[1] == 0:
            candidates.append(t)
        t *= 2
    candidates = [t for t in candidates if fits(t)]
    if not candidates:
        raise MemoryPreflightError(
            f"capacity planner: no power-of-two tile in [{min_tile}, {max_tile}] "
            f"(divisible by mesh axes {multiple_of}) fits the memory budget "
            f"{_fmt_bytes(budget)} ({headroom_frac:.0%} of {_fmt_bytes(capacity)}) "
            f"with model fixed={_fmt_bytes(fixed)} per_cell={per_cell:.1f} B. "
            "Lower the grid resolution, shrink n_grid, or pass an explicit "
            "tile_shape."
        )
    best = candidates[-1]
    # No point tiling beyond the grid itself: once one tile covers the grid,
    # larger candidates change nothing (min() clamps the modeled cells), so
    # the SMALLEST covering candidate is the canonical deterministic answer.
    for t in candidates:
        if t >= n_b and t >= n_u:
            best = t
            break
    shape = (best, best)
    cells = min(best, n_b) * min(best, n_u) / divisor
    return shape, {
        **base_rec,
        "tile_shape": list(shape),
        "verdict": "ok",
        "capacity_bytes": int(capacity),
        "budget_bytes": budget,
        "modeled_bytes": int(fixed + per_cell * cells),
    }


def plan_from_probes(
    n_b: int,
    n_u: int,
    probe_footprint: Callable[[int, int], dict],
    capacity: Optional[int] = None,
    headroom_frac: Optional[float] = None,
    probe_shapes: Tuple[Tuple[int, int], ...] = ((8, 8), (16, 16)),
    **plan_kwargs,
) -> Tuple[Tuple[int, int], dict]:
    """`plan_tile_shape` with the linear model fitted from small measured
    probes (``probe_footprint(tb, tu) -> footprint dict``). With no
    capacity the probes are SKIPPED entirely — on CPU the planner must cost
    nothing but a dict lookup."""
    if capacity is None:
        capacity = device_capacity()
    if capacity is None:
        return plan_tile_shape(
            n_b, n_u, (0.0, 0.0), None, headroom_frac, **plan_kwargs
        )
    points = []
    for tb, tu in probe_shapes:
        fp = probe_footprint(tb, tu)
        points.append((tb * tu, fp.get("total_bytes", 0)))
    shape, rec = plan_tile_shape(
        n_b, n_u, fit_linear_model(points), capacity, headroom_frac, **plan_kwargs
    )
    rec["probe_shapes"] = [list(s) for s in probe_shapes]
    return shape, rec


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _round_to_multiple(shape, multiple_of) -> Tuple[int, int]:
    """Clamp a shape onto the mesh-divisibility grid (round down to the
    multiple; never below the multiple itself)."""
    out = []
    for dim, m in zip(shape, multiple_of):
        if m <= 1:
            out.append(dim)
        else:
            out.append(max(m, (dim // m) * m))
    return tuple(out)


# ---------------------------------------------------------------------------
# Checkpoint-debris retention (`report gc` satellite)
# ---------------------------------------------------------------------------


def gc_debris(root, lease_ttl_s: float = 900.0) -> list:
    """Prune checkpoint debris left by aborted multihost runs under
    ``root``: every ``quarantine/`` directory (corrupt-tile evidence that an
    explicit gc invocation is entitled to clear), every stale
    ``tile_*.lease`` file — stale meaning its tile ``.npz`` already exists
    (completed steal), its holder's TTL lapsed, or the lease is unreadable
    (torn write from a dead holder) — and every EXPIRED elastic-scheduler
    heartbeat (``host_*.hb`` whose own TTL lapsed, or unreadable). Live
    leases within TTL and live heartbeats are preserved: a running steal
    or a breathing host must not be yanked out from under its holder.
    Returns the removed paths. Pure stdlib."""
    root = Path(root)
    removed: list = []
    if not root.is_dir():
        return removed
    now = time.time()
    for q in sorted(root.rglob("quarantine")):
        if not q.is_dir():
            continue
        try:
            shutil.rmtree(q)
            removed.append(q)
        except OSError:
            pass
    for lease in sorted(root.rglob("tile_*.lease")):
        stale = False
        if lease.with_suffix(".npz").exists():
            stale = True
        else:
            try:
                held = json.loads(lease.read_text())
                ttl = float(held.get("ttl_s", lease_ttl_s))
                stale = (now - float(held.get("ts", 0.0))) >= ttl
            except (OSError, ValueError):
                stale = True  # torn write from a dead holder
        if stale:
            try:
                lease.unlink()
                removed.append(lease)
            except OSError:
                pass
    # Expired heartbeats (resilience.elastic): a host that died without a
    # graceful release ages out via its own recorded TTL; an unreadable
    # heartbeat is a torn write from a dying host — debris either way.
    for hb in sorted(root.rglob("host_*.hb")):
        stale = False
        try:
            rec = json.loads(hb.read_text())
            # Fallback mirrors elastic.DEFAULT_HEARTBEAT_TTL_S (kept as a
            # literal: this module stays stdlib-only for the report CLI;
            # update BOTH if that constant ever changes) — gc must never
            # use a SHORTER ttl than live_hosts(), or it would delete a
            # heartbeat whose host liveness still counts as breathing.
            ttl = float(rec.get("ttl_s", 300.0))
            stale = (now - float(rec.get("ts", 0.0))) >= ttl
        except (OSError, ValueError):
            stale = True
        if stale:
            try:
                hb.unlink()
                removed.append(hb)
            except OSError:
                pass
    # Lease-takeover / heartbeat temp files (`*.lease.<pid>.tmp`,
    # `*.hb.<pid>.tmp`, written just before their os.replace): a surviving
    # one means the writer died mid-rename — always debris.
    for pattern in ("tile_*.lease.*.tmp", "host_*.hb.*.tmp"):
        for tmp in sorted(root.rglob(pattern)):
            try:
                tmp.unlink()
                removed.append(tmp)
            except OSError:
                pass
    return removed
