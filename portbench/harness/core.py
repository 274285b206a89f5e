"""One run of one cell: set-up, the measured window, the optional traced
stretch, then, once the window has closed and the program's state is
freed, the comparison with the plain reference. `execute` returns the
result line's object; `run.py` prints it.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Optional

import torch

from harness.cell import Cell

# top-level modules that nothing a run loads may import: JAX, and the JAX
# package with its benchmarks (compared by whole top-level name, since the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "sbr_tpu", "benchmarks", "bench")
GIB = float(1 << 30)


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every module
    this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def guard_imports() -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded: {', '.join(found)}")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric's reader gets: the cell, the traced stretch,
    the harness's timers and counters, and what the reference worked out."""

    cell: Cell
    capture: object
    timers: dict
    counters: dict
    reference: dict
    device_kind: str


def _finite(v: float) -> Optional[float]:
    return v if math.isfinite(v) else None


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Run ``cell`` once and return the result line's object. ``t_start``
    is the process's start on ``time.perf_counter``'s clock."""
    driver = cell.driver().Driver(cell, seed, device)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    driver.window(seconds, trace)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    guard_imports()
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, ref_info = driver.compare()
    print(f"{cell.name}: set-up {setup_s:.3f} s, compared in {time.perf_counter() - t:.3f} s",
          file=sys.stderr, flush=True)
    limits = cell.workload["limits"]
    checks = [Check(k, float(v), float(limits[k])) for k, v in numbers.items()]
    correct = driver.failed == 0 and driver.attempted > 0 and all(c.ok for c in checks)

    metrics = {}
    if not trace:
        values = dict(driver.end_to_end())
        values["setup_s"] = setup_s
        values["peak_mem_gib"] = peak / GIB
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        record = RunRecord(cell=cell, capture=driver.capture, timers=driver.timers,
                           counters=driver.counters, reference=ref_info, device_kind=kind)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(driver.attempted),
              "failed": int(driver.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = driver.capture.busy_s()
        dev["window_s"] = driver.capture.window_s
        result["breakdown"] = {"device_ops": driver.capture.top_ops(10),
                               "idle_gaps": driver.capture.idle_gaps(10)}
    result["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in checks}
    return result
