"""Stage timing and profiler hooks: the port of ``sbr_tpu.obs.timing``.

- `fence` — an honest device fence: waits for the CUDA devices that its
  tensors live on (a no-op for CPU tensors, whose ops have finished when
  they return).
- `StageTimer` — named wall-clock stages over that fence.
- `trace` — a `torch.profiler` capture of the enclosed block, written as a
  Chrome trace (``trace.json``) under ``log_dir``.

The structured layer on top (`RunContext` event logs and per-stage spans)
lives in `sbr_tpu_torch.obs.runlog`.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict

import torch


def _tensor_leaves(obj, out: list) -> list:
    """The tensors of a nesting of tuples, lists, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _tensor_leaves(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensor_leaves(v, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            _tensor_leaves(getattr(obj, name, None), out)
    return out


def tensor_leaves(*objs) -> list:
    """Every tensor in ``objs`` (tuples, lists, dicts and dataclasses are
    walked), in order."""
    return _tensor_leaves(objs, [])


def fence(*tensors) -> None:
    """Wait until the work producing ``tensors`` has finished: one
    synchronize per CUDA device among them. CPU tensors need none."""
    devices = {t.device for t in tensor_leaves(*tensors) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates named wall-clock stages.

    Usage::

        timer = StageTimer()
        with timer.stage("learning"):
            ls = solve_learning(params)
            timer.sync(ls.cdf)
        print(timer.report())
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def sync(self, *tensors) -> None:
        fence(*tensors)

    def total(self) -> float:
        return sum(self.times.values())

    def report(self) -> str:
        width = max((len(k) for k in self.times), default=0)
        lines = [f"  {k:<{width}} {v * 1e3:10.1f} ms" for k, v in self.times.items()]
        lines.append(f"  {'total':<{width}} {self.total() * 1e3:10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (the CPU, and CUDA when available)
    of the enclosed block and write it to ``log_dir/trace.json``, which
    chrome://tracing and Perfetto open. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
