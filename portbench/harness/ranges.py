"""The program's own profiler ranges in a traced stretch.

While a torch profiler records, the port opens named ranges around its
stages (`torch.profiler.record_function`): the grid's tile
``sweeps.beta_u_grid`` with the solve's ``baseline.hazard``,
``baseline.buffers`` and ``baseline.xi``; the agents' ``agents.prologue``
and, each step, ``agents.step`` with ``agents.counts``,
``agents.recount_full``, ``agents.sync`` and ``agents.infection``. They
are host events of the capture (`Capture.ops`), on the clock of the
runtime calls that launched the device events (`Capture.launches`). A
program without them leaves none, and a reader then reads nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def spans(capture, name: str) -> List[Tuple[int, int]]:
    """(start ns, end ns) of every range ``name``, by start."""
    return sorted((s, e) for s, e, n in capture.ops if n == name)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: list = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def host_ms(capture, name: str) -> float:
    """Host milliseconds inside the ranges ``name`` (their union)."""
    return sum(e - s for s, e in _union(spans(capture, name))) / 1e6


def kernels_in(capture, name: str) -> list:
    """The kernels (`Capture.kernels`) whose launching runtime call starts
    inside a range ``name``."""
    inside = _union(spans(capture, name))
    starts = [s for s, _ in inside]
    out = []
    for ev in capture.kernels():
        t = capture.launches.get(ev[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            out.append(ev)
    return out


def divisor(run, name: str, counter: str) -> Optional[int]:
    """The number of ranges ``name`` in the traced stretch, when it is the
    run's count ``counter`` (``tiles_traced``, ``steps_traced``); None
    when there is no capture, no such range, or the two disagree."""
    if run.capture is None:
        return None
    n = len(spans(run.capture, name))
    return n if n and n == run.counters.get(counter) else None


def tiles(run) -> Optional[int]:
    """The traced tiles, one ``sweeps.beta_u_grid`` range each."""
    return divisor(run, "sweeps.beta_u_grid", "tiles_traced")


def steps(run) -> Optional[int]:
    """The traced simulation's steps, one ``agents.step`` range each."""
    return divisor(run, "agents.step", "steps_traced")
