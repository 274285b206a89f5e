"""The benchmark's arithmetic: the table of peaks, the least bytes of the
infection step, and the statistics of a measured window. Kept here, apart
from the program, so that a change to the program cannot change how it is
measured.
"""

from __future__ import annotations

import math
from typing import Sequence

# Published HBM bandwidth, bytes per second, by the name the card reports:
# NVIDIA's data sheet of the H100 SXM, at its 700 W limit.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def infection_step_bytes(n: int, size: int, not_informed: int, frontier: int) -> int:
    """Least bytes one infection step moves on n agents of a float type of
    ``size`` bytes: every agent's informed flag (1 B) and informed time
    read and written; the count (4 B) of every agent not informed, whose
    output it decides; β and the in-degree of every frontier agent (not
    informed, with a withdrawn in-neighbour), the only agents that draw."""
    return n * (1 + size + 1 + size) + not_informed * 4 + frontier * 2 * size


def rate(work: float, first_start: float, last_done: float) -> float:
    """Work per second over a whole window: all the work completed, over
    the time from the window's start to the last completion."""
    return work / (last_done - first_start)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of every value."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
