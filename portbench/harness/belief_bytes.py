"""The least bytes of one belief step (``csrc/belief_update.cu``), for the
belief kernel's share of its roofline. Kept apart from the program, beside
`yardstick`, so that a change to the program cannot change how it is
measured.
"""

from __future__ import annotations


def belief_step_bytes(n: int, size: int, not_informed: int, newly: int) -> int:
    """Least bytes one belief step moves on n agents of a float type of
    ``size`` bytes (34 B an agent in float32 where it must touch all).

    Every agent: its informed flag (1 B), belief, count (4 B) and safe
    degree read, and its informed flag, informed time and belief written,
    since each output is a new array. Only what the step provably needs
    beyond that is counted: the informed time is read for every agent but
    those newly informed, whose output is the step's time; the awareness
    and the threshold only for the ``not_informed`` agents, since an agent
    already informed stays so whatever they hold."""
    every = 1 + size + 4 + size + 1 + size + size
    return n * every + (n - newly) * size + not_informed * 2 * size
