"""Share of the traced simulation in which no device event ran: one less
the union of the device events' intervals over the simulation's length on
the host clock, in percent. None unless the capture holds an ``info.step``
range for every step (`harness.ranges`)."""

from harness import ranges


def read(run):
    if ranges.divisor(run, "info.step", "steps_traced") is None:
        return None
    idle = run.capture.idle_share()
    return None if idle is None else 100.0 * idle
