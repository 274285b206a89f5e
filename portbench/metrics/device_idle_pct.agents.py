"""Share of the traced simulation in which no device event ran: one less
the union of the device events' intervals over the simulation's length on
the host clock, in percent."""


def read(run):
    if run.capture is None or not run.counters.get("steps_traced"):
        return None
    idle = run.capture.idle_share()
    return None if idle is None else 100.0 * idle
