"""Device milliseconds a step of every kernel but the infection kernel
(the withdrawn mask, the neighbour counts, the fractions) over the traced
simulation."""

INFECTION = "infection_update"


def read(run):
    cap, steps = run.capture, run.counters.get("steps_traced")
    if cap is None or not steps:
        return None
    ns = sum(e - s for s, e, name, _ in cap.kernels() if INFECTION not in name)
    return ns / 1e6 / steps
