"""Device milliseconds a step of the neighbour counts in the belief loop:
the kernels whose launching runtime call lies inside an ``info.counts``
range (the ``wd[src]`` gather and the prefix-sum recount) over the traced
simulation's steps, one ``info.step`` range each (`harness.ranges`). None
without those ranges."""

from harness import ranges


def read(run):
    steps = ranges.divisor(run, "info.step", "steps_traced")
    if steps is None or not ranges.spans(run.capture, "info.counts"):
        return None
    ns = sum(e - s for s, e, _, _ in ranges.kernels_in(run.capture, "info.counts"))
    return ns / 1e6 / steps
