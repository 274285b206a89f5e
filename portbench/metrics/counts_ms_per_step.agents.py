"""Device milliseconds a step of the neighbour counts: the kernels whose
launching runtime call lies inside an ``agents.counts`` range (the gather
engine's recount, the incremental engine's compaction, ``index_add`` or
fallback recount), over the traced simulation's steps (`harness.ranges`).
None without those ranges."""

from harness import ranges


def read(run):
    steps = ranges.steps(run)
    if steps is None or not ranges.spans(run.capture, "agents.counts"):
        return None
    ns = sum(e - s for s, e, _, _ in ranges.kernels_in(run.capture, "agents.counts"))
    return ns / 1e6 / steps
