"""Share of the traced simulation's steps that recounted every edge: the
``agents.recount_full`` ranges over the ``agents.step`` ranges
(`harness.ranges`), in percent; the incremental engine's overflow
fallbacks. None unless the capture holds a range for every step."""

from harness import ranges


def read(run):
    steps = ranges.steps(run)
    if steps is None:
        return None
    return 100.0 * len(ranges.spans(run.capture, "agents.recount_full")) / steps
