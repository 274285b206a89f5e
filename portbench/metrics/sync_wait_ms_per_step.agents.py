"""Host milliseconds a step spent reading device values, the incremental
engine's two reads of the overflow flag: the ``agents.sync`` ranges of
the traced simulation over its steps (`harness.ranges`). None without
those ranges."""

from harness import ranges


def read(run):
    steps = ranges.steps(run)
    if steps is None or not ranges.spans(run.capture, "agents.sync"):
        return None
    return ranges.host_ms(run.capture, "agents.sync") / steps
