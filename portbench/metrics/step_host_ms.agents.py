"""The host's milliseconds a step of the traced simulation, enqueueing and
waiting: the mean ``agents.step`` range (`harness.ranges`). None unless
the capture holds a range for every step."""

from harness import ranges


def read(run):
    steps = ranges.steps(run)
    if steps is None:
        return None
    return ranges.host_ms(run.capture, "agents.step") / steps
