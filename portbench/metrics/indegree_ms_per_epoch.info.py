"""Host milliseconds an epoch of the in-degree draw: the ``info.indegrees``
ranges over the traced simulation's epochs, one ``info.epoch`` range each
(`harness.ranges`). Where the card draws the in-degrees this is the
host's enqueue of its kernel; where the host draws them (numpy's ids of
about 10^8 edges), the draw itself, while the card waits. None without
those ranges."""

from harness import ranges


def read(run):
    epochs = ranges.divisor(run, "info.epoch", "epochs_traced")
    if epochs is None or not ranges.spans(run.capture, "info.indegrees"):
        return None
    return ranges.host_ms(run.capture, "info.indegrees") / epochs
