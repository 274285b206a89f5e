"""Host milliseconds an epoch of the rewired graph's rebuild: the
``info.regen`` ranges (the tilt table, the tilted sources, the host
in-degree draw and the uploads) over the traced simulation's epochs, one
``info.epoch`` range each (`harness.ranges`). None without those ranges."""

from harness import ranges


def read(run):
    epochs = ranges.divisor(run, "info.epoch", "epochs_traced")
    if epochs is None or not ranges.spans(run.capture, "info.regen"):
        return None
    return ranges.host_ms(run.capture, "info.regen") / epochs
