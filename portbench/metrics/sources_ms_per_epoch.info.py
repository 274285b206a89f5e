"""Device milliseconds an epoch of the tilted source draw: the kernels
whose launching runtime call lies inside an ``info.sources`` range (the
Threefry words of every edge and their search in the tilt table) over the
traced simulation's epochs, one ``info.epoch`` range each
(`harness.ranges`). None without those ranges."""

from harness import ranges


def read(run):
    epochs = ranges.divisor(run, "info.epoch", "epochs_traced")
    if epochs is None or not ranges.spans(run.capture, "info.sources"):
        return None
    ns = sum(e - s for s, e, _, _ in ranges.kernels_in(run.capture, "info.sources"))
    return ns / 1e6 / epochs
