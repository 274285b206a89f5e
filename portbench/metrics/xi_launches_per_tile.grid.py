"""Kernels a tile launched in the solve's ξ stage: the device kernels
(copies and sets left out) whose launching runtime call lies inside a
``baseline.xi`` range, over the traced tiles (`harness.ranges`). None
without those ranges."""

from harness import ranges


def read(run):
    tiles = ranges.tiles(run)
    if tiles is None or not ranges.spans(run.capture, "baseline.xi"):
        return None
    return len(ranges.kernels_in(run.capture, "baseline.xi")) / tiles
