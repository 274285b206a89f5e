"""The researcher's wait for a tile: the nearest-rank 95th percentile of
every tile of the window, each timed on the host from its call to its
outputs on the host, the traced stretch left out."""

from harness.yardstick import percentile


def read(run):
    times = run.timers.get("tile_s")
    if not times:
        return None
    return percentile(times, 95) * 1e3
