"""Host milliseconds a tile in the solve's buffer stage (`optimal_buffer`,
the scan crossings): the ``baseline.buffers`` ranges of the traced tiles
over the tiles, one ``sweeps.beta_u_grid`` range each (`harness.ranges`).
None without those ranges."""

from harness import ranges


def read(run):
    tiles = ranges.tiles(run)
    if tiles is None or not ranges.spans(run.capture, "baseline.buffers"):
        return None
    return ranges.host_ms(run.capture, "baseline.buffers") / tiles
