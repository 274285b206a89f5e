"""Host milliseconds a tile in the solve's ξ stage (`compute_xi`, the
fixed numerics' 90-step bisection): the ``baseline.xi`` ranges of the
traced tiles over the tiles, one ``sweeps.beta_u_grid`` range each
(`harness.ranges`). None without those ranges."""

from harness import ranges


def read(run):
    tiles = ranges.tiles(run)
    if tiles is None or not ranges.spans(run.capture, "baseline.xi"):
        return None
    return ranges.host_ms(run.capture, "baseline.xi") / tiles
