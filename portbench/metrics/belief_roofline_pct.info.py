"""The belief kernel's share of its roofline over the traced simulation:
the least time of its launches, their bytes (`belief_bytes`, with each
step's agents not informed and newly informed as the reference run of the
same simulation counts them) at the card's published HBM bandwidth (none
for a card without one), over the device time the launches took, in
percent. The launches are the ``belief_update`` kernels launched inside
``info.belief`` ranges; None unless there is one a step, one
``info.step`` range each (`harness.ranges`)."""

from harness import ranges
from harness.belief_bytes import belief_step_bytes
from harness.yardstick import HBM_BYTES_PER_S

BELIEF = "belief_update"


def read(run):
    ref = run.reference
    steps = ranges.divisor(run, "info.step", "steps_traced")
    if steps is None or "newly" not in ref or run.device_kind not in HBM_BYTES_PER_S:
        return None
    launches = [(s, e) for s, e, name, _ in ranges.kernels_in(run.capture, "info.belief")
                if BELIEF in name]
    if len(launches) != steps or len(ref["newly"]) != steps:
        return None
    seconds = sum(e - s for s, e in launches) / 1e9
    least = sum(belief_step_bytes(ref["n"], ref["float_bytes"], int(u), int(c))
                for u, c in zip(ref["not_informed"], ref["newly"]))
    return 100.0 * least / HBM_BYTES_PER_S[run.device_kind] / seconds
