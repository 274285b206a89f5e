"""The infection kernel's share of its roofline over the traced simulation:
the least time of its launches, their bytes
(`yardstick.infection_step_bytes` with each step's frontier and agents not
informed, as the reference run of the same simulation counts them) at the
card's published HBM bandwidth (none for a card without one), over the
device time the launches took, in percent. None unless the trace holds one
launch a step."""

from harness.yardstick import HBM_BYTES_PER_S, infection_step_bytes

INFECTION = "infection_update"


def read(run):
    cap, ref = run.capture, run.reference
    if cap is None or "frontier" not in ref or run.device_kind not in HBM_BYTES_PER_S:
        return None
    launches = [(s, e) for s, e, name, _ in cap.kernels() if INFECTION in name]
    if not launches or len(launches) != len(ref["frontier"]):
        return None
    seconds = sum(e - s for s, e in launches) / 1e9
    least = sum(infection_step_bytes(ref["n"], ref["float_bytes"], int(u), int(f))
                for u, f in zip(ref["not_informed"], ref["frontier"]))
    return 100.0 * least / HBM_BYTES_PER_S[run.device_kind] / seconds
