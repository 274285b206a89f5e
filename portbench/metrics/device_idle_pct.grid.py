"""Share of the traced stretch of tiles in which no device event ran: one
less the union of the device events' intervals over the stretch's length
on the host clock, in percent."""


def read(run):
    if run.capture is None or not run.counters.get("tiles_traced"):
        return None
    idle = run.capture.idle_share()
    return None if idle is None else 100.0 * idle
