"""Device kernels launched per tile of the traced stretch, counted from the
profiler's raw device events (copies and sets left out)."""


def read(run):
    cap = run.capture
    if cap is None or not run.counters.get("tiles_traced"):
        return None
    return len(cap.kernels()) / run.counters["tiles_traced"]
