"""Holding the port's obs events to the reference's for the same call.

`assert_same_events` compares the events of the chosen kinds, in order:
the (kind, action or stage or name) sequence exactly, then every field
that is not a time, a path, a cache key (sha256 over inputs that carry
the backend tag) or one of the reference's XLA cost fields. Floats are
compared within ``rtol``/``atol`` (NaN equals NaN); a health census's
worst cells by index and flags, as tests/test_torch_obs.py does.
"""

import json
import math

# times, paths and backend-tagged keys; the reference's XLA analyses
DROPPED = {
    "mono", "ts", "dur_s", "trace_s", "compile_s", "execute_s", "backoff_s", "path", "key",
    "flops", "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes", "code_bytes",
}


def events(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


def label(ev: dict):
    return (ev["kind"], ev.get("action") or ev.get("stage") or ev.get("name"))


def _close(got, want, rtol, atol, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            _close(got[k], want[k], rtol, atol, f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{where}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        g, w = float(got), float(want)
        if math.isnan(w):
            assert math.isnan(g), (where, got, want)
        else:
            assert abs(g - w) <= atol + rtol * abs(w), (where, got, want)
    else:
        assert got == want, (where, got, want)


def assert_same_events(got: list, want: list, kinds, rtol: float = 1e-12, atol: float = 1e-12,
                       dropped=()):
    """The port's events ``got`` against the reference's ``want``, for the
    event kinds in ``kinds``; ``dropped`` names further fields to skip."""
    drop = DROPPED | set(dropped)
    g = [e for e in got if e["kind"] in kinds]
    w = [e for e in want if e["kind"] in kinds]
    assert [label(e) for e in g] == [label(e) for e in w]
    assert g, "no events of the compared kinds"
    for a, b in zip(g, w):
        a = {k: v for k, v in a.items() if k not in drop}
        b = {k: v for k, v in b.items() if k not in drop}
        assert set(a) == set(b), (label(b), sorted(set(a) ^ set(b)))
        for k in b:
            if k == "worst_cells":
                assert [(c["index"], c["flags"]) for c in a[k]] == \
                    [(c["index"], c["flags"]) for c in b[k]]
            else:
                _close(a[k], b[k], rtol, atol, f"{label(b)}.{k}")
