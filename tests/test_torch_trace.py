"""The port's request tracing (sbr_tpu_torch.obs.trace) against
sbr_tpu.obs.trace, on the CPU.

Contracts, each on the same inputs in both packages:

- the head-sampling verdict `keep_decision` on 2,000 seeded ids at several
  rates, the knobs (`sample_rate`, `slo_ms`, `max_file_bytes`), `mint` and
  `from_headers`;
- `TraceWriter`: the committed lines byte for byte, the sampled-out drop
  and the SLO exemplar, rotation into ``trace.NNN.jsonl``, `load_spans`'
  tolerance of torn lines, `summary_for` / `close_for`, the manifest's
  ``trace`` roll-up, and `gc_trace_files`;
- the engine's spans for a computed miss, a coalesced duplicate, an LRU
  hit, the three sheds (expired, unmeetable, expired while queued), a
  degraded answer and a failed one: names, parents and attributes equal
  with ids and times dropped (tests/torch_telemetry.py drives both
  engines);
- answers bit for bit the same traced and untraced.
"""

import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.obs import trace as jtrace  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import trace  # noqa: E402
from torch_telemetry import answer_bits, drive, make_engine, span_structure  # noqa: E402

MODS = (jtrace, trace)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("SBR_TRACE_SAMPLE", "SBR_SERVE_SLO_MS", "SBR_TRACE_MAX_MB", "SBR_FLIGHT",
                "SBR_DEMAND", "SBR_OBS", "SBR_TILE_CACHE_DIR", "SBR_SERVE_DEADLINE_MS"):
        monkeypatch.delenv(var, raising=False)


# -- sampling and the knobs ----------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.1, 0.25, 0.5, 0.9, 1.0])
def test_keep_decision_equals_the_reference(rate):
    rng = random.Random(17)
    ids = [f"{rng.getrandbits(64):016x}" for _ in range(2000)] + ["zz-not-hex", ""]
    want = [jtrace.keep_decision(i, rate) for i in ids]
    assert [trace.keep_decision(i, rate) for i in ids] == want
    if 0.0 < rate < 1.0:
        assert abs(sum(want[:2000]) / 2000 - rate) < 0.05  # the hash spreads


@pytest.mark.parametrize("raw", ["", "0", "0.3", "1", "7", "-2", "nope"])
def test_knobs_equal_the_reference(raw, monkeypatch):
    for var in ("SBR_TRACE_SAMPLE", "SBR_SERVE_SLO_MS", "SBR_TRACE_MAX_MB"):
        monkeypatch.setenv(var, raw)
    for fn in ("sample_rate", "slo_ms", "max_file_bytes"):
        assert getattr(trace, fn)() == getattr(jtrace, fn)(), fn


def test_mint_and_from_headers(monkeypatch):
    for mod in MODS:
        assert mod.mint("worker") is None  # off: no context at all
        assert mod.from_headers(None, None) is None
        ctx = mod.from_headers(" abc123 ", "p" * 80, service="worker")
        assert (ctx.trace_id, ctx.remote_parent, ctx.parent_id, ctx.keep) == (
            "abc123", "p" * 64, "p" * 64, True)
    monkeypatch.setenv("SBR_TRACE_SAMPLE", "1")
    for mod in MODS:
        ctx = mod.mint("loadgen")
        assert ctx.keep and ctx.service == "loadgen" and len(ctx.trace_id) == 16
        assert ctx.remote_parent is None and ctx.spans == []
    assert (trace.TRACE_HEADER, trace.PARENT_HEADER, trace.TRACE_FILE) == (
        jtrace.TRACE_HEADER, jtrace.PARENT_HEADER, jtrace.TRACE_FILE)


def _ctx(mod, tid="0123456789abcdef", keep=True, n=3):
    ctx = mod.TraceContext(tid, keep=keep, service="worker")
    root = ctx.add("worker.request", 1700000000.123456789, 0.0123, parent=None,
                   span_id="000000ff", status=200)
    for k in range(n):
        ctx.add(f"engine.layer{k}", 1700000000.2 + k, 1e-3 * k, parent=root,
                span_id=f"{k:08x}", lru="miss", disk=None, n=k, svc="ignored", ts="ignored")
    return ctx


# -- the writer ----------------------------------------------------------------


def test_span_ids_keep_the_reference_form_without_a_syscall(monkeypatch):
    """A span id is eight hex digits, as the reference's, drawn from the
    interpreter's generator: `os.urandom` lets go of the interpreter lock,
    and a forward of the router waited milliseconds to take it back."""
    ref = jtrace.TraceContext("0" * 16).alloc_id()

    def refused(n):
        raise AssertionError("os.urandom called for a span id")

    monkeypatch.setattr(trace.os, "urandom", refused)
    ctx = trace.TraceContext("0" * 16)
    ids = [ctx.alloc_id() for _ in range(2000)]
    assert all(len(i) == len(ref) == 8 and int(i, 16) >= 0 for i in ids)
    assert len(set(ids)) > 1990


def test_writer_lines_byte_equal_and_sampling(tmp_path):
    out = {}
    for mod, name in ((jtrace, "ref"), (trace, "port")):
        d = tmp_path / name
        w = mod.TraceWriter(d)
        assert w.commit(None) is False and w.commit(mod.TraceContext("x")) is False
        assert w.commit(_ctx(mod)) is True
        assert w.commit(_ctx(mod, "ffffffff00000000", keep=False)) is False  # sampled out
        assert w.commit(_ctx(mod, "eeeeeeee00000000", keep=False), exemplar=True) is True
        out[name] = ((d / "trace.jsonl").read_bytes(), w.close())
    assert out["port"] == out["ref"]
    lines = out["port"][0].decode().splitlines()
    assert len(lines) == 8 and json.loads(lines[-1])["exemplar"] is True
    assert out["port"][1] == {"traces": 2, "spans": 8, "exemplars": 1, "dropped": 1}


def test_rotation_and_torn_lines(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_TRACE_MAX_MB", "0")  # the 64 KiB floor
    docs = {}
    for mod, name in ((jtrace, "ref"), (trace, "port")):
        d = tmp_path / name
        w = mod.TraceWriter(d)
        for k in range(240):
            assert w.commit(_ctx(mod, f"{k:016x}", n=4))
        w.close()
        with open(d / "trace.jsonl", "ab") as fh:
            fh.write(b'{"trace": "torn", "sp\n\xff\xfe not json\n[1, 2]\n')
        files = [p.name for p in mod.trace_files(d)]
        spans, bad = mod.load_spans(d)
        docs[name] = (files, [(p.name, p.read_bytes()) for p in sorted(d.iterdir())], spans, bad)
    assert docs["port"] == docs["ref"]
    files, _, spans, bad = docs["port"]
    assert files[0] == "trace.001.jsonl" and files[-1] == "trace.jsonl" and len(files) >= 3
    assert len(spans) == 240 * 5 and bad == 3


def test_writer_registry_and_manifest_rollup(tmp_path):
    run = obs.start_run(label="traced", run_dir=tmp_path / "run")
    try:
        w = trace.writer_for(run)
        assert w is trace.writer_for(str(run.run_dir)) and trace.writer_for(None) is None
        w.commit(_ctx(trace))
        assert trace.summary_for(run.run_dir) == {"traces": 1, "spans": 4, "exemplars": 0,
                                                  "dropped": 0}
    finally:
        obs.end_run()
    manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
    assert manifest["trace"] == {"traces": 1, "spans": 4, "exemplars": 0, "dropped": 0}
    assert trace.close_for(tmp_path / "run")["traces"] == 1
    assert trace.summary_for(tmp_path / "run") is None and trace.close_for(tmp_path / "x") is None


def test_layer_histograms_record_committed_spans(tmp_path):
    before = trace.layer_histograms().summaries().get("engine.layer2", {}).get("count", 0)
    trace.TraceWriter(tmp_path).commit(_ctx(trace))
    assert trace.layer_histograms().summaries()["engine.layer2"]["count"] == before + 1
    lines = trace.layer_prometheus()
    assert any(line.startswith('sbr_trace_span_ms_count{layer="engine.layer2"}') for line in lines)


def _gc_tree(root, live_name="live"):
    for name, status in (("done", "complete"), (live_name, "running")):
        d = root / name
        d.mkdir(parents=True)
        (d / "manifest.json").write_text(json.dumps({"status": status}))
        (d / "trace.jsonl").write_text("{}\n")
        for k in range(1, 5):
            p = d / f"trace.{k:03d}.jsonl"
            p.write_text("{}\n")
            os.utime(p, (1000 + k, 1000 + k))
    (root / "not_a_run").mkdir()


@pytest.mark.parametrize("keep", [0, 1, 3, 9])
def test_gc_trace_files_equals_the_reference(tmp_path, keep):
    got = {}
    for mod, name in ((jtrace, "ref"), (trace, "port")):
        root = tmp_path / name
        _gc_tree(root)
        removed = mod.gc_trace_files(root, keep_rotated=keep)
        got[name] = (sorted(os.path.relpath(p, root) for p in removed),
                     sorted(str(p.relative_to(root)) for p in root.rglob("*")))
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == max(4 - keep, 0)  # the live run is never touched


# -- the engine's spans ----------------------------------------------------------


@pytest.fixture(scope="module")
def driven():
    return {pkg: drive(pkg) for pkg in ("ref", "port")}


def test_engine_spans_equal_the_reference(driven):
    want = [span_structure(s) for s in driven["ref"]["spans"]]
    got = [span_structure(s) for s in driven["port"]["spans"]]
    assert got == want
    names = [[n for n, _, _ in q] for q in got]
    full = ["engine.admission", "engine.queue", "engine.cache", "engine.batch",
            "engine.dispatch", "engine.query"]
    assert names[:3] == [full] * 3
    assert names[3] == ["engine.admission", "engine.queue", "engine.cache", "engine.query"]
    assert names[4] == names[5] == ["engine.admission"]
    roots = [q[-1][2] for q in got]
    assert [r.get("source") for r in roots[:4]] == ["computed", "computed", "coalesced", "lru"]
    assert roots[6] == {"name": "engine.query", "svc": "worker", "shed": "queue-expired"}
    assert roots[7]["degraded"] is True and roots[7]["source"] == "tilecache"
    assert roots[8]["error"] == "SolverUnavailable"
    assert got[4][0][2]["shed"] is True and got[4][0][1] == "00c0ffee"
    assert got[0][2][2] == {"name": "engine.cache", "svc": "worker", "lru": "miss",
                            "disk": "off"}
    assert got[3][2][2] == {"name": "engine.cache", "svc": "worker", "lru": "hit"}
    assert got[2][3][2]["coalesced"] is True
    assert got[0][4][2] == {"name": "engine.dispatch", "svc": "worker", "bucket": 8,
                            "padded_lanes": 6, "padded_share": 0.75}
    assert got[7][3][2]["hit"] is True and got[8][3][2]["hit"] is False


def test_engine_answers_are_the_same_untraced(driven):
    from sbr_tpu_torch.models import params as P

    engine = make_engine("port")
    try:
        plain = engine.query_many([P.make_model_params(), P.make_model_params(u=0.2),
                                   P.make_model_params()])
    finally:
        engine.close()
    traced = driven["port"]["answers"][:3]
    assert answer_bits(plain)[:2] == answer_bits(traced)[:2]
    assert [r.source for r in plain] == ["computed", "computed", "coalesced"]
    for got, want in zip(driven["port"]["answers"], driven["ref"]["answers"]):
        assert (got.source, got.degraded, got.status, got.flags) == (
            want.source, want.degraded, int(want.status), int(want.flags))
        assert abs(got.xi - want.xi) <= 1e-12 or (np.isnan(got.xi) and np.isnan(want.xi))


def test_trace_writer_needs_a_run_directory(tmp_path):
    engine = make_engine("port")
    try:
        assert engine.trace_writer() is None
    finally:
        engine.close()
    engine = make_engine("port", run_dir=str(tmp_path / "run"))
    try:
        w = engine.trace_writer()
        assert w is trace.writer_for(tmp_path / "run") and w.path.parent == tmp_path / "run"
    finally:
        engine.close()
