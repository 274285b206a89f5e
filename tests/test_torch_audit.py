"""The port's numerics audit (sbr_tpu_torch.obs.audit) against
sbr_tpu.obs.audit, on the CPU.

Contracts:

- the eight built-in probes, each run in both packages on the same
  surface (float64, the suite's fixed numerics): the value keys, meta,
  statuses, iterations, convergence and counts equal, every other value
  within FLOAT_TOL; ``grad.ift_fd``'s ``worst_rel`` under its 1e-5
  tolerance on both sides; the `payload_fingerprint` hex of
  ``graphgen.layout``, ``infomodel.gossip`` and ``scenario.composed``
  equal to the reference's;
- the machinery on the same inputs in both packages: `classify` (verdict
  and detail over every tier), `ulp_diff`, `key_hash` of one key dict, the
  loud version refusal, the archive of a rewritten golden, the battery's
  verdicts under injected ``audit.canary`` faults, `gc_audit_files`;
- `report audit` (`audit_doc`) gives the reference's document and exit
  code on the same folded events, on runs either package wrote; a golden
  that ``sbr_tpu`` wrote gives the port's CLI exit 3, never a verdict;
- the scheduler (the reference's TestScheduler) and the engine's wiring
  (TestEngineWiring), with the port's structural-no-op witnesses in a
  fresh process: with ``SBR_AUDIT`` off the module is not imported, no
  ``sbr_audit`` text is exposed, building the engine launches no kernel
  and notes no program;
- the module and the four parity CLIs import neither ``jax`` nor
  ``sbr_tpu``, in a fresh interpreter that also runs a one-probe battery.
"""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.obs import audit as jaudit  # noqa: E402
from sbr_tpu.obs import report as jreport  # noqa: E402
from sbr_tpu.resilience import faults as jfaults  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import audit, report  # noqa: E402
from sbr_tpu_torch.resilience import faults  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 180  # seconds: every subprocess in this file is bounded
CPU = "cpu"
# Explicit environment key: the registry tests need no device.
KEY = {"platform": "test", "x64": False, "jax": "0.0", "grid_program": 0,
       "scenario_program": 0}
# float values of a probe against the reference's (measured ≤ 5e-14)
FLOAT_TOL = 1e-12
EXACT_VALUES = ("status", "iterations", "converged", "n_checked", "n_edges", "run_cells")
SAME_FINGERPRINT = ("graphgen.layout", "infomodel.gossip", "scenario.composed")
MODS = (jaudit, audit)
FAULTS = {jaudit: jfaults, audit: faults}


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
def _clean(monkeypatch):
    for var in ("SBR_AUDIT", "SBR_AUDIT_INTERVAL_S", "SBR_AUDIT_PROBES",
                "SBR_AUDIT_REGISTRY_DIR", "SBR_OBS", "SBR_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    yield
    faults.reset()
    jfaults.reset()


def const_probe(mod=audit, name="synth.const", tier="bitwise", fingerprint="f" * 64,
                values=None, ok=None, **kw):
    """A synthetic probe returning a fixed result (no solve): callable as
    the reference's ``fn()`` and the port's ``fn(device=, dtype=)``."""
    def fn(**_):
        out = {"fingerprint": fingerprint, "values": dict(values or {"v": 1.5}), "meta": {}}
        if ok is not None:
            out["ok"] = ok
        return out
    return mod.Probe(name=name, tier=tier, fn=fn, **kw)


def run(mod, probe, reg_dir, update=False, **kw):
    return mod.run_battery(probe_names=[probe], reg_dir=reg_dir, update=update, key=KEY,
                           emit=False, **kw)


# ---------------------------------------------------------------------------
# The built-in probes against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(jaudit.probes()))
def test_probe_matches_reference(name):
    assert list(audit.probes()) == list(jaudit.probes())
    ref = jaudit.probes()[name].fn()
    got = audit.probes()[name].fn(device=CPU, dtype="float64")
    assert got["meta"] == ref["meta"]
    assert set(got["values"]) == set(ref["values"])
    for k, v in ref["values"].items():
        if k in EXACT_VALUES:
            assert got["values"][k] == v, k
        elif name == "grad.ift_fd":
            assert got["values"][k] <= 1e-5 and v <= 1e-5, (got["values"][k], v)
        else:
            assert abs(got["values"][k] - v) <= FLOAT_TOL, (k, got["values"][k], v)
    assert got.get("ok") == ref.get("ok")
    if name in SAME_FINGERPRINT:
        assert got["fingerprint"] == ref["fingerprint"]
    # the port's fingerprint depends on the math only: a second run agrees
    assert audit.probes()[name].fn(device=CPU)["fingerprint"] == got["fingerprint"]
    tier = audit.probes()[name]
    assert (tier.tier, tier.requires_x64) == (jaudit.probes()[name].tier,
                                              jaudit.probes()[name].requires_x64)


def test_float32_battery_skips_the_float64_probe(tmp_path):
    rep = audit.run_battery(probe_names=["grad.ift_fd", "graphgen.layout"], reg_dir=tmp_path,
                            update=True, device=CPU, dtype=torch.float32, emit=False)
    assert rep["key"]["dtype"] == "float32"
    assert rep["probes"]["grad.ift_fd"]["verdict"] == "skipped"
    doc = json.loads(Path(rep["golden_path"]).read_text())
    assert list(doc["probes"]) == ["graphgen.layout"]


def test_env_key_carries_the_backend_and_dtype():
    key = audit.env_key(CPU, "float64")
    assert key == {"backend": "torch", "platform": "cpu", "torch": torch.__version__,
                   "dtype": "float64", "grid_program": key["grid_program"],
                   "scenario_program": key["scenario_program"]}
    assert audit.key_hash(key) != audit.key_hash(audit.env_key(CPU, "float32"))
    with pytest.raises(ValueError):
        audit.dtype_name("float16")


# ---------------------------------------------------------------------------
# The machinery, both packages on the same inputs
# ---------------------------------------------------------------------------

_CLASSIFY_CASES = [
    ("bitwise", {}, {"fingerprint": "abc", "values": {}}, None),
    ("bitwise", {}, {"fingerprint": "abc", "values": {}}, {"fingerprint": "abc", "values": {}}),
    ("bitwise", {}, {"fingerprint": "xyz", "values": {}}, {"fingerprint": "abc", "values": {}}),
    ("ulp", {"max_ulps": 2}, {"fingerprint": "o", "values": {"xi": 0.37000000000000005}},
     {"fingerprint": "g", "values": {"xi": 0.37}}),
    ("ulp", {"max_ulps": 2}, {"fingerprint": "o", "values": {"xi": 0.37 + 1e-6}},
     {"fingerprint": "g", "values": {"xi": 0.37}}),
    ("ulp", {}, {"fingerprint": "g", "values": {"xi": 0.37, "extra": 1.0}},
     {"fingerprint": "g", "values": {"xi": 0.37}}),
    ("ulp", {}, {"fingerprint": "g", "values": {"xi": float("nan")}},
     {"fingerprint": "g", "values": {"xi": float("nan")}}),
    ("tolerance", {"tol": 1e-5}, {"fingerprint": "x", "values": {"rel": 1.0 + 1e-7}},
     {"fingerprint": "g", "values": {"rel": 1.0}}),
    ("tolerance", {"tol": 1e-5}, {"fingerprint": "x", "values": {"rel": 1.1}},
     {"fingerprint": "g", "values": {"rel": 1.0}}),
    ("tolerance", {}, {"fingerprint": "x", "values": {"rel": 1.0}, "ok": False},
     {"fingerprint": "g", "values": {"rel": 1.0}}),
    ("tolerance", {}, {"fingerprint": "x", "values": {"rel": float("nan")}},
     {"fingerprint": "g", "values": {"rel": 1.0}}),
    ("tolerance", {}, {"fingerprint": "x", "values": {}}, {"fingerprint": "g", "values": {"a": 1}}),
]


@pytest.mark.parametrize("case", range(len(_CLASSIFY_CASES)))
def test_classify_equals_reference(case):
    tier, kw, result, golden = _CLASSIFY_CASES[case]
    out = [mod.classify(const_probe(mod, tier=tier, **kw), result, golden) for mod in MODS]
    assert out[0] == out[1]


def test_ulp_diff_and_key_hash_equal_reference():
    pairs = [(0.5, 0.5), (0.5, float(np.nextafter(0.5, 1.0))), (float("nan"), float("nan")),
             (float("nan"), 0.5), (-1e-300, 1e-300), (1.0, -1.0), (3.25, 3.2500000001)]
    for a, b in pairs:
        assert audit.ulp_diff(a, b) == jaudit.ulp_diff(a, b) or (
            math.isinf(audit.ulp_diff(a, b)) and math.isinf(jaudit.ulp_diff(a, b)))
    assert audit.ulp_diff(0.5, float(np.nextafter(0.5, 1.0))) == 1.0
    key = {**KEY, "backend": "torch", "dtype": "float64", "nested": {"b": [1, 2.5], "a": None}}
    assert audit.key_hash(key) == jaudit.key_hash(key)
    with pytest.raises(ValueError):
        audit.Probe(name="x", tier="vibes", fn=lambda **_: {})


@pytest.mark.parametrize("mod", MODS, ids=["ref", "port"])
def test_update_pass_missing_drift_error(mod, tmp_path):
    p = const_probe(mod)
    assert run(mod, p, tmp_path)["missing"] == ["synth.const"]
    rep = run(mod, p, tmp_path, update=True)
    assert rep["updated"] and Path(rep["golden_path"]).is_file()
    rep = run(mod, p, tmp_path)
    assert rep["ok"] and rep["probes"]["synth.const"]["verdict"] == "pass"
    rep = run(mod, const_probe(mod, fingerprint="b" * 64), tmp_path)
    assert rep["drift"] == ["synth.const"]

    def boom(**_):
        raise RuntimeError("solver exploded")
    rep = run(mod, mod.Probe(name="synth.boom", tier="bitwise", fn=boom), tmp_path)
    assert rep["probes"]["synth.boom"]["verdict"] == "error" and rep["drift"] == ["synth.boom"]
    with pytest.raises(KeyError):
        mod.run_battery(probe_names=["no.such.probe"], reg_dir=tmp_path, key=KEY, emit=False)


def test_registry_files_equal_reference(tmp_path):
    """Two rewrites archive the first golden under the same name in both
    packages, the golden documents agree but for the write time, and a
    version mismatch is refused loudly with the regeneration hint."""
    docs = []
    for mod in MODS:
        reg = tmp_path / mod.__name__
        p = const_probe(mod, values={"v": 2.5, "w": -1.0})
        run(mod, p, reg, update=True)
        run(mod, p, reg, update=True)
        names = sorted(f.name for f in reg.iterdir())
        doc = json.loads(mod.golden_path(reg, KEY).read_text())
        doc.pop("written_at")
        docs.append((names, doc))
        doc2 = dict(doc, registry_version=mod.AUDIT_REGISTRY_VERSION + 1)
        mod.golden_path(reg, KEY).write_text(json.dumps(doc2))
        with pytest.raises(mod.AuditRegistryVersionError, match="--update-goldens"):
            run(mod, p, reg)
    assert docs[0] == docs[1]
    assert docs[0][0] == [f"goldens_{audit.key_hash(KEY)}.000.json",
                          f"goldens_{audit.key_hash(KEY)}.json"]


@pytest.mark.parametrize("rules,drift", [
    ([{"point": "audit.canary", "kind": "corrupt", "match": "synth.b"}], ["synth.b"]),
    ([{"point": "audit.canary", "kind": "nan"}], ["synth.a", "synth.b"]),
    ([{"point": "audit.canary", "kind": "corrupt", "match": "synth.none"}], []),
])
def test_canary_faults_equal_reference(tmp_path, rules, drift):
    out = []
    for mod in MODS:
        reg = tmp_path / mod.__name__
        probes = [const_probe(mod, name="synth.a", fingerprint="a" * 64,
                              values={"v": 1.0}),
                  const_probe(mod, name="synth.b", fingerprint="b" * 64, tier="tolerance",
                              values={"v": 2.0}, ok=True)]
        mod.run_battery(probe_names=probes, reg_dir=reg, update=True, key=KEY, emit=False)
        fx = FAULTS[mod]
        fx.install(fx.FaultPlan({"seed": 7, "rules": rules}))
        try:
            rep = mod.run_battery(probe_names=probes, reg_dir=reg, key=KEY, emit=False)
        finally:
            fx.reset()
        out.append({n: (p["verdict"], p["detail"], p["fingerprint"], p["values"],
                        p["meta"].get("injected_fault")) for n, p in rep["probes"].items()})
        assert rep["drift"] == drift
    assert json.dumps(out[0], default=str) == json.dumps(out[1], default=str)


def _gc_tree(root: Path) -> None:
    for run_name, live in (("run_a", False), ("run_b", False), ("run_live", True)):
        d = root / "runs" / run_name
        (d / "audit").mkdir(parents=True)
        for i in range(6):
            (d / "audit" / f"battery_{i:04d}.json").write_text("{}")
        if live:
            (d / "manifest.json").write_text(json.dumps({"status": "running"}))
    reg = root / "reg"
    reg.mkdir()
    for key in ("abc", "def"):
        (reg / f"goldens_{key}.json").write_text("{}")
        for i in range(5):
            (reg / f"goldens_{key}.{i:03d}.json").write_text("{}")


@pytest.mark.parametrize("keep", [0, 2, 9])
def test_gc_audit_files_equal_reference(tmp_path, keep):
    removed = []
    for mod in MODS:
        root = tmp_path / mod.__name__
        _gc_tree(root)
        got = mod.gc_audit_files(root / "runs", keep=keep, reg_dir=root / "reg")
        removed.append(sorted(str(Path(p).relative_to(root)) for p in got))
        assert (root / "reg" / "goldens_abc.json").is_file()
        assert len(list((root / "runs" / "run_live" / "audit").iterdir())) == 6
    assert removed[0] == removed[1]
    assert len(removed[1]) == 2 * (6 - min(keep, 6)) + 2 * (5 - min(keep, 5))


# ---------------------------------------------------------------------------
# `report audit` on the same folded events
# ---------------------------------------------------------------------------


def _audited_run(mod, obs_mod, run_dir: Path, reg: Path, batteries, extra=()):
    """A run directory that ``mod``'s battery wrote through ``obs_mod``."""
    r = obs_mod.start_run(label="audit_test", run_dir=str(run_dir))
    try:
        for probe, kw in batteries:
            mod.run_battery(probe_names=[probe], reg_dir=reg, key=KEY, **kw)
        for action, fields in extra:
            obs_mod.log_audit(action, **fields)
    finally:
        obs_mod.end_run()
    return Path(r.run_dir)


def _doc_view(doc: dict) -> dict:
    """An audit document without its directory and timings."""
    out = {k: v for k, v in doc.items() if k not in ("dir", "manifest_audit")}
    out["probes"] = {n: {k: v for k, v in e.items() if k != "duration_ms"}
                     for n, e in doc.get("probes", {}).items()}
    out["cycles"] = [{k: v for k, v in c.items() if k != "duration_s"}
                     for c in doc.get("cycles", [])]
    return out


@pytest.mark.parametrize("scenario", ["clean", "drift", "error", "torn", "empty"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_report_audit_equals_reference(tmp_path, scenario, writer):
    import sbr_tpu.obs as jobs

    mod, obs_mod = (jaudit, jobs) if writer == "ref" else (audit, obs)
    reg = tmp_path / "reg"
    mod.run_battery(probe_names=[const_probe(mod, fingerprint="a" * 64)], reg_dir=reg,
                    update=True, key=KEY, emit=False)
    fp = "b" * 64 if scenario == "drift" else "a" * 64
    batteries = [] if scenario == "empty" else [(const_probe(mod, fingerprint=fp), {"cycle": 1}),
                                                (const_probe(mod, fingerprint="a" * 64),
                                                 {"cycle": 2})]
    extra = [("error", {"cycle": 3, "error": "RuntimeError('x')"})] if scenario == "error" else ()
    run_dir = _audited_run(mod, obs_mod, tmp_path / "run", reg, batteries, extra)
    if scenario == "torn":
        with open(run_dir / "events.jsonl", "a") as fh:
            fh.write('{"kind": "audit", "action": "probe", "pro')
    (doc_p, code_p), (doc_r, code_r) = report.audit_doc(run_dir), jreport.audit_doc(run_dir)
    assert code_p == code_r == {"clean": 0, "torn": 0, "drift": 1, "error": 1, "empty": 3}[scenario]
    assert _doc_view(doc_p) == _doc_view(doc_r)
    if batteries:
        assert len(list((run_dir / "audit").glob("battery_*.json"))) == 2
        assert json.loads((run_dir / "manifest.json").read_text())["audit"]["cycle"] == 2


def test_report_audit_cli_exit_codes(tmp_path, capsys):
    assert report.main(["audit", str(tmp_path / "nope")]) == 2
    assert "not a directory" in capsys.readouterr().out
    run_dir = _audited_run(audit, obs, tmp_path / "run", tmp_path / "reg",
                           [(const_probe(), {"cycle": 1})])
    # a probe without a golden is no drift: the gate passes, as the reference's does
    assert report.main(["audit", str(run_dir), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["probes"]["synth.const"]["verdict"] == "no_golden"
    assert doc["last_verdict"] == "no_golden" == jreport.audit_doc(run_dir)[0]["last_verdict"]


def test_reference_golden_gives_the_port_no_goldens(tmp_path, capsys):
    """The reference's golden for the same probe never shares the port's
    key: the port's CLI exits 3, never a verdict."""
    reg = tmp_path / "reg"
    jaudit.run_battery(probe_names=["graphgen.layout"], reg_dir=reg, update=True, emit=False)
    assert len(list(reg.glob("goldens_*.json"))) == 1
    argv = ["--registry", str(reg), "--device", CPU, "--probes", "graphgen.layout"]
    assert audit.main(argv) == 3
    assert "MISS" in capsys.readouterr().out
    assert audit.main(argv + ["--update-goldens"]) == 0
    assert audit.main(argv) == 0
    assert len(list(reg.glob("goldens_*.json"))) == 2  # the reference's file untouched
    assert audit.main(argv[:4] + ["--probes", "no.such"]) == 2


def test_cli_obs_dir_and_drift_exit(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    base = ["--registry", reg, "--device", CPU, "--probes", "graphgen.layout"]
    assert audit.main(base + ["--update"]) == 0
    faults.install(faults.FaultPlan({"seed": 3, "rules": [
        {"point": "audit.canary", "kind": "corrupt", "match": "graphgen.layout"}]}))
    try:
        assert audit.main(base + ["--obs-dir", str(tmp_path / "run"), "--json"]) == 1
    finally:
        faults.reset()
    out = capsys.readouterr().out
    assert f"obs run dir: {tmp_path / 'run'}" in out
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["drift"] == ["graphgen.layout"]
    assert report.main(["audit", str(tmp_path / "run")]) == 1
    assert audit.main(["--list"]) == 0
    assert "grad.ift_fd" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The scheduler (the reference's TestScheduler)
# ---------------------------------------------------------------------------


class TestScheduler:
    def _goldens(self, reg, probe):
        audit.run_battery(probe_names=[probe], reg_dir=reg, update=True, emit=False,
                          device=CPU)

    def test_cycle_pass_then_drift_latches(self, tmp_path):
        p = const_probe()
        self._goldens(tmp_path, p)
        s = audit.AuditScheduler(engine=None, reg_dir=tmp_path, interval=3600.0,
                                 probe_names=[p], device=CPU)
        s.run_cycle()
        assert s.status == "pass" and s.status_gauge() == 1
        assert s.heartbeat_block()["cycles"] == 1
        faults.install(faults.FaultPlan({
            "seed": 1, "rules": [{"point": "audit.canary", "kind": "corrupt"}]}))
        try:
            s.run_cycle()
        finally:
            faults.reset()
        assert s.status == "drift" and s.drift_probes == [p.name]
        # drift latches: a clean cycle after the corruption keeps the flag
        s.run_cycle()
        assert s.status == "drift" and s.status_gauge() == -1

    def test_prometheus_lines(self, tmp_path):
        p = const_probe()
        self._goldens(tmp_path, p)
        s = audit.AuditScheduler(engine=None, reg_dir=tmp_path, interval=3600.0,
                                 probe_names=[p], device=CPU)
        s.run_cycle()
        text = "\n".join(s.prometheus_lines())
        assert "sbr_audit_status 1" in text
        assert 'sbr_audit_probe_ms_count{probe="synth.const"} 1' in text

    def test_cycle_error_recorded_not_raised(self, tmp_path):
        p = const_probe()
        self._goldens(tmp_path, p)
        path = next(tmp_path.glob("goldens_*.json"))
        doc = json.loads(path.read_text())
        doc["registry_version"] = audit.AUDIT_REGISTRY_VERSION + 1
        path.write_text(json.dumps(doc))
        s = audit.AuditScheduler(engine=None, reg_dir=tmp_path, interval=3600.0,
                                 probe_names=[p], device=CPU)
        assert s.run_cycle() is None
        assert s.status == "pending"
        assert "AuditRegistryVersionError" in (s.snapshot()["last_error"] or "")

    def test_knobs(self, monkeypatch):
        for mod in MODS:
            monkeypatch.delenv("SBR_AUDIT", raising=False)
            assert mod.enabled() is False
            monkeypatch.setenv("SBR_AUDIT", "1")
            assert mod.enabled() is True
            monkeypatch.setenv("SBR_AUDIT_INTERVAL_S", "garbage")
            assert mod.interval_s() == mod.DEFAULT_INTERVAL_S
            monkeypatch.setenv("SBR_AUDIT_PROBES", "a, b,")
            assert mod.probe_filter() == ("a", "b")
        monkeypatch.delenv("SBR_AUDIT_REGISTRY_DIR", raising=False)
        assert audit.registry_dir().parts[-3:] == (".cache", "sbr_tpu_torch", "audit_goldens")


# ---------------------------------------------------------------------------
# The engine's wiring (the reference's TestEngineWiring)
# ---------------------------------------------------------------------------

_NO_OP_PROBE = r"""
import json, sys
from sbr_tpu_torch import _build
from sbr_tpu_torch.models.params import SolverConfig, make_model_params
from sbr_tpu_torch.obs import prof
from sbr_tpu_torch.serve import Engine, ServeConfig
launches, traces = dict(_build.LAUNCHES), dict(prof.trace_counts())
engine = Engine(config=SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False),
                serve=ServeConfig(buckets=(1, 8)), device="cpu")
built = {"launches": dict(_build.LAUNCHES) == launches,
         "traces": dict(prof.trace_counts()) == traces}
try:
    engine.start()
    engine.query_many([make_model_params()])
    text = engine.prometheus()
    statz = json.dumps(engine.statz())
    hz = engine.healthz()
finally:
    engine.close()
print(json.dumps({"audit": engine.audit is None, **built,
                  "module": "sbr_tpu_torch.obs.audit" in sys.modules,
                  "metrics": "sbr_audit" in text, "statz": '"audit"' in statz,
                  "healthz": hz["status"]}))
"""


class TestEngineWiring:
    def _engine(self):
        from sbr_tpu_torch.models.params import SolverConfig
        from sbr_tpu_torch.serve import Engine

        return Engine(config=SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False),
                      device=CPU)

    def test_off_is_structural_noop(self):
        """In a fresh process (this one imports the module): with
        SBR_AUDIT unset the engine builds no scheduler, never imports the
        module, exposes no audit bytes, and building it launches no kernel
        and notes no program."""
        env = {k: v for k, v in os.environ.items() if not k.startswith("SBR_AUDIT")}
        proc = subprocess.run([sys.executable, "-c", _NO_OP_PROBE], capture_output=True,
                              text=True, timeout=TIMEOUT, cwd=str(REPO),
                              env={**env, "PYTHONPATH": str(REPO)})
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out == {"audit": True, "launches": True, "traces": True, "module": False,
                       "metrics": False, "statz": False, "healthz": "ready"}

    def test_on_attaches_scheduler(self, tmp_path, monkeypatch):
        audit.run_battery(probe_names=["graphgen.layout"], reg_dir=tmp_path, update=True,
                          emit=False, device=CPU)
        monkeypatch.setenv("SBR_AUDIT", "1")
        monkeypatch.setenv("SBR_AUDIT_REGISTRY_DIR", str(tmp_path))
        monkeypatch.setenv("SBR_AUDIT_INTERVAL_S", "3600")
        monkeypatch.setenv("SBR_AUDIT_PROBES", "graphgen.layout")
        eng = self._engine()
        try:
            eng.start()
            assert eng.audit is not None
            assert (eng.audit.device, eng.audit.dtype) == (eng.device, eng.dtype)
            assert "sbr_audit_status 0" in eng.prometheus()
            rep = eng.audit.run_cycle()
            assert rep["ok"] and rep["key"]["platform"] == "cpu"
            assert "sbr_audit_status 1" in eng.prometheus()
            assert eng.statz()["audit"]["status"] == "pass"
            assert eng.healthz()["status"] == "ready"
            # drift flips /healthz degraded with the audit_drift reason
            eng.audit.status = "drift"
            eng.audit.drift_probes = ["graphgen.layout"]
            hz = eng.healthz()
            assert hz["status"] == "degraded"
            assert "audit_drift: graphgen.layout" in hz["reasons"]
        finally:
            eng.close()

    def test_idle_engine_runs_cycles_and_answers_stay(self, tmp_path, monkeypatch):
        """A short interval: the scheduler's thread runs cycles in the idle
        gaps, each probe under the dispatch lock, and the answers are the
        audit-off engine's bits."""
        from sbr_tpu_torch.models.params import make_model_params

        audit.run_battery(probe_names=["graphgen.layout"], reg_dir=tmp_path, update=True,
                          emit=False, device=CPU)
        queries = [make_model_params(), make_model_params(beta=1.5, u=0.2)]
        bits = {}
        for on in ("0", "1"):
            monkeypatch.setenv("SBR_AUDIT", on)
            monkeypatch.setenv("SBR_AUDIT_REGISTRY_DIR", str(tmp_path))
            monkeypatch.setenv("SBR_AUDIT_INTERVAL_S", "0.05")
            monkeypatch.setenv("SBR_AUDIT_PROBES", "graphgen.layout")
            eng = self._engine()
            try:
                eng.start()
                res = eng.query_many(queries)
                if on == "1":
                    deadline = time.monotonic() + 60
                    while eng.audit.snapshot()["cycles"] < 2 and time.monotonic() < deadline:
                        time.sleep(0.05)
                    snap = eng.audit.snapshot()
                    assert snap["cycles"] >= 2 and snap["status"] == "pass", snap
                    assert "graphgen.layout" in snap["probe_ms"]
                    res = eng.query_many(queries)
            finally:
                eng.close()
            bits[on] = [np.float64(r.xi).tobytes() for r in res]
        assert bits["0"] == bits["1"]


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------

_IMPORTS = r"""
import json, sys, tempfile
from sbr_tpu_torch.obs import audit
import sbr_tpu_torch.grad.parity, sbr_tpu_torch.scenario.parity
import sbr_tpu_torch.infomodels.parity, sbr_tpu_torch.social.graphgen_cli
rep = audit.run_battery(probe_names=["graphgen.layout"], reg_dir=tempfile.mkdtemp(),
                        update=True, device="cpu", emit=False)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sbr_tpu" or m.startswith("sbr_tpu."))
print(json.dumps({"bad": bad, "verdict": rep["probes"]["graphgen.layout"]["verdict"]}))
"""


def test_audit_and_clis_import_neither_jax_nor_the_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORTS], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=str(REPO), env={**os.environ,
                                                                "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"bad": [], "verdict": "golden"}
