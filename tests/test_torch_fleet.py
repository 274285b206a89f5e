"""The port's serving fleet (sbr_tpu_torch.serve.fleet, .router and
loadgen's fleet mode) against sbr_tpu's, on the CPU.

Contracts:

- the circuit breaker and fleet membership (tests/test_fleet.py's
  breaker and membership cases): a scripted sequence of clock steps,
  failures and successes gives the same `allow()` / `admissible()`
  answers, states, ages and transitions in both packages, and a
  heartbeat either package's `WorkerAnnouncer` writes is read alike by
  both packages' `live_workers`;
- the router (tests/test_fleet.py's router cases and tests/test_audit.py's
  quarantine): each case runs once per package against identical stub
  workers (canned stdlib HTTP servers announced in a fresh fleet dir),
  with both routers seeded from the same (empty) history. The sequence
  of workers hit, the status codes, the ``fleet`` events (kinds and
  fields, the stubs' URLs normalized) and the `healthz()` / `statz()`
  counters are equal;
- the worker process: ``python -m sbr_tpu_torch.serve.fleet --device
  cpu`` drains on SIGTERM (rc 143, heartbeat withdrawn, manifest
  "interrupted"); without a card and without ``--device cpu`` it exits
  2 and `spawn_worker` raises;
- one module-scoped CPU fleet: ``loadgen --fleet 2 --device cpu`` on a
  small pool, its ``--answers-out`` bit for bit the port's in-process
  `Engine` and within 1e-12 of `sbr_tpu.serve.Engine` (statuses and flags
  equal); ``--fleet-kill-after`` byte-identical with 0 lost; a gossip and
  a bayes population query through the router equal to
  `Engine.query_population` in process, bit for bit.

Worker processes get one intra-op thread (``OMP_NUM_THREADS=1``); every
process, router and endpoint closes in a ``finally``, and every wait has a
timeout.
"""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu import obs as jobs  # noqa: E402
from sbr_tpu.resilience import faults as jfaults  # noqa: E402
from sbr_tpu.serve import fleet as jfleet  # noqa: E402
from sbr_tpu.serve import router as jrouter  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.resilience import faults  # noqa: E402
from sbr_tpu_torch.serve import fleet, loadgen, router  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 180  # seconds: every process and wait in this file is bounded
PKGS = {"port": (fleet, router, faults, obs), "ref": (jfleet, jrouter, jfaults, jobs)}
# the reference's serve-engine float tolerance (f64)
FLOAT_TOL = 1e-12
# the population worker's grid (the population tests' n_grid)
POP_GRID = 256
# the small pool of the module's fleet
SHAPE = dict(queries=24, pool=5, group=4, n_grid=64, bisect_iters=20, buckets="1,8", seed=0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("SBR_BREAKER_THRESHOLD", "SBR_BREAKER_COOLDOWN_S", "SBR_ROUTER_HEDGE_MS",
                "SBR_SERVE_DEADLINE_MS", "SBR_FLEET_POLL_S", "SBR_FAULT_PLAN", "SBR_OBS",
                "SBR_TRACE_SAMPLE", "SBR_AUDIT", "SBR_DEMAND", "SBR_FLIGHT", "SBR_PREWARM"):
        monkeypatch.delenv(var, raising=False)
    # both routers seed their latency estimate from the same, empty history
    monkeypatch.setenv("SBR_OBS_HISTORY", str(tmp_path / "empty_history.jsonl"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    faults.install(None)
    faults.reset()
    jfaults.install(None)
    jfaults.reset()


# ---------------------------------------------------------------------------
# Circuit breaker and membership
# ---------------------------------------------------------------------------

# (operation, argument) scripts over a clocked breaker; "t" sets the clock
BREAKER_SCRIPTS = {
    "opens_after_threshold": (dict(threshold=3, cooldown_s=5.0),
                              [("fail",), ("fail",), ("allow",), ("fail",), ("allow",)]),
    "success_resets_count": (dict(threshold=2, cooldown_s=5.0),
                             [("fail",), ("ok",), ("fail",), ("allow",)]),
    "half_open_single_probe": (dict(threshold=1, cooldown_s=5.0),
                               [("fail",), ("allow",), ("t", 5.0), ("allow",), ("allow",),
                                ("ok",), ("allow",)]),
    "half_open_failure_reopens": (dict(threshold=1, cooldown_s=5.0),
                                  [("fail",), ("t", 5.0), ("allow",), ("fail",), ("t", 9.0),
                                   ("allow",), ("t", 10.0), ("allow",)]),
    "admissible_side_effect_free": (dict(threshold=1, cooldown_s=5.0),
                                    [("fail",), ("t", 5.0), ("adm",), ("adm",), ("adm",),
                                     ("allow",), ("adm",), ("ok",), ("adm",)]),
    "abandoned_releases_probe": (dict(threshold=1, cooldown_s=2.0),
                                 [("fail",), ("t", 2.0), ("allow",), ("abandon",), ("allow",),
                                  ("t", 3.5), ("fail",), ("allow",)]),
}


def _run_breaker(mod, kw, script) -> list:
    now = [0.0]
    seen = []
    b = mod.CircuitBreaker(clock=lambda: now[0],
                           on_transition=lambda old, new: seen.append((old, new)), **kw)
    trace = []
    for step in script:
        op = step[0]
        if op == "t":
            now[0] = step[1]
        elif op == "fail":
            b.record_failure()
        elif op == "ok":
            b.record_success()
        elif op == "abandon":
            b.record_abandoned()
        elif op == "allow":
            trace.append(("allow", b.allow()))
        elif op == "adm":
            trace.append(("adm", b.admissible()))
        trace.append((b.state, b.consecutive_failures, b.age_s()))
    return trace + [tuple(seen)]


@pytest.mark.parametrize("case", sorted(BREAKER_SCRIPTS))
def test_breaker_equals_reference(case):
    kw, script = BREAKER_SCRIPTS[case]
    got, want = (_run_breaker(m, kw, script) for m in (fleet, jfleet))
    assert got == want
    if case == "opens_after_threshold":
        assert ("allow", True) in got and got[-2][0] == "open"
    if case == "half_open_single_probe":
        assert got[-1] == (("closed", "open"), ("open", "half_open"), ("half_open", "closed"))


def test_breaker_thresholds_from_env(monkeypatch):
    monkeypatch.setenv("SBR_BREAKER_THRESHOLD", "7")
    monkeypatch.setenv("SBR_BREAKER_COOLDOWN_S", "1.5")
    got, want = fleet.CircuitBreaker(), jfleet.CircuitBreaker()
    assert (got.threshold, got.cooldown_s) == (want.threshold, want.cooldown_s) == (7, 1.5)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_announce_and_filter_non_workers(writer, tmp_path):
    ann = PKGS[writer][0].WorkerAnnouncer(tmp_path, "http://127.0.0.1:1234", host="w1")
    ann.beat(qps=2.5)
    # a sweep host sharing the dir (no url) never routes traffic
    from sbr_tpu_torch.resilience.elastic import Heartbeat

    Heartbeat(tmp_path, "sweep-host").beat(tiles_done=3)
    lives = [m.live_workers(tmp_path) for m in (fleet, jfleet)]
    assert lives[0] == lives[1]
    assert list(lives[0]) == ["w1"]
    assert lives[0]["w1"]["url"] == "http://127.0.0.1:1234" and lives[0]["w1"]["qps"] == 2.5
    assert lives[0]["w1"]["role"] == "serve_worker"
    ann.withdraw()
    assert fleet.live_workers(tmp_path) == {} == jfleet.live_workers(tmp_path)
    assert fleet.live_workers(tmp_path / "missing") == {}


def test_heartbeat_ttl_expiry(tmp_path):
    ann = fleet.WorkerAnnouncer(tmp_path, "http://x", ttl_s=0.05, host="w1")
    ann.beat()
    for m in (fleet, jfleet):
        assert "w1" in m.live_workers(tmp_path)
        assert "w1" not in m.live_workers(tmp_path, now=time.time() + 1.0)


def test_heartbeat_fault_point_silences_beat(tmp_path):
    faults.install(faults.FaultPlan(
        {"seed": 0, "rules": [{"point": "fleet.heartbeat", "kind": "transient",
                               "at_hits": [1]}]}))
    ann = fleet.WorkerAnnouncer(tmp_path, "http://x", host="w1")
    ann.beat()  # silenced: no heartbeat file lands
    assert fleet.live_workers(tmp_path) == {}
    ann.beat()  # the next beat goes through
    assert "w1" in fleet.live_workers(tmp_path)


def test_fleet_dir_knob(monkeypatch, tmp_path):
    monkeypatch.delenv("SBR_FLEET_DIR", raising=False)
    assert fleet.fleet_dir() is None is jfleet.fleet_dir()
    monkeypatch.setenv("SBR_FLEET_DIR", str(tmp_path))
    assert fleet.fleet_dir() == jfleet.fleet_dir() == tmp_path
    assert fleet.fleet_dir("/x") == Path("/x")


# ---------------------------------------------------------------------------
# The router against identical stub workers
# ---------------------------------------------------------------------------


class _StubWorker:
    """A canned /query responder announced in the fleet dir: a fixed JSON
    body, an optional delay and status code. Every hit lands in the shared
    ``log`` (host, deadline header) in arrival order."""

    def __init__(self, fleet_dir, host_id, log, xi=1.0, status_code=200, delay_s=0.0,
                 ttl_s=60.0):
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                log.append((host_id, self.headers.get("X-SBR-Deadline-Ms")))
                if stub.delay_s:
                    time.sleep(stub.delay_s)
                body = json.dumps(
                    {"xi": stub.xi, "tau_bar_in": 1.0, "aw_max": 2.0, "status": 1, "flags": 0,
                     "residual": 0.0, "source": "computed", "degraded": False,
                     "scenario": "default", "latency_ms": 1.0}).encode()
                self.send_response(stub.status_code)
                self.send_header("Content-Type", "application/json")
                if stub.status_code == 429:
                    self.send_header("Retry-After", "2.5")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.xi, self.status_code, self.delay_s = xi, status_code, delay_s
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.announcer = fleet.WorkerAnnouncer(fleet_dir, f"http://127.0.0.1:{self.port}",
                                               host=host_id, ttl_s=ttl_s)
        self.announcer.beat(healthz="ready")

    def close(self):
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:
            pass
        self.announcer.withdraw()


def _post(rt, deadline_header=None, body=None) -> tuple:
    headers = {"Content-Type": "application/json"}
    if deadline_header is not None:
        headers["X-SBR-Deadline-Ms"] = str(deadline_header)
    req = urllib.request.Request(f"http://127.0.0.1:{rt.port}/query",
                                 data=body if body is not None else b'{"beta": 1.0, "u": 0.1}',
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()).get("xi"), None
    except urllib.error.HTTPError as err:
        return err.code, None, err.headers.get("Retry-After")


# Each case: (stubs as (host, kwargs), router kwargs, env, drive); the
# drive function posts through the router and returns what it observed.
def _drive_repeat(n, **kw):
    def drive(rt, stubs):
        return [_post(rt, **kw) for _ in range(n)]
    return drive


def _drive_until(code, n=4):
    def drive(rt, stubs):
        out = []
        for _ in range(n):
            out.append(_post(rt))
            if out[-1][0] == code:
                break
        return out
    return drive


def _drive_expiry(rt, stubs):
    rt.refresh_workers(force=True)
    before = rt.healthz()["routable"]
    time.sleep(0.4)  # the TTL lapses with no further beat
    rt.refresh_workers(force=True)
    return [before, rt.healthz()["routable"]]


ROUTER_CASES = {
    "failover_absorbs_dead_worker": (
        [("w-dead", dict(status_code=500)), ("w-live", dict(xi=42.0))], {},
        {"SBR_BREAKER_THRESHOLD": "1"}, _drive_repeat(4)),
    "all_down_is_lost_503": ([("w-dead", dict(status_code=500))], {}, {}, _drive_repeat(1)),
    "worker_429_passes_through": (
        [("w-shed", dict(status_code=429)), ("w-peer", dict(delay_s=0.2))], {}, {},
        _drive_until(429)),
    "expired_deadline_sheds_at_router": ([("w1", {})], {}, {}, _drive_repeat(1,
                                                                            deadline_header=-1)),
    "deadline_propagates": ([("w1", {})], {}, {}, _drive_repeat(1, deadline_header=5000)),
    "hedge_win_one_latency_sample": (
        [("a-slow", dict(delay_s=0.8, xi=1.0)), ("b-fast", dict(xi=2.0))], {"hedge_ms": 50.0},
        {}, _drive_repeat(1)),
    "worker_4xx_without_failover": (
        [("w-400", dict(status_code=400)), ("w-peer", dict(delay_s=0.2))], {}, {},
        _drive_until(400)),
    "bad_deadline_header_is_client_error": ([("w1", {})], {}, {},
                                            _drive_repeat(1, deadline_header="abc",
                                                          body=b"{}")),
    "heartbeat_expiry_drops_worker": ([("w1", dict(ttl_s=0.2))], {}, {}, _drive_expiry),
    "injected_forward_fault_fails_over": (
        [("aa", dict(xi=1.0)), ("bb", dict(xi=7.0))], {}, {"fault": "aa"}, _drive_repeat(1)),
}


def _fleet_events(run_dir: Path) -> list:
    out = []
    for line in (run_dir / "events.jsonl").read_text().splitlines():
        ev = json.loads(line)
        if ev.get("kind") == "fleet":
            out.append({k: v for k, v in ev.items() if k not in ("ts", "mono", "url", "error",
                                                                  "reason")})
    return out


def _router_case(pkg: str, case: str, root: Path, monkeypatch) -> dict:
    fleet_mod, router_mod, faults_mod, obs_mod = PKGS[pkg]
    stubs_spec, rkw, env, drive = ROUTER_CASES[case]
    env = dict(env)
    fault = env.pop("fault", None)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fdir = root / pkg / "fleet"
    log: list = []
    stubs = [_StubWorker(fdir, host, log, **kw) for host, kw in stubs_spec]
    run = obs_mod.RunContext(run_dir=str(root / pkg / "run"), label="router")
    if fault:
        faults_mod.install(faults_mod.FaultPlan({"seed": 0, "rules": [
            {"point": "router.forward", "kind": "transient", "match": fault, "max_fires": 1}]}))
    rt = router_mod.Router(fdir, poll_s=0.01, run=run, **rkw).start()
    try:
        observed = drive(rt, stubs)
        rt.refresh_workers(force=True)
        health = rt.healthz()
        statz = rt.statz()
        out = dict(observed=observed, hits=[h for h, _ in log],
                   deadlines=[d is not None and 0 < float(d) <= 5000 for _, d in log],
                   counters=dict(rt.counters), healthz=health, statz_counters=statz["counters"],
                   latency_count=rt.latency_hist.count,
                   breakers={h: w["breaker"] for h, w in statz["workers"].items()},
                   forwards={h: w["forwards"] for h, w in statz["workers"].items()})
    finally:
        rt.close()
        for s in stubs:
            s.close()
        faults_mod.install(None)
        faults_mod.reset()
        run.finalize()
    out["events"] = _fleet_events(root / pkg / "run")
    return out


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_equals_reference(case, tmp_path, monkeypatch):
    got = _router_case("port", case, tmp_path, monkeypatch)
    want = _router_case("ref", case, tmp_path, monkeypatch)
    assert got == want
    c = got["counters"]
    if case == "failover_absorbs_dead_worker":
        assert all(code == 200 and xi == 42.0 for code, xi, _ in got["observed"])
        assert c["failed"] == 0 and c["failover"] >= 1
        assert got["healthz"]["status"] == "degraded"
        assert "w-dead" in " ".join(got["healthz"]["reasons"])
    elif case == "all_down_is_lost_503":
        assert got["observed"][0][0] == 503 and c["failed"] == 1
    elif case == "worker_429_passes_through":
        assert got["observed"][-1][:1] == (429,) and got["observed"][-1][2] == "2.5"
        assert (c["shed"], c["failover"], c["failed"]) == (1, 0, 0)
    elif case == "expired_deadline_sheds_at_router":
        assert got["observed"][0][0] == 429 and got["hits"] == [] and c["shed"] == 1
    elif case == "deadline_propagates":
        assert got["deadlines"] == [True]
    elif case == "hedge_win_one_latency_sample":
        assert got["observed"] == [(200, 2.0, None)]
        assert (c["hedged"], c["hedge_wins"], c["completed"]) == (1, 1, 1)
        assert got["latency_count"] == 1  # the hedged win is recorded once
    elif case == "worker_4xx_without_failover":
        assert got["observed"][-1][0] == 400
        assert (c["client_errors"], c["failed"], c["failover"]) == (1, 0, 0)
        assert set(got["breakers"].values()) == {"closed"}
    elif case == "bad_deadline_header_is_client_error":
        assert got["observed"][0][0] == 400 and c["client_errors"] == 1 and c["failed"] == 0
    elif case == "heartbeat_expiry_drops_worker":
        assert got["observed"] == [1, 0]
    elif case == "injected_forward_fault_fails_over":
        assert got["observed"] == [(200, 7.0, None)] and c["failover"] == 1
    assert got["events"]  # the fleet events were compared, not absent


def _audit_beat(ann, status):
    ann.beat(audit={"status": status, "cycles": 3,
                    "drift_probes": ["graphgen.layout"] if status == "drift" else []})


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_drifted_heartbeat_quarantines_and_clears(pkg, tmp_path):
    ann = fleet.WorkerAnnouncer(tmp_path, "http://127.0.0.1:1", host="w0")
    _audit_beat(ann, "drift")
    rt = PKGS[pkg][1].Router(tmp_path, poll_s=0.01)
    try:
        rt.refresh_workers(force=True)
        w = rt._workers["w0"]
        assert w.quarantined and rt._candidates() == []
        _audit_beat(ann, "pass")  # a clean heartbeat (worker restarted) re-admits it
        rt.refresh_workers(force=True)
        assert not w.quarantined and len(rt._candidates()) == 1
    finally:
        rt.close()


def test_healthz_reports_quarantine_as_the_reference(tmp_path):
    bad = fleet.WorkerAnnouncer(tmp_path, "http://127.0.0.1:1", host="w0")
    good = fleet.WorkerAnnouncer(tmp_path, "http://127.0.0.1:2", host="w1")
    _audit_beat(bad, "drift")
    _audit_beat(good, "pass")
    docs = []
    for mod in (router, jrouter):
        rt = mod.Router(tmp_path, poll_s=0.0)
        try:
            docs.append((rt.healthz(), {h: (w["quarantined"], w["audit"]["status"])
                                        for h, w in rt.statz()["workers"].items()},
                         rt.prometheus()))
        finally:
            rt.close()
    assert docs[0] == docs[1]
    doc = docs[0][0]
    assert doc["status"] == "degraded" and doc["quarantined"] == 1 and doc["routable"] == 1
    assert any("quarantine" in r for r in doc["reasons"])


def test_fleet_rollups_equal_reference(tmp_path):
    """The statz/prometheus roll-ups of the workers' prewarm and flight
    blocks, and the absent-when-off contract."""
    a = fleet.WorkerAnnouncer(tmp_path, "http://127.0.0.1:1", host="w0")
    b = fleet.WorkerAnnouncer(tmp_path, "http://127.0.0.1:2", host="w1")
    a.beat()
    b.beat()
    off = []
    for mod in (router, jrouter):
        rt = mod.Router(tmp_path, poll_s=0.0)
        try:
            s = rt.statz()
            off.append(("prewarm" in s, "flight" in s, "demand" in s,
                        "sbr_prewarm" in rt.prometheus()))
        finally:
            rt.close()
    assert off == [(False, False, False, False)] * 2
    a.beat(prewarm={"status": "sweeping", "plan": "f1", "tiles_done": 2, "tiles_total": 5,
                    "abandoned": 0},
           flight={"dispatches": 10, "dropped_records": 1, "device_busy_frac": 0.5})
    b.beat(prewarm={"status": "done", "plan": "f1", "tiles_done": 3, "tiles_total": 5,
                    "abandoned": 1},
           flight={"dispatches": 30, "dropped_records": 0, "device_busy_frac": 0.9})
    docs = []
    for mod in (router, jrouter):
        rt = mod.Router(tmp_path, poll_s=0.0)
        try:
            s = rt.statz()
            docs.append((s["prewarm"], s["flight"], rt.prometheus()))
        finally:
            rt.close()
    assert docs[0] == docs[1]
    assert docs[0][0]["plans"]["f1"]["tiles_done"] == 5 and docs[0][0]["status"] == "sweeping"
    assert docs[0][1]["device_busy_frac"] == 0.8


def test_router_main_serves_and_finalizes(tmp_path):
    """``python -m sbr_tpu_torch.serve.router``: the readiness line, a
    routed query, then SIGTERM: exit 143, the final fleet.json written and
    the router's run finalized by its close (as the reference's is)."""
    log: list = []
    stub = _StubWorker(tmp_path / "fleet", "w1", log, xi=3.0)
    proc = subprocess.Popen([sys.executable, "-m", "sbr_tpu_torch.serve.router", "--fleet-dir",
                             str(tmp_path / "fleet"), "--run-dir", str(tmp_path / "run")],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        ready = json.loads(proc.stdout.readline())
        req = urllib.request.Request(ready["url"] + "/query", data=b'{"beta": 1.0, "u": 0.1}',
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["xi"] == 3.0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        stub.close()
    snap = json.loads((tmp_path / "run" / "fleet.json").read_text())
    assert snap["counters"]["completed"] == 1 and log == [("w1", None)]
    manifest = json.loads((tmp_path / "run" / "manifest.json").read_text())
    assert manifest["status"] == "complete"
    assert manifest["fleet"]["worker_join"] == 1


# ---------------------------------------------------------------------------
# The worker process
# ---------------------------------------------------------------------------


def test_sigterm_drains_heartbeat_and_finalizes_interrupted(tmp_path):
    fleet_dir, run_dir = tmp_path / "fleet", tmp_path / "wrun"
    w = loadgen.spawn_worker(str(fleet_dir), n_grid=64, bisect_iters=20, buckets="1",
                             run_dir=str(run_dir), device="cpu", heartbeat_ttl=60.0,
                             timeout_s=TIMEOUT)
    try:
        assert w["device"] == "cpu"
        assert list(fleet_dir.glob("host_*.hb"))  # announced
        os.kill(w["pid"], signal.SIGTERM)
        assert w["proc"].wait(timeout=60) == 143  # 128 + SIGTERM
        # the heartbeat was withdrawn at the drain: peers reclaim at once
        assert not list(fleet_dir.glob("host_*.hb"))
        manifest = json.loads((run_dir / "manifest.json").read_text())
        assert manifest["status"] == "interrupted"
    finally:
        if w["proc"].poll() is None:
            w["proc"].kill()
            w["proc"].wait(timeout=TIMEOUT)


def test_worker_without_a_card_exits_and_spawn_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device starts")
    proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.serve.fleet", "--fleet-dir",
                           str(tmp_path / "f")], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=str(REPO))
    assert proc.returncode == 2 and "device='cpu'" in proc.stderr
    assert not list((tmp_path / "f").glob("host_*.hb"))  # never announced
    with pytest.raises(RuntimeError, match="exit code 2"):
        loadgen.spawn_worker(str(tmp_path / "g"), 64, 20, "1", timeout_s=TIMEOUT)


def test_loadgen_fleet_setup_failure_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device starts")
    assert loadgen.main(["--fleet", "1", "--queries", "2", "--pool", "2"]) == 2
    assert "fleet setup failed" in capsys.readouterr().err


def test_loadgen_history_needs_fleet(capsys):
    assert loadgen.main(["--history", "--device", "cpu"]) == 2
    assert "--history needs --fleet" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# One CPU fleet of two port workers
# ---------------------------------------------------------------------------


def _fleet_argv(root: Path, name: str, *extra) -> list:
    return ["--fleet", "2", "--device", "cpu", "--queries", str(SHAPE["queries"]),
            "--pool", str(SHAPE["pool"]), "--group", str(SHAPE["group"]),
            "--n-grid", str(SHAPE["n_grid"]), "--bisect-iters", str(SHAPE["bisect_iters"]),
            "--buckets", SHAPE["buckets"], "--seed", str(SHAPE["seed"]),
            "--run-dir", str(root / name), "--answers-out", str(root / f"{name}.json"), *extra]


@pytest.fixture(scope="module")
def cpu_fleet(tmp_path_factory):
    """A clean and a killed ``loadgen --fleet 2 --device cpu`` run, each a
    process (so its workers inherit one intra-op thread), with their
    summaries and answers."""
    root = tmp_path_factory.mktemp("fleet")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "SBR_OBS_HISTORY": str(root / "history.jsonl")}
    out = {}
    for name, extra in (("clean", ["--history"]), ("killed", ["--fleet-kill-after", "8"])):
        proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.serve.loadgen",
                               *_fleet_argv(root, name, *extra)], capture_output=True,
                              text=True, timeout=TIMEOUT, cwd=str(REPO), env=env)
        out[name] = (proc.returncode, json.loads(proc.stdout.strip().splitlines()[-1]),
                     json.loads((root / f"{name}.json").read_text()))
    out["root"] = root
    return out


def _pool_answers(engine_cls, cfg, serve_cfg, **kw) -> list:
    pool = loadgen.build_pool(SHAPE["seed"], SHAPE["pool"])
    mix = loadgen.query_mix(SHAPE["seed"], SHAPE["pool"], SHAPE["queries"])
    eng = engine_cls(config=cfg, serve=serve_cfg, **kw)
    try:
        res = eng.query_many(pool)
    finally:
        eng.close()
    return [res[i] for i in mix]


def test_fleet_answers_equal_in_process_engines(cpu_fleet):
    from sbr_tpu.models.params import SolverConfig as JCfg
    from sbr_tpu.serve.engine import Engine as JEngine
    from sbr_tpu.serve.engine import ServeConfig as JServe
    from sbr_tpu_torch.serve import Engine, ServeConfig

    rc, summary, answers = cpu_fleet["clean"]
    assert rc == 0 and summary["failures"] == [] and summary["fleet_lost"] == 0
    assert summary["answered"] == SHAPE["queries"] and summary["device"] == "cpu"
    cfg = tparams.SolverConfig(n_grid=SHAPE["n_grid"], bisect_iters=SHAPE["bisect_iters"],
                               refine_crossings=False)
    port = _pool_answers(Engine, cfg, ServeConfig(buckets=(1, 8)), device="cpu")
    ref = _pool_answers(JEngine, JCfg(n_grid=SHAPE["n_grid"], bisect_iters=SHAPE["bisect_iters"],
                                      refine_crossings=False), JServe(buckets=(1, 8)))
    from sbr_tpu_torch.serve.endpoint import query_result_doc

    for a, p, r in zip(answers, port, ref):
        doc = query_result_doc(p)
        for f in ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual"):
            assert a[f] == doc[f], f  # bit for bit: JSON floats round-trip exactly
        assert (a["status"], a["flags"]) == (int(r.status), int(r.flags))
        for f in ("xi", "tau_bar_in", "aw_max"):
            got, want = getattr(p, f), float(getattr(r, f))
            assert np.isnan(got) == np.isnan(want)
            if not np.isnan(want):
                assert abs(got - want) <= FLOAT_TOL


def test_fleet_summary_and_history(cpu_fleet):
    from sbr_tpu_torch.obs import history

    _, summary, _ = cpu_fleet["clean"]
    for key in ("fleet_p99_ms", "fleet_p50_ms", "fleet_qps", "fleet_failover_count",
                "fleet_shed_rate", "fleet_lost", "workers_ready_s"):
        assert summary[key] is not None, key
    assert summary["router_counters"]["completed"] == SHAPE["queries"] + SHAPE["pool"]
    recs = history.load(cpu_fleet["root"] / "history.jsonl")
    assert len(recs) == 1 and recs[0]["platform"] == "cpu"
    assert recs[0]["label"] == "loadgen_fleet" and recs[0]["schema"] >= 7
    assert {"fleet_p99_ms", "fleet_failover_count", "fleet_shed_rate"} <= set(recs[0]["metrics"])


def test_fleet_kill_is_byte_identical_with_none_lost(cpu_fleet):
    rc, summary, answers = cpu_fleet["killed"]
    assert rc == 0 and summary["fleet_lost"] == 0 and summary["failures"] == []
    assert summary["killed_worker"]
    assert summary["fleet_failover_count"] >= 1
    clean = cpu_fleet["clean"][2]
    assert answers == [{**a, "latency_ms": b["latency_ms"], "source": b["source"]}
                       for a, b in zip(clean, answers)]


def test_report_fleet_reads_the_router_runs(cpu_fleet, capsys):
    from sbr_tpu.obs import report as jreport
    from sbr_tpu_torch.obs import report

    root = cpu_fleet["root"]
    for name in ("clean", "killed"):
        docs = []
        for main in (report.main, jreport.main):
            code = main(["fleet", str(root / name), "--json"])
            doc = json.loads(capsys.readouterr().out)
            doc.pop("snapshot")
            docs.append((code, doc))
        assert docs[0] == docs[1] and docs[0][0] == 0
        assert docs[0][1]["lost"] == 0
    # the dead worker's breaker is open in the killed run's final snapshot
    code = report.main(["fleet", str(root / "killed"), "--stuck-after-s", "0.000001"])
    assert code == 1 and "GATE: FLEET BREACH" in capsys.readouterr().out
    workers = sorted((root / "clean_workers").iterdir())
    assert [w.name for w in workers] == ["w0", "w1"]
    assert all(json.loads((w / "manifest.json").read_text())["status"] == "interrupted"
               for w in workers)


@pytest.fixture(scope="module")
def pop_worker(tmp_path_factory):
    """One worker process on the CPU at the population config, and the
    router in front of it."""
    root = tmp_path_factory.mktemp("popfleet")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        w = loadgen.spawn_worker(str(root / "fleet"), POP_GRID, 40, "1", device="cpu",
                                 heartbeat_ttl=600, timeout_s=TIMEOUT)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    rt = router.Router(root / "fleet", poll_s=0.05).start()
    try:
        yield rt
    finally:
        rt.close()
        loadgen.stop_workers([w])


@pytest.mark.parametrize("channel", ["gossip", "bayes"])
def test_routed_population_equals_in_process(pop_worker, channel):
    from sbr_tpu_torch.serve import Engine

    fig12 = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25}
    pop = {"graph": {"model": "erdos_renyi", "n": 300, "avg_degree": 6.0},
           "infomodel": {"channel": channel}, "seeds": 2, "vary": "sim", "g0": None}
    code, body, _ = loadgen.http_request(pop_worker.port, "/query",
                                         {**fig12, "population": pop}, timeout=TIMEOUT)
    assert code == 200, body
    got = json.loads(body)
    eng = Engine(config=tparams.SolverConfig(n_grid=POP_GRID, bisect_iters=40,
                                             refine_crossings=False), device="cpu")
    try:
        want = eng.query_population(tparams.make_model_params(**fig12), pop)
    finally:
        eng.close()
    drop = ("latency_ms", "source", "trace_id")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
    assert got["source"] == "computed" and len(got["crossing_times"]) == 2
