"""The port's trace registry and profiler capture (sbr_tpu_torch.obs.prof)
on the CPU, mirroring tests/test_prof.py where it is not XLA's.

- The retrace detector: a program fed churning shapes counts a trace per
  new abstract signature, and once the within-run count passes its budget
  each further trace lands a ``retrace`` event with the running count (the
  reference's counts on the same churn); stable shapes stay quiet.
- `note_trace` counts without a run; the budget env is the reference's.
- `profile` off is a no-op; a capture on the CPU records a summary inside
  the run directory; the size bound prunes.
- The compile block says ``monitoring: false`` (no compile listeners).
- Solver outputs are bit for bit the same under ``SBR_OBS_PROFILE=1``.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.obs import prof as jprof  # noqa: E402
from sbr_tpu_torch import obs  # noqa: E402
from sbr_tpu_torch.obs import prof  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_active_run():
    assert obs.current_run() is None
    was_on = obs.metrics.metrics().enabled
    yield
    while obs.end_run() is not None:
        pass
    (obs.metrics.metrics().enable if was_on else obs.metrics.metrics().disable)()


def _events(run_dir):
    return [json.loads(line) for line in (Path(run_dir) / "events.jsonl").read_text().splitlines()]


# -- retrace detector --------------------------------------------------------


def test_retrace_detector_counts_shape_churn_as_the_reference(tmp_path):
    def f(x):
        prof.note_call("test_torch_prof.churn", x, budget=2)
        return (x * 2.0).sum()

    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        vals = [float(f(torch.arange(float(n), dtype=torch.float64))) for n in (2, 3, 4, 5)]
    assert vals == [float(sum(2.0 * i for i in range(n))) for n in (2, 3, 4, 5)]
    retraces = [e for e in _events(run.run_dir) if e["kind"] == "retrace"]

    @jax.jit
    def g(x):
        jprof.note_trace("test_torch_prof.churn_ref", budget=2)
        return (x * 2.0).sum()

    from sbr_tpu import obs as jobs

    with jobs.run_context(run_dir=str(tmp_path / "j")) as jrun:
        for n in (2, 3, 4, 5):
            float(g(jnp.arange(float(n))))
    jretraces = [e for e in _events(jrun.run_dir) if e["kind"] == "retrace"]
    assert [e["count"] for e in retraces] == [e["count"] for e in jretraces] == [3, 4]
    assert all(e["name"] == "test_torch_prof.churn" and e["budget"] == 2 for e in retraces)
    assert set(retraces[0]) == set(jretraces[0])
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["retraces"]["test_torch_prof.churn"] == {
        "traces": 4, "budget": 2, "over_budget": True}


def test_retrace_detector_quiet_on_stable_shapes(tmp_path):
    def f(x):
        prof.note_call("test_torch_prof.stable", x, budget=1)
        return x.sum()

    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        for _ in range(5):
            f(torch.arange(7.0))
    assert not [e for e in _events(run.run_dir) if e["kind"] == "retrace"]
    assert prof.trace_counts()["test_torch_prof.stable"] == 1


def test_signature_sees_dtype_device_and_plain_values():
    a = prof.abstract_signature(torch.zeros(3), 1.0, "x")
    assert a == prof.abstract_signature(torch.ones(3), 1.0, "x")
    assert a != prof.abstract_signature(torch.zeros(3, dtype=torch.float64), 1.0, "x")
    assert a != prof.abstract_signature(torch.zeros(4), 1.0, "x")
    assert a != prof.abstract_signature(torch.zeros(3), 2.0, "x")


def test_note_trace_counts_without_run(monkeypatch):
    prof.reset_trace_counts()
    assert prof.note_trace("a") == 1
    assert prof.note_trace("a") == 2
    assert prof.trace_counts() == {"a": 2}
    monkeypatch.setenv("SBR_OBS_RETRACE_BUDGET", "7")
    assert prof.trace_budget("a") == 7 == jprof.trace_budget("never_seen_name")
    prof.reset_trace_counts()
    assert prof.trace_counts() == {}


def test_capture_counts_as_a_trace_and_as_compile_time(tmp_path):
    prof.reset_trace_counts()
    before = prof.capture_totals()
    prof.note_capture("serve.bucket", 0.25)
    after = prof.capture_totals()
    assert after["captures"] == before["captures"] + 1
    assert after["seconds"] == pytest.approx(before["seconds"] + 0.25)
    assert prof.trace_counts() == {"serve.bucket": 1}
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        obs.jit_call("captures", lambda x: (prof.note_capture("p", 0.5), x)[1], torch.ones(2))
    (ev,) = [e for e in _events(run.run_dir) if e["kind"] == "jit_call"]
    assert ev["compile_s"] == pytest.approx(0.5)


def test_compile_block_says_no_monitoring(tmp_path):
    assert prof.monitoring_available() is False
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with obs.span("compile_here"):
            pass
    xla = json.loads((run.run_dir / "manifest.json").read_text())["xla"]
    assert xla["monitoring"] is False and xla["compiles"] == 0 and xla["by_span"] == {}


# -- profiler capture --------------------------------------------------------


def test_profile_disabled_is_noop(tmp_path, monkeypatch):
    monkeypatch.delenv("SBR_OBS_PROFILE", raising=False)
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with obs.profile("nope") as trace_dir:
            assert trace_dir is None
    assert not [e for e in _events(run.run_dir) if e["kind"] == "profile"]
    assert json.loads((run.run_dir / "manifest.json").read_text())["profiles"] is None


def test_profile_capture_records_summary(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_OBS_PROFILE", "1")
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with obs.profile("cap") as trace_dir:
            assert trace_dir is not None
            with obs.annotate("stage"), obs.step_annotation(0, "rep"):
                float((torch.arange(32.0) * 2.0).sum())
    (ev,) = [e for e in _events(run.run_dir) if e["kind"] == "profile"]
    assert ev["label"] == "cap"
    assert ev["files"] > 0 and ev["bytes"] > 0 and ev["pruned"] is False
    assert ev["window_s"] > 0.0
    # the capture lives INSIDE the run dir, so run retention prunes it too
    assert str(run.run_dir) in ev["trace_dir"]
    trace = json.loads((Path(ev["trace_dir"]) / "trace.json").read_text())
    names = {e.get("name") for e in trace.get("traceEvents", [])}
    assert {"stage", "rep#0"} <= names
    manifest = json.loads((run.run_dir / "manifest.json").read_text())
    assert manifest["profiles"][0]["label"] == "cap"


def test_profile_size_bound_prunes_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("SBR_OBS_PROFILE", "1")
    monkeypatch.setenv("SBR_OBS_PROFILE_MAX_MB", "0.0001")  # ~100 bytes
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with obs.profile("big"):
            float((torch.arange(32.0) * 2.0).sum())
    (ev,) = [e for e in _events(run.run_dir) if e["kind"] == "profile"]
    assert ev["pruned"] is True
    assert not Path(ev["trace_dir"]).exists()


def test_timing_trace_writes_a_chrome_trace(tmp_path):
    from sbr_tpu_torch.obs.timing import trace

    with trace(str(tmp_path / "t")):
        float(torch.ones(8).sum())
    assert json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]


# -- acceptance: the observatory perturbs nothing ----------------------------


def test_solver_outputs_identical_under_profiling_env(tmp_path, monkeypatch):
    """The sweep and the fixed point solved with SBR_OBS_PROFILE=1 (span
    annotations on) are bit for bit the plain path."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.obs.timing import tensor_leaves
    from sbr_tpu_torch.social.solver import solve_equilibrium_social
    from sbr_tpu_torch.sweeps import beta_u_grid

    m = make_model_params()
    m12 = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    cfg = SolverConfig(n_grid=96, bisect_iters=30, refine_crossings=False)
    betas, us = np.array([0.5, 1.0]), np.array([0.05, 0.5])

    def solve():
        return (beta_u_grid(betas, us, m, config=cfg, device=CPU),
                solve_equilibrium_social(m12, SolverConfig(n_grid=128, bisect_iters=30),
                                         max_iter=10, device=CPU))

    plain = solve()
    monkeypatch.setenv("SBR_OBS_PROFILE", "1")
    with obs.run_context(run_dir=str(tmp_path / "r")):
        with obs.profile("solve"):
            profiled = solve()
    for a, b in zip(tensor_leaves(plain), tensor_leaves(profiled)):
        assert torch.equal(a.nan_to_num(3.0), b.nan_to_num(3.0))
