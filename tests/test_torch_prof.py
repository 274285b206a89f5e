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
- The ranges (`annotate`, `step_annotation`, spans) fire whenever a torch
  profiler records, whoever started it, also in a program region or with
  no run (then with no event), and create nothing when none records.
- Solver and agent outputs are bit for bit the same under
  ``SBR_OBS_PROFILE=1``.
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


# -- ranges: on while any torch profiler records ------------------------------


def _range_names(p, prefix=""):
    return [e.name() for e in p.profiler.kineto_results.events() if e.name().startswith(prefix)]


def _count_record_functions(monkeypatch):
    """Count every record function made from here on, of either kind."""
    made = []
    for owner, name in ((torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (torch._C._profiler, "_RecordFunctionFast")):
        def counted(*args, _real=getattr(owner, name), **kwargs):
            made.append(args)
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)
    return made


def test_ranges_are_host_operations_not_user_annotations(monkeypatch):
    """A range is a host operation of the trace (``cpu_op``), as an aten
    operation is: the CUDA profiler copies user annotations to the device's
    timeline, where trace readers would count them as kernels."""
    from torch.profiler import ProfilerActivity, profile

    made = _count_record_functions(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with obs.annotate("stage.host"):
            float(torch.ones(4).sum())
    assert made == [("stage.host",)]
    (event,) = [e for e in p.profiler.kineto_results.events() if e.name() == "stage.host"]
    assert not event.is_user_annotation()


def test_annotate_fires_under_a_bare_profiler(monkeypatch):
    """Another profiler than `obs.profile`, with SBR_OBS_PROFILE unset and
    no run active, still gets the ranges."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("SBR_OBS_PROFILE", raising=False)
    assert not prof.ranges_on()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        assert prof.ranges_on()
        with obs.annotate("stage.outer"), obs.step_annotation(3, "stage.rep"):
            float(torch.ones(4).sum())
    assert not prof.ranges_on()
    assert sorted(_range_names(p, "stage.")) == ["stage.outer", "stage.rep#3"]


def test_annotate_makes_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setenv("SBR_OBS_PROFILE", "1")  # the capture's switch, not the ranges'
    made = _count_record_functions(monkeypatch)
    with obs.annotate("stage"), obs.step_annotation(0), obs.span("stage.span") as sp:
        sp.sync(torch.ones(2))
    mark = prof.ranges()
    with mark("a"), mark("b"):
        pass
    assert made == []
    assert prof.annotate("x") is prof.annotate("y") is mark("c")  # one shared null context


def test_span_in_a_program_gives_a_range_and_no_event(tmp_path):
    """Inside a program region, or with no run, `obs.span` writes no event,
    pushes no span name and fences nothing, but the profiler sees it."""
    from torch.profiler import ProfilerActivity, profile

    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with obs.program(), obs.span("stage.in_program") as sp:
                assert sp is obs.runlog._NULL_SPAN and obs.active_span() is None
                float(torch.ones(4).sum())
            with obs.span("stage.in_run"):
                float(torch.ones(4).sum())
    with profile(activities=[ProfilerActivity.CPU]) as q:
        with obs.span("stage.no_run") as sp:
            assert sp is obs.runlog._NULL_SPAN
    stages = [e.get("stage") for e in _events(run.run_dir) if e["kind"].startswith("stage")]
    assert stages == ["stage.in_run", "stage.in_run"]
    assert sorted(_range_names(p, "stage.")) == ["stage.in_program", "stage.in_run"]
    assert _range_names(q, "stage.") == ["stage.no_run"]


def test_range_names_never_begin_with_cu():
    """Trace readers take host events named ``cu…`` for the CUDA runtime's
    calls: no span or range the port names may begin so."""
    import re

    root = Path(__file__).resolve().parents[1] / "sbr_tpu_torch"
    pattern = re.compile(r"""(?:\bspan|annotate|step_annotation|mark)\(\s*f?["']([^"']+)["']""")
    names = {m for f in root.rglob("*.py") for m in pattern.findall(f.read_text())}
    assert {"agents.step", "agents.sync", "baseline.xi", "sweeps.beta_u_grid"} <= names
    assert not [n for n in names if n.startswith("cu")]


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


@pytest.mark.parametrize("engine", ["gather", "incremental", "info"])
def test_agents_identical_under_profiling_env(tmp_path, monkeypatch, engine):
    """A simulation in either engine, its step loop's ranges on under the
    profiler, is bit for bit the plain run (a small change budget makes the
    incremental engine recount fully on some steps); so is a rewired bayes
    information model (``info``), its epoch and step ranges on."""
    from sbr_tpu_torch.obs.timing import tensor_leaves
    from sbr_tpu_torch.social import agents as ta

    src, dst = ta.erdos_renyi_edges(1500, 8.0, seed=2)
    cfg = ta.AgentSimConfig(n_steps=30, dt=0.1, exit_delay=0.5, reentry_delay=2.0)
    budget = 6 if engine == "incremental" else None

    def simulate():
        if engine == "info":
            return _rewired_bayes(cfg)
        return ta.simulate_agents(1.0, src, dst, 1500, x0=0.01, config=cfg, seed=5,
                                  engine=engine, incremental_budget=budget, device=CPU)

    plain = simulate()
    monkeypatch.setenv("SBR_OBS_PROFILE", "1")
    with obs.run_context(run_dir=str(tmp_path / "r")):
        with obs.profile("simulate") as trace_dir:
            assert trace_dir is not None and prof.ranges_on()
            profiled = simulate()
    if engine == "info":
        assert plain.epochs == profiled.epochs == 5 and plain.belief is not None
    else:
        assert 0 < int(plain.full_recount_steps.sum()) <= cfg.n_steps
    for a, b in zip(tensor_leaves(plain), tensor_leaves(profiled)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _rewired_bayes(cfg):
    from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

    spec = InfoModelSpec(channel="bayes", dynamics="rewire", epoch_steps=7)
    return simulate_info(spec, ErdosRenyiSpec(n=1500, avg_degree=8.0), x0=0.01, config=cfg,
                         seed=5, device=CPU)
