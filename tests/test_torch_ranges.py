"""The profiler ranges inside the port's hot paths, on the CPU: the step
loop of both agent engines (`social.agents._run_engine`) and its prologue,
the epoch and step loops of a rewired bayes information model
(`infomodels.engine`'s ``info.*`` ranges), and the stages of a β×u grid tile (`sweeps.beta_u_grid` with the solver's
``baseline.*`` spans, silent as run-log spans inside the program). The
benchmark's per-layer readers count and time these ranges, so their
number, names and nesting are held here; with no profiler recording the
paths create no range and query the profiler's state once a call.
"""

import collections
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig, make_model_params  # noqa: E402
from sbr_tpu_torch.obs import prof  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402
from sbr_tpu_torch.sweeps import beta_u_grid  # noqa: E402

CPU = "cpu"
N, STEPS = 2000, 30
CFG = ta.AgentSimConfig(n_steps=STEPS, dt=0.1, exit_delay=0.5, reentry_delay=2.0)
ENGINES = {"gather": {}, "incremental": {"incremental_budget": 6}}
# a rewired bayes run whose epoch length does not divide its steps
REWIRE = InfoModelSpec(channel="bayes", dynamics="rewire", epoch_steps=7)


@pytest.fixture(scope="module")
def graph():
    return ta.erdos_renyi_edges(N, 8.0, seed=1)


def _simulate(graph, engine):
    src, dst = graph
    return ta.simulate_agents(1.0, src, dst, N, x0=0.01, config=CFG, seed=3, engine=engine,
                              device=CPU, **ENGINES[engine])


def _grid():
    return beta_u_grid(np.array([0.5, 1.0, 2.0]), np.array([0.05, 0.5]), make_model_params(),
                       config=SolverConfig(n_grid=96, bisect_iters=30, refine_crossings=False),
                       device=CPU)


def _rewire():
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

    return simulate_info(REWIRE, ErdosRenyiSpec(n=N, avg_degree=8.0), x0=0.01, config=CFG,
                         seed=3, device=CPU)


def _ranges(p, prefixes):
    """(name, start ns, end ns) of the capture's host events so named."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in p.profiler.kineto_results.events()
            if e.name().startswith(prefixes)]


def _inside(inner, outers):
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_step_loop_ranges(graph, engine):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r = _simulate(graph, engine)
    ranges = _ranges(p, ("agents.",))
    counts = collections.Counter(name for name, _, _ in ranges)
    recounts = int(r.full_recount_steps.sum())
    assert counts["agents.prologue"] == 1
    assert counts["agents.step"] == counts["agents.counts"] == counts["agents.infection"] == STEPS
    assert counts["agents.recount_full"] == recounts
    if engine == "gather":
        assert recounts == STEPS and counts["agents.sync"] == 0
    else:
        # the budget forces the fallback on some steps and not on others
        assert 0 < recounts < STEPS and counts["agents.sync"] == 2 * STEPS
    by = collections.defaultdict(list)
    for rng in ranges:
        by[rng[0]].append(rng)
    steps = by["agents.step"]
    (prologue,) = by["agents.prologue"]
    assert prologue[2] <= min(s for _, s, _ in steps)
    for name in ("agents.counts", "agents.infection", "agents.sync"):
        assert all(_inside(rng, steps) for rng in by[name]), name
    assert all(_inside(rng, by["agents.counts"]) for rng in by["agents.recount_full"])
    # the overflow flag's first read is inside the counts, its second after them
    inside = [_inside(rng, by["agents.counts"]) for rng in by["agents.sync"]]
    assert inside == [True, False] * (len(inside) // 2)


def test_rewired_bayes_epoch_and_step_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r = _rewire()
    ranges = _ranges(p, ("info.",))
    counts = collections.Counter(name for name, _, _ in ranges)
    epochs = math.ceil(STEPS / REWIRE.epoch_steps)
    assert r.epochs == epochs == 5
    for name in ("info.epoch", "info.regen", "info.indegrees", "info.sources", "info.sync"):
        assert counts[name] == epochs, name
    for name in ("info.step", "info.counts", "info.belief"):
        assert counts[name] == STEPS, name
    by = collections.defaultdict(list)
    for rng in ranges:
        by[rng[0]].append(rng)
    for name in ("info.regen", "info.step", "info.sync"):
        assert all(_inside(rng, by["info.epoch"]) for rng in by[name]), name
    for name in ("info.indegrees", "info.sources"):
        assert all(_inside(rng, by["info.regen"]) for rng in by[name]), name
    for name in ("info.counts", "info.belief"):
        assert all(_inside(rng, by["info.step"]) for rng in by[name]), name
    # each epoch rebuilds its graph before its steps, and fences after them
    for epoch, regen, sync in zip(by["info.epoch"], by["info.regen"], by["info.sync"]):
        steps = [rng for rng in by["info.step"] if _inside(rng, [epoch])]
        assert steps and regen[2] <= min(s for _, s, _ in steps)
        assert sync[1] >= max(e for _, _, e in steps)
    assert sum(len([s for s in by["info.step"] if _inside(s, [ep])])
               for ep in by["info.epoch"]) == STEPS


def test_grid_stage_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _grid()
    ranges = _ranges(p, ("sweeps.", "baseline."))
    counts = collections.Counter(name for name, _, _ in ranges)
    assert counts["sweeps.beta_u_grid"] == counts["baseline.hazard"] == 1
    assert counts["baseline.buffers"] == counts["baseline.xi"] == 1
    tile = [rng for rng in ranges if rng[0] == "sweeps.beta_u_grid"]
    assert all(_inside(rng, tile) for rng in ranges if rng[0].startswith("baseline."))


def test_rewired_bayes_makes_no_range_without_a_profiler(monkeypatch):
    made = []

    def counted(*args, **kwargs):
        made.append(args)
        raise AssertionError("a range was made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    r = _rewire()
    assert made == [] and r.epochs == 5


@pytest.mark.parametrize("path", ["gather", "incremental", "grid"])
def test_no_range_and_one_query_a_call_without_a_profiler(graph, monkeypatch, path):
    """With no profiler recording, neither path creates a record function;
    a simulation asks the profiler's state twice (its prologue, its step
    loop), not once a step."""
    made, queries = [], []
    real_on = prof.ranges_on

    def counted(*args, **kwargs):
        made.append(args)
        raise AssertionError("a range was made with no profiler recording")

    def on():
        queries.append(1)
        return real_on()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    monkeypatch.setattr(prof, "ranges_on", on)
    if path == "grid":
        _grid()
        assert made == [] and queries
    else:
        _simulate(graph, path)
        assert made == [] and len(queries) == 2


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_one_query_a_call_while_a_profiler_records(graph, monkeypatch, engine):
    """While a profiler records, the loop's ranges do not ask again: two
    queries a simulation, as with none recording."""
    queries = []
    real_on = prof.ranges_on

    def on():
        queries.append(1)
        return real_on()

    monkeypatch.setattr(prof, "ranges_on", on)
    with profile(activities=[ProfilerActivity.CPU]):
        _simulate(graph, engine)
    assert len(queries) == 2
