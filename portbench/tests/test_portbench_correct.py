"""The comparison that decides `correct`, at sizes a CPU test holds: the
plain references against the program, the control (the reference in the
type below the configuration's, in the program's place) coming out not
correct, and whole runs with the timed path broken coming out not correct.

    python -m pytest portbench/tests -q
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from harness.cell import load_cell  # noqa: E402
from harness.core import execute  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 12345


def tiny(name: str):
    """The cell ``name`` cut to a CPU test's size: 40×40 grid cells in
    tiles of 20×20, or 20,000 agents for 60 steps from x0 = 10^-3. Its
    traffic, numerics and limits stay the workload file's."""
    cell = load_cell(ROOT, name)
    if name.startswith("paper_grid"):
        cell.config["beta_axis"]["points"] = cell.config["u_axis"]["points"] = 40
        cell.config["tile"] = [20, 20]
        cell.workload["warm_tiles"] = [[0, 0]]
        cell.workload["trace_from_below"] = 2
    else:
        cell.config["n_agents"] = 20_000
        cell.config["sim"].update(n_steps=60, x0=1e-3)
    return cell


def run(cell, seed=SEED, seconds=0.3):
    return execute(cell, seed, seconds, False, CPU, time.perf_counter())


# -- the references against the program -------------------------------------


def test_grid_reference_equals_the_program_in_float64():
    """At float64 the program and the reference read the same semantics:
    every status equal, ξ and AW_max within 10^-7."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.models.params import SolverConfig

    cell = load_cell(ROOT, "paper_grid.fixed")
    ref = cell.reference()
    drv = cell.driver()
    betas, us = drv.axes(cell.config)
    rng = np.random.default_rng(0)
    b = np.sort(betas[rng.choice(betas.size, 12, replace=False)])
    u = np.sort(us[rng.choice(us.size, 20, replace=False)])
    m = cell.config["model"]
    base = st.make_model_params(beta=m["beta"], eta_bar=m["eta_bar"], u=m["u"], p=m["p"],
                                kappa=m["kappa"], lam=m["lam"], x0=m["x0"])
    got = st.beta_u_grid(b, u, base, config=SolverConfig(refine_crossings=False,
                                                         numerics="fixed"),
                         dtype=torch.float64, device="cpu")
    inputs = drv.reference_inputs(dict(cell.config, dtype="float64", root_tol=1e-7))
    want = ref.solve_cells(b, u, inputs)
    assert np.array_equal(got.status.numpy(), want["status"])
    run_ = want["status"] == 0
    assert run_.sum() > 20
    np.testing.assert_allclose(got.xi.numpy()[run_], want["xi"][run_], rtol=1e-7)
    np.testing.assert_allclose(got.max_aw.numpy()[run_], want["aw_max"][run_], atol=1e-7)


def test_grid_reference_peak_is_the_peak_of_the_path():
    """AW_max from the candidate points equals the maximum of the path
    AW(t) = G(t) − G(t − ξ + τ_IN) + x0 sampled densely on [0, η]."""
    cell = load_cell(ROOT, "paper_grid.fixed")
    ref = cell.reference()
    inputs = cell.driver().reference_inputs(dict(cell.config, dtype="float64"))
    b = np.array([1.0, 2.5, 40.0])
    u = np.array([0.01, 0.05, 0.2])
    want = ref.solve_cells(b, u, inputs)
    x0, eta = inputs["x0"], inputs["eta"]
    t = np.linspace(0.0, eta, 400_001)
    G = lambda s, beta: x0 / (x0 + (1 - x0) * np.exp(-beta * s))  # noqa: E731
    knots, hazard = ref.hazard_rows(torch.tensor(b), inputs, torch.float64, "cpu")
    checked = 0
    for i, beta in enumerate(b):
        for j in range(len(u)):
            if want["status"][i, j] != 0:
                continue
            xi = want["xi"][i, j]
            # τ_IN from the reference's own crossing: G(ξ) − G(τ_IN) = κ
            g_in = G(xi, beta) - inputs["kappa"]
            t_in = (np.log(g_in / (1 - g_in)) - np.log(x0 / (1 - x0))) / beta
            d = xi - t_in
            path = G(t, beta) - np.where(t >= d, G(t - d, beta), 0.0) + x0
            assert want["aw_max"][i, j] >= path.max() - 1e-9
            assert want["aw_max"][i, j] <= path.max() + 1e-6
            checked += 1
    assert checked >= 3


def test_agent_reference_equals_the_program():
    """The reference's graph is the program's, and its float32 simulation
    the program's bit for bit, on either engine."""
    from sbr_tpu_torch.social.agents import AgentSimConfig, simulate_agents
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec, prepare_generated_graph

    cell = tiny("er_gossip.gather")
    ref = cell.reference()
    drv = cell.driver()
    sim = drv.sim_params(cell.config)
    n = cell.config["n_agents"]
    graph = ref.build_graph(n, 10.0, SEED, CPU)
    cfg = AgentSimConfig(n_steps=sim["n_steps"], dt=sim["dt"])
    for engine in ("gather", "incremental"):
        pg = prepare_generated_graph(ErdosRenyiSpec(n=n, avg_degree=10.0), seed=SEED,
                                     config=cfg, engine=engine, dtype=np.float32, device="cpu")
        assert torch.equal(pg.src.long(), graph["src"])
        seed = drv.sim_seed(SEED, 3)
        got = simulate_agents(prepared=pg, x0=sim["x0"], config=cfg, seed=seed)
        want = ref.simulate(graph, sim, seed)
        assert np.array_equal(got.informed.numpy(), want["informed_final"])
        assert np.array_equal(got.t_inf.double().numpy(), want["t_inf"])
        np.testing.assert_allclose(got.informed_frac.double().numpy(), want["informed"] / n,
                                   rtol=1e-6)
        assert want["frontier"].max() > 0


def test_threefry_matches_the_published_vector():
    """Threefry-2x32, 20 rounds: the Random123 known-answer vector for key
    and counter all ones."""
    ref = load_cell(ROOT, "er_gossip.gather").reference()
    m = 0xFFFFFFFF
    assert ref.threefry(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)


# -- sound runs, the control and the faults ----------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(tiny(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["paper_grid.fixed", "er_gossip.gather"])
def test_the_control_is_not_correct(name):
    """The calibration's readings: the program's within every limit, the
    reference computed in bfloat16 in the program's place past one."""
    from harness.cell import load_module

    calibrate = load_module(HERE / "calibrate.py", "portbench_calibrate")
    row = calibrate.readings(tiny(name), SEED, 0.3, CPU, control=True)
    limits = load_cell(ROOT, name).workload["limits"]
    assert row["control_dtype"] == "bfloat16"
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row


def test_a_grid_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import sbr_tpu_torch.sweeps.baseline_sweeps as sweeps

    solve = sweeps.beta_u_grid

    def altered(*args, **kwargs):
        g = solve(*args, **kwargs)
        i = int(torch.nonzero(g.status.reshape(-1) == 0)[0])
        g.xi.view(-1)[i] *= 1.001
        return g

    monkeypatch.setattr(sweeps, "beta_u_grid", altered)
    out = run(tiny("paper_grid.fixed"))
    assert not out["correct"] and out["checks"]["xi_gap"]["value"] > 5e-4


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    import sbr_tpu_torch.social.agents as agents

    monkeypatch.setattr(agents, "infection_update",
                        lambda informed, t_inf, *a, **k: (informed, t_inf))
    out = run(tiny("er_gossip.gather"))
    assert not out["correct"]


def test_an_agent_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import sbr_tpu_torch.social.agents as agents

    step = agents.infection_update

    def altered(*args, **kwargs):
        informed, t_inf = step(*args, **kwargs)
        t_inf = t_inf.clone()
        t_inf[7] = -1.0
        return informed, t_inf

    monkeypatch.setattr(agents, "infection_update", altered)
    out = run(tiny("er_gossip.incremental"))
    assert not out["correct"] and out["checks"]["state_mismatch"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = execute(load_cell(ROOT, name), SEED, 2.0, False, torch.device("cuda", 0),
                  time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
