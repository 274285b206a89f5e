"""The `er_bayes_rewire` configuration's benchmark parts on the CPU: its
plain reference against the program bit for bit, the control and a
fault coming out not correct, the belief step's bytes, the six readers
of the program's ``info.*`` ranges on synthetic captures, and the cell's
files.

    python -m pytest portbench/tests -q
"""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from harness.belief_bytes import belief_step_bytes  # noqa: E402
from harness.cell import load_cell, load_module  # noqa: E402
from harness.core import execute  # noqa: E402
from harness.trace import Capture  # noqa: E402

CPU = torch.device("cpu")
CELL = "er_bayes_rewire.epochs"
SEED = 2**31 + 12345
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("regen_ms_per_epoch.info", "indegree_ms_per_epoch.info",
           "sources_ms_per_epoch.info", "counts_ms_per_step.info",
           "belief_roofline_pct.info", "device_idle_pct.info")


def tiny(n=20_000, n_steps=60, epoch_steps=None, degree=None):
    """The cell cut to a CPU test's size: 20,000 agents for 60 steps (three
    epochs of 25, 25 and 10). Its traffic, spec and limits stay the files'."""
    cell = load_cell(ROOT, CELL)
    cell.config["n_agents"] = n
    cell.config["sim"]["n_steps"] = n_steps
    if epoch_steps is not None:
        cell.config["info"]["epoch_steps"] = epoch_steps
    if degree is not None:
        cell.config["avg_degree"] = degree
    return cell


def run(cell, seed=SEED, seconds=0.3):
    return execute(cell, seed, seconds, False, CPU, time.perf_counter())


# -- the reference against the program --------------------------------------


def test_the_reference_equals_the_program_bit_for_bit():
    """3,000 agents of degree 6, three epochs of five steps: the per-step
    counts, and the final informed flags, informed times and beliefs."""
    from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info
    from sbr_tpu_torch.social.agents import AgentSimConfig
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

    cell = tiny(n=3000, n_steps=15, epoch_steps=5, degree=6.0)
    cfg, sim = cell.config, cell.config["sim"]
    drv = cell.driver()
    seed = drv.sim_seed(SEED, 2)
    want = cell.reference().simulate(cfg, seed, CPU)
    got = simulate_info(InfoModelSpec(**cfg["info"]), ErdosRenyiSpec(n=3000, avg_degree=6.0),
                        x0=sim["x0"], config=AgentSimConfig(
                            n_steps=15, dt=sim["dt"], exit_delay=sim["exit_delay"],
                            reentry_delay=sim["reentry_delay"]),
                        seed=seed, dtype=np.float32, device="cpu")
    assert got.epochs == want["epochs"] == 3
    recip = np.float32(1) / np.float32(3000)
    for key, frac in (("informed", got.informed_frac), ("withdrawn", got.withdrawn_frac)):
        assert np.array_equal(frac.numpy(), want[key].astype(np.float32) * recip), key
    assert np.array_equal(got.informed.numpy(), want["informed_final"])
    assert np.array_equal(got.t_inf.double().numpy(), want["t_inf"])
    assert np.array_equal(got.belief.double().numpy(), want["belief"])
    # agents were informed in the run's steps, not only at its start
    assert want["informed"][-1] > want["informed"][1] > want["informed"][0] > 0


def test_the_tilt_table_saturates_and_follows_the_withdrawn():
    """The table's last entries are 2^32 − 1 (the saturating conversion),
    and a withdrawn agent's bucket is 1 + bias times a calm one's."""
    ref = load_cell(ROOT, CELL).reference()
    wd = torch.zeros(1000, dtype=torch.bool)
    wd[100:200] = True
    table = ref.tilt_table(wd, 4.0)
    assert int(table[-1]) == 2**32 - 1
    width = torch.diff(table).double()
    assert width[150] / width[500] == pytest.approx(5.0, rel=1e-4)
    # the blocked prefix is a prefix sum
    x = torch.rand(4099, dtype=torch.float64)
    assert torch.allclose(ref.blocked_prefix(x), torch.cumsum(x, 0))


def test_a_sound_run_is_correct_and_compares_three_numbers():
    out = run(tiny())
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"frac_gap", "state_mismatch", "belief_gap"}
    assert out["checks"]["state_mismatch"]["value"] == 0
    assert out["checks"]["belief_gap"]["value"] == 0


def test_the_bfloat16_control_is_not_correct():
    """The calibration's readings: the program's within every limit, the
    reference computed in bfloat16 in the program's place past one."""
    calibrate = load_module(HERE / "calibrate.py", "portbench_calibrate")
    row = calibrate.readings(tiny(), SEED, 0.3, CPU, control=True)
    limits = load_cell(ROOT, CELL).workload["limits"]
    assert row["control_dtype"] == "bfloat16"
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row


def test_an_epoch_whose_graph_is_not_redrawn_is_not_correct(monkeypatch):
    """Every epoch after the first gets the first epoch's graph: its
    in-degrees and, from the same key words, its sources."""
    import sbr_tpu_torch.social.graphgen as graphgen

    indegrees, key_words = graphgen.epoch_indegrees, graphgen.epoch_key_words
    sources, drawn = graphgen.generate_tilted_sources, {}

    def first_sources(n, e, words, table, chunk_edges=None):
        key = tuple(int(w) for w in words)
        if key not in drawn:
            drawn[key] = sources(n, e, words, table, chunk_edges)
        return drawn[key]

    monkeypatch.setattr(graphgen, "epoch_indegrees",
                        lambda spec, seed, epoch, e: indegrees(spec, seed, 0, e))
    monkeypatch.setattr(graphgen, "epoch_key_words", lambda seed, epoch: key_words(seed, 0))
    monkeypatch.setattr(graphgen, "generate_tilted_sources", first_sources)
    out = run(tiny())
    assert not out["correct"]
    assert out["checks"]["state_mismatch"]["value"] >= 1


def test_a_belief_step_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import sbr_tpu_torch.infomodels.engine as engine

    step = engine.belief_update

    def altered(*args, **kwargs):
        informed, t_inf, belief = step(*args, **kwargs)
        belief = belief.clone()
        belief[11] += 1e-3
        return informed, t_inf, belief

    monkeypatch.setattr(engine, "belief_update", altered)
    out = run(tiny())
    assert not out["correct"] and out["checks"]["belief_gap"]["value"] > 1e-5


# -- the belief step's bytes ---------------------------------------------------


def test_belief_bytes_count_only_what_the_step_must_move():
    # 10 agents of float32, none informed: 34 B each
    assert belief_step_bytes(10, 4, 10, 0) == 340
    # every agent informed before the step: neither awareness nor threshold
    assert belief_step_bytes(10, 4, 0, 0) == 10 * 26
    # 3 newly informed of 5 not informed: their informed times are not read
    assert belief_step_bytes(10, 4, 5, 3) == 10 * 22 + 7 * 4 + 5 * 8
    assert belief_step_bytes(10, 8, 10, 0) == 10 * 62


# -- the readers of the info.* ranges -----------------------------------------


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def _info_capture():
    # two epochs of one step each. Epoch 1: regen 100-400 (sources 120-200
    # launching kernels 1-2, indegrees 250-380), step 420-600 (counts
    # 430-500 launching 3, belief 520-560 launching 4), sync 600-620.
    # Epoch 2 the same 1000 ns later, with kernels 5-8.
    ops = []
    for base in (0, 1000):
        ops += [(base, base + 640, "info.epoch"), (base + 100, base + 400, "info.regen"),
                (base + 120, base + 200, "info.sources"),
                (base + 250, base + 380, "info.indegrees"),
                (base + 420, base + 600, "info.step"), (base + 430, base + 500, "info.counts"),
                (base + 520, base + 560, "info.belief"), (base + 600, base + 620, "info.sync")]
    launches, device = {}, []
    for i, base in enumerate((0, 1000)):
        c = 4 * i
        launches.update({c + 1: base + 130, c + 2: base + 150, c + 3: base + 440,
                         c + 4: base + 530})
        device += [(base + 140, base + 160, "k_threefry", c + 1),
                   (base + 170, base + 200, "k_searchsorted", c + 2),
                   (base + 450, base + 490, "k_cumsum", c + 3),
                   (base + 540, base + 550, "void belief_update_kernel<float>", c + 4)]
    return Capture(window_s=2e-6, device=device, launches=launches, ops=sorted(ops))


def _run(capture, **counters):
    reference = {"n": 1000, "float_bytes": 4, "not_informed": [1000, 900], "newly": [100, 50]}
    return SimpleNamespace(capture=capture, counters=counters, reference=reference,
                           device_kind=H100)


@pytest.mark.parametrize("name,want", [
    ("regen_ms_per_epoch.info", 300 / 1e6),
    ("indegree_ms_per_epoch.info", 130 / 1e6),
    ("sources_ms_per_epoch.info", (20 + 30) / 1e6),
    ("counts_ms_per_step.info", 40 / 1e6),
    ("belief_roofline_pct.info",
     100.0 * (belief_step_bytes(1000, 4, 1000, 100) + belief_step_bytes(1000, 4, 900, 50))
     / 3.35e12 / 20e-9),
    ("device_idle_pct.info", 100.0 * (1 - 200e-9 / 2e-6)),
])
def test_info_readers(name, want):
    run_ = _run(_info_capture(), epochs_traced=2, steps_traced=2)
    assert _reader(name).read(run_) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_info_readers_read_nothing_without_their_ranges(name):
    plain = Capture(window_s=1e-6, device=[(10, 20, "belief_update", 1)], launches={1: 5},
                    ops=[(0, 30, "aten::mul")])
    counters = {"epochs_traced": 2, "steps_traced": 2}
    assert _reader(name).read(_run(plain, **counters)) is None
    assert _reader(name).read(_run(None, **counters)) is None


@pytest.mark.parametrize("name", READERS)
def test_info_readers_refuse_a_divisor_the_run_disagrees_with(name):
    cap = _info_capture()
    assert _reader(name).read(_run(cap, epochs_traced=3, steps_traced=3)) is None
    assert _reader(name).read(_run(cap)) is None


def test_the_roofline_wants_a_belief_launch_a_step():
    cap = _info_capture()
    cap.device = [ev for ev in cap.device if ev[3] != 8]
    run_ = _run(cap, epochs_traced=2, steps_traced=2)
    assert _reader("belief_roofline_pct.info").read(run_) is None
    run_ = _run(_info_capture(), epochs_traced=2, steps_traced=2)
    run_.device_kind = "cpu"
    assert _reader("belief_roofline_pct.info").read(run_) is None


# -- the cell's files ----------------------------------------------------------


def test_the_cell_loads_with_its_metrics():
    cell = load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config_name == "er_bayes_rewire"
    assert cell.traffic == "sims_rewire" and cell.workload["driver"] == "info_sims"
    assert {m["name"] for m in cell.end_to_end} == {"agent_steps_per_s", "peak_mem_gib",
                                                   "setup_s"}
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert cell.config["reduced"] == [] and cell.config["info"]["dynamics"] == "rewire"
    assert set(cell.workload["limits"]) == {"frac_gap", "state_mismatch", "belief_gap"}
    # the driver seeds its simulations by the agents' rule
    agents = load_module(HERE / "drivers" / "agent_sims.py", "portbench_driver_agent_sims")
    assert all(cell.driver().sim_seed(SEED, i) == agents.sim_seed(SEED, i) for i in (-1, 0, 5))
