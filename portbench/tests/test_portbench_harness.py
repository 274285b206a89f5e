"""The benchmark's own arithmetic and plumbing, on the CPU: the window's
statistics, the bytes bound, the trace's busy and idle reading, the cell
files and the import guard.

    python -m pytest portbench/tests -q
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import yardstick  # noqa: E402
from harness.cell import load_cell  # noqa: E402
from harness.core import FORBIDDEN, forbidden_modules  # noqa: E402
from harness.trace import Capture  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_rate_takes_all_work_over_the_whole_window():
    # three units of 10 work each, the window from 100.0 to the last completion
    assert yardstick.rate(30, 100.0, 106.0) == pytest.approx(5.0)


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert yardstick.percentile(values, 95) == 95
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.percentile([5, 1, 4, 2, 3], 95) == 5


def test_infection_bytes_count_each_input_once():
    # 10 agents of float32: 10 B of informed, 40 B of t_inf read and the same
    # written; 3 counts of 4 B; beta and deg of 2 frontier agents
    assert yardstick.infection_step_bytes(10, 4, 3, 2) == 10 * 10 + 12 + 16
    assert yardstick.infection_step_bytes(10, 8, 0, 0) == 10 * 18


def _driver(name):
    import torch

    cell = load_cell(ROOT, name)
    return cell.driver().Driver(cell, 1, torch.device("cpu"))


def test_grid_window_statistics():
    d = _driver("paper_grid.fixed")
    d.tb = d.tu = 2
    d.t0 = 10.0
    d.units = [(10.0, 10.5), (10.5, 11.5), (11.5, 12.0)]
    out = d.end_to_end()
    assert out["equilibria_per_s"] == pytest.approx(12 / 2.0)
    tail = d.cell.reader("tile_p95_ms.host")
    assert tail.read(SimpleNamespace(timers={"tile_s": d.tile_times()})) == pytest.approx(1000.0)
    # the traced stretch is left out of the tail, not of the rate
    d.traced = range(1, 2)
    assert d.tile_times() == pytest.approx([0.5, 0.5])
    assert tail.read(SimpleNamespace(timers={"tile_s": d.tile_times()})) == pytest.approx(500.0)
    assert tail.read(SimpleNamespace(timers={})) is None
    assert d.end_to_end()["equilibria_per_s"] == pytest.approx(12 / 2.0)


def test_agent_window_statistics():
    d = _driver("er_gossip.gather")
    d.t0 = 0.0
    d.units = [(0.0, 2.0), (2.0, 5.0)]
    n, steps = d.n, d.sim["n_steps"]
    assert d.end_to_end()["agent_steps_per_s"] == pytest.approx(2 * n * steps / 5.0)


def _capture():
    # kernels at [0, 10) and [5, 20) ns overlap; a set at [30, 40); a kernel at [60, 70)
    device = [(0, 10, "k_a", 1), (5, 20, "k_b", 2), (30, 40, "Memset (Device)", 3),
              (60, 70, "k_a", 4)]
    ops = [(-5, 100, "outer"), (22, 29, "aten::slow"), (45, 58, "aten::item")]
    launches = {1: -1, 2: 1, 3: 25, 4: 50}
    return Capture(window_s=100e-9, device=device, launches=launches, ops=ops)


def test_busy_is_the_union_of_device_intervals():
    cap = _capture()
    assert cap.busy_s() == pytest.approx(40e-9)
    assert cap.idle_share() == pytest.approx(0.6)
    assert len(cap.kernels()) == 3


def test_top_ops_and_idle_gaps_are_labelled():
    cap = _capture()
    assert cap.top_ops()[0] == ["k_a", pytest.approx(20e-9)]
    gaps = dict((k, v) for k, v in cap.idle_gaps())
    # the gap 20-30 ends with the set launched inside aten::slow; 40-60 with
    # the kernel launched inside aten::item
    assert gaps == {"aten::slow": pytest.approx(10e-9), "aten::item": pytest.approx(20e-9)}


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["sbr_tpu_torch", "sbr_tpu_torch.social", "jaxtyping",
                              "benchmarks_x", "numpy"]) == []
    assert forbidden_modules(["sbr_tpu.social", "jax", "jaxlib.xla", "flax",
                              "benchmarks.ablate", "bench"]) == sorted(FORBIDDEN)


def test_a_run_loads_nothing_forbidden():
    """Every module of the harness, each cell's driver, reference and
    readers, and the program's entry points they call, in a fresh process."""
    code = f"""
import sys
sys.path.insert(0, {str(HERE)!r}); sys.path.insert(1, {str(ROOT)!r})
from harness.cell import load_cell
from harness.core import forbidden_modules
from pathlib import Path
for name in {CELLS!r}:
    cell = load_cell(Path({str(ROOT)!r}), name)
    cell.driver(); cell.reference()
    for m in cell.per_layer:
        cell.reader(m["name"])
import sbr_tpu_torch.social.graphgen, sbr_tpu_torch.social.agents
import sbr_tpu_torch.sweeps.baseline_sweeps, sbr_tpu_torch.models.params
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = load_cell(ROOT, name)
    assert cell.chips == 1
    assert cell.end_to_end and cell.per_layer
    assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in cell.end_to_end}
    assert set(cell.workload["limits"]) and cell.workload["traffic"] == cell.traffic
    for m in cell.per_layer:
        assert hasattr(cell.reader(m["name"]), "read")
    assert hasattr(cell.driver(), "Driver") and cell.reference() is not None


def test_benchmark_names_and_units_keep_to_the_contract():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert name.match(entry["name"]), entry["name"]
    for m in metrics:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    # every file under the benchmark's folder is named from name characters
    for p in HERE.rglob("*"):
        if "__pycache__" not in p.parts and p.is_file():
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


def test_run_without_a_card_exits_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_program_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
