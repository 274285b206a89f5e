"""The readers of the program's own profiler ranges (`harness.ranges` and
the eight metrics over it), on synthetic captures whose ranges, runtime
calls and kernels are known, on the CPU.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from harness import ranges  # noqa: E402
from harness.cell import load_module  # noqa: E402
from harness.trace import Capture  # noqa: E402

GRID = ("xi_ms_per_tile.grid", "buffers_ms_per_tile.grid", "xi_launches_per_tile.grid")
AGENTS = ("prologue_ms.agents", "step_host_ms.agents", "sync_wait_ms_per_step.agents",
          "counts_ms_per_step.agents", "full_recount_pct.agents")


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def _grid_capture():
    # two tiles; kernels 1 (buffers), 2-3 and 5 (xi, 5 in the second tile),
    # 4 (outside every stage), and a set launched in the ξ stage
    ops = [(0, 1000, "sweeps.beta_u_grid"), (100, 300, "baseline.buffers"),
           (140, 160, "aten::lt"), (400, 900, "baseline.xi"), (480, 520, "aten::mul"),
           (2000, 3000, "sweeps.beta_u_grid"), (2100, 2200, "baseline.buffers"),
           (2300, 2800, "baseline.xi")]
    launches = {1: 150, 2: 500, 3: 600, 4: 950, 5: 2350, 6: 450}
    device = [(200, 210, "k_lt", 1), (510, 530, "k_mul", 2), (610, 640, "k_add", 3),
              (960, 970, "k_copy", 4), (2360, 2400, "k_mul", 5), (460, 470, "Memset (Device)", 6)]
    return Capture(window_s=3e-6, device=device, launches=launches, ops=sorted(ops))


def _agents_capture():
    # a prologue and two steps; the first step recounts fully; the counts
    # launch kernels 1 and 2, the infection 3 and 4
    ops = [(0, 100, "agents.prologue"),
           (200, 600, "agents.step"), (210, 400, "agents.counts"),
           (250, 350, "agents.recount_full"), (300, 320, "agents.sync"),
           (450, 470, "agents.sync"), (500, 590, "agents.infection"),
           (700, 1100, "agents.step"), (710, 900, "agents.counts"), (760, 780, "agents.sync"),
           (950, 960, "agents.sync"), (1000, 1090, "agents.infection")]
    launches = {1: 260, 2: 720, 3: 510, 4: 1010}
    device = [(270, 300, "k_cumsum", 1), (730, 780, "k_index_add", 2),
              (520, 560, "infection_update", 3), (1020, 1060, "infection_update", 4)]
    return Capture(window_s=1.2e-6, device=device, launches=launches, ops=sorted(ops))


def _run(capture, **counters):
    return SimpleNamespace(capture=capture, counters=counters)


def test_kernels_in_a_range_are_those_its_runtime_calls_launched():
    cap = _grid_capture()
    assert [ev[3] for ev in ranges.kernels_in(cap, "baseline.xi")] == [2, 3, 5]
    assert [ev[3] for ev in ranges.kernels_in(cap, "baseline.buffers")] == [1]
    assert ranges.host_ms(cap, "baseline.xi") == pytest.approx(1000 / 1e6)
    assert ranges.kernels_in(cap, "agents.counts") == []


def test_host_time_counts_overlapping_ranges_once():
    cap = Capture(window_s=1e-6, device=[], launches={},
                  ops=[(0, 100, "r"), (50, 150, "r"), (300, 310, "r")])
    assert ranges.host_ms(cap, "r") == pytest.approx(160 / 1e6)


@pytest.mark.parametrize("name,want", [
    ("xi_ms_per_tile.grid", (500 + 500) / 2 / 1e6),
    ("buffers_ms_per_tile.grid", (200 + 100) / 2 / 1e6),
    ("xi_launches_per_tile.grid", 3 / 2),
])
def test_grid_readers(name, want):
    assert _reader(name).read(_run(_grid_capture(), tiles_traced=2)) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("prologue_ms.agents", 100 / 1e6),
    ("step_host_ms.agents", (400 + 400) / 2 / 1e6),
    ("sync_wait_ms_per_step.agents", (20 + 20 + 20 + 10) / 2 / 1e6),
    ("counts_ms_per_step.agents", (30 + 50) / 2 / 1e6),
    ("full_recount_pct.agents", 100.0 * 1 / 2),
])
def test_agent_readers(name, want):
    assert _reader(name).read(_run(_agents_capture(), steps_traced=2)) == pytest.approx(want)


def test_no_fallback_reads_zero_percent_and_no_sync_reads_nothing():
    cap = _agents_capture()
    cap.ops = [o for o in cap.ops if o[2] not in ("agents.recount_full", "agents.sync")]
    run = _run(cap, steps_traced=2)
    assert _reader("full_recount_pct.agents").read(run) == 0.0
    assert _reader("sync_wait_ms_per_step.agents").read(run) is None


def _plain_capture():
    # a program without ranges: aten operations and kernels only
    return Capture(window_s=1e-6, device=[(10, 20, "k", 1)], launches={1: 5},
                   ops=[(0, 30, "aten::mul")])


@pytest.mark.parametrize("name", GRID + AGENTS)
def test_readers_read_nothing_without_their_ranges(name):
    counters = {"tiles_traced": 2, "steps_traced": 2}
    assert _reader(name).read(_run(_plain_capture(), **counters)) is None
    assert _reader(name).read(_run(None, **counters)) is None
    # the other path's ranges are not this reader's
    other = _agents_capture() if name in GRID else _grid_capture()
    assert _reader(name).read(_run(other, **counters)) is None


@pytest.mark.parametrize("name", GRID + AGENTS)
def test_readers_refuse_a_divisor_the_run_disagrees_with(name):
    cap = _grid_capture() if name in GRID else _agents_capture()
    assert _reader(name).read(_run(cap, tiles_traced=3, steps_traced=3)) is None
    assert _reader(name).read(_run(cap)) is None
