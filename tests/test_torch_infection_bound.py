"""The infection kernel's bound as chip_smoke.py computes it: the bytes
its inputs need (counts only for agents not informed, beta and deg only
for the frontier) against the frontier's instructions on the busiest pipe
of the build's SASS reading. The card's own numbers come from its run;
here the arithmetic is held to the rule on made-up readings."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

SIZES = {torch.float32: 4, torch.float64: 8, torch.float16: 2, torch.bfloat16: 2}
# an issue-bound reading, as the build's: 128 instructions, one clock an
# agent on an SM's four schedulers
ISSUE_BOUND = {"alu": 60, "fma": 20, "imad": 30, "issue": 128, "xu": 2}


@pytest.mark.parametrize("dtype", list(SIZES))
def test_bytes_count_counts_only_where_not_informed(dtype):
    n, uninformed, frontier = 1_000_000, 700_000, 600_000
    size = SIZES[dtype]
    got = cs.bound_ms(n, dtype, frontier, uninformed, pipes=ISSUE_BOUND)
    want = (n * (2 + 2 * size) + 4 * uninformed + 2 * size * frontier) / cs.HBM_BYTES_PER_S
    assert got["bytes_ms"] == pytest.approx(want * 1e3, rel=1e-15)
    assert got["frontier_share"] == 0.6 and got["uninformed_share"] == 0.7
    # every agent informed: informed and t_inf in, informed' and t_inf' out
    none = cs.bound_ms(n, dtype, 0, 0, pipes=ISSUE_BOUND)
    assert none["bytes_ms"] == pytest.approx(n * (2 + 2 * size) / cs.HBM_BYTES_PER_S * 1e3)
    assert none["ops_ms"] == 0.0 and none["bound_by"] == "bytes"


def test_frontier_of_counts_the_frontier_and_the_agents_not_informed():
    informed = torch.tensor([True, False, False, True, False, False])
    counts = torch.tensor([3, 0, 2, 0, 1, 0], dtype=torch.int32)
    assert cs.frontier_of(informed, counts) == (2, 4)


@pytest.mark.parametrize("pipes, pipe", [
    (ISSUE_BOUND, "issue"),
    ({"alu": 100, "issue": 110, "xu": 3}, "alu"),
    ({"alu": 10, "issue": 40, "xu": 12}, "xu"),
])
def test_operations_take_the_busiest_pipe(pipes, pipe, monkeypatch):
    monkeypatch.setattr(cs, "N_SMS", 132)
    monkeypatch.setattr(cs, "SM_CLOCK_HZ", 1.98e9)
    from sbr_tpu_torch.benchmarks.sass_count import PIPE_LANES

    frontier = 5_000_000
    got = cs.bound_ms(10_000_000, torch.float32, frontier, 7_000_000, pipes=pipes)
    assert got["ops_pipe"] == pipe
    clocks = pipes[pipe] / PIPE_LANES[pipe]
    assert got["ops_ms"] == pytest.approx(frontier * clocks / (132 * 1.98e9) * 1e3)


@pytest.mark.parametrize("issue, bound_by", [(16, "bytes"), (4096, "operations")])
def test_the_bound_is_the_larger_time(issue, bound_by):
    got = cs.bound_ms(10_000_000, torch.float16, 6_000_000, 7_000_000,
                      pipes={"issue": issue})
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == max(got["bytes_ms"], got["ops_ms"])


def test_the_bound_reads_this_runs_sass_and_nothing_else(monkeypatch):
    monkeypatch.setattr(cs, "INFECTION_SASS", {})
    with pytest.raises(AssertionError, match="phase_sass"):
        cs.bound_ms(1000, torch.float32, 10, 20)
    monkeypatch.setattr(cs, "INFECTION_SASS", {"float32": {"issue": 256}})
    assert cs.bound_ms(1000, torch.float32, 10, 20) == cs.bound_ms(
        1000, torch.float32, 10, 20, pipes={"issue": 256})
