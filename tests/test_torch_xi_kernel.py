"""The ξ stage's kernel route (sbr_tpu_torch/baseline/xi_kernel.py), on the
CPU.

The kernel itself (csrc/xi_bisect.cu) runs only on the card, where
tests/test_torch_cuda.py holds it bit for bit to the eager route. Here:

- `xi_kernel.takes` leaves every CPU call on the eager route, which
  launches nothing, and `compute_xi`'s CPU outputs are the eager
  bisection's, on a Figure-5 subgrid and on edge lanes, whose flags the
  card tests hold the kernel to;
- `xi_kernel.layout` describes each input's view expanded to the cells;
- the wrapper refuses what the kernel does not take before it loads it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu_torch import _build  # noqa: E402
from sbr_tpu_torch.baseline import xi_kernel  # noqa: E402
from sbr_tpu_torch.baseline.learning import learning_solution_from_samples  # noqa: E402
from sbr_tpu_torch.baseline.solver import compute_xi  # noqa: E402
from sbr_tpu_torch.diag.health import NAN_INPUT, NAN_OUTPUT, NO_BRACKET, NONFINITE_RESIDUAL  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig  # noqa: E402
from xi_cases import (  # noqa: E402
    assert_same_stage,
    edge_inputs,
    grid_inputs,
    subgrid,
)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_cpu_call_stays_on_the_eager_route(numerics, dtype):
    ls, ti, to, kappa, cfg = grid_inputs(subgrid(8), subgrid(8), dtype, numerics=numerics)
    assert not xi_kernel.takes(ti, to, ls, kappa, cfg)
    before = _build.LAUNCHES[xi_kernel.KERNEL]
    got = compute_xi(ti, to, ls, kappa, cfg, with_health=True)
    # an explicit bracket equal to the default one is the eager route too
    want = compute_xi(ti, to, ls, kappa, cfg, lo=ti, hi=to, with_health=True)
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before
    assert_same_stage(got, want)
    assert len(compute_xi(ti, to, ls, kappa, cfg)) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampled_stage_1_and_half_types_stay_eager_on_the_cpu(dtype):
    ls, ti, to, kappa, cfg = grid_inputs(subgrid(4), subgrid(4), dtype)
    sampled = learning_solution_from_samples(ls.grid, ls.cdf, ls.pdf)
    assert not xi_kernel.takes(ti, to, sampled, kappa, cfg)
    assert not xi_kernel.takes(ti.half(), to.half(), ls, kappa.half(), cfg)
    assert not xi_kernel.takes(ti.requires_grad_(True), to, ls, kappa, cfg)


@pytest.mark.parametrize("iters", [1, 2, 90])
@pytest.mark.parametrize("column", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_lanes_stay_on_the_eager_route_with_their_flags(dtype, column, iters):
    ls, ti, to, kappa = edge_inputs(dtype, column)
    cfg = SolverConfig(n_grid=64, bisect_iters=iters, numerics="fixed")
    assert not xi_kernel.takes(ti, to, ls, kappa, cfg)
    before = _build.LAUNCHES[xi_kernel.KERNEL]
    got = compute_xi(ti, to, ls, kappa, cfg, with_health=True)
    want = compute_xi(ti, to, ls, kappa, cfg, lo=ti, hi=to, with_health=True)
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before
    assert_same_stage(got, want)
    flags = got[4].flags[0]
    assert int(flags[0]) == 0
    assert int(flags[1]) & NAN_INPUT and int(flags[2]) & NAN_INPUT
    assert int(flags[1]) & NAN_OUTPUT and int(flags[3]) & NONFINITE_RESIDUAL
    assert int(flags[6]) & NO_BRACKET


# (cells, another input) of each case, as views of one buffer
_VIEWS = {
    "cells": lambda b: (b[:35].reshape(5, 7), b[35:70].reshape(5, 7)),
    "transposed": lambda b: (b[:35].reshape(7, 5).t(), b[35:70].reshape(5, 7)),
    "column": lambda b: (b[:35].reshape(5, 7), b[3:8].reshape(5, 1)),
    "scalar": lambda b: (b[:35].reshape(5, 7), b[4]),
    "strided": lambda b: (b[:70].reshape(5, 14)[:, ::2], b[1:6].unsqueeze(-1)),
    "row": lambda b: (b[:35].reshape(5, 7), b[10:17]),
    "three_dims": lambda b: (b[:24].reshape(2, 3, 4), b[5:9]),
    "four_dims": lambda b: (b.reshape(2, 3, 4, 5), b[:5]),
}


@pytest.mark.parametrize("case", sorted(_VIEWS))
def test_layout_describes_each_expanded_view(case):
    base = torch.arange(2 * 3 * 4 * 5, dtype=torch.float64)
    cells, others = _VIEWS[case](base)
    ts = (cells, others, base[7], others, cells)
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    lay = xi_kernel.layout(shape, ts)
    dims = xi_kernel.MAX_DIMS
    assert len(lay) == dims * (1 + len(ts))
    padded = lay[:dims]
    assert int(np.prod(padded)) == shape.numel()
    for k, t in enumerate(ts):
        strides = lay[dims * (k + 1):dims * (k + 2)]
        view = torch.as_strided(t, padded, strides, t.storage_offset())
        assert torch.equal(view, t.expand(shape).reshape(padded)), k


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        xi_kernel.xi_bisect(*(t.half() for _ in range(5)), 90, 1e-4)
    with pytest.raises(ValueError, match="tau_in"):
        xi_kernel.xi_bisect(t, t, t, t, t, 90, 1e-4)
