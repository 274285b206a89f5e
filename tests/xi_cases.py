"""Inputs and checks of the ξ stage's kernel route, shared by its CPU
tests (test_torch_xi_kernel.py) and its card tests (test_torch_cuda.py).
Imports neither jax nor sbr_tpu."""

import numpy as np
import torch

from sbr_tpu_torch.baseline.learning import solve_learning
from sbr_tpu_torch.baseline.solver import solve_equilibrium_core
from sbr_tpu_torch.models.params import LearningParams, SolverConfig, make_model_params
from sbr_tpu_torch.sweeps.baseline_sweeps import _RowLearning

# points on each axis of the paper's Figure-5 grid (portbench's paper_grid)
POINTS = 5000


def subgrid(n: int) -> np.ndarray:
    """n indices spread evenly over an axis of the 5000-point grid."""
    return np.linspace(0, POINTS - 1, n).astype(int)


def grid_inputs(rows, cols, dtype, device="cpu", numerics="fixed", n_grid=512, iters=90):
    """(ls, τ̄_IN, τ̄_OUT, κ, config) of the cells ``rows`` × ``cols`` (index
    arrays) of the paper's 5000×5000 Figure-5 grid, as `solve_param_cell`
    builds them on ``device`` (β a column against the u row)."""
    betas = (1.0 / np.linspace(1e-4, 1.0, POINTS))[rows]
    us = np.linspace(0.001, 1.0, POINTS)[cols]
    cfg = SolverConfig(n_grid=n_grid, bisect_iters=iters, refine_crossings=False,
                       numerics=numerics)
    m = make_model_params()
    e = m.economic
    t0, t1, x0, p, kappa, lam, eta = (
        torch.tensor(v, dtype=dtype, device=device)
        for v in (*m.learning.tspan, m.learning.x0, e.p, e.kappa, e.lam, e.eta))
    beta = torch.as_tensor(betas, dtype=dtype, device=device).unsqueeze(-1)
    ls = solve_learning(_RowLearning(beta, (t0, t1), x0), cfg, dtype=dtype, device=device)
    u = torch.as_tensor(us, dtype=dtype, device=device)
    r = solve_equilibrium_core(ls, u, p, kappa, lam, eta, t1, cfg, curves=False)
    return ls, r.tau_bar_in_unc, r.tau_bar_out_unc, kappa, cfg


def edge_inputs(dtype, column: bool, device="cpu"):
    """Edge lanes against β = 1 or the column (1, 0.5, 3): a root, NaN ends,
    τ̄_IN = τ̄_OUT (no crossing, also at 0), no bracket (AW stays under κ),
    an infinite end."""
    ti = [7.327538, float("nan"), 5.0, float("nan"), 5.0, 0.0, 0.0, 3.0]
    to = [10.446095, 10.0, float("nan"), float("nan"), 5.0, 0.0, 0.5, float("inf")]
    if column:
        beta, t0, t1, x0 = (torch.tensor(v, dtype=dtype, device=device)
                            for v in ([[1.0], [0.5], [3.0]], 0.0, 30.0, 1e-4))
        learning = _RowLearning(beta, (t0, t1), x0)
    else:
        learning = LearningParams(beta=1.0, tspan=(0.0, 30.0), x0=1e-4)
    ls = solve_learning(learning, SolverConfig(n_grid=64), dtype=dtype, device=device)
    rows = 3 if column else 1
    ti, to = (torch.tensor([v] * rows, dtype=dtype, device=device) for v in (ti, to))
    return ls, ti, to, torch.tensor(0.6, dtype=dtype, device=device)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN payloads too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


def assert_same_stage(got, want) -> None:
    names = ("xi", "err", "root_ok", "increasing")
    for name, a, b in zip(names, got[:4], want[:4]):
        assert same_bits(a, b), name
    for name in ("residual", "bracket_width", "iterations", "flags"):
        assert same_bits(getattr(got[4], name), getattr(want[4], name)), name
