"""The HJB value function of the interest-rate extension: the port of
``sbr_tpu.interest.value_function``.

In reversed time τ̄ = ξ* − τ,

    V'(τ̄) = (h(τ̄) + δ)·(1 − V(τ̄)) + max(u + r·V(τ̄) − h(τ̄), 0),
    V(0)  = (u + δ)/(r + δ),

with h the hazard rate, integrated forward over the hazard grid and saved
at its knots.

Shapes follow `core.interp`: the grid and the hazard are row tables
R + (n,); u, r and V's lanes have the cell shape C, which R broadcasts to
(a (β, u, r) policy grid has R = (B, 1, 1) and C = (B, U, R)). V has
shape C + (n,).

- Fixed numerics: RK4 with max(ode_substeps, 4) substeps an interval. As
  in the reference, every stage's hazard lookup is hoisted out of the
  sequential loop and evaluated at once, with the node times associated
  as the in-loop path would (t0 + j·h; t + 0.5·h; t + h), and the
  substeps are unrolled. The loop over the n − 1 intervals is a loop of
  passes, one interval each, vectorised over the cells; on the card it
  is replayed from a CUDA graph (`core.ode.run_passes`), unless an input
  requires grad (`grad.cell.interest_cell`), when it runs eagerly so that
  autograd records it: the fixed RK4 is the gradient path of the HJB.
- Adaptive numerics: `core.ode.bs32` with the cells as lanes, the hazard
  interpolated at each attempt's node times.
"""

from __future__ import annotations

import torch

from sbr_tpu_torch.core.interp import interp, interp_guided, interp_uniform
from sbr_tpu_torch.core.ode import bs32, run_passes
from sbr_tpu_torch.diag.health import Health
from sbr_tpu_torch.models.params import SolverConfig


def solve_value_function(tau_grid, hr, delta, r, u, config: SolverConfig | None = None,
                         uniform: bool = True, index_fn=None, with_health: bool = False):
    """V sampled on ``tau_grid`` (module docstring). ``uniform`` selects
    index arithmetic for the hazard lookups; otherwise ``index_fn`` (t →
    bracketing-index guess, `baseline.solver.warped_grid_index`) feeds
    `interp_guided`, or, without it, a searchsorted interpolation on a 1-D
    grid. With ``with_health`` appends a `Health`: bs32's under adaptive
    numerics (its ODE_BUDGET flag is the only sign that an interval ran
    out of attempts), a zero-flag one under fixed numerics."""
    if config is None:
        config = SolverConfig()
    dtype, dev = hr.dtype, hr.device

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    delta, r, u = tensor(delta), tensor(r), tensor(u)
    t0 = tau_grid[..., 0]
    dt = tau_grid[..., 1] - tau_grid[..., 0]

    if uniform:
        def hr_at(t):
            return interp_uniform(t, t0, dt, hr)
    elif index_fn is not None:
        def hr_at(t):
            return interp_guided(t, tau_grid, hr, index_fn(t))
    else:
        def hr_at(t):
            return interp(t, tau_grid, hr)

    v0 = (u + delta) / (r + delta)
    cells = torch.broadcast_shapes(v0.shape, tau_grid.shape[:-1])
    v0 = v0.expand(cells).contiguous()

    def rhs_at(hv, v):
        return (hv + delta) * (1.0 - v) + torch.clamp(u + r * v - hv, min=0.0)

    if config.adaptive:
        out = bs32(
            lambda t, v, _: rhs_at(hr_at(t), v), v0, tau_grid, rtol=config.ode_rtol,
            atol=config.ode_atol, with_health=with_health, lane_ndim=v0.dim(),
        )
        return out

    substeps = max(config.ode_substeps, 4)
    # the node times, interval axis first: (n−1, s, 3) + R, with R the rows
    # of the grid and the hazard together (K hazard rows on one shared grid)
    rows = torch.broadcast_shapes(tau_grid.shape[:-1], hr.shape[:-1])
    tg = tau_grid.expand(*rows, tau_grid.shape[-1]).movedim(-1, 0)
    t0s = tg[:-1]
    h = (tg[1:] - t0s) / substeps
    j = torch.arange(substeps, dtype=dtype, device=dev).reshape((1, substeps) + (1,) * (tg.dim() - 1))
    tj = t0s.unsqueeze(1) + j * h.unsqueeze(1)
    hcol = h.unsqueeze(1)
    nodes = torch.stack([tj, tj + 0.5 * hcol, tj + hcol], dim=2)
    hr_nodes = hr_at(nodes)
    half = 0.5 * h
    sixth = h / 6.0

    n_int = t0s.shape[0]
    # V at the save points, and a spare row for the passes past the last
    # interval (chunks of passes may overrun it): (n + 1,) + C
    out = torch.zeros((n_int + 2,) + cells, dtype=dtype, device=dev)
    out[0] = v0
    spare = torch.full((), n_int + 1, dtype=torch.int64, device=dev)

    def one_pass(s):
        """One interval: its substeps unrolled, all node reads static."""
        j, v = s["j"], s["v"]
        live = j < n_int
        row = torch.clamp(j, max=n_int - 1).reshape(1)
        hstep, hhalf, hsixth, hrow = (x.index_select(0, row)[0] for x in (h, half, sixth, hr_nodes))
        v1 = v
        for m in range(substeps):
            h1, hm, h2 = hrow[m, 0], hrow[m, 1], hrow[m, 2]
            k1 = rhs_at(h1, v1)
            k2 = rhs_at(hm, v1 + hhalf * k1)
            k3 = rhs_at(hm, v1 + hhalf * k2)
            k4 = rhs_at(h2, v1 + hstep * k3)
            v1 = v1 + hsixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        v1 = torch.where(live, v1, v)
        out.index_copy_(0, torch.where(live, j + 1, spare).reshape(1), v1.unsqueeze(0))
        return dict(j=j + 1, v=v1)

    march = dict(j=torch.zeros((), dtype=torch.int64, device=dev), v=v0.clone())
    # autograd through V (the grad layer's interest cell) needs the passes
    # recorded, so they run eagerly; otherwise they replay from a graph
    differentiable = torch.is_grad_enabled() and any(
        t.requires_grad for t in (tau_grid, hr, delta, r, u)
    )
    run_passes(one_pass, march, lambda s: int(s["j"]) >= n_int, eager=differentiable)
    out = out[: n_int + 1].movedim(0, -1)
    if not with_health:
        return out
    return out, Health.of_flags(torch.zeros(cells, dtype=torch.int32, device=dev), dtype)
