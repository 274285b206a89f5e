"""Plain reference of the `paper_grid` configuration: the three-stage
baseline solve of a block of (β, u) cells, written from the model's
equations in plain PyTorch. It imports nothing of the program.

Stage 1 is the logistic learning curve G(t) = x0 / (x0 + (1 − x0)·e^{−βt})
and its density g = β·G·(1 − G). Stage 2 is the hazard

    h(τ) = p·e^{λτ}·g(τ) / (p·∫₀^τ e^{λs} g(s) ds + (1 − p)·∫₀^η e^{λs} g(s) ds)

on the configuration's grid over [0, η]: half of its knots uniform, half
placed through the logistic's inverse CDF, the integral by composite
Gauss-Legendre quadrature panel by panel. The buffer times are the first
up-crossing and the last down-crossing of h against u, linearly
interpolated between knots, with the first and last knots above u as
fallbacks and t1 when h never exceeds u. Stage 3 solves
AW(ξ) = G(ξ) − G(τ_IN) = κ on [τ_IN, τ_OUT] in closed form through the
logistic's inverse, classifies the cell (no crossing, no root within the
configuration's tolerance, a root on the falling branch, or a run) and
takes the peak of the withdrawal path AW(t) = G(t) − G(t − ξ + τ_IN) + x0
over [0, η] from its candidate points.

Every operation runs in ``dtype``: float64 is the reference, and a lower
type gives the control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

RUN, NO_CROSSING, NO_ROOT, FALSE_EQ = 0, 1, 2, 3


def _cdf(t, beta, x0):
    return x0 / (x0 + (1.0 - x0) * torch.exp(-beta * t))


def _pdf(t, beta, x0):
    g = _cdf(t, beta, x0)
    return beta * g * (1.0 - g)


def _logit(v):
    return torch.log(v) - torch.log1p(-v)


def hazard_rows(beta, cfg: dict, dtype, device):
    """(knots, hazard) of each β in ``beta`` (shape (R,)): two (R, n)
    tensors."""
    p, lam, eta, x0 = (torch.tensor(float(cfg[k]), dtype=dtype, device=device)
                       for k in ("p", "lam", "eta", "x0"))
    n, warp, order = int(cfg["n_grid"]), float(cfg["grid_warp"]), int(cfg["quad_order"])
    beta = beta.to(dtype=dtype, device=device)[:, None]
    n_q = max(1, int(warp * n))
    n_u = n - n_q
    t_uniform = eta * torch.arange(n_u, dtype=dtype, device=device) / (n_u - 1)
    q = torch.arange(n_q, dtype=dtype, device=device) / (n_q - 1)
    levels = x0 + q * (_cdf(eta, beta, x0) - x0)
    # a level that rounds to 1 has no finite time: it lands on η
    saturated = levels >= 1.0
    t_q = (_logit(torch.where(saturated, 0.5, levels)) - _logit(x0)) / beta
    t_q = torch.where(saturated, eta, t_q)
    knots = torch.cat([t_uniform.expand(beta.shape[0], n_u), t_q], dim=1)
    knots = torch.sort(knots, dim=1).values.clamp(min=0.0)
    knots = torch.minimum(knots, eta)
    knots[:, 0] = 0.0
    knots[:, -1] = eta

    def integrand(s):
        return torch.exp(lam * s) * _pdf(s, beta, x0)

    nodes, weights = np.polynomial.legendre.leggauss(order)
    a, b = knots[:, :-1], knots[:, 1:]
    half, mid = 0.5 * (b - a), 0.5 * (a + b)
    panel = torch.zeros_like(a)
    for node, weight in zip(nodes, weights):
        panel = panel + float(weight) * integrand(mid + half * float(node))
    integral = torch.cat([torch.zeros_like(knots[:, :1]), torch.cumsum(half * panel, dim=1)],
                         dim=1)
    hazard = p * torch.exp(lam * knots) * _pdf(knots, beta, x0) / (
        p * integral + (1.0 - p) * integral[:, -1:])
    return knots, hazard


def _first(mask):
    """Index of the first True along the last axis (0 when none)."""
    return mask.to(torch.uint8).argmax(-1)


def _last(mask):
    """Index of the last True along the last axis."""
    return mask.shape[-1] - 1 - mask.flip(-1).to(torch.uint8).argmax(-1)


def _interp(x, y, u, i):
    """Where the segment [i, i + 1] of (x, y) meets the level u."""
    x1, x2 = x.gather(-1, i[..., None])[..., 0], x.gather(-1, (i + 1)[..., None])[..., 0]
    y1, y2 = y.gather(-1, i[..., None])[..., 0], y.gather(-1, (i + 1)[..., None])[..., 0]
    return x1 + (u - y1) * (x2 - x1) / (y2 - y1)


def solve_cells(beta, u, cfg: dict, dtype=torch.float64, device="cpu", rows: int = 8) -> dict:
    """status (int32), ξ and AW_max of every cell of the block β × u,
    arrays of shape (len(beta), len(u)) on the host (ξ and AW_max NaN
    unless the cell runs). ``rows`` β rows are solved at a time."""
    beta = torch.as_tensor(beta).to(device=device, dtype=dtype)
    u = torch.as_tensor(u).to(device=device, dtype=dtype)
    kappa, eta, x0, t1 = (torch.tensor(float(cfg[k]), dtype=dtype, device=device)
                          for k in ("kappa", "eta", "x0", "t1"))
    tol = float(cfg["root_tol"])
    out = {"status": [], "xi": [], "aw_max": []}
    for r0 in range(0, beta.shape[0], rows):
        b = beta[r0:r0 + rows]
        knots, hazard = hazard_rows(b, cfg, dtype, device)
        x = knots[:, None, :].expand(-1, u.shape[0], -1)
        y = hazard[:, None, :].expand(-1, u.shape[0], -1)
        uu = u[None, :].expand(b.shape[0], -1)
        above = y > uu[..., None]
        up = ~above[..., :-1] & above[..., 1:]
        down = above[..., :-1] & ~above[..., 1:]
        any_above = above.any(-1)
        t_in = torch.where(
            up.any(-1), _interp(x, y, uu, _first(up)),
            torch.where(any_above, x.gather(-1, _first(above)[..., None])[..., 0], t1))
        t_out = torch.where(
            down.any(-1), _interp(x, y, uu, _last(down)),
            torch.where(any_above, x.gather(-1, _last(above)[..., None])[..., 0], t1))
        bb = b[:, None]
        g_in = _cdf(t_in, bb, x0)
        reach = _cdf(t_out, bb, x0) - g_in
        has_root = reach >= kappa
        target = torch.where(has_root, kappa + g_in, torch.full_like(g_in, 0.5))
        xi = torch.where(has_root, (_logit(target) - _logit(x0)) / bb, t_out)
        shortfall = torch.where(has_root, torch.zeros_like(reach), kappa - reach)
        rising = _pdf(xi, bb, x0) >= _pdf(t_in, bb, x0)
        status = torch.where(
            t_in == t_out, NO_CROSSING,
            torch.where(shortfall > tol, NO_ROOT, torch.where(rising, RUN, FALSE_EQ)))
        run = status == RUN
        # AW(t) = G(t) − G(t − d)·[t ≥ d] + x0 with d = ξ − τ_IN; its peak on
        # [0, η] is at 0, η, d, or where g(t) = g(t − d): t = s* + d/2
        d = xi - t_in
        s_star = (torch.log1p(-x0) - torch.log(x0)) / bb
        zero = torch.zeros_like(d)
        cands = torch.stack([zero, eta.expand_as(d), d.clamp(0.0, None).clamp(None, eta),
                             (s_star + 0.5 * d).clamp(0.0, None).clamp(None, eta)])
        aw = (_cdf(cands, bb, x0) - torch.where(cands >= d, _cdf(cands - d, bb, x0), zero)
              + x0).amax(0)
        nan = torch.full_like(xi, float("nan"))
        out["status"].append(status.to(torch.int32).cpu())
        out["xi"].append(torch.where(run, xi, nan).double().cpu())
        out["aw_max"].append(torch.where(run, aw, nan).double().cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}
