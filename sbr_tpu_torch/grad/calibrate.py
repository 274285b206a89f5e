"""Calibration: fit (β, u, κ) to an observed withdrawal curve; the port of
``sbr_tpu.grad.calibrate``.

Given samples of the cumulative aggregate-withdrawal curve AW(t), recover
the structural parameters. With IFT gradients the model curve AW(t; θ) is
differentiable in θ end to end (θ → hazard → buffers → ξ → curve), so the
fit is first-order optimisation of a closed-form loss.

Identification: AW(t) depends on θ only through β and the two branch start
times ξ − τ^CON, so the curve alone leaves a one-dimensional (u, κ) ridge
of perfect fits. A real withdrawal series ends at the crash, so the fit
also takes the observed crash time ξ_obs, which closes the system; pass
``xi_obs=None`` to fit the curve alone.

- **Loss**: the mean squared error of `grad.cell.aw_cum_at` against the
  observations, plus ``xi_weight·(ξ(θ) − ξ_obs)²`` when ξ_obs is given.
- **Parameters** move unconstrained: log β, log u, logit κ (log λ,
  logit p), so the boxes hold by construction.
- **Optimizer**: Adam with the reference's own arithmetic (b1 0.9, b2
  0.999, eps 1e-8, θ ← θ − lr·m̂/(√v̂ + eps)), not ``torch.optim.Adam``,
  whose update rounds in another order. A host loop with early exit; the
  same data and start give the same trajectory.

`synth_withdrawals` makes the test fixture: AW samples from a known θ*.
With telemetry on, the fit runs under the ``grad.calibrate`` span and logs
``grad`` events ``calib_start``, ``calib_step`` (every ``log_every``
steps) and ``calib_done``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.core.interp import linspace
from sbr_tpu_torch.grad.api import _resolve
from sbr_tpu_torch.grad.cell import aw_cum_at, baseline_cell
from sbr_tpu_torch.models.params import ModelParams, SolverConfig, params_to_pytree


def _logit(v):
    return torch.log(v) - torch.log1p(-v)


# Parameters the calibrator may fit, with their unconstrained transforms.
_TRANSFORMS = {
    "beta": (torch.log, torch.exp),
    "u": (torch.log, torch.exp),
    "kappa": (_logit, torch.sigmoid),
    "lam": (torch.log, torch.exp),
    "p": (_logit, torch.sigmoid),
}
CALIBRATABLE = tuple(_TRANSFORMS)

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class CalibResult:
    """One calibration outcome (host-side, JSON-friendly)."""

    params: dict  # fitted values, natural space, plain floats
    loss: float  # final MSE
    steps: int  # steps actually run
    converged: bool  # loss tol or step tol met within the budget
    loss_history: tuple  # per-step losses


def _theta0(params: ModelParams, dtype, device) -> dict:
    return {k: torch.full((), float(v), dtype=dtype, device=device)
            for k, v in params_to_pytree(params).items() if k != "eta_bar"}


def _loss(raw: dict, rest: dict, t_obs, aw_obs, xi_obs, xi_weight: float, config, dtype):
    theta = {**rest, **{k: _TRANSFORMS[k][1](v) for k, v in raw.items()}}
    out = baseline_cell(theta, config, dtype)
    aw = aw_cum_at(t_obs, out["xi_candidate"], out["tau_in"], out["tau_out"],
                   theta["beta"], theta["x0"])
    loss = torch.mean((aw - aw_obs) ** 2)
    if xi_obs is not None:
        loss = loss + xi_weight * (out["xi_candidate"] - xi_obs) ** 2
    return loss


def _adam_step(raw: dict, m: dict, v: dict, t: int, lr: float, rest: dict, t_obs, aw_obs,
               xi_obs, xi_weight: float, config, dtype):
    """One step at ``raw``: the loss there, its gradient, and the Adam
    update in the reference's arithmetic. Returns (raw', m', v', loss)."""
    with torch.enable_grad():
        leaves = {k: x.detach().requires_grad_(True) for k, x in raw.items()}
        loss = _loss(leaves, rest, t_obs, aw_obs, xi_obs, xi_weight, config, dtype)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    upd, m2, v2 = {}, {}, {}
    for (k, x), g in zip(raw.items(), grads):
        m2[k] = _B1 * m[k] + (1 - _B1) * g
        v2[k] = _B2 * v[k] + (1 - _B2) * g**2
        mhat = m2[k] / (1 - _B1**t)
        vhat = v2[k] / (1 - _B2**t)
        upd[k] = x - lr * mhat / (torch.sqrt(vhat) + _EPS)
    return upd, m2, v2, loss.detach()


def synth_withdrawals(params: ModelParams, n_obs: int = 64, noise: float = 0.0, seed: int = 0,
                      config: Optional[SolverConfig] = None, dtype=None, device=None):
    """The calibration fixture: ``(t_obs, aw_obs, xi)`` sampled from the
    model at ``params`` on a uniform grid over [0, η] (the reference's
    ``jnp.linspace``, bit for bit), with seeded Gaussian noise of scale
    ``noise`` on the curve; ``xi`` is the planted crash time. The noise
    comes from numpy's ``default_rng(seed)``, not the reference's
    ``jax.random`` stream."""
    config, dtype, device = _resolve(config, dtype, device)
    theta = _theta0(params, dtype, device)
    with torch.no_grad():
        out = baseline_cell(theta, config, dtype)
        t_obs = linspace(0.0, theta["eta"], n_obs, dtype, device)
        aw = aw_cum_at(t_obs, out["xi_candidate"], out["tau_in"], out["tau_out"],
                       theta["beta"], theta["x0"])
    if noise > 0.0:
        draw = np.random.default_rng(seed).standard_normal(n_obs)
        aw = aw + noise * torch.as_tensor(draw, dtype=dtype, device=device)
    return t_obs, aw, out["xi_candidate"]


def fit_withdrawals(t_obs, aw_obs, init: ModelParams, wrt=("beta", "u", "kappa"), xi_obs=None,
                    xi_weight: float = 1e-2, steps: int = 400, lr: float = 0.05,
                    loss_tol: float = 1e-12, step_tol: float = 1e-10, log_every: int = 25,
                    config: Optional[SolverConfig] = None, dtype=None,
                    device=None) -> CalibResult:
    """Fit ``wrt`` ⊆ {β, u, κ, λ, p} to observed (t, AW) samples by Adam
    over the IFT-differentiable model curve (module docstring).

    ``init`` gives the starting point and the held parameters, the
    resolved η and tspan included (build it with `with_overrides` on the
    data's base so η matches). The start must be a RUN cell: where there
    is no crossing the curve is flat and its gradient exactly zero, and
    such a dead start reports ``converged=False``.

    Converged: the loss falls under ``loss_tol``, or the best loss seen
    stops improving (by a relative ``step_tol``) for 40 steps after at
    least halving the starting loss. A stall without improvement and an
    exhausted budget are not converged. The fitted parameters are the best
    iterate's. ``log_every`` is the cadence of the ``calib_step`` events."""
    config, dtype, device = _resolve(config, dtype, device)
    wrt = tuple(wrt)
    unknown = set(wrt) - set(CALIBRATABLE)
    if not wrt or unknown:
        raise ValueError(f"wrt must be a non-empty subset of {CALIBRATABLE}, got {wrt!r}")

    theta0 = _theta0(init, dtype, device)
    rest = {k: v for k, v in theta0.items() if k not in wrt}
    raw = {k: _TRANSFORMS[k][0](theta0[k]) for k in wrt}
    m = {k: torch.zeros((), dtype=dtype, device=device) for k in wrt}
    v = {k: torch.zeros((), dtype=dtype, device=device) for k in wrt}
    t_obs = torch.as_tensor(t_obs, dtype=dtype, device=device)
    aw_obs = torch.as_tensor(aw_obs, dtype=dtype, device=device)
    xi_arg = None if xi_obs is None else torch.as_tensor(xi_obs, dtype=dtype, device=device)

    losses = []
    converged = False
    # Adam oscillates near the optimum: the fit stalls only when the BEST
    # loss seen has not improved for a whole window, and returns the best
    # iterate
    best_loss, best_step, best_raw = float("inf"), -1, raw
    stall_window = 40
    n_obs = int(t_obs.shape[0])
    with obs.span("grad.calibrate", n_obs=n_obs, steps=steps):
        obs.event("grad", action="calib_start", wrt=list(wrt), steps=steps, lr=lr,
                  n_obs=n_obs, with_xi=xi_obs is not None)
        for i in range(steps):
            raw_before = raw
            raw, m, v, loss = _adam_step(raw, m, v, i + 1, float(lr), rest, t_obs, aw_obs,
                                         xi_arg, float(xi_weight), config, dtype)
            loss_f = float(loss)  # the loss at raw_before
            losses.append(loss_f)
            if loss_f < best_loss * (1.0 - step_tol):
                best_loss, best_step, best_raw = loss_f, i, raw_before
            if (i % max(log_every, 1)) == 0:
                obs.event("grad", action="calib_step", step=i, loss=loss_f)
            if loss_f <= loss_tol:
                best_loss, best_raw = loss_f, raw_before
                converged = True
                break
            if i - best_step >= stall_window:
                # a floor counts only if the fit improved: a dead gradient does not
                converged = best_loss < 0.5 * losses[0]
                break
        fitted = {k: float(_TRANSFORMS[k][1](x)) for k, x in best_raw.items()}
        final_loss = best_loss if losses else float("nan")
        obs.event("grad", action="calib_done", steps=len(losses), loss=final_loss,
                  converged=bool(converged), **{f"fit_{k}": v for k, v in fitted.items()})
    return CalibResult(
        params=fitted,
        loss=final_loss,
        steps=len(losses),
        converged=bool(converged),
        loss_history=tuple(losses),
    )
