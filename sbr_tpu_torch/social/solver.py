"""Damped fixed-point equilibrium for social learning: the port of
``sbr_tpu.social.solver``.

The algorithm is the reference's:

1. tspan is (0, η); every curve lives on one uniform grid over [0, η].
2. AW⁽⁰⁾ is the word-of-mouth logistic CDF.
3. Iterate: forced learning from AW⁽ⁿ⁻¹⁾ (`dynamics.solve_forced_learning`)
   → the baseline equilibrium on it (`solve_equilibrium_core`) → the
   candidate AW̃⁽ⁿ⁾ (`get_aw`). On an inner no-run ξ⁽ⁿ⁾ = ξ⁽ⁿ⁻¹⁾ + η/500,
   and the loop aborts once that passes η. Convergence is the sup norm of
   the UNDAMPED step, |AW̃⁽ⁿ⁾ − AW⁽ⁿ⁻¹⁾| < tol; otherwise
   AW⁽ⁿ⁾ = (1 − α)·AW⁽ⁿ⁻¹⁾ + α·AW̃⁽ⁿ⁾, or, under ``numerics="adaptive"``,
   the gated Anderson(1) step.

The reference runs the loop as one ``lax.while_loop``; here it is a Python
loop over tensors on the device, with one host read per outer iteration
(the loop's condition). Where XLA rewrites the loop body's arithmetic, the
port copies the compiled form: the ξ march multiplies by the rounded
reciprocal of 500, and the damping line is one fused multiply-add,
fma(1 − α, AW, α·AW̃) (`social.fused._fma`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.baseline.learning import logistic_cdf
from sbr_tpu_torch.baseline.solver import get_aw, solve_equilibrium_core
from sbr_tpu_torch.core.interp import linspace
from sbr_tpu_torch.diag.health import (
    FP_ABORTED,
    FP_NOT_CONVERGED,
    NAN_OUTPUT,
    Health,
    flag_bit,
)
from sbr_tpu_torch.models.params import ModelParams, SolverConfig
from sbr_tpu_torch.models.results import EquilibriumResult, LearningSolution, _fmt
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.social.dynamics import solve_forced_learning
from sbr_tpu_torch.social.fused import _fma

HISTORY_LEN = 64


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class SocialFixedPointResult:
    """Fixed-point output: the last inner equilibrium and the iteration's
    metadata, with the reference's fields.

    ``history_err`` and ``history_xi`` are a ring of the last
    `HISTORY_LEN` iterations' undamped error and ξ; NaN slots never ran.
    ``health`` merges the last inner solve's with the fixed point's:
    residual = the final undamped error, iterations = outer steps plus the
    inner solve's, and the FP_NOT_CONVERGED, FP_ABORTED and NAN_OUTPUT
    bits."""

    equilibrium: EquilibriumResult  # the final inner solve
    learning: LearningSolution  # the final forced-learning curves
    aw: torch.Tensor  # (n,) final AW samples on [0, η]
    grid: torch.Tensor  # (n,) uniform grid over [0, η]
    xi: torch.Tensor  # final ξ iterate (with the no-run increments)
    iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    aborted: torch.Tensor  # bool: the ξ march passed η
    error: torch.Tensor  # last undamped sup-norm error
    history_err: Optional[torch.Tensor] = None  # (HISTORY_LEN,)
    history_xi: Optional[torch.Tensor] = None  # (HISTORY_LEN,)
    health: Optional[Health] = None
    solve_time: float = 0.0  # host wall clock, taken after the device finished

    def replace(self, **changes) -> "SocialFixedPointResult":
        return dataclasses.replace(self, **changes)

    def history(self):
        """(err, ξ) per iteration in chronological order, trimmed to the
        iterations that ran, as numpy arrays."""
        n = int(self.iterations)
        ln = self.history_err.shape[-1]
        err = self.history_err.cpu().numpy()
        xi = self.history_xi.cpu().numpy()
        if n <= ln:
            return err[:n], xi[:n]
        k = n % ln
        return np.concatenate([err[k:], err[:k]]), np.concatenate([xi[k:], xi[:k]])

    def curves_on(self, t):
        """(G, AW) interpolated onto host times ``t`` with ``np.interp``:
        the mean-field curves an agent-level comparison measures against."""
        t = np.asarray(t, dtype=np.float64)
        grid = _host64(self.grid)
        g = np.interp(t, grid, _host64(self.learning.cdf))
        aw = np.interp(t, grid, _host64(self.aw))
        return g, aw

    def __repr__(self) -> str:
        return (
            f"SocialFixedPointResult(ξ={_fmt(self.xi)}, "
            f"iterations={_fmt(self.iterations)}, converged={_fmt(self.converged)}, "
            f"error={_fmt(self.error, 3)}, aborted={_fmt(self.aborted)}, "
            f"bankrun={_fmt(self.equilibrium.bankrun)}, "
            f"solve_time={_fmt(self.solve_time, 3)}s)"
        )


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def no_run_xi(res: EquilibriumResult, xi_prev, eta):
    """The iteration's ξ: the inner solve's on a run, else the previous ξ
    plus η/500, which XLA compiles into η times the reciprocal of 500
    rounded in η's dtype."""
    np_dtype = np.float32 if eta.dtype == torch.float32 else np.float64
    return torch.where(res.bankrun, res.xi, xi_prev + eta * float(np_dtype(1) / np_dtype(500)))


def run_fixed_point(
    step: Callable,
    aw0: torch.Tensor,
    grid: torch.Tensor,
    eta: torch.Tensor,
    tol: float,
    max_iter: int,
    damping: float,
    adaptive: bool = False,
    verbose: bool = False,
) -> SocialFixedPointResult:
    """The damped outer iteration shared by the social and the information
    fixed points. ``step(aw, xi)`` returns (learning, equilibrium, ξ′, AW̃)
    for the current iterate, ξ′ with the no-run march applied (see
    `no_run_xi`); the abort, convergence, damping (Anderson
    under ``adaptive``), the history ring and the health are this
    function's. One host read per iteration decides whether to go on."""
    if max_iter < 1:
        raise ValueError(f"max_iter must be at least 1, got {max_iter}")
    dtype, device = grid.dtype, grid.device
    tol_ = torch.full((), tol, dtype=dtype, device=device)
    alpha = torch.full((), damping, dtype=dtype, device=device)
    one_minus_alpha = 1.0 - alpha
    tiny = torch.finfo(dtype).tiny

    aw = aw0
    xi = torch.zeros((), dtype=dtype, device=device)
    err = torch.full((), float("inf"), dtype=dtype, device=device)
    converged = aborted = torch.zeros((), dtype=torch.bool, device=device)
    hist_err = torch.full((HISTORY_LEN,), float("nan"), dtype=dtype, device=device)
    hist_xi = torch.full((HISTORY_LEN,), float("nan"), dtype=dtype, device=device)
    prev_aw = prev_r = torch.zeros_like(aw0)
    it = 0
    while it < max_iter:
        with obs.program():  # the reference's loop body is traced code
            ls, res, xi_new, aw_new = step(aw, xi)
        exceeded = ~res.bankrun & (xi_new > eta)
        err_new = (aw_new - aw).abs().max()
        conv = (err_new < tol_) & ~exceeded
        damped = _fma(one_minus_alpha.expand_as(aw), aw, alpha * aw_new)
        if adaptive:
            # gated Anderson(1): extrapolate along the last two residuals,
            # only near convergence (previous undamped error under 10·tol)
            # and with the reference's safeguards
            r_k = aw_new - aw
            dr = r_k - prev_r
            denom = (dr * dr).sum()
            gamma = (dr * r_k).sum() / torch.where(denom > tiny, denom, 1.0)
            gamma = torch.clamp(gamma, -5.0, 5.0)
            accel = aw + alpha * r_k - gamma * (aw - prev_aw + alpha * dr)
            accel_ok = (
                (it > 0) & (err < 10.0 * tol_) & (denom > tiny)
                & torch.isfinite(accel).all() & res.bankrun
            )
            aw_step = torch.where(accel_ok, accel, damped)
            prev_aw, prev_r = aw, r_k
        else:
            aw_step = damped
        aw_next = torch.where(conv, aw_new, aw_step)
        aw = torch.where(exceeded, aw, aw_next)
        if verbose:
            print(
                f"[social fp] iter {it + 1}: err={float(err_new):.3e} "
                f"xi={float(xi_new):.6f} bankrun={bool(res.bankrun)}",
                flush=True,
            )
        slot = it % HISTORY_LEN
        hist_err[slot] = err_new
        hist_xi[slot] = xi_new
        xi, err, converged, aborted = xi_new, err_new, conv, exceeded
        it += 1
        # the loop's condition: the one host read of the iteration
        if bool(conv | exceeded):
            break

    not_conv = ~converged & ~aborted
    fp_flags = (
        flag_bit(not_conv, FP_NOT_CONVERGED)
        | flag_bit(aborted, FP_ABORTED)
        | flag_bit(~torch.isfinite(aw).all(), NAN_OUTPUT)
    )
    iterations = torch.full((), it, dtype=torch.int32, device=device)
    fp_health = Health(
        residual=err,
        bracket_width=torch.full((), float("nan"), dtype=dtype, device=device),
        iterations=iterations,
        flags=fp_flags,
    )
    return SocialFixedPointResult(
        equilibrium=res, learning=ls, aw=aw, grid=grid, xi=xi,
        iterations=iterations, converged=converged, aborted=aborted, error=err,
        history_err=hist_err, history_xi=hist_xi,
        health=res.health.merge(fp_health),
    )


def _model_scalars(model: ModelParams, dtype, device):
    """(β, x0, u, p, κ, λ, η) as 0-d tensors of ``dtype`` on ``device``."""
    econ = model.economic
    return tuple(
        torch.tensor(float(v), dtype=dtype, device=device)
        for v in (model.learning.beta, model.learning.x0, econ.u, econ.p,
                  econ.kappa, econ.lam, econ.eta)
    )


def fixed_point_grid(model: ModelParams, config: SolverConfig, dtype, device) -> torch.Tensor:
    """The fixed point's grid, ``linspace(0, η, n_grid)`` as XLA compiles
    ``jnp.linspace`` (bit for bit at start 0)."""
    eta = torch.tensor(float(model.economic.eta), dtype=dtype, device=device)
    return linspace(torch.zeros((), dtype=dtype, device=device), eta, config.n_grid,
                    dtype, device)


def _finish(res: SocialFixedPointResult, t0: float) -> SocialFixedPointResult:
    if res.aw.device.type == "cuda":
        torch.cuda.synchronize(res.aw.device)
    return res.replace(solve_time=time.perf_counter() - t0)


def solve_equilibrium_social(
    model: ModelParams,
    config: SolverConfig | None = None,
    tol: float = 1e-4,
    max_iter: int = 250,
    damping: float = 0.5,
    dtype=None,
    verbose: bool = False,
    device=None,
) -> SocialFixedPointResult:
    """Solve the social-learning equilibrium on ``device`` (the CUDA card
    unless the caller names one) in ``dtype`` (float64 unless given
    ``torch.float32``).

    Defaults are the reference's (tol 1e-4, max_iter 250, α = 0.5); the
    Figure-12/13 script calls with max_iter=500. ``verbose`` prints one
    line per iteration from the host. The result carries ``solve_time``,
    taken after the device has finished.

    With telemetry on, the loop runs as one program through `obs.jit_call`
    inside the ``social.fixed_point`` span, followed by the
    ``fixed_point``, ``status`` and ``health`` events (`_log_fixed_point`)."""
    if config is None:
        config = SolverConfig()
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    t0 = time.perf_counter()
    beta, x0, u, p, kappa, lam, eta = _model_scalars(model, dtype, device)
    grid = fixed_point_grid(model, config, dtype, device)

    def program(beta, x0, u, p, kappa, lam, eta, grid):
        obs.prof.note_call("social.fixed_point", beta, x0, u, p, kappa, lam, eta, grid,
                           config, tol, max_iter, damping)

        def step(aw, xi):
            ls = solve_forced_learning(beta, aw, grid, x0)
            res = solve_equilibrium_core(ls, u, p, kappa, lam, eta, eta, config)
            xi_new = no_run_xi(res, xi, eta)
            aw_new = get_aw(xi_new, res.tau_bar_in_unc, res.tau_bar_out_unc, grid, ls)[0]
            return ls, res, xi_new, aw_new

        return run_fixed_point(
            step, logistic_cdf(grid, beta, x0), grid, eta, tol, max_iter, damping,
            adaptive=config.adaptive, verbose=verbose,
        )

    with obs.span("social.fixed_point", n_grid=config.n_grid, max_iter=int(max_iter)) as sp:
        res = obs.jit_call("social.fixed_point", program, beta, x0, u, p, kappa, lam, eta, grid)
        sp.sync(res.aw, res.xi)
    res = _finish(res, t0)
    _log_fixed_point(res)
    return res


def _log_fixed_point(res: SocialFixedPointResult) -> None:
    """Host-boundary telemetry for a finished fixed-point solve: the
    metrics' solve and iteration counts, and with a run active the
    ``fixed_point`` event (iterations, flags, the history ring), then the
    ``status`` and ``health`` censuses. Reads the returned tensors only."""
    n_iter = int(res.iterations)
    registry = obs.metrics.metrics()
    registry.inc("social.fixed_point.solves")
    registry.inc("social.fixed_point.iterations", n_iter)
    registry.observe("social.fixed_point.solve_s", float(res.solve_time))
    if not obs.enabled():
        return
    err_trace, xi_trace = res.history()
    obs.event(
        "fixed_point",
        stage="social.fixed_point",
        iterations=n_iter,
        converged=bool(res.converged),
        aborted=bool(res.aborted),
        error=float(res.error),
        xi=float(res.xi),
        bankrun=bool(res.equilibrium.bankrun),
        history_err=[float(e) for e in err_trace],
        history_xi=[float(x) for x in xi_trace],
    )
    obs.log_status("social.fixed_point", res.equilibrium.status)
    obs.log_health("social.fixed_point", res.health, res.equilibrium.status)


def fixed_point_from_numpy(arrays: dict, device=None) -> SocialFixedPointResult:
    """A `SocialFixedPointResult` from numpy arrays, for instance those of
    an ``sbr_tpu`` fixed point, so that `close_loop(fp=...)` runs on
    exactly the reference's curves and window.

    ``arrays`` holds the result's fields by name; ``learning``,
    ``equilibrium`` and ``health`` (and the equilibrium's ``health``) are
    nested dicts of their records' fields. Keys the port's records do not
    have are ignored, and ``None`` stays ``None``. The dtypes are the
    arrays'."""
    device = torch.device(device) if device is not None else default_device()

    def t(a):
        if a is None:
            return None
        return torch.as_tensor(np.array(a)).to(device)

    def record(cls, d, nested):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in names:
                continue
            if k in nested:
                sub_cls, sub_nested = (nested[k] if isinstance(nested[k], tuple)
                                       else (nested[k], {}))
                kw[k] = None if v is None else record(sub_cls, v, sub_nested)
            elif k == "closed_form":
                kw[k] = bool(v)
            elif k == "solve_time":
                kw[k] = float(v)
            else:
                kw[k] = t(v)
        return cls(**kw)

    return record(SocialFixedPointResult, arrays, {
        "equilibrium": (EquilibriumResult, {"health": Health}),
        "learning": LearningSolution,
        "health": Health,
    })
