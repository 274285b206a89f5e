"""Matplotlib figure builders: the port of ``sbr_tpu.figures.plotting``.

Each builder returns a `matplotlib.figure.Figure`; saving is the caller's
job (the master runner writes PDFs). Curve data comes from the port's
solver results, which stay tensors on their device until this boundary:
`_np` brings them to the host (``.cpu().numpy()``) and every plotted
number is computed from there as the reference computes it. Builders that
evaluate the model again (the learning CDFs, the hazard decomposition, the
AW curves) do so with the port's functions on the result's device and
dtype. The signatures, the plotted data and the styling are the
reference's.

Figures are drawn with matplotlib, or where it is not installed with the
built-in PDF writer (`figures.backend`). Importing this module does not switch the matplotlib
backend; the master CLI selects Agg.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sbr_tpu_torch.baseline.solver import get_aw, hazard_rate
from sbr_tpu_torch.figures.backend import pyplot
from sbr_tpu_torch.models.params import SolverConfig


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (or anything array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(ls, x) -> torch.Tensor:
    """Host values as a tensor of the learning solution's dtype and device."""
    return torch.as_tensor(np.asarray(x), dtype=ls.dtype, device=ls.device)


# The reference's palette (`plotting.jl:31`, `2_heterogeneity.jl:92`).
_SERIES_COLORS = ["tab:blue", "tab:red", "tab:green", "tab:purple", "tab:orange"]
_GROUP_COLORS = ["royalblue", "darkgreen", "mediumvioletred", "darkorange"]


def _new_axes(title: str, xlabel: str, ylabel: str):
    fig, ax = pyplot().subplots(figsize=(6.4, 4.4))
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.4)
    return fig, ax


def plot_learning_distribution(
    learning_solutions: Sequence,
    tspan,
    beta_values: Sequence[float],
    labels: Optional[Sequence[str]] = None,
):
    """Figure 1 — learning CDFs for several β (`plotting.jl:24-40`)."""
    fig, ax = _new_axes("Learning Dynamics", "Time", "Fraction Informed")
    t = np.linspace(tspan[0], tspan[1], 1000)
    for i, ls in enumerate(learning_solutions):
        vals = _np(ls.cdf_at(_on(ls, t)))
        label = labels[i] if labels is not None else rf"$\beta = {beta_values[i]}$"
        ax.plot(t, vals, lw=1.5, color=_SERIES_COLORS[i % len(_SERIES_COLORS)], label=label)
    ax.legend(loc="lower right")
    return fig


def plot_hazard_rate_decomposition(
    result,
    ls,
    econ,
    config: SolverConfig | None = None,
    threshold_curve: Optional[np.ndarray] = None,
    threshold_label: Optional[str] = None,
):
    """Figure 2 — hazard decomposition h(τ) = π(τ)·h_f(τ) in normal time
    (`plotting.jl:62-132`).

    With ``threshold_curve`` (values on the result's tau_grid), draws the
    interest-rate extension's u + rV(τ) threshold instead of the flat u line
    (`scripts/3_interest_rates.jl:141-156`).
    """
    if config is None:
        config = SolverConfig()
    xi = float(result.xi)
    eta = float(econ.eta)
    u = float(econ.u)

    # Reversed-time components: total hazard (prior p) and conditional
    # fragile hazard (p = 1); belief π is their ratio, clamped to [0, 1].
    tau_grid, hr_fragile = hazard_rate(1.0, econ.lam, ls, eta, config)
    _, hr_total = hazard_rate(econ.p, econ.lam, ls, eta, config)
    tau_grid = _np(tau_grid)
    h_f = _np(hr_fragile)
    h = _np(hr_total)
    with np.errstate(invalid="ignore", divide="ignore"):
        pi = np.clip(np.nan_to_num(h / h_f, nan=0.0), 0.0, 1.0)

    # Normal time t = ξ - τ̄ (`plotting.jl:95-104`): evaluate at τ̄ = ξ - t
    # for t ∈ [0, ξ], clamping into the hazard grid's domain.
    t_plot = np.linspace(0.0, xi, 1000)
    tau_eval = np.clip(xi - t_plot, 0.0, min(1.3 * xi, eta))
    h_t = np.interp(tau_eval, tau_grid, h)
    pi_t = np.interp(tau_eval, tau_grid, pi)
    h_f_t = np.interp(tau_eval, tau_grid, h_f)

    fig, ax = _new_axes(
        r"$h(\tau) = \pi(\tau) \times h_f(\tau)$", r"Time since learning $(\tau)$", "Hazard Rate"
    )
    ax.plot(t_plot, h_t, lw=1.5, color="mediumvioletred", label=r"$h(\tau)$ - Total hazard")
    ax.plot(t_plot, pi_t, lw=1.0, color="royalblue", label=r"$\pi(\tau)$ - Belief fragile")
    ax.plot(t_plot, h_f_t, lw=1.0, color="tomato", label=r"$h_f(\tau)$ - Conditional hazard")

    if threshold_curve is not None:
        thr_t = np.interp(tau_eval, tau_grid, _np(threshold_curve))
        ax.plot(t_plot, thr_t, lw=1.0, color="darkgray")
        ax.annotate(
            threshold_label or r"$u + rV(\tau)$",
            (0.7 * xi, 1.15 * thr_t[len(thr_t) // 2]),
            color="darkgray",
            fontsize=10,
        )
    else:
        ax.axhline(u, color="darkgray", lw=1.0)
        ax.annotate(f"$u = {u}$", (0.7 * xi, 1.3 * u if u > 0 else 0.02), color="darkgray", fontsize=10)

    mid_h_f = float(np.interp(0.5 * (tau_eval[0] + tau_eval[-1]), tau_grid, h_f))
    ax.axvline(xi, color="darkgoldenrod", lw=1.5, ls="-.")
    ax.annotate(
        rf"$\xi = {xi:.1f}$", (1.02 * xi, mid_h_f), color="darkgoldenrod", fontsize=10, ha="left"
    )
    ax.set_xlim(0, 1.2 * xi)
    ax.set_ylim(0, 1.2 * mid_h_f)
    ax.legend(loc="upper left")
    return fig


def plot_equilibrium(result, ls, econ, x_range=None, y_range=None):
    """Figure 3 family — AW dynamics with ξ/κ annotations and the
    return-time arrow (`plotting.jl:156-210`)."""
    xi = float(result.xi)
    kappa = float(econ.kappa)
    eta = float(econ.eta)
    tau_in = float(result.tau_in)

    t_grid = np.arange(0.0, min(2.0 * xi, eta) + 1e-9, 0.1)
    aw_cum, aw_out, aw_in = (
        _np(a)
        for a in get_aw(result.xi, result.tau_bar_in_unc, result.tau_bar_out_unc,
                        _on(ls, t_grid), ls)
    )

    fig, ax = _new_axes("Aggregate Withdrawals", "Time", "AW(t)")
    ax.plot(t_grid, aw_cum, color="darkred", lw=2, label="AW")
    ax.plot(t_grid, aw_out, color="darkred", ls="--", label="Informed")
    ax.plot(t_grid, aw_in, color="royalblue", ls="--", label="Reentered")

    ax.axvline(xi, color="darkgoldenrod", lw=2)
    ax.annotate(rf"$\xi = {xi:.1f}$", (xi + 0.4, 0.9), color="darkgoldenrod", fontsize=7)
    ax.axhline(kappa, color="grey", lw=1)
    ax.annotate(rf"$\kappa = {kappa:.2f}$", (xi / 2, kappa + 0.015), color="grey", fontsize=7)

    # Two-sided "return after τ_IN" arrow (`plotting.jl:203-209`).
    x0 = 0.8 * xi
    y0 = float(np.interp(x0, t_grid, aw_out))
    ax.annotate(
        "",
        xy=(x0 + tau_in, y0),
        xytext=(x0, y0),
        arrowprops=dict(arrowstyle="<->", color="darkgreen", lw=2),
    )
    ax.annotate(
        f"Return after {tau_in:.2f}",
        (x0 + tau_in / 2, y0 - 0.04),
        color="darkgreen",
        fontsize=6,
        ha="center",
    )

    ax.set_ylim(y_range if y_range is not None else (0, 1))
    if x_range is not None:
        ax.set_xlim(x_range)
    ax.legend(loc="upper left")
    return fig


def _shade_no_run(ax, x_values, invalid_mask):
    """Grey 'No Bank Run' band over a contiguous NaN region
    (`plotting.jl:253-268`)."""
    idx = np.flatnonzero(invalid_mask)
    if idx.size > 1:
        ax.axvspan(x_values[idx[0]], x_values[idx[-1]], color="gray", alpha=0.2)
        y0, y1 = ax.get_ylim()
        ax.annotate(
            "No Bank Run",
            ((x_values[idx[0]] + x_values[idx[-1]]) / 2, (y0 + y1) / 2),
            fontsize=8,
            rotation=90,
            ha="center",
            va="center",
        )


def plot_comp_stat_withdrawals_and_collapse(
    u_values, max_withdrawals, collapse_times, kappa, return_times=None
):
    """Figure 4 — two panels: peak withdrawals and collapse/return times vs
    u, with no-run shading (`plotting.jl:233-302`). Returns (fig_a, fig_b)."""
    u_values = _np(u_values)
    max_withdrawals = _np(max_withdrawals)
    collapse_times = _np(collapse_times)
    kappa = float(kappa)

    fig_a, ax_a = _new_axes("(a) Effect on Peak Withdrawals", "Deposit Utility (u)", "Peak Withdrawals")
    ax_a.plot(u_values, max_withdrawals, color="darkred")
    ax_a.set_ylim(0, 1)
    ax_a.axhline(kappa, color="grey", lw=1, ls="--")
    ax_a.annotate(f"$\\kappa = {kappa}$", (u_values[0] + 0.03, kappa + 0.025), color="grey", fontsize=8)
    _shade_no_run(ax_a, u_values, np.isnan(max_withdrawals))

    fig_b, ax_b = _new_axes("(b) Collapse Time and Return Time", "Deposit Utility (u)", "Time")
    valid = ~np.isnan(collapse_times)
    ax_b.plot(u_values[valid], collapse_times[valid], color="darkgoldenrod", ls="--", label="Collapse Time")
    if return_times is not None:
        return_times = _np(return_times)
        valid_r = ~np.isnan(return_times)
        ax_b.plot(u_values[valid_r], return_times[valid_r], label="Return Time")
    _shade_no_run(ax_b, u_values, ~valid)
    ax_b.legend(loc="upper right")
    return fig_a, fig_b


def plot_heatmap_aw(ave_meeting_time, u_values, max_aw_matrix):
    """Figure 5 — β×u peak-withdrawal heatmap, x = average meeting time
    = 1/β (`scripts/1_baseline.jl:278-284`). ``max_aw_matrix`` is (U, B)
    like the reference's storage (`1_baseline.jl:213`)."""
    fig, ax = _new_axes("Peak Withdrawals", "Average meeting time", "Deposit Utility")
    ax.grid(False)
    mesh = ax.pcolormesh(
        _np(ave_meeting_time),
        _np(u_values),
        _np(max_aw_matrix),
        cmap="viridis",
        alpha=0.8,
        shading="auto",
        # Embed as an image: at the paper's 5000×5000 resolution a vector
        # mesh would be 25M path objects and a several-hundred-MB PDF.
        rasterized=True,
    )
    fig.colorbar(mesh, ax=ax)
    return fig


def plot_aw_hetero(result, aw, econ, betas):
    """Heterogeneity figure — total AW plus per-group decomposition
    (`scripts/2_heterogeneity.jl:97-124`)."""
    xi = float(result.xi)
    kappa = float(econ.kappa)
    t = _np(aw.t_grid)
    sel = t <= 2.0 * xi

    fig, ax = _new_axes("Aggregate Withdrawals - Heterogeneous Groups", "Time", "AW(t)")
    ax.plot(t[sel], _np(aw.aw_cum)[sel], color="darkred", lw=2, label="Total AW")
    for k, beta_k in enumerate(betas):
        ax.plot(
            t[sel],
            _np(aw.aw_groups)[k][sel],
            ls="--",
            color=_GROUP_COLORS[k % len(_GROUP_COLORS)],
            label=rf"Group {k + 1} ($\beta$={beta_k})",
        )
    ax.axhline(kappa, color="grey", lw=1)
    ax.annotate(rf"$\kappa = {kappa:.2f}$", (xi / 2, kappa + 0.015), color="grey", fontsize=7)
    ax.axvline(xi, color="darkgoldenrod", lw=2)
    ax.annotate(rf"$\xi = {xi:.1f}$", (xi + 0.4, kappa * 0.85), color="darkgoldenrod", fontsize=7)
    ax.legend(loc="upper left")
    return fig


def plot_value_function(result_interest, econ):
    """Interest-rate figure — V in normal time t = ξ - τ̄ with the terminal
    value δ/(δ-r) (`scripts/3_interest_rates.jl:83-113`)."""
    base = result_interest.base
    xi = float(base.xi)
    tau = _np(base.tau_grid)
    v = _np(result_interest.v)

    t = xi - tau
    keep = t >= 0
    order = np.argsort(t[keep])

    fig, ax = _new_axes("Value Function", "Time", "Value V(t)")
    ax.plot(t[keep][order], v[keep][order], color="royalblue", lw=2, label="V(t)")
    v_terminal = econ.delta / (econ.delta - econ.r)
    ax.axhline(
        v_terminal, color="darkgray", ls="--", lw=1, label=f"Terminal value = {v_terminal:.2f}"
    )
    ax.set_xlim(0, float(t[keep].max()))
    ax.legend(loc="upper left")
    return fig


def plot_agent_closure(comp):
    """Equilibrium→agent loop closure: the explicit-agent
    population, run with the withdrawal window derived FROM the solved social
    fixed point, against that fixed point's own AW(t) and G(t) curves
    (`social_learning_solver.jl:63-263` + `solver.jl:495-532`). ``comp`` is a
    `sbr_tpu_torch.social.closure.LoopComparison`."""
    fig, (ax_aw, ax_g) = pyplot().subplots(1, 2, figsize=(11.0, 4.2))
    t = _np(comp.t)
    for ax, fp, sim, name in (
        (ax_aw, comp.aw_fp, comp.aw_sim, "AW(t)"),
        (ax_g, comp.g_fp, comp.g_sim, "G(t)"),
    ):
        ax.plot(t, fp, color="tab:blue", lw=2, label="fixed point (ODE)")
        ax.plot(
            t, sim, color="tab:red", lw=1.2, ls="--",
            label=f"{comp.n_agents:,} agents" + (f" (mean of {comp.n_reps})" if comp.n_reps > 1 else ""),
        )
        ax.set_xlabel("Time")
        ax.set_ylabel(name)
        ax.grid(True, alpha=0.4)
    xi = float(comp.fp.equilibrium.xi)
    ax_aw.axvline(xi, color="darkgoldenrod", lw=1.5)
    ax_aw.annotate(rf"$\xi = {xi:.1f}$", (xi + 0.2, 0.02), color="darkgoldenrod", fontsize=7)
    ax_aw.set_title(
        rf"Withdrawals: window [$\xi-\bar\tau_{{OUT}}^{{CON}}$, $\xi-\bar\tau_{{IN}}^{{CON}}$)"
        rf" = [{comp.exit_delay:.2f}, {comp.reentry_delay:.2f})"
        f"; sup-error {comp.err_aw_sup:.3f}"
    )
    ax_g.set_title(f"Learning; RMS error {comp.err_g_rms:.3f}")
    ax_aw.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    return fig
