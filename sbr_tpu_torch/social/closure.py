"""Closing the equilibrium → agent loop: the port of ``sbr_tpu.social.closure``.

An agent informed at time s withdraws during [s + ξ − τ̄_OUT^CON,
s + ξ − τ̄_IN^CON) (`get_aw`). `close_loop`:

1. solves the social-learning fixed point (or takes one, ``fp=``);
2. derives exit_delay = ξ − τ̄_OUT^CON and reentry_delay = ξ − τ̄_IN^CON
   from its equilibrium (`equilibrium_window`);
3. simulates N explicit agents with that window, on a host Erdős–Rényi
   graph or one generated on the device, through the port's agent engines,
   whose steps end in the CUDA infection kernel (gossip) or the CUDA belief
   kernel (bayes) for tensors on the card;
4. compares the agents' withdrawn and informed fractions with the fixed
   point's AW(t) and G(t).

In the dense-graph limit each agent's observed withdrawn-neighbour fraction
concentrates on the population AW(t), so the errors shrink as N grows. The
mid-trajectory start (``g0``) seeds round(g0·N) agents at the stratified
quantiles of G on [0, t0], with negative informed times on the simulation's
clock. The host parts are the reference's numpy: the seed choice, the
``np.interp`` inversions and the error metrics. With the same fixed point
(`social.solver.fixed_point_from_numpy`) the agents' curves equal
``sbr_tpu``'s bit for bit on the gossip paths, and on the bayes path with
the same per-agent fields (tested).

A ``dynamics="rewire"`` information model closes against its tilted
mean-field curve, each member regenerating its graph every epoch.

Not ported: ``mesh=`` (raises ``NotImplementedError``) and the ``obs``
census line of an information-model closure.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from sbr_tpu_torch.models.params import ModelParams, SolverConfig, make_model_params
from sbr_tpu_torch.social.agents import (
    AgentSimConfig,
    default_device,
    erdos_renyi_edges,
    prepare_agent_graph,
    simulate_agents,
)
from sbr_tpu_torch.social.solver import SocialFixedPointResult, solve_equilibrium_social


def _host(x, dtype=np.float64) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def equilibrium_window(eq) -> tuple:
    """(exit_delay, reentry_delay) implied by an equilibrium's strategy:
    with the constrained buffers τ̄^CON = min(τ̄^UNC, ξ), an agent informed
    at s withdraws during [s + ξ − τ̄_OUT^CON, s + ξ − τ̄_IN^CON)."""
    xi = float(eq.xi)
    if not np.isfinite(xi):
        raise ValueError("equilibrium has no bank run (xi is NaN) — no window to derive")
    tau_in_con = min(float(eq.tau_bar_in_unc), xi)
    tau_out_con = min(float(eq.tau_bar_out_unc), xi)
    return xi - tau_out_con, xi - tau_in_con


@dataclasses.dataclass(frozen=True)
class LoopComparison:
    """Fixed point against agent simulation on the shared time grid ``t``
    (host numpy arrays)."""

    fp: SocialFixedPointResult
    exit_delay: float
    reentry_delay: float
    t: np.ndarray  # (n_steps,) simulation grid
    aw_fp: np.ndarray  # fixed-point AW(t) on t
    aw_sim: np.ndarray  # mean agent withdrawn_frac on t
    g_fp: np.ndarray  # fixed-point forced-learning G(t) on t
    g_sim: np.ndarray  # mean agent informed_frac on t
    n_agents: int
    n_reps: int
    err_aw_sup: float
    err_aw_rms: float
    err_g_rms: float
    # per-member AW trajectories (n_reps, n_steps), with the seeds= axis
    aw_seeds: Optional[np.ndarray] = None
    # the information model the members ran under (None: legacy gossip)
    infomodel: Optional[object] = None


def _bayes_evidence_curve(fp: SocialFixedPointResult, infomodel, grid: np.ndarray) -> np.ndarray:
    """The mean-field evidence level M(t) = running max of ∫ llr(w_obs(AW))
    on the fixed point's grid, by the host trapezoid."""
    from sbr_tpu_torch.infomodels.meanfield import observed_fraction

    llr0_c, llr1_c = infomodel.llr
    w_obs = np.asarray(observed_fraction(_host(fp.aw), infomodel))
    llr_curve = w_obs * llr1_c + (1.0 - w_obs) * llr0_c
    dt_grid = float(grid[1] - grid[0])
    lam_curve = np.concatenate(
        [[0.0], np.cumsum((llr_curve[1:] + llr_curve[:-1]) * 0.5 * dt_grid)]
    )
    return np.maximum.accumulate(lam_curve)


def close_loop(
    model: Optional[ModelParams] = None,
    n_agents: int = 100_000,
    avg_degree: float = 20.0,
    dt: float = 0.1,
    t_max: Optional[float] = None,
    g0: Optional[float] = 0.02,
    n_reps: int = 1,
    seed: int = 0,
    config: SolverConfig | None = None,
    tol: float = 1e-4,
    max_iter: int = 500,
    mesh=None,
    fp: Optional[SocialFixedPointResult] = None,
    graph=None,
    infomodel=None,
    seeds: Optional[Sequence[int]] = None,
    tolerance: Optional[float] = None,
    device=None,
) -> LoopComparison:
    """Solve the fixed point, feed its window to the agent simulation on
    ``device`` (the CUDA card unless the caller names one), compare.

    The arguments are the reference's. Defaults: the Figure-12 calibration
    (β 0.9, η̄ 30, u 0.5, p 0.99, κ 0.25, λ 0.25) and an Erdős–Rényi graph
    dense enough for the mean-field limit.

    - ``graph``: None samples a host Erdős–Rényi graph per member
      (`erdos_renyi_edges`); a `social.graphgen` spec (with
      ``spec.n == n_agents``) generates it on the device per member.
    - ``g0``: the mid-trajectory start at the time t0 where the fixed
      point's G reaches g0 (see the module docstring); None runs from
      scratch with x0·N founders.
    - ``fp``: a precomputed fixed point of the same ``model``.
    - ``infomodel``: an `infomodels.InfoModelSpec`, static or rewired;
      the loop then closes against its mean-field fixed point
      (`infomodels.meanfield.solve_fixed_point_info`). The bayes mid-start
      seeds the threshold-ordered prefix {i: a_i·M(t0) ≥ θ_i} with crossing
      times M⁻¹(θ_i/a_i) and starts every belief at M(t0).
    - ``seeds``: member seeds replacing the ``n_reps`` ladder; the graph
      is then prepared once (at ``seed``) and reused by every member, whose
      AW rows land on ``aw_seeds``.
    - ``tolerance``: recorded by the reference's telemetry; no effect here.
    """
    del tolerance  # only the reference's obs census line reads it
    if config is None:
        config = SolverConfig()
    if model is None:
        model = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    if infomodel is not None and mesh is not None:
        raise ValueError(
            "infomodel= runs the single-device info engines; mesh= is not supported"
        )
    if mesh is not None:
        raise NotImplementedError("the sharded agent engines (mesh=) are not ported yet")
    device = torch.device(device) if device is not None else default_device()
    if infomodel is not None:
        if graph is None:
            from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

            graph = ErdosRenyiSpec(n=n_agents, avg_degree=avg_degree)
        if fp is None:
            from sbr_tpu_torch.infomodels.meanfield import solve_fixed_point_info

            fp = solve_fixed_point_info(
                infomodel, model, config=config, tol=tol, max_iter=max_iter, device=device
            )
    elif fp is None:
        fp = solve_equilibrium_social(
            model, config=config, tol=tol, max_iter=max_iter, device=device
        )
    exit_delay, reentry_delay = equilibrium_window(fp.equilibrium)

    grid = _host(fp.grid)
    g_curve = _host(fp.learning.cdf)
    eta = float(model.economic.eta)
    beta = float(model.learning.beta)
    x0 = float(model.learning.x0)

    bayes = infomodel is not None and infomodel.channel == "bayes"
    t0 = 0.0
    informed0 = t_inf0 = None
    m_curve = None
    if g0 is not None:
        if not (x0 < g0 < float(g_curve[-1])):
            raise ValueError(f"g0={g0} outside the fixed point's G range")
        # G is monotone: invert by interpolation for t0 and the seed times
        t0 = float(np.interp(g0, g_curve, grid))
        k = max(1, int(round(g0 * n_agents)))
        quantiles = (np.arange(k) + 0.5) * (g0 / k)
        s = np.interp(quantiles, g_curve, grid)  # informed times in [0, t0]
        if bayes:
            m_curve = _bayes_evidence_curve(fp, infomodel, grid)

    t_end = eta if t_max is None else float(t_max)
    n_steps = max(int(round((t_end - t0) / dt)), 2)
    sim_cfg = AgentSimConfig(
        n_steps=n_steps, dt=dt, exit_delay=exit_delay, reentry_delay=reentry_delay
    )

    if graph is not None and graph.n != n_agents:
        raise ValueError(f"graph spec n={graph.n} does not match n_agents={n_agents}")

    member_seeds = (
        [int(sd) for sd in seeds]
        if seeds is not None
        else [seed + 1000 * rep for rep in range(n_reps)]
    )
    if not member_seeds:
        raise ValueError("seeds must be non-empty")
    n_reps = len(member_seeds)

    # the seeds= axis: the graph is prepared once, at the base seed, and
    # every member reuses it; only per-member state varies. A rewire
    # model regenerates its graph every epoch, so there is none to share.
    shared_pg = None
    if seeds is not None and (infomodel is None or infomodel.dynamics == "static"):
        from sbr_tpu_torch.infomodels import engine
        from sbr_tpu_torch.social.graphgen import prepare_generated_graph

        if infomodel is not None and infomodel.channel == "gossip":
            betas_arg = (
                engine._agent_fields(infomodel, n_agents, seed, beta, np.float32, device)[0]
                .cpu().numpy()
                if infomodel.groups
                else beta
            )
            shared_pg = prepare_generated_graph(
                graph, seed=seed, betas=betas_arg, config=sim_cfg, device=device
            )
        elif infomodel is not None:
            shared_pg = prepare_generated_graph(
                graph, seed=seed, betas=1.0, config=sim_cfg, engine="gather", device=device
            )
        elif graph is not None:
            shared_pg = prepare_generated_graph(
                graph, seed=seed, betas=beta, config=sim_cfg, device=device
            )
        else:
            src, dst = erdos_renyi_edges(n_agents, avg_degree, seed=seed)
            shared_pg = prepare_agent_graph(
                beta, src, dst, n_agents, config=sim_cfg, device=device
            )

    aw_acc = g_acc = None
    aw_rows = [] if seeds is not None else None
    t = None
    for rep_seed in member_seeds:
        belief0 = None
        if g0 is not None and not bayes:
            rng = np.random.default_rng(rep_seed + 17)
            informed0 = np.zeros(n_agents, dtype=bool)
            chosen = rng.choice(n_agents, size=len(s), replace=False)
            informed0[chosen] = True
            t_inf0 = np.zeros(n_agents)
            t_inf0[chosen] = s - t0  # the clock starts at t0: seeds are ≤ 0
        if infomodel is not None:
            from sbr_tpu_torch.infomodels import engine

            if g0 is not None and bayes:
                _, thr_d, aware_d = engine._agent_fields(
                    infomodel, n_agents, rep_seed, beta, np.float32, device
                )
                ratio = _host(thr_d) / _host(aware_d)
                m0 = float(np.interp(t0, grid, m_curve))
                informed0 = ratio <= m0
                t_inf0 = np.zeros(n_agents)
                # crossing times M⁻¹(θ/a) on [0, t0], on the clock at t0
                t_inf0[informed0] = np.interp(ratio[informed0], m_curve, grid) - t0
                belief0 = m0
            sim = engine.simulate_info(
                infomodel, graph, beta=beta, x0=x0, config=sim_cfg,
                seed=rep_seed, exact_seeds=True, informed0=informed0,
                t_inf0=t_inf0, prepared=shared_pg, belief0=belief0,
                device=None if shared_pg is not None else device,
            )
        elif shared_pg is not None:
            sim = simulate_agents(
                prepared=shared_pg, x0=x0, config=sim_cfg, seed=rep_seed,
                exact_seeds=True, informed0=informed0, t_inf0=t_inf0,
            )
        elif graph is not None:
            from sbr_tpu_torch.social.graphgen import prepare_generated_graph

            pg = prepare_generated_graph(
                graph, seed=rep_seed, betas=beta, config=sim_cfg, device=device
            )
            sim = simulate_agents(
                prepared=pg, x0=x0, config=sim_cfg, seed=rep_seed,
                exact_seeds=True, informed0=informed0, t_inf0=t_inf0,
            )
        else:
            src, dst = erdos_renyi_edges(n_agents, avg_degree, seed=rep_seed)
            sim = simulate_agents(
                beta, src, dst, n_agents, x0=x0, config=sim_cfg, seed=rep_seed,
                exact_seeds=True, informed0=informed0, t_inf0=t_inf0, device=device,
            )
        aw = _host(sim.withdrawn_frac)
        g = _host(sim.informed_frac)
        if aw_rows is not None:
            aw_rows.append(aw)
        aw_acc = aw if aw_acc is None else aw_acc + aw
        g_acc = g if g_acc is None else g_acc + g
        if t is None:
            t = t0 + _host(sim.t_grid)
    aw_sim = aw_acc / n_reps
    g_sim = g_acc / n_reps

    g_fp, aw_fp = fp.curves_on(t)
    d = aw_sim - aw_fp
    dg = g_sim - g_fp
    return LoopComparison(
        fp=fp,
        exit_delay=exit_delay,
        reentry_delay=reentry_delay,
        t=t,
        aw_fp=aw_fp,
        aw_sim=aw_sim,
        g_fp=g_fp,
        g_sim=g_sim,
        n_agents=n_agents,
        n_reps=n_reps,
        err_aw_sup=float(np.max(np.abs(d))),
        err_aw_rms=float(np.sqrt(np.mean(d**2))),
        err_g_rms=float(np.sqrt(np.mean(dg**2))),
        aw_seeds=np.stack(aw_rows) if aw_rows else None,
        infomodel=infomodel,
    )
