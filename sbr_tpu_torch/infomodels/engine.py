"""Agent-level simulation of information models, in PyTorch.

The port of ``sbr_tpu.infomodels.engine`` for one device.
`simulate_info(spec, graph, ...)` runs N explicit agents under an
`InfoModelSpec` on a graph generated on the device (a `social.graphgen`
spec):

- **gossip × static** delegates to the agent simulation
  (`prepare_generated_graph` + `simulate_agents`); a K-group spec rides
  the same engines with per-agent β drawn from the group table.
- **bayes × static** runs the belief step: a Python loop over the steps
  (the reference's ``lax.scan``), each a `_seg_counts` recount of the
  withdrawn in-neighbours and one `social.fused.belief_update`, which
  launches the CUDA kernel for tensors on the card.
- **dynamics="rewire"** wraps either channel in a host loop of epochs:
  each epoch regenerates the edge set, born dst-sorted, with the source
  marginal tilted toward the agents withdrawing at its start
  (`graphgen.tilt_threshold_table`, `generate_tilted_sources`,
  `epoch_indegrees`), then runs ``epoch_steps`` steps carrying (informed,
  t_inf[, belief]) across the boundary. Gossip epochs ride
  `simulate_agents` with the global step offset (so its counter stream
  continues as under launch chunking), bayes epochs `_bayes_sim`; every
  step still ends in the channel's CUDA kernel. One scalar read fences
  each epoch.

The per-agent fields (group, threshold, awareness) come from one Threefry
block per agent keyed by SeedSequence((seed, 31)), as in the reference.
The threshold's logistic noise takes a float32 ``log``, and PyTorch's and
XLA's ``log`` differ in the last bit on about a tenth of the lanes, so the
thresholds agree to within that; groups, awareness and β are equal bit for
bit. `agent_fields_from_numpy` carries fields from elsewhere (the JAX
package, or another device), so that two runs compute the same simulation.

A rewire run equals ``sbr_tpu``'s bit for bit in both channels (the bayes
channel with the fields carried), fractions, final state and epochs alike
(tested).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.infomodels.spec import InfoModelSpec
from sbr_tpu_torch.social import agents as A
from sbr_tpu_torch.social import graphgen as G
from sbr_tpu_torch.social.fused import belief_update
from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec, ScaleFreeSpec, prepare_generated_graph
from sbr_tpu_torch.social.rng import _threefry2x32, _uniform_from_bits


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class InfoSimResult:
    """Population trajectories and final per-agent state of one run: the
    `AgentSimResult` fields plus the belief channel's state and the
    number of graphs the run saw."""

    t_grid: torch.Tensor  # (n_steps,)
    informed_frac: torch.Tensor  # (n_steps,)
    withdrawn_frac: torch.Tensor  # (n_steps,)
    informed: torch.Tensor  # (N,) bool, final
    t_inf: torch.Tensor  # (N,) informed times
    belief: Optional[torch.Tensor] = None  # (N,) final log-odds evidence (bayes)
    epochs: int = 1  # distinct graphs the run saw (1 = static)
    agent_steps: int = 0
    belief_updates: int = 0  # N·steps through belief_update (bayes only)

    def __repr__(self) -> str:
        return (
            f"InfoSimResult(N={self.informed.shape[-1]}, "
            f"steps={self.t_grid.shape[-1]}, epochs={self.epochs}, "
            f"final_G={float(self.informed_frac[-1]):.4g}, "
            f"final_AW={float(self.withdrawn_frac[-1]):.4g})"
        )


def _agent_fields(spec: InfoModelSpec, n: int, seed: int, beta: float, dtype,
                  device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-agent (betas, thresholds, awareness) on ``device`` from the
    K-group table: one Threefry block per agent keyed by
    SeedSequence((seed, 31)). The threshold's uniform takes word 1 as its
    high word, the group's word 0, in the reference's order.

    Thresholds are θ_g + s·log(u/(1−u)) with u clipped to [2^-23, 1−2^-23]
    and the log taken in float32. β is β·a_g/⟨a⟩ (dist-weighted mean), so
    a homogeneous spec's awareness cancels in the gossip channel; the
    bayes channel reads the awareness itself."""
    device = torch.device(device)
    tdtype = A._TORCH_DTYPE[np.dtype(dtype)]
    weights, thresholds, awareness = spec.group_table()
    k0, k1 = np.random.SeedSequence((seed, 31)).generate_state(2, np.uint32)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    x0w, x1w = _threefry2x32(int(k0), int(k1), ids, torch.zeros_like(ids))
    u_thr = _uniform_from_bits(x1w, x0w, torch.float32)
    if len(weights) > 1:
        u_grp = _uniform_from_bits(x0w, x1w, torch.float32)
        cum = torch.tensor(np.cumsum(weights[:-1]), dtype=torch.float32, device=device)
        grp = torch.searchsorted(cum, u_grp, right=True)
    else:
        grp = torch.zeros(n, dtype=torch.int64, device=device)
    thr_g = torch.tensor(thresholds, dtype=tdtype, device=device)
    a_g = torch.tensor(awareness, dtype=tdtype, device=device)
    eps = 2.0**-23
    u_c = torch.clamp(u_thr, eps, 1.0 - eps)
    noise = torch.log(u_c / (1.0 - u_c)).to(tdtype)
    thr = thr_g[grp] + torch.tensor(spec.threshold_scale, dtype=tdtype, device=device) * noise
    aware = a_g[grp]
    mean_a = float(sum(w * a for w, a in zip(weights, awareness)))
    # divide by a device tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    betas = torch.tensor(beta, dtype=tdtype, device=device) * aware / torch.tensor(
        mean_a, dtype=tdtype, device=device
    )
    return betas, thr, aware


def agent_fields_from_numpy(betas, thresholds, awareness, device):
    """Per-agent (betas, thresholds, awareness) from numpy arrays of one
    float dtype, on ``device``: the fields `_agent_fields` draws, carried
    from another run (``sbr_tpu``'s, or this package's on another device),
    to pass to `simulate_info` as ``fields=``."""
    device = torch.device(device)
    return tuple(A._tensor(np.asarray(a), device) for a in (betas, thresholds, awareness))


def _bayes_sim(prepared: A.PreparedAgentGraph, awareness, thr, llr01, informed0,
               t_init, belief0, k0: int, config: A.AgentSimConfig):
    """The Bayesian observer simulation on one device: per step one
    `_seg_counts` recount over the dst-sorted edges and one fused
    `belief_update`. ``llr01`` holds (llr0, llr1) rounded to the sim dtype;
    ``k0`` is the global index of the first step. Returns the per-step
    informed and withdrawn fractions and the final (informed, t_inf,
    belief)."""
    n = prepared.n
    dev = prepared.device
    dtype = prepared.indeg.dtype
    src, row_ptr = prepared.src, prepared.row_ptr
    ts = A._step_times(config, k0, prepared.dtype)
    t_next = A._next_times(config, k0, prepared.dtype)
    llr0, llr1 = (float(v) for v in llr01)
    t_inf = torch.where(informed0, t_init, float("inf")).to(dtype)
    informed, belief = informed0, belief0
    safe_deg = torch.clamp(prepared.indeg, min=1.0)
    g_counts = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    w_counts = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    for j in range(config.n_steps):
        wd = A._withdrawn(informed, t_inf, float(ts[j]), config.exit_delay,
                          config.reentry_delay)
        counts = A._seg_counts(wd[src], row_ptr)
        g_counts[j] = informed.sum()
        w_counts[j] = wd.sum()
        # agents crossing in step k get t_{k+1} (see social.fused)
        informed, t_inf, belief = belief_update(
            informed, t_inf, belief, counts, awareness, safe_deg, thr,
            float(t_next[j]), config.dt, llr0, llr1, config.fused,
        )
    return (
        A._fractions(g_counts, n, prepared.dtype),
        A._fractions(w_counts, n, prepared.dtype),
        informed, t_inf, belief,
    )


def _gather_prepared(n: int, e: int, betas, src, row_ptr, indeg, dtype,
                     device) -> A.PreparedAgentGraph:
    """One epoch's arrays as a gather-engine `PreparedAgentGraph`, so a
    rewired gossip epoch rides `simulate_agents` unchanged."""
    return A.PreparedAgentGraph(
        n=n, n_edges=e, dtype=np.dtype(dtype), device=device, engine="gather",
        budget=0, max_degree=64, betas=betas, src=src, row_ptr=row_ptr,
        indeg=indeg, inc=None,
    )


def _base_source_weights(graph, device) -> torch.Tensor:
    """The base source marginal (float32) that the panic tilt multiplies:
    uniform for Erdős–Rényi, the Chung–Lu weights for scale-free,
    normalised in float64 and then rounded, as the reference does. SBM's
    source law conditions on the destination's block, which no marginal
    table expresses, so rewiring rejects it."""
    if isinstance(graph, ErdosRenyiSpec):
        return torch.ones(graph.n, dtype=torch.float32, device=device)
    if isinstance(graph, ScaleFreeSpec):
        w = np.arange(1, graph.n + 1, dtype=np.float64) ** (-1.0 / (graph.gamma - 1.0))
        return torch.from_numpy((w / w.sum()).astype(np.float32)).to(device)
    raise ValueError(
        f"dynamics='rewire' supports ErdosRenyiSpec/ScaleFreeSpec base "
        f"graphs (the SBM source law conditions on the destination block); "
        f"got {type(graph).__name__}"
    )


def _log_belief_census(dynamics: str, crossed: int, belief: torch.Tensor) -> None:
    obs.log_infomodel("belief_census", channel="bayes", dynamics=dynamics, crossed=crossed,
                      mean_belief=float(belief.mean()), max_belief=float(belief.max()))


def _simulate_rewire(spec: InfoModelSpec, graph, seed: int, config: A.AgentSimConfig,
                     dtype: np.dtype, fields, llr01, informed, t_init, belief,
                     chunk_edges, device) -> InfoSimResult:
    """The panic-rewiring epoch loop of `simulate_info` (module docstring).
    ``t_inf`` is carried with inf for the never-informed, as each epoch
    returns it, and enters the next epoch with inf replaced by 0 (the
    engines put inf back where the agent is uninformed)."""
    n = graph.n
    tdtype = A._TORCH_DTYPE[dtype]
    betas_d, thr_d, aware_d = fields
    e = G._check_edges(graph.edge_count(seed))
    base_w = _base_source_weights(graph, device)
    t_inf = torch.where(informed, t_init, float("inf")).to(tdtype)
    gs_parts, aws_parts = [], []
    done = n_epochs = 0
    while done < config.n_steps:
        this_len = min(spec.epoch_steps, config.n_steps - done)
        # the epoch's start time rounds from the float64 product, as the
        # reference's jnp.asarray(done * dt, dtype) does
        t_now = float(dtype.type(done * config.dt))
        wd_now = A._withdrawn(informed, t_inf, t_now, config.exit_delay, config.reentry_delay)
        thr_table = G.tilt_threshold_table(base_w, wd_now, spec.rewire_bias)
        src = G.generate_tilted_sources(
            n, e, G.epoch_key_words(seed, n_epochs), thr_table, chunk_edges
        )
        indeg_h = G.epoch_indegrees(graph, seed, n_epochs, e)
        row_ptr = torch.from_numpy(G._row_ptr_host(indeg_h)).to(device)
        indeg = A._tensor(indeg_h.astype(dtype), device)
        pg = _gather_prepared(n, e, betas_d, src, row_ptr, indeg, dtype, device)
        cfg_ep = dataclasses.replace(config, n_steps=this_len, max_steps_per_launch=None)
        t_start = torch.where(torch.isfinite(t_inf), t_inf, 0.0).to(tdtype)
        if spec.channel == "gossip":
            part = A.simulate_agents(
                prepared=pg, config=cfg_ep, seed=seed, informed0=informed,
                t_inf0=t_start, step_offset=done,
            )
            informed, t_inf = part.informed, part.t_inf
            gs, aws = part.informed_frac, part.withdrawn_frac
        else:
            gs, aws, informed, t_inf, belief = _bayes_sim(
                pg, aware_d, thr_d, llr01, informed, t_start, belief, done, cfg_ep
            )
        gs_parts.append(gs)
        aws_parts.append(aws)
        if obs.enabled():
            obs.log_infomodel("rewire_epoch", epoch=n_epochs, channel=spec.channel,
                              steps=this_len, edges=e, withdrawing=int(wd_now.sum()))
        done += this_len
        n_epochs += 1
        float(gs[-1])  # one scalar fence an epoch boundary
    bayes = spec.channel == "bayes"
    if bayes and obs.enabled():
        _log_belief_census("rewire", int(informed.sum()), belief)
    return InfoSimResult(
        t_grid=A._tensor(A._step_times(config, 0, dtype)[:-1], device),
        informed_frac=torch.cat(gs_parts), withdrawn_frac=torch.cat(aws_parts),
        informed=informed, t_inf=t_inf, belief=belief if bayes else None,
        epochs=n_epochs, agent_steps=n * config.n_steps,
        belief_updates=n * config.n_steps if bayes else 0,
    )


def simulate_info(
    spec: InfoModelSpec,
    graph,
    beta: float = 0.9,
    x0: float = 1e-4,
    config: A.AgentSimConfig = A.AgentSimConfig(),
    seed: int = 0,
    dtype=np.float32,
    engine: str = "auto",
    exact_seeds: bool = False,
    informed0=None,
    t_inf0=None,
    chunk_edges=None,
    prepared: Optional[A.PreparedAgentGraph] = None,
    belief0=None,
    device=None,
    fields=None,
) -> InfoSimResult:
    """Simulate N explicit agents under information model ``spec`` on the
    graph ``graph`` (a `social.graphgen` spec), generated on ``device``
    (the CUDA card unless the caller names one).

    ``beta`` is the gossip learning rate; the bayes channel ignores it.
    ``config`` carries the step grid and the withdrawal window as for
    `simulate_agents`, and ``config.fused`` selects the lowering of both
    channels' step. ``prepared`` (a graph to reuse; its device is the
    run's) must, for the gossip channel, carry the spec's per-agent β.
    ``fields``: the (betas, thresholds, awareness) tensors of
    `agent_fields_from_numpy`, used instead of drawing them.

    ``dynamics="rewire"`` regenerates the graph every epoch (module
    docstring), so it takes no ``prepared``; ``engine`` does not apply.

    The gossip-reducible spec's result equals `simulate_agents` on the
    same prepared graph, and ``sbr_tpu``'s, bit for bit; with the same
    fields, the bayes channel's equals ``sbr_tpu``'s bit for bit, static
    or rewired (tested)."""
    rewire = spec.dynamics == "rewire"
    if prepared is not None and rewire:
        raise ValueError(
            "prepared= conflicts with dynamics='rewire': rewiring regenerates "
            "the edge set every epoch, so there is no graph to reuse"
        )
    if belief0 is not None and spec.channel != "bayes":
        raise ValueError("belief0= only applies to channel='bayes'")
    if prepared is not None:
        if device is not None:
            raise ValueError("device= conflicts with prepared=: the prepared graph fixes it")
        if prepared.mesh is not None:
            raise ValueError(
                "prepared= is sharded over a mesh: the information engines run on one "
                "device (shard the gossip path through social.agents)"
            )
        device = prepared.device
    device = torch.device(device) if device is not None else A.default_device()
    n = graph.n
    dtype = np.dtype(dtype)
    hetero = len(spec.group_table()[0]) > 1

    if spec.channel == "gossip" and not rewire:
        pg = prepared
        if pg is None:
            if fields is not None:
                betas_arg = fields[0].cpu().numpy()
            elif hetero:
                betas_arg = _agent_fields(spec, n, seed, beta, dtype, device)[0].cpu().numpy()
            else:
                betas_arg = beta
            pg = prepare_generated_graph(
                graph, seed=seed, betas=betas_arg, config=config, dtype=dtype,
                engine=engine, chunk_edges=chunk_edges, device=device,
            )
        r = A.simulate_agents(
            prepared=pg, x0=x0, config=config, seed=seed,
            exact_seeds=exact_seeds, informed0=informed0, t_inf0=t_inf0,
        )
        return InfoSimResult(
            t_grid=r.t_grid, informed_frac=r.informed_frac,
            withdrawn_frac=r.withdrawn_frac, informed=r.informed,
            t_inf=r.t_inf, belief=None, epochs=1, agent_steps=r.agent_steps,
        )

    pg = prepared
    if pg is None and not rewire:
        pg = prepare_generated_graph(
            graph, seed=seed, betas=1.0, config=config, dtype=dtype,
            engine="gather", chunk_edges=chunk_edges, device=device,
        )
    if pg is not None:
        dtype = pg.dtype
    tdtype = A._TORCH_DTYPE[dtype]
    if fields is None:
        fields = _agent_fields(spec, n, seed, beta, dtype, device)
    fields = tuple(f.to(device=device, dtype=tdtype) for f in fields)
    _, thr_d, aware_d = fields
    llr01 = tuple(dtype.type(v) for v in spec.llr)
    if informed0 is None:
        informed0 = A._draw_seeds(np.random.default_rng(seed), n, x0, exact_seeds)
    informed_d = A._state_tensor(informed0, torch.bool, bool, device)
    if t_inf0 is None:
        t_init_d = torch.zeros(n, dtype=tdtype, device=device)
    else:
        t_init_d = A._state_tensor(t_inf0, tdtype, dtype, device)
    if belief0 is None:
        belief_d = torch.zeros(n, dtype=tdtype, device=device)
    else:
        belief_d = A._tensor(np.broadcast_to(np.asarray(belief0, dtype), (n,)), device)
    if rewire:
        return _simulate_rewire(spec, graph, seed, config, dtype, fields, llr01, informed_d,
                                t_init_d, belief_d, chunk_edges, device)
    gs, aws, informed, t_inf, belief = _bayes_sim(
        pg, aware_d, thr_d, llr01, informed_d, t_init_d, belief_d, 0, config
    )
    if obs.enabled():
        _log_belief_census("static", int(informed.sum()) - int(informed_d.sum()), belief)
    return InfoSimResult(
        t_grid=A._tensor(A._step_times(config, 0, dtype)[:-1], device),
        informed_frac=gs, withdrawn_frac=aws, informed=informed, t_inf=t_inf,
        belief=belief, epochs=1, agent_steps=n * config.n_steps,
        belief_updates=n * config.n_steps,
    )
