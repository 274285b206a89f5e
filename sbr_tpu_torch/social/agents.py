"""Explicit-agent social learning on graphs, in PyTorch.

N agents with heterogeneous learning rates β_i on a directed graph, each
learning from the withdrawal actions of its in-neighbors. Per step of size
dt::

    withdrawn_i(t) = informed_i ∧ (t ≥ t_inf_i + exit_delay)
                                ∧ (t < t_inf_i + reentry_delay)
    frac_i(t)      = (Σ_{j→i} withdrawn_j) / indegree_i    ← segmented reduce
    P(i informs)   = 1 - exp(-β_i · frac_i · dt)           ← exact hazard

The port of ``sbr_tpu.social.agents``. Two engines compute the
per-destination withdrawn-neighbor counts, bit-identical in results:

- "gather": full recount every step, an exact int32 prefix sum over the
  dst-sorted edges plus row-pointer gathers (`_seg_counts`).
- "incremental": event-driven ±1 updates over the changed agents'
  out-edges, with the full recount as the overflow fallback
  (`_incremental_sim`). The fallback is a host ``if`` on the step's
  overflow flag, which costs one small device-to-host sync per step.

Both end every step in `social.fused.infection_update`, which launches the
CUDA kernel for tensors on the card. Each step is one iteration of a
Python loop (the JAX package's ``lax.scan``). Seeds and Erdős–Rényi edges
come from the same numpy calls as in the JAX package, and the per-(agent,
step) draw from the same Threefry stream, so the two packages agree bit for
bit on the same inputs (tested).

**Sharding** (``mesh=``, a ``DeviceMesh`` of `parallel.mesh`): every rank
of the mesh axis runs the same program on its block of agents
(block-sharded by id, padded with inert agents to a multiple of the axis
size, or of 8× it for the bitpacked paths) and its chunk of the
dst-sorted edges (sharded by edge count). Agent ids stay global, so each
rank's infection draws are keyed exactly as on one device, and the run is
bit for bit the single-device run on any mesh. Per step, by ``comm``:

- "scatter" (default): the withdrawn mask is packed to N/8 bytes
  (`recount.pack_mask`), all-gathered, gathered per edge by
  `recount.bit_gather` (the recount CUDA kernel on the card), reduced by
  `_seg_counts` over this rank's edges and delivered by one
  ``psum_scatter``, each rank receiving its own block's counts;
- "allgather_psum": the naive baseline, a bool all-gather, `_seg_counts`,
  a full psum and a slice.

The incremental engine under a mesh (`_run_sharded`) shards the
src-sorted out-edges by edge count, detects changes globally from the
all-gathered packed mask, and falls back to the same bitpacked recount on
an overflow anywhere. The collectives are those of
`parallel.collectives`. The engines run eagerly: a CUDA graph cannot
hold a collective of a gloo group.

``engine="measure"`` in `prepare_agent_graph` times each candidate engine
on the graph and keeps the faster. Both RNG streams run on every engine
(``AgentSimConfig.rng_stream``, `rng._agent_uniforms`), and every float
type of the reference: float16 and bfloat16 round where XLA on the CPU
rounds the reference's step (`social.fused`, `_next_times`, `_fractions`).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch.native import sort_edges_by_dst
from sbr_tpu_torch.parallel import collectives as C
from sbr_tpu_torch.parallel.mesh import axis_index, axis_size, mesh_device
from sbr_tpu_torch.social import recount
from sbr_tpu_torch.social.fused import MODES, host_round, infection_update
from sbr_tpu_torch.social.rng import prng_key

try:  # numpy's bfloat16 (the JAX package's jnp.bfloat16) comes from ml_dtypes
    import ml_dtypes as _ml_dtypes
except ImportError:  # pragma: no cover - then bfloat16 runs take torch tensors only
    _ml_dtypes = None

_TORCH_DTYPE = {
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
if _ml_dtypes is not None:
    _TORCH_DTYPE[np.dtype(_ml_dtypes.bfloat16)] = torch.bfloat16


def default_device() -> torch.device:
    """The device entry points run on unless the caller names one: the
    CUDA card. Raises when there is none — pass ``device="cpu"`` to run the
    plain versions on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: sbr_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Graph generation (host-side numpy)
# ---------------------------------------------------------------------------


def erdos_renyi_edges(n: int, avg_degree: float, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse directed Erdős–Rényi G(n, p) with p = avg_degree/(n-1).

    Draws E ~ Binomial(n(n-1), p) directed pairs uniformly, with self-loops
    resampled away. Returns (src, dst) int32 arrays: the numpy stream of
    ``sbr_tpu.social.agents.erdos_renyi_edges`` (its path without the
    native sampler), so a seed gives the same graph.
    """
    rng = np.random.default_rng(seed)
    p = avg_degree / max(n - 1, 1)
    e = int(rng.binomial(n * (n - 1), p))
    src = rng.integers(0, n, size=e, dtype=np.int32)
    dst = rng.integers(0, n, size=e, dtype=np.int32)
    loops = src == dst
    dst[loops] = (dst[loops] + 1 + rng.integers(0, n - 1, size=loops.sum())) % n
    return src, dst


def scale_free_edges(
    n: int, avg_degree: float, gamma: float = 2.5, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Directed scale-free graph via the Chung–Lu power-law model: both
    endpoints drawn with probability ∝ (i+1)^{-1/(γ-1)}, so in- and
    out-degrees have tail exponent γ."""
    rng = np.random.default_rng(seed)
    e = int(n * avg_degree)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (gamma - 1.0))
    w /= w.sum()
    src = rng.choice(n, size=e, p=w).astype(np.int32)
    dst = rng.choice(n, size=e, p=w).astype(np.int32)
    loops = src == dst
    dst[loops] = (dst[loops] + 1 + rng.integers(0, n - 1, size=loops.sum())) % n
    return src, dst


# ---------------------------------------------------------------------------
# Configuration and result
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AgentSimConfig:
    """Static simulation knobs, with the fields and checks of
    ``sbr_tpu.social.agents.AgentSimConfig``.

    - n_steps: time steps of size dt over [0, n_steps·dt].
    - dt: step size.
    - exit_delay / reentry_delay: the withdrawal window relative to each
      agent's informed time.
    - max_steps_per_launch: split a run into host-level chunks of at most
      this many steps, carrying (informed, t_inf); bit-identical to the
      unchunked run.
    - compact_impl: lowering of the incremental engine's change compaction
      ("searchsorted" | "searchsorted_blocked" | "scatter"; bit-identical).
    - rng_stream: "counter" (one Threefry block an agent, fused into the
      infection kernel) or "foldin" (two chained blocks, run unfused in
      every mode, as the reference runs it).
    - fused: lowering of the infection step (see `social.fused`).
    """

    n_steps: int = 200
    dt: float = 0.1
    exit_delay: float = 0.0
    reentry_delay: float = float("inf")
    max_steps_per_launch: Optional[int] = None
    compact_impl: str = "searchsorted"
    rng_stream: str = "counter"
    fused: str = "auto"

    def __post_init__(self):
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if self.dt <= 0:
            raise ValueError("dt must be positive")
        if self.max_steps_per_launch is not None and self.max_steps_per_launch < 1:
            raise ValueError("max_steps_per_launch must be >= 1 (or None)")
        if self.compact_impl not in ("scatter", "searchsorted", "searchsorted_blocked"):
            raise ValueError(
                "compact_impl must be 'scatter', 'searchsorted', or "
                "'searchsorted_blocked'"
            )
        if self.rng_stream not in ("foldin", "counter"):
            raise ValueError("rng_stream must be 'foldin' or 'counter'")
        if self.fused not in MODES:
            raise ValueError(f"fused must be one of {MODES}, got {self.fused!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class AgentSimResult:
    """Trajectories of the population aggregates plus final per-agent state.

    ``informed_frac``/``withdrawn_frac`` are sampled at step starts
    (t = k·dt): the explicit-population analogues of G(t) and AW(t).
    ``full_recount_steps`` flags the steps that recomputed the neighbor
    counts by the full recount (every step for "gather")."""

    t_grid: torch.Tensor  # (n_steps,)
    informed_frac: torch.Tensor  # (n_steps,)
    withdrawn_frac: torch.Tensor  # (n_steps,)
    informed: torch.Tensor  # (N,) bool, final
    t_inf: torch.Tensor  # (N,) informed times (inf when never informed)
    full_recount_steps: Optional[torch.Tensor] = None  # (n_steps,) bool
    agent_steps: int = 0

    def __repr__(self) -> str:
        rec = ""
        if self.full_recount_steps is not None:
            rec = f", recounts={int(self.full_recount_steps.sum())}"
        return (
            f"AgentSimResult(N={self.informed.shape[-1]}, "
            f"steps={self.t_grid.shape[-1]}, "
            f"final_G={float(self.informed_frac[-1]):.4g}, "
            f"final_AW={float(self.withdrawn_frac[-1]):.4g}{rec})"
        )


def _withdrawn(informed, t_inf, t, exit_delay, reentry_delay):
    # the delays rounded to the state's dtype first, as the reference's
    # weakly typed scalars are (it matters below 32 bits)
    exit_delay = host_round(exit_delay, t_inf.dtype)
    reentry_delay = host_round(reentry_delay, t_inf.dtype)
    return informed & (t >= t_inf + exit_delay) & (t < t_inf + reentry_delay)


def _compact_ids(mask, budget: int, dump: int, impl: str = "scatter"):
    """Ascending indices of True entries, padded with ``dump``: the
    ``nonzero(size=budget, fill_value=dump)`` contract, in the three
    bit-identical lowerings of ``sbr_tpu.social.agents._compact_ids``
    (each keeps the first ``budget`` True indices on overflow)."""
    n_mask = mask.shape[0]
    dev = mask.device
    if impl in ("searchsorted", "searchsorted_blocked"):
        m = mask.to(torch.int32)
        if impl == "searchsorted_blocked":
            pad = (-n_mask) % 128
            if pad:
                m = torch.cat([m, torch.zeros(pad, dtype=torch.int32, device=dev)])
            within = torch.cumsum(m.reshape(-1, 128), dim=1, dtype=torch.int32)
            row_tot = within[:, -1]
            offs = torch.cumsum(row_tot, 0, dtype=torch.int32) - row_tot
            c = (within + offs[:, None]).reshape(-1)[:n_mask]
        else:
            c = torch.cumsum(m, 0, dtype=torch.int32)
        q = torch.arange(1, budget + 1, dtype=torch.int32, device=dev)
        res = torch.searchsorted(c, q, side="left", out_int32=True)
        return torch.where(res >= n_mask, dump, res)
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.where(mask & (pos < budget), pos, budget)
    ids = torch.arange(n_mask, dtype=torch.int32, device=dev)
    out = torch.full((budget + 1,), dump, dtype=torch.int32, device=dev)
    return out.scatter_(0, idx.to(torch.int64), ids)[:budget]


def _draw_seeds(rng, n: int, x0: float, exact_seeds: bool) -> np.ndarray:
    """Initial informed mask, in the JAX package's draw order: exactly
    round(x0·n) seeds (≥1 when x0>0) under ``exact_seeds``, else Bernoulli
    seeds with ≥1 guaranteed when x0>0."""
    if exact_seeds:
        k = max(1, int(round(x0 * n))) if x0 > 0 else 0
        informed0 = np.zeros(n, bool)
        if k:
            informed0[rng.choice(n, size=k, replace=False)] = True
        return informed0
    informed0 = rng.random(n) < x0
    if x0 > 0 and not informed0.any():
        informed0[rng.integers(0, n)] = True
    return informed0


def _canonicalize_graph(betas, src, dst, n: int, dtype):
    """Host-side canonicalization: per-agent β, in-degrees, dst-sorted edges
    and their int32 row-pointer table (edges of agent i occupy
    [row_ptr[i], row_ptr[i+1]))."""
    betas = np.broadcast_to(np.asarray(betas, dtype=dtype), (n,)).copy()
    src, dst, indeg_i, row_ptr = sort_edges_by_dst(src, dst, n)
    return betas, src, dst, indeg_i.astype(dtype), row_ptr.astype(np.int32)


# ---------------------------------------------------------------------------
# Engine census (host numpy; copied from the JAX package)
# ---------------------------------------------------------------------------


def _auto_engine(
    edge_slices,
    max_degree: int,
    n_steps: int,
    n: int,
    beta_mean: float,
    dt: float,
    budget: int,
    waves: float = 2.0,
) -> str:
    """Engine choice for engine="auto": incremental when its expected cost
    in recount units beats the gather engine's. A fallback step costs one
    recount plus detection overhead (1+ε, ε = 0.15); a clean incremental
    step ρ = 0.35 recounts (the JAX package's calibration)."""
    fallback_steps = _census_fallback_steps(
        edge_slices, max_degree, n_steps, n, beta_mean, dt, budget, waves
    )
    rho, eps = 0.35, 0.15
    cost_incremental = fallback_steps * (1.0 + eps) + max(
        n_steps - fallback_steps, 0.0
    ) * rho
    return "incremental" if cost_incremental <= n_steps else "gather"


# The realized transition is ~25% wider than the mean-field logistic, so the
# census runs its trajectory at β/1.25 (the JAX package's calibration).
_CENSUS_BAND_STRETCH = 1.25


def _census_fallback_steps(
    edge_slices,
    max_degree: int,
    n_steps: int,
    n: int,
    beta_mean: float,
    dt: float,
    budget: int,
    waves: float = 2.0,
) -> float:
    """Predicted full-recount steps of the incremental engine: steps whose
    change mass on the band-stretched logistic exceeds ``budget``, plus the
    saturating hub term Σ(1-exp(-H·ΔG̃)) for H agents above ``max_degree``."""
    hubs = int((np.asarray(edge_slices) > max_degree).sum())
    fallback_steps = 0.0
    if beta_mean > 0:
        x0c = 1e-4
        t = np.arange(n_steps + 1) * dt
        beta_eff = beta_mean / _CENSUS_BAND_STRETCH
        g = x0c / (x0c + (1.0 - x0c) * np.exp(-beta_eff * t))
        dgt = waves * np.diff(g)
        overflow = (n * dgt > budget) if budget > 0 else np.zeros_like(dgt, bool)
        p_hub = -np.expm1(-hubs * dgt) if hubs > 0 else 0.0
        fallback_steps = float(np.sum(np.where(overflow, 1.0, p_hub)))
    return fallback_steps


def _census_waves(config: AgentSimConfig) -> float:
    """Change waves per agent within the horizon T = n_steps·dt: the entry
    wave if entries can occur before T, the exit wave if exits can; an
    empty window never changes anyone."""
    horizon = config.n_steps * config.dt
    if config.exit_delay >= config.reentry_delay or config.exit_delay >= horizon:
        return 0.0
    return 1.0 + float(config.reentry_delay < horizon)


def _default_incremental_budget(n_block: int, floor: int = 4096) -> int:
    """Default per-step changed-agent budget of the incremental engine."""
    return min(max(floor, n_block // 64), 65536)


def _resolve_engine_from_outdeg(
    outdeg_c,
    n: int,
    e: int,
    config: AgentSimConfig,
    incremental_budget: Optional[int],
    d0: int,
    beta_mean: float,
    mesh=None,
    mesh_axis: str = "agents",
) -> str:
    """The engine="auto" decision from the host out-degree census: the
    whole out-degree vector on one device, the per-chunk slice tail under
    a mesh, with the budget the runtime will use (per rank under a mesh,
    times the axis size)."""
    if e == 0:
        return "gather"
    outdeg_c = np.asarray(outdeg_c, dtype=np.int64)
    if mesh is None:
        census = outdeg_c
        budget_est = incremental_budget or _default_incremental_budget(n)
    else:
        # edge-count sharding splits hub edges across chunks, and the
        # per-rank change budget multiplies across ranks
        n_dev_a = axis_size(mesh, mesh_axis)
        ec_a = max(1, -(-e // n_dev_a))
        out_ptr_c = np.concatenate([[0], np.cumsum(outdeg_c)])
        census = _max_chunk_slice(out_ptr_c, ec_a, n)
        nb_a = (n + (-n) % (8 * n_dev_a)) // n_dev_a
        budget_est = (
            incremental_budget or _default_incremental_budget(nb_a, floor=512)
        ) * n_dev_a
    return _auto_engine(
        census,
        d0,
        config.n_steps,
        n,
        beta_mean,
        config.dt,
        int(budget_est),
        waves=_census_waves(config),
    )


def _max_chunk_slice(out_ptr: np.ndarray, ec: int, n: int) -> np.ndarray:
    """Per-agent largest out-edge slice under edge-count sharding with chunk
    size ``ec``: an agent's src-sorted edge range lands in 1-2 chunks when
    its degree is at most ``ec`` (middle chunks of longer spans are full)."""
    starts = out_ptr[:-1].astype(np.int64)
    ends = out_ptr[1:].astype(np.int64)
    f = starts // ec
    piece1 = np.minimum(ends, (f + 1) * ec) - starts
    piece2 = np.clip(ends - (f + 1) * ec, 0, ec)
    return np.maximum(piece1, piece2)[:n]


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _seg_counts(active_src, row_ptr):
    """Per-destination neighbor counts from a dst-sorted edge activity mask:
    exact int32 prefix sum P, counts_i = P[row_ptr[i+1]] − P[row_ptr[i]]."""
    prefix = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=active_src.device),
        torch.cumsum(active_src.to(torch.int32), 0, dtype=torch.int32),
    ])
    return prefix[row_ptr[1:]] - prefix[row_ptr[:-1]]


def _step_times(config: AgentSimConfig, k0: int, np_dtype) -> np.ndarray:
    """t_k = dtype(k)·dtype(dt) for the call's global steps and the one
    after them, rounded as the JAX package's ``k.astype(dtype) * dt``."""
    ks = np.arange(config.n_steps + 1, dtype=np.int64) + k0
    return ks.astype(np_dtype) * np_dtype.type(config.dt)


def _next_times(config: AgentSimConfig, k0: int, np_dtype) -> np.ndarray:
    """The informed time of an agent newly informed in step k, for the
    call's global steps: the JAX package's ``t + dt`` with t = dtype(k)·dt,
    rounded as XLA on the CPU rounds it. It contracts the multiply-add into
    one fused multiply-add in float64, float32 and float16 (the last
    through a float32 fma), which is dtype(k+1)·dt rounded once; bfloat16
    rounds the product and the sum each."""
    ks = np.arange(config.n_steps, dtype=np.int64) + k0
    dt = np_dtype.type(config.dt)
    if _TORCH_DTYPE.get(np_dtype) == torch.bfloat16:
        return ks.astype(np_dtype) * dt + dt  # each operation rounded
    if np_dtype == np.float16:
        exact = ks.astype(np_dtype).astype(np.float64) * float(dt) + float(dt)
        return exact.astype(np.float32).astype(np_dtype)
    return (ks + 1).astype(np_dtype) * dt


def _fractions(counts: torch.Tensor, n: int, np_dtype) -> torch.Tensor:
    """Integer counts as fractions of n, rounded as the JAX package's
    ``mean`` of a 0/1 vector rounds them: XLA turns the division by the
    constant n into a product with its reciprocal, rounded in the dtype of
    the sum, which is float32 for the half types (then rounded once to
    the dtype)."""
    acc = np.dtype(np.float32) if np_dtype.itemsize < 4 else np_dtype
    recip = acc.type(1) / acc.type(n)
    return (counts.to(_TORCH_DTYPE[acc]) * float(recip)).to(_TORCH_DTYPE[np_dtype])


def _run_engine(prepared, config: AgentSimConfig, informed0, t_init, key, k0: int):
    """One launch of ``config.n_steps`` steps on one device, either engine.
    Returns the per-step (informed, withdrawn) counts, the recount flags
    and the final state."""
    n = prepared.n
    dev = prepared.device
    dtype = prepared.betas.dtype
    betas, src, row_ptr = prepared.betas, prepared.src, prepared.row_ptr
    ts = _step_times(config, k0, prepared.dtype)
    t_next = _next_times(config, k0, prepared.dtype)
    t_inf = torch.where(informed0, t_init, float("inf")).to(dtype)
    informed = informed0
    safe_deg = torch.clamp(prepared.indeg, min=1.0)
    g_counts = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    w_counts = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    incremental = prepared.engine == "incremental"
    recounts = []
    if incremental:
        dst2, out_ptr, outdeg = prepared.inc
        e = src.shape[0]
        budget_agents, budget_deg = prepared.budget, prepared.max_degree
        d_lane = torch.arange(budget_deg, dtype=torch.int32, device=dev)[None, :]
        counts = torch.zeros(n, dtype=torch.int32, device=dev)
        wd_prev = torch.zeros(n, dtype=torch.bool, device=dev)

    for j in range(config.n_steps):
        k = k0 + j
        t = float(ts[j])
        wd = _withdrawn(informed, t_inf, t, config.exit_delay, config.reentry_delay)
        if incremental:
            dwd = wd.to(torch.int32) - wd_prev.to(torch.int32)
            changed = dwd != 0
            n_changed = changed.sum()
            cids = _compact_ids(changed, budget_agents, n, config.compact_impl)
            valid = cids < n
            cids_c = torch.clamp(cids, max=n - 1)
            degs = torch.where(valid, outdeg[cids_c], 0)
            overflow = (n_changed > budget_agents) | (degs.max() > budget_deg)
            # the host `if` that stands for lax.cond: one small sync per step
            if bool(overflow):
                counts = _seg_counts(wd[src], row_ptr)
            else:
                starts = out_ptr[cids_c]
                emask = d_lane < degs[:, None]
                eidx = torch.clamp(starts[:, None] + d_lane, max=e - 1)
                dsts = dst2[eidx]
                sign = torch.where(valid, dwd[cids_c], 0)
                delta = torch.where(emask, sign[:, None], 0)
                # integer adds commute, so the atomic order cannot matter
                counts = counts.index_add(0, dsts.reshape(-1), delta.reshape(-1))
            recounts.append(bool(overflow))
            wd_prev = wd
        else:
            counts = _seg_counts(wd[src], row_ptr)
        g_counts[j] = informed.sum()
        w_counts[j] = wd.sum()
        # agents informed in step k get t_{k+1} (see social.fused)
        informed, t_inf = infection_update(
            informed, t_inf, counts, betas, safe_deg, key, k, 0, float(t_next[j]),
            config.dt, config.rng_stream, config.fused,
        )
    if incremental:
        recount_flags = torch.tensor(recounts, dtype=torch.bool, device=dev)
    else:
        recount_flags = torch.ones(config.n_steps, dtype=torch.bool, device=dev)
    return AgentSimResult(
        t_grid=_tensor(ts[:-1], dev),
        informed_frac=_fractions(g_counts, n, prepared.dtype),
        withdrawn_frac=_fractions(w_counts, n, prepared.dtype),
        informed=informed,
        t_inf=t_inf,
        full_recount_steps=recount_flags,
        agent_steps=n * config.n_steps,
    )


def _bit_at(bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` of a little-endian packed mask, as int32 0/1."""
    return (bits[pos >> 3].to(torch.int32) >> (pos & 7)) & 1


def _unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """A packed mask of 8·len(bits) agents as bool (``np.unpackbits`` in
    little bit order)."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return ((bits.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1).to(torch.bool)


def _bit_recount(bits_global, src, row_ptr, mesh, axis: str):
    """Count this rank's dst-sorted edges against the gathered global bit
    mask and psum_scatter each rank its own agent block's totals: the one
    body of every bitpacked recount (the "scatter" comm and the
    incremental engine's fallback). The per-edge gather is
    `recount.bit_gather`, the recount CUDA kernel on the card."""
    active = recount.bit_gather(bits_global, src)
    counts = _seg_counts(active, row_ptr)[:-1]  # global ids; the pad segment dropped
    return C.psum_scatter(counts, mesh, axis)


def _bitpacked_block_counts(wd, src, row_ptr, mesh, axis: str):
    """Sharded full recount from the local withdrawn mask: pack to nb/8
    bytes, all-gather, `_bit_recount`. The local block is byte-aligned."""
    return _bit_recount(C.all_gather(recount.pack_mask(wd), mesh, axis), src, row_ptr,
                        mesh, axis)


def _run_sharded(prepared, config: AgentSimConfig, informed0, t_init, key, k0: int):
    """One launch on every rank of the mesh axis: this rank's agent block
    (``informed0``/``t_init`` are its blocks), either engine. Returns the
    replicated trajectories and the whole final state, padding trimmed."""
    mesh, axis = prepared.mesh, prepared.mesh_axis
    dev = prepared.device
    dtype = prepared.betas.dtype
    nb = prepared.betas.shape[0]
    n_gl = prepared.n_gl
    offset = axis_index(mesh, axis) * nb  # global id of this block's first agent
    betas, src, row_ptr = prepared.betas, prepared.src, prepared.row_ptr
    ts = _step_times(config, k0, prepared.dtype)
    t_next = _next_times(config, k0, prepared.dtype)
    t_inf = torch.where(informed0, t_init, float("inf")).to(dtype)
    informed = informed0
    safe_deg = torch.clamp(prepared.indeg, min=1.0)
    g_local = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    w_local = torch.empty(config.n_steps, dtype=torch.int64, device=dev)
    incremental = prepared.engine == "incremental"
    recounts = []
    if incremental:
        dst2, lstart, ldeg = prepared.inc
        ec = dst2.shape[0]
        budget_agents, budget_deg = prepared.budget, prepared.max_degree
        d_lane = torch.arange(budget_deg, dtype=torch.int32, device=dev)[None, :]
        has_edges = ldeg > 0
        counts = torch.zeros(nb, dtype=torch.int32, device=dev)
        prev_bits = torch.zeros(n_gl // 8, dtype=torch.uint8, device=dev)

    for j in range(config.n_steps):
        k = k0 + j
        t = float(ts[j])
        wd = _withdrawn(informed, t_inf, t, config.exit_delay, config.reentry_delay)
        if incremental:
            # global change detection from the gathered packed mask
            bits = C.all_gather(recount.pack_mask(wd), mesh, axis)
            visible = _unpack_bits(bits ^ prev_bits) & has_edges
            n_vis = visible.sum()
            cids = _compact_ids(visible, budget_agents, n_gl, config.compact_impl)
            valid = cids < n_gl
            cids_c = torch.clamp(cids, max=n_gl - 1)
            degs = torch.where(valid, ldeg[cids_c], 0)
            overflow = (n_vis > budget_agents) | (degs.max() > budget_deg)
            # every rank takes the same branch: the host reads the psum'd flag
            overflow_any = bool(C.psum(overflow.to(torch.int32), mesh, axis) > 0)
            if overflow_any:
                counts = _bit_recount(bits, src, row_ptr, mesh, axis)
            else:
                emask = d_lane < degs[:, None]
                eidx = torch.clamp(lstart[cids_c][:, None] + d_lane, max=ec - 1)
                dsts = torch.where(emask, dst2[eidx], n_gl)  # pad lanes → dump slot
                sign = torch.where(valid, _bit_at(bits, cids_c) - _bit_at(prev_bits, cids_c), 0)
                delta = torch.where(emask, sign[:, None], 0)
                buf = torch.zeros(n_gl + 1, dtype=torch.int32, device=dev).index_add(
                    0, dsts.reshape(-1), delta.reshape(-1))
                counts = counts + C.psum_scatter(buf[:n_gl], mesh, axis)
            recounts.append(overflow_any)
            prev_bits = bits
        elif prepared.comm == "scatter":
            counts = _bitpacked_block_counts(wd, src, row_ptr, mesh, axis)
        else:
            wd_global = C.all_gather(wd, mesh, axis)
            full = C.psum(_seg_counts(wd_global[src], row_ptr)[:-1], mesh, axis)
            counts = full[offset:offset + nb]
        g_local[j] = informed.sum()
        w_local[j] = wd.sum()
        informed, t_inf = infection_update(
            informed, t_inf, counts, betas, safe_deg, key, k, offset, float(t_next[j]),
            config.dt, config.rng_stream, config.fused,
        )
    n = prepared.n
    if incremental:
        recount_flags = torch.tensor(recounts, dtype=torch.bool, device=dev)
    else:
        recount_flags = torch.ones(config.n_steps, dtype=torch.bool, device=dev)
    # the trajectories are integer counts, so one psum at the end equals the
    # reference's psum a step; normalized by the true N
    return AgentSimResult(
        t_grid=_tensor(ts[:-1], dev),
        informed_frac=_fractions(C.psum(g_local, mesh, axis), n, prepared.dtype),
        withdrawn_frac=_fractions(C.psum(w_local, mesh, axis), n, prepared.dtype),
        informed=C.all_gather(informed, mesh, axis)[:n],
        t_inf=C.all_gather(t_inf, mesh, axis)[:n],
        full_recount_steps=recount_flags,
        agent_steps=n * config.n_steps,
    )


# ---------------------------------------------------------------------------
# Prepared graphs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: fields are tensors
class PreparedAgentGraph:
    """Device-resident graph structures, reusable across simulations: the
    dst-sorted edges and row pointers, per-agent β and in-degrees, the
    resolved engine and, for "incremental", its src-sorted out-edge arrays
    ``inc = (dst2, out_ptr, outdeg)``.

    Under a mesh every tensor is this rank's shard, as the reference's
    sharded arrays hold it on each device: β and in-degrees of the agent
    block (padded agents inert), the edge chunk's sources (pad edges have
    source 0), its row-pointer table over the n_gl + 2 global segment ids,
    and for "incremental" ``inc = (dst2, lstart, ldeg)``: the chunk of
    src-sorted destinations and every global agent's slice in it."""

    n: int
    n_edges: int  # TRUE edge count (the sharded src may carry pad edges)
    dtype: np.dtype  # the simulation float type
    device: torch.device
    engine: str  # resolved: "gather" or "incremental"
    budget: int
    max_degree: int
    betas: torch.Tensor
    src: torch.Tensor  # dst-sorted edge sources
    row_ptr: torch.Tensor
    indeg: torch.Tensor
    inc: Optional[tuple] = None
    mesh: object = None  # a DeviceMesh, or None on one device
    mesh_axis: str = "agents"
    comm: str = "scatter"
    n_pad: int = 0  # inert pad agents (0 without a mesh)
    # engine="measure" only: ((label, measured agent-steps/s), ...) of each
    # timed candidate, in the order timed
    measured_steps_per_sec: Optional[Tuple[Tuple[str, float], ...]] = None

    @property
    def n_gl(self) -> int:
        """Padded agent count (``n`` without a mesh)."""
        return self.n + self.n_pad


def _tensor(a, device) -> torch.Tensor:
    """A numpy array on ``device``. ``torch.from_numpy`` refuses bfloat16
    arrays, so those cross as their 16-bit words."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of another framework's buffer
        a = a.copy()
    if _TORCH_DTYPE.get(a.dtype) == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _pad_block(n: int, n_dev: int, comm: str, engine: str) -> int:
    """Padded agent count under a mesh: a multiple of the axis size, or of
    8× it where local blocks are packed to bytes (the "scatter" comm, and
    the incremental engine, whose fallback is the bitpacked recount)."""
    block = 8 * n_dev if (comm == "scatter" or engine == "incremental") else n_dev
    return n + (-n) % block


def _check_sources(src_local: np.ndarray, n: int) -> None:
    """The recount kernel's contract: every id it gathers lies in [0, N)."""
    if src_local.size and (int(src_local.min()) < 0 or int(src_local.max()) >= n):
        raise ValueError("an edge source lies outside [0, N): the recount gather needs ids in range")


def _measure_engine(n, config, incremental_budget, d0, md_pinned, measure_probe, canonical,
                    prepare):
    """engine="measure": one warm-up and one timed simulation of each
    candidate on this graph, config and device; the faster one's prepared
    graph, carrying the measured rates. Under a mesh the elapsed times are
    psum'd, so every rank makes the same choice."""
    import time as _time
    import warnings

    probe = dict(measure_probe or {})
    bad = set(probe) - {"x0", "seed", "informed0", "t_inf0", "exact_seeds"}
    if bad:
        raise ValueError(f"measure_probe: unknown keys {sorted(bad)}")
    if np.size(canonical[1]) == 0:
        # both candidates coerce to gather on an edgeless graph
        return prepare("gather", d0)
    candidates = [("gather", d0), ("incremental", d0)]
    if not md_pinned:
        # a widened cap is worth a timed try when the census predicts a
        # recount-heavy run and widening shrinks the hub set
        outdeg_m = np.bincount(canonical[1], minlength=n)
        d_wide = 8 * d0
        predicted = _census_fallback_steps(
            outdeg_m, d0, config.n_steps, n,
            float(np.mean(canonical[0], dtype=np.float64)), config.dt,
            incremental_budget or _default_incremental_budget(n),
            waves=_census_waves(config),
        )
        if predicted > 0.1 * config.n_steps and int((outdeg_m > d_wide).sum()) < int(
            (outdeg_m > d0).sum()
        ):
            candidates.append(("incremental", d_wide))
    measured = []
    pg_c = cand_resident = None
    for cand_eng, cand_d in candidates:
        is_speculative = cand_d != d0
        pg_c = None  # only one candidate's tensors are resident at a time
        try:
            pg_c = prepare(cand_eng, cand_d)
            cand_resident = (cand_eng, cand_d)
            res = simulate_agents(prepared=pg_c, config=config, **probe)
            float(res.informed_frac[-1])  # warm-up, and the device fence
            t0 = _time.perf_counter()
            res = simulate_agents(prepared=pg_c, config=config, **probe)
            float(res.informed_frac[-1])
            elapsed = _time.perf_counter() - t0
        except Exception:
            # a speculative candidate must not abort a prepare that
            # succeeds without it (its wide grid may not fit)
            if not is_speculative:
                raise
            warnings.warn(
                f"engine='measure': widened-cap candidate (max_degree={cand_d}) failed "
                "to prepare/run and was dropped from the A/B",
                RuntimeWarning, stacklevel=3,
            )
            pg_c, cand_resident = None, None
            continue
        if pg_c.mesh is not None:
            elapsed = float(C.psum(torch.tensor([elapsed], dtype=torch.float64,
                                                device=pg_c.device),
                                   pg_c.mesh, pg_c.mesh_axis)[0])
        label = cand_eng if cand_d == d0 else f"{cand_eng}(max_degree={cand_d})"
        measured.append(((cand_eng, cand_d), label, n * config.n_steps / elapsed))
        del res
    winner = max(measured, key=lambda t: t[2])[0]
    if winner != cand_resident:
        pg_c = None
        pg_c = prepare(*winner)
    return dataclasses.replace(
        pg_c, measured_steps_per_sec=tuple((lbl, rate) for _, lbl, rate in measured)
    )


def prepare_agent_graph(
    betas,
    src,
    dst,
    n: int,
    config: AgentSimConfig = AgentSimConfig(),
    mesh=None,
    dtype=np.float32,
    engine: str = "auto",
    incremental_budget: Optional[int] = None,
    incremental_max_degree: Optional[int] = None,
    device=None,
    mesh_axis: str = "agents",
    comm: str = "scatter",
    measure_probe: Optional[dict] = None,
    _canonical: Optional[tuple] = None,
) -> PreparedAgentGraph:
    """Host-side canonicalization and upload, reusable across simulations.

    ``config`` enters only through the engine="auto" census. ``engine``:
    "gather" or "incremental" pick explicitly; "auto" picks by the census;
    "measure" times one simulation of each candidate on this graph and
    device (after a warm-up) and keeps the faster, its rates on
    ``measured_steps_per_sec`` (``measure_probe``: the state kwargs of the
    timed runs: x0, seed, informed0, t_inf0, exact_seeds). ``device``
    defaults to the CUDA card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU.

    ``mesh``: a 1-D ``DeviceMesh`` (`parallel.make_agent_mesh`); every rank
    calls this with the same arguments and keeps its own shard (see
    `PreparedAgentGraph`). Its device type sets the device. ``comm``
    ("scatter" or "allgather_psum") is the gather engine's collective
    scheme under a mesh."""
    dtype = np.dtype(dtype)
    md_pinned = incremental_max_degree is not None
    d0 = int(incremental_max_degree) if md_pinned else 64
    if engine not in ("auto", "gather", "incremental", "measure"):
        raise ValueError(f"Unknown engine {engine!r}")
    if comm not in ("scatter", "allgather_psum"):
        raise ValueError(f"Unknown comm strategy {comm!r}")
    if measure_probe is not None and engine != "measure":
        raise ValueError(
            f"measure_probe= only applies to engine='measure' (got engine={engine!r})"
        )
    if mesh is not None:
        device = mesh_device(mesh)
    device = torch.device(device) if device is not None else default_device()
    if _canonical is None:
        _canonical = _canonicalize_graph(betas, src, dst, n, dtype)

    if engine == "measure":
        def prepare(eng, d):
            return prepare_agent_graph(
                betas, src, dst, n, config=config, mesh=mesh, dtype=dtype, engine=eng,
                incremental_budget=incremental_budget, incremental_max_degree=d,
                device=device, mesh_axis=mesh_axis, comm=comm, _canonical=_canonical,
            )

        return _measure_engine(n, config, incremental_budget, d0, md_pinned, measure_probe,
                               _canonical, prepare)

    betas_h, src_h, dst_h, indeg_h, row_ptr_h = _canonical
    if engine == "auto":
        engine = _resolve_engine_from_outdeg(
            np.bincount(src_h, minlength=n), n, len(src_h), config,
            incremental_budget, d0, float(np.mean(betas_h, dtype=np.float64)),
            mesh=mesh, mesh_axis=mesh_axis,
        )
    if engine == "incremental" and len(src_h) == 0:
        # the dense out-edge grid cannot gather from an empty edge array
        engine = "gather"
    if mesh is not None:
        return _prepare_sharded(betas_h, src_h, dst_h, indeg_h, n, dtype, device, engine,
                                incremental_budget, d0, mesh, mesh_axis, comm)

    budget, inc = 0, None
    if engine == "incremental":
        # out-edge structure: the same edge multiset re-sorted by SOURCE
        # (dst2[e] = destination of the e-th src-sorted edge)
        dst2_h, _, outdeg_h, out_ptr_h = sort_edges_by_dst(dst_h, src_h, n)
        budget = incremental_budget or _default_incremental_budget(n)
        inc = (
            _tensor(dst2_h, device),
            _tensor(out_ptr_h.astype(np.int32), device),
            _tensor(outdeg_h, device),
        )
    return PreparedAgentGraph(
        n=n, n_edges=len(src_h), dtype=dtype, device=device, engine=engine,
        budget=int(budget), max_degree=d0,
        betas=_tensor(betas_h, device), src=_tensor(src_h, device),
        row_ptr=_tensor(row_ptr_h, device), indeg=_tensor(indeg_h, device),
        inc=inc, comm=comm, mesh_axis=mesh_axis,
    )


def _prepare_sharded(betas_h, src_h, dst_h, indeg_h, n, dtype, device, engine,
                     incremental_budget, d0, mesh, mesh_axis, comm) -> PreparedAgentGraph:
    """This rank's shard of the canonical graph, laid out as the reference's
    sharded prepare lays each device's: agents padded to `_pad_block`;
    dst-sorted edges padded with source 0 and the sentinel destination n_gl
    to a multiple of the axis size and cut into equal chunks, each with its
    row-pointer table over the n_gl + 2 global segment ids; for the
    incremental engine, the src-sorted destinations cut into chunks of
    ⌈E/n_dev⌉ (padded with n_gl) and every agent's (start, length) in this
    rank's chunk."""
    n_dev = axis_size(mesh, mesh_axis)
    d = axis_index(mesh, mesh_axis)
    n_gl = _pad_block(n, n_dev, comm, engine)
    n_pad = n_gl - n
    nb = n_gl // n_dev
    betas_p = np.concatenate([betas_h, np.zeros(n_pad, betas_h.dtype)])
    indeg_p = np.concatenate([indeg_h, np.zeros(n_pad, indeg_h.dtype)])
    e_pad = (-len(src_h)) % n_dev
    src_p = np.concatenate([src_h, np.zeros(e_pad, np.int32)])
    dst_p = np.concatenate([dst_h, np.full(e_pad, n_gl, np.int32)])
    e_local = len(dst_p) // n_dev
    lo = d * e_local
    src_l = src_p[lo:lo + e_local]
    _check_sources(src_l, n)
    row_ptr_l = np.searchsorted(dst_p[lo:lo + e_local], np.arange(n_gl + 2),
                                side="left").astype(np.int32)
    budget, inc = 0, None
    if engine == "incremental":
        dst2_all, _, _, out_ptr_all = sort_edges_by_dst(dst_h, src_h, n)
        e_all = int(out_ptr_all[-1])
        ec = max(1, -(-e_all // n_dev))
        dst2_sh = np.full(n_dev * ec, n_gl, np.int32)
        dst2_sh[:e_all] = dst2_all
        c_lo, c_hi = d * ec, (d + 1) * ec
        s = np.clip(out_ptr_all[:-1].astype(np.int64), c_lo, c_hi)
        e_ = np.clip(out_ptr_all[1:].astype(np.int64), c_lo, c_hi)
        lstart = np.zeros(n_gl, np.int32)
        ldeg = np.zeros(n_gl, np.int32)
        lstart[:n] = s - c_lo
        ldeg[:n] = e_ - s
        budget = incremental_budget or _default_incremental_budget(nb, floor=512)
        inc = (_tensor(dst2_sh[c_lo:c_hi], device), _tensor(lstart, device),
               _tensor(ldeg, device))
    blk = slice(d * nb, (d + 1) * nb)
    return PreparedAgentGraph(
        n=n, n_edges=len(src_h), dtype=dtype, device=device, engine=engine,
        budget=int(budget), max_degree=d0,
        betas=_tensor(betas_p[blk], device), src=_tensor(src_l, device),
        row_ptr=_tensor(row_ptr_l, device), indeg=_tensor(indeg_p[blk], device),
        inc=inc, mesh=mesh, mesh_axis=mesh_axis, comm=comm, n_pad=n_pad,
    )


def prepared_from_numpy(arrays: dict, device) -> PreparedAgentGraph:
    """A prepared graph from a ``sbr_tpu`` ``PreparedAgentGraph``'s arrays,
    taken as numpy: ``betas``, ``src``, ``row_ptr``, ``indeg``, and for
    the incremental engine ``dst2``, ``out_ptr``, ``outdeg``; with
    ``engine``, ``budget`` and ``max_degree``."""
    device = torch.device(device)
    engine = str(arrays["engine"])
    if engine not in ("gather", "incremental"):
        raise ValueError(f"Unknown engine {engine!r}")
    betas = np.asarray(arrays["betas"])
    inc = None
    if engine == "incremental":
        inc = tuple(
            _tensor(np.asarray(arrays[k], np.int32), device)
            for k in ("dst2", "out_ptr", "outdeg")
        )
    return PreparedAgentGraph(
        n=int(betas.shape[0]), n_edges=int(np.shape(arrays["src"])[0]),
        dtype=betas.dtype, device=device, engine=engine,
        budget=int(arrays["budget"]), max_degree=int(arrays["max_degree"]),
        betas=_tensor(betas, device),
        src=_tensor(np.asarray(arrays["src"], np.int32), device),
        row_ptr=_tensor(np.asarray(arrays["row_ptr"], np.int32), device),
        indeg=_tensor(np.asarray(arrays["indeg"], betas.dtype), device),
        inc=inc,
    )


# ---------------------------------------------------------------------------
# Resume state on disk
# ---------------------------------------------------------------------------


def save_agent_state(path, result: AgentSimResult, seed: int, dt: float) -> None:
    """Persist a simulation's exact-resume state to ``path`` as an npz with
    the keys of ``sbr_tpu.social.agents.save_agent_state`` (informed,
    t_inf, next_step, seed, dt), written atomically. ``seed`` must be the
    seed the run used: the RNG stream is keyed on it."""
    path = Path(path)
    t0 = float(result.t_grid[0])
    k0 = int(round(t0 / dt))
    arrays = dict(
        informed=result.informed.cpu().numpy(),
        t_inf=result.t_inf.cpu().numpy(),
        next_step=np.int64(k0 + result.t_grid.shape[-1]),
        seed=np.int64(seed),
        dt=np.float64(dt),
    )
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_agent_state(path, dt: Optional[float] = None) -> dict:
    """Load a ``save_agent_state`` checkpoint (this package's or
    ``sbr_tpu``'s) as ``simulate_agents`` kwargs: ``informed0``,
    ``t_inf0``, ``step_offset`` and ``seed``. Pass ``dt`` to check it
    against the checkpoint's step grid."""
    with np.load(Path(path)) as d:
        if dt is not None and abs(float(d["dt"]) - dt) > 1e-12:
            raise ValueError(
                f"checkpoint was written at dt={float(d['dt'])}, resuming "
                f"config has dt={dt} — the step grid would not line up"
            )
        return {
            "informed0": d["informed"],
            "t_inf0": d["t_inf"],
            "step_offset": int(d["next_step"]),
            "seed": int(d["seed"]),
        }


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _state_tensor(arr, dtype: torch.dtype, np_dtype, device) -> torch.Tensor:
    """Initial state on the device: a tensor is moved and cast (a no-op
    for a previous launch's carry), anything else goes through numpy."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype)
    return _tensor(np.asarray(arr, dtype=np_dtype), device)


def simulate_agents(
    betas=None,
    src=None,
    dst=None,
    n: Optional[int] = None,
    x0: float = 1e-4,
    config: AgentSimConfig = AgentSimConfig(),
    seed: int = 0,
    mesh=None,
    dtype=np.float32,
    exact_seeds: bool = False,
    informed0=None,
    t_inf0=None,
    engine: str = "auto",
    incremental_budget: Optional[int] = None,
    incremental_max_degree: Optional[int] = None,
    prepared: Optional[PreparedAgentGraph] = None,
    step_offset: int = 0,
    device=None,
    mesh_axis: str = "agents",
    comm: str = "scatter",
) -> AgentSimResult:
    """Simulate N explicit agents learning from neighbor withdrawals.

    Takes (betas, src, dst, n) and prepares the graph on ``device`` (the
    CUDA card unless the caller names one), or a ``prepared`` graph, whose
    device it runs on. ``informed0``/``t_inf0`` override the seeded initial
    state (t_inf0 may be negative: informed before the window starts);
    ``step_offset`` is the global index of the first step, so a run resumes
    exactly from a previous result's state. Results are bit-identical to
    ``sbr_tpu.social.agents.simulate_agents`` on the same inputs, with or
    without ``prepared`` and under any ``max_steps_per_launch``.

    ``mesh`` (a 1-D ``DeviceMesh``; every rank calls this with the same
    arguments) shards the agents and edges over ``mesh_axis``, with
    ``comm`` the gather engine's collective scheme (module docstring).
    Every rank gets back the whole result, bit for bit the single-device
    run. ``engine="measure"`` is a `prepare_agent_graph` feature.
    """
    if prepared is None:
        if betas is None or src is None or dst is None or n is None:
            raise ValueError("simulate_agents needs (betas, src, dst, n) or prepared=")
        if engine == "measure":
            # measuring runs 2 warm-ups and 2 timed simulations; it pays only
            # where a prepared graph is reused
            raise ValueError(
                "engine='measure' is a prepare_agent_graph feature: prepare "
                "the graph once (the A/B timing amortizes over repeated "
                "simulations) and pass prepared= here"
            )
        prepared = prepare_agent_graph(
            betas, src, dst, n, config=config, mesh=mesh, dtype=dtype,
            engine=engine, incremental_budget=incremental_budget,
            incremental_max_degree=incremental_max_degree, device=device,
            mesh_axis=mesh_axis, comm=comm,
        )
    else:
        conflicts = [
            name
            for name, passed in (
                ("betas", betas is not None), ("src", src is not None),
                ("dst", dst is not None), ("n", n is not None),
                ("mesh", mesh is not None), ("comm", comm != "scatter"),
                ("engine", engine != "auto"),
                ("incremental_budget", incremental_budget is not None),
                ("incremental_max_degree", incremental_max_degree is not None),
                ("device", device is not None),
            )
            if passed
        ]
        if conflicts:
            raise ValueError(
                f"simulate_agents: {conflicts} conflict with prepared= — the "
                "prepared graph already fixes the graph/mesh/engine/device; rebuild "
                "it with prepare_agent_graph(...) to change them"
            )
    n = prepared.n
    dev = prepared.device
    np_dtype = prepared.dtype
    for name, arr in (("informed0", informed0), ("t_inf0", t_inf0)):
        if arr is not None and np.shape(arr)[0] != n:
            raise ValueError(
                f"simulate_agents: {name} has length {np.shape(arr)[0]} "
                f"but the graph has n = {n} agents"
            )
    if informed0 is None:
        informed0 = _draw_seeds(np.random.default_rng(seed), n, x0, exact_seeds)
    informed0_d = _state_tensor(informed0, torch.bool, bool, dev)
    if t_inf0 is None:
        t_init_d = torch.zeros(n, dtype=prepared.betas.dtype, device=dev)
    else:
        t_init_d = _state_tensor(t_inf0, prepared.betas.dtype, np_dtype, dev)
    key = prng_key(seed)

    launch_cap = config.max_steps_per_launch
    if launch_cap is not None and launch_cap < config.n_steps:
        # equal host-level launches carrying (informed, t_inf); the step
        # index stays global, so the result is bit-identical
        n_chunks = -(-config.n_steps // launch_cap)
        chunk_len = -(-config.n_steps // n_chunks)
        parts = []
        inf_c, tinf_c = informed0_d, t_init_d
        done = 0
        while done < config.n_steps:
            this_len = min(chunk_len, config.n_steps - done)
            cfg_c = dataclasses.replace(config, n_steps=this_len, max_steps_per_launch=None)
            part = simulate_agents(
                config=cfg_c, seed=seed, informed0=inf_c, t_inf0=tinf_c,
                prepared=prepared, step_offset=step_offset + done,
            )
            parts.append(part)
            inf_c, tinf_c = part.informed, part.t_inf
            done += this_len
        return AgentSimResult(
            t_grid=torch.cat([p.t_grid for p in parts]),
            informed_frac=torch.cat([p.informed_frac for p in parts]),
            withdrawn_frac=torch.cat([p.withdrawn_frac for p in parts]),
            informed=parts[-1].informed,
            t_inf=parts[-1].t_inf,
            full_recount_steps=torch.cat([p.full_recount_steps for p in parts]),
            agent_steps=sum(p.agent_steps for p in parts),
        )
    if prepared.mesh is None:
        return _run_engine(prepared, config, informed0_d, t_init_d, key, int(step_offset))
    # this rank's block of the padded state
    nb = prepared.betas.shape[0]
    lo = axis_index(prepared.mesh, prepared.mesh_axis) * nb
    pad = prepared.n_pad
    informed0_d = torch.cat([informed0_d, informed0_d.new_zeros(pad)])[lo:lo + nb]
    t_init_d = torch.cat([t_init_d, t_init_d.new_zeros(pad)])[lo:lo + nb]
    return _run_sharded(prepared, config, informed0_d, t_init_d, key, int(step_offset))
