"""Generative graph models built on the device, in PyTorch.

The port of ``sbr_tpu.social.graphgen`` for one device. A graph is born in
the canonical dst-sorted, row-pointer layout of ``social.agents``, and no
edge list passes through the host. Each spec factors its edge law as
(destination marginal) × (source conditional):

- the in-degree vector is one host multinomial draw over the destination
  marginal (node-length, the only host work), and its cumsum is the
  row-pointer table;
- the destination of edge position p is structural: the row whose
  [row_ptr[d], row_ptr[d+1]) range holds p;
- only the source is drawn, one Threefry-2x32 block per edge, keyed by the
  edge id and the spec's key words.

So the canonical build needs no sort. The incremental engine's out-edge
orientation is the same edges grouped by source in the host layout's
(src, dst, raw id) order; a stable sort of the dst-sorted sources gives
exactly that, since their positions already run in (dst, raw id) order.

Three generative models, frozen dataclasses with the reference's fields and
checks: `ErdosRenyiSpec`, `ScaleFreeSpec` (Chung–Lu, both endpoints ∝
(i+1)^{−1/(γ−1)}) and `StochasticBlockSpec`. For the same (spec, seed) the
layout equals ``sbr_tpu``'s bit for bit (tested). The 32-bit words of the
draws are kept in int64 tensors, as in ``social.rng``.

Panic rewiring (`infomodels.engine`'s ``dynamics="rewire"``) regenerates
the edge set every epoch from the same factoring: `epoch_indegrees` redraws
the destination marginal (`epoch_indegrees_on` draws the same in-degrees
on the card, `pcg64.uniform_indegrees`), `tilt_threshold_table` tilts the source marginal
toward the withdrawing agents, and `generate_tilted_sources` draws the
dst-sorted sources against it, keyed by `epoch_key_words`. The table and
the sources equal ``sbr_tpu``'s bit for bit (tested).

**Sharded build** (``mesh=``, `_prepare_mesh`): each rank draws only its
own contiguous range of edge positions, so the gather layout needs no
collective at all (a position's source is a pure function of the seed and
the edge id). The incremental orientation is a distributed counting sort:
each rank histograms its own sources, `parallel.exclusive_psum` merges the
histograms into every rank's offsets, each rank scatters its edges to
their global src-sorted positions, and one tiled ``psum_scatter`` delivers
each rank its edge chunk. The shards equal the host prepare's
(`agents.prepare_agent_graph` with the same mesh) byte for byte (tested).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.core.integrate import xla_cumsum
from sbr_tpu_torch.social import agents as A
from sbr_tpu_torch.social import pcg64
from sbr_tpu_torch.social.rng import _threefry2x32

__all__ = [
    "ErdosRenyiSpec",
    "ScaleFreeSpec",
    "StochasticBlockSpec",
    "epoch_indegrees",
    "epoch_indegrees_on",
    "epoch_key_words",
    "generate_edges",
    "generate_tilted_sources",
    "plan_chunk_edges",
    "prepare_generated_graph",
    "tilt_threshold_table",
]


# ---------------------------------------------------------------------------
# Graph specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ErdosRenyiSpec:
    """Sparse directed Erdős–Rényi G(n, p) with p = avg_degree/(n−1)."""

    n: int
    avg_degree: float

    def __post_init__(self):
        _check_spec(self.n, self.avg_degree)

    def edge_count(self, seed: int) -> int:
        # E ~ Binomial(n(n−1), p), drawn on the host: O(1) work
        rng = np.random.default_rng(seed)
        p = self.avg_degree / max(self.n - 1, 1)
        return int(rng.binomial(self.n * (self.n - 1), min(p, 1.0)))


@dataclasses.dataclass(frozen=True)
class ScaleFreeSpec:
    """Chung–Lu power-law configuration model: both endpoints ∝
    (i+1)^{−1/(γ−1)}, so in- and out-degree tails carry exponent γ."""

    n: int
    avg_degree: float
    gamma: float = 2.5

    def __post_init__(self):
        _check_spec(self.n, self.avg_degree)
        if not (self.gamma > 1.0):
            raise ValueError("gamma must be > 1")

    def edge_count(self, seed: int) -> int:
        return int(self.n * self.avg_degree)


@dataclasses.dataclass(frozen=True)
class StochasticBlockSpec:
    """Balanced stochastic block model: ``n_blocks`` contiguous blocks of
    near-equal size; the destination marginal is uniform and each edge
    keeps its source inside the destination's block with probability
    ``p_in`` (uniform over the other blocks otherwise)."""

    n: int
    avg_degree: float
    n_blocks: int = 4
    p_in: float = 0.8

    def __post_init__(self):
        _check_spec(self.n, self.avg_degree)
        if self.n_blocks < 2:
            raise ValueError("n_blocks must be >= 2")
        if self.n < 2 * self.n_blocks:
            raise ValueError("need n >= 2*n_blocks (every block needs >= 2 nodes)")
        if not (0.0 <= self.p_in <= 1.0):
            raise ValueError("p_in must be in [0, 1]")

    def edge_count(self, seed: int) -> int:
        return int(self.n * self.avg_degree)


# Edge positions are int32 with one chunk of headroom below 2^31, as in the
# reference: chunks are clamped to _MAX_CHUNK and E to _MAX_EDGES.
_MAX_CHUNK = 1 << 26
_MAX_EDGES = 2**31 - 2**27


def _check_spec(n: int, avg_degree: float) -> None:
    if n < 2:
        raise ValueError("need n >= 2 agents")
    if not (avg_degree > 0):
        raise ValueError("avg_degree must be positive")
    if n >= 2**31 or n * avg_degree >= _MAX_EDGES:
        raise ValueError(
            "graphgen is int32-indexed with chunk headroom: need n < 2^31 "
            "and E < 2^31 - 2^27"
        )


def _check_edges(e: int) -> int:
    """The drawn edge count (binomial for ER) must keep the final chunk's
    positions in int32."""
    if e >= _MAX_EDGES:
        raise ValueError(
            f"drawn edge count {e} leaves no int32 chunk headroom "
            f"(need E < {_MAX_EDGES})"
        )
    return e


# ---------------------------------------------------------------------------
# Host tables (numpy; copied from the reference)
# ---------------------------------------------------------------------------


def _spec_key_words(seed: int) -> Tuple[np.uint32, np.uint32]:
    """The (k0, k1) Threefry key words of a generation seed, from numpy's
    SeedSequence: the same in every process."""
    k0, k1 = np.random.SeedSequence(seed).generate_state(2, np.uint32)
    return np.uint32(k0), np.uint32(k1)


def _spec_weights(spec) -> Optional[np.ndarray]:
    """The destination-marginal weight vector, or None for uniform."""
    if isinstance(spec, ScaleFreeSpec):
        return np.arange(1, spec.n + 1, dtype=np.float64) ** (
            -1.0 / (spec.gamma - 1.0)
        )
    return None


def _uniform_ids(rng, n: int, e: int):
    """The ``e`` destination ids of a uniform marginal's in-degree draw,
    at most 2^24 at a time, as the reference draws them (a numpy Generator
    continues one stream of 32-bit words across calls, so the chunks give
    the ids of one draw). They are drawn as uint32 and viewed as int32 (n < 2^31): below
    2^32 numpy's bounded draw takes 32-bit words whatever the output type,
    so the ids, and the stream after them, are the reference's int64 draw's
    (tested), in half the memory."""
    for done in range(0, e, 1 << 24):
        yield rng.integers(0, n, size=min(1 << 24, e - done), dtype=np.uint32).view(np.int32)


def _indeg_host(spec, seed: int, e: int) -> np.ndarray:
    """The in-degree vector: one host multinomial draw over the spec's
    destination marginal, seeded from SeedSequence((seed, 1)). Uniform
    marginals draw it as a bincount of uniform integers (`_uniform_ids`)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    w = _spec_weights(spec)
    if w is None:
        indeg = np.zeros(spec.n, np.int64)
        for ids in _uniform_ids(rng, spec.n, e):
            indeg += np.bincount(ids, minlength=spec.n)
        return indeg.astype(np.int32)
    return rng.multinomial(e, w / w.sum()).astype(np.int32)


def epoch_key_words(seed: int, epoch: int) -> Tuple[np.uint32, np.uint32]:
    """Threefry key words of one panic-rewiring epoch, from
    SeedSequence((seed, 23, epoch)): a stream per epoch, apart from the
    base generation stream and the in-degree draws, the same in every
    process."""
    k0, k1 = np.random.SeedSequence((seed, 23, epoch)).generate_state(2, np.uint32)
    return np.uint32(k0), np.uint32(k1)


def _epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((seed, 1, epoch)))


def epoch_indegrees(spec, seed: int, epoch: int, e: int) -> np.ndarray:
    """The in-degree vector of one rewiring epoch: the base spec's
    destination marginal, redrawn from SeedSequence((seed, 1, epoch)), so
    epoch graphs are independent realizations, deterministic in (seed,
    epoch). Uniform marginals draw at most 2^24 integers at a time, as the
    reference does (`_uniform_ids`)."""
    rng = _epoch_rng(seed, epoch)
    w = _spec_weights(spec)
    if w is None:
        indeg = np.zeros(spec.n, np.int64)
        for ids in _uniform_ids(rng, spec.n, e):
            indeg += np.bincount(ids, minlength=spec.n)
        return indeg.astype(np.int32)
    return rng.multinomial(e, w / w.sum()).astype(np.int32)


def epoch_indegrees_on(spec, seed: int, epoch: int, e: int, device) -> torch.Tensor:
    """`epoch_indegrees` as an int64 tensor on ``device``, entry for entry.
    On a CUDA device a uniform marginal's in-degrees are drawn by the card
    (`pcg64.uniform_indegrees`): at 10^8 edges numpy's draw of the ids on
    one host thread is most of a rewired epoch, and the part of it that
    varies most from draw to draw."""
    if _spec_weights(spec) is None and torch.device(device).type == "cuda":
        return pcg64.uniform_indegrees(_epoch_rng(seed, epoch), spec.n, e, device)
    return torch.from_numpy(epoch_indegrees(spec, seed, epoch, e).astype(np.int64)).to(device)


def tilt_threshold_table(base_weights: torch.Tensor, wd: torch.Tensor, bias) -> torch.Tensor:
    """uint32-quantized inverse CDF of the panic-tilted source marginal,
    p(src = j) ∝ w_j·(1 + bias·wd_j), with ``wd`` the withdrawn mask: the
    destination marginal is untouched, so an epoch's stream is still born
    dst-sorted and only the source draw reads this table.

    The reference's arithmetic, one rounded op at a time (it runs eagerly):
    ``w * (1 + bias·wd)`` as three ops, never a fused multiply-add; XLA's
    blocked prefix (`core.integrate.xla_cumsum`); division by the last
    entry; the product with 2^32; the minimum with 4294967295.0, which
    rounds to 2^32 in float32. XLA's float → uint32 conversion saturates,
    so the last entries, where the CDF is 1, become 4294967295: the words
    are held in int64 and clamped to [0, 2^32 − 1] after the cast, as the
    other tables of this module are held. Returns an int64 tensor."""
    w = base_weights
    bias_t = torch.tensor(bias, dtype=w.dtype, device=w.device)
    t = w * (1.0 + bias_t * wd.to(w.dtype))
    cdf = xla_cumsum(t)
    cdf = cdf / cdf[-1]
    thr = torch.clamp(cdf * 4294967296.0, max=4294967295.0)
    return torch.clamp(thr.to(torch.int64), 0, 2**32 - 1)


def generate_tilted_sources(n: int, e: int, key_words, thr_table: torch.Tensor,
                            chunk_edges=None) -> torch.Tensor:
    """dst-sorted int32 sources of one rewired epoch, on the table's
    device: E counter-Threefry draws (one block per edge id, keyed by the
    epoch's ``key_words``) against the tilted inverse-CDF table, chunked
    under `plan_chunk_edges`. Each position is a function of (key, edge
    id) alone, so the result does not depend on the chunk."""
    device = thr_table.device
    out = torch.empty(e, dtype=torch.int32, device=device)
    if e == 0:
        return out
    chunk = (
        plan_chunk_edges(e, n, device=device)
        if chunk_edges in (None, "auto")
        else int(chunk_edges)
    )
    chunk = max(1, min(chunk, max(e, 1), _MAX_CHUNK))
    k0, k1 = (int(k) for k in key_words)
    for c0 in range(0, e, chunk):
        count = min(chunk, e - c0)
        eid = torch.arange(c0, c0 + count, dtype=torch.int64, device=device)
        x0, _ = _threefry2x32(k0, k1, eid, torch.zeros_like(eid))
        out[c0:c0 + count] = torch.clamp(_searchsorted32(thr_table, x0, "right"), max=n - 1)
    return out


def _spec_tables(spec) -> Tuple[np.ndarray, ...]:
    """Node-length lookup tables of the source conditional: the quantized
    inverse CDF for scale-free, block boundaries for SBM, none for ER."""
    if isinstance(spec, ErdosRenyiSpec):
        return ()
    if isinstance(spec, ScaleFreeSpec):
        cdf = np.cumsum(_spec_weights(spec))
        cdf /= cdf[-1]
        thr = np.minimum(np.floor(cdf * 2.0**32), 2.0**32 - 1).astype(np.uint32)
        return (thr,)
    if isinstance(spec, StochasticBlockSpec):
        b = spec.n_blocks
        starts = (np.arange(b + 1, dtype=np.int64) * spec.n + b - 1) // b
        return (starts.astype(np.uint32),)
    raise TypeError(f"unknown graph spec {type(spec).__name__}")


def _device_tables(spec, device) -> Tuple[torch.Tensor, ...]:
    # uint32 tables held as int64, the word type of the draws
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device) for t in _spec_tables(spec))


def _row_ptr_host(indeg_h: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(indeg_h)]).astype(np.int32)


# ---------------------------------------------------------------------------
# Per-edge draws (pure functions of (key words, edge id, structural dst))
# ---------------------------------------------------------------------------


def _mulhi32(a, m):
    """floor(a·m / 2^32) for 32-bit words ``a`` (int64 tensor) and
    0 <= m < 2^31 (int or int64 tensor): the Lemire range map. The
    reference builds it from 16-bit halves in uint32; the product fits in
    int64 here, so one multiply and shift give the same bits."""
    return (a * m) >> 32


def _searchsorted32(table, x, side: str) -> torch.Tensor:
    return torch.searchsorted(table, x, right=(side == "right")).to(torch.int32)


def _needs_dst(spec) -> bool:
    """Whether the source conditional reads the structural destination:
    only SBM's does (ER and scale-free sources are marginal draws)."""
    return isinstance(spec, StochasticBlockSpec)


def _src_at(spec, tables, k0: int, k1: int, eid, dst):
    """Source node (int32 in [0, n)) of each edge id ``eid`` (int64 tensor)
    given its structural destination ``dst`` (None where `_needs_dst` is
    false): one Threefry block per edge, as the reference draws it."""
    n = spec.n
    x0, x1 = _threefry2x32(k0, k1, eid, torch.zeros_like(eid))
    if isinstance(spec, ErdosRenyiSpec):
        return _mulhi32(x0, n).to(torch.int32)
    if isinstance(spec, ScaleFreeSpec):
        (thr,) = tables
        return torch.clamp(_searchsorted32(thr, x0, "right"), max=n - 1)
    (starts,) = tables
    dst = dst.to(torch.int64)
    blk = torch.searchsorted(starts, dst, right=True) - 1
    lo = starts[blk]
    size = starts[blk + 1] - lo
    within = x1 < min(int(spec.p_in * 2.0**32), 2**32 - 1)
    s_in = lo + _mulhi32(x0, size)
    # an in-block self-loop is moved one slot on, within the block
    off2 = torch.where(s_in - lo + 1 >= size, 0, s_in - lo + 1)
    s_in = torch.where(s_in == dst, lo + off2, s_in)
    r = _mulhi32(x0, n - size)
    s_out = r + torch.where(r >= lo, size, 0)
    return torch.where(within, s_in, s_out).to(torch.int32)


def _dst_chunk(row_ptr, n: int, c0: int, chunk: int) -> torch.Tensor:
    """Structural destinations (int32) of the positions [c0, c0+chunk): the
    row spans clipped to the window, repeated. Positions past E take the
    last node id n−1, as the reference's ``jnp.repeat(...,
    total_repeat_length=chunk)`` fills them; callers drop those lanes."""
    e = int(row_ptr[-1])
    reps = torch.diff(torch.clamp(row_ptr.to(torch.int64), c0, c0 + chunk))
    count = max(0, min(chunk, e - c0))
    d = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=row_ptr.device), reps, output_size=count
    )
    if count < chunk:
        d = torch.cat([d, torch.full((chunk - count,), n - 1, dtype=torch.int32,
                                     device=row_ptr.device)])
    return d


# ---------------------------------------------------------------------------
# Chunked builds
# ---------------------------------------------------------------------------


def plan_chunk_edges(e: int, n: int, budget_bytes: Optional[int] = None,
                     device=None) -> int:
    """Edges drawn per chunk: the largest power of two whose scratch fits
    the budget, floored at 2^14 and capped at 2^26 and at E.

    Scratch is ~16 int64 lanes per edge (the Threefry words and their
    temporaries) plus the N-vectors and the E-length output. The budget is
    ``budget_bytes``, else ``SBR_GRAPHGEN_BUDGET_BYTES``, else 0.8 of the
    card's free memory on a CUDA ``device``, else 1 GiB. The result does
    not depend on the plan: it sets peak memory and speed only."""
    if budget_bytes is None:
        env = os.environ.get("SBR_GRAPHGEN_BUDGET_BYTES", "").strip()
        if env:
            budget_bytes = int(env)
        elif device is not None and torch.device(device).type == "cuda":
            budget_bytes = int(0.8 * torch.cuda.mem_get_info(device)[0])
        else:
            budget_bytes = 1 << 30
    fixed = 6 * 4 * (n + 1) + 4 * e
    per_edge = 16 * 8
    chunk = max((budget_bytes - fixed) // per_edge, 1)
    chunk = 1 << min(max(int(math.floor(math.log2(max(chunk, 1)))), 14), 26)
    return int(min(chunk, max(e, 1)))


class _SingleBuild:
    """One device's build: in-degrees from the host multinomial, the
    dst-sorted sources drawn chunk by chunk, and lazily the out-degree
    census and the incremental orientation (a gather-engine build pays
    for neither). ``row_ptr``'s last entry is E."""

    def __init__(self, spec, seed: int, chunk_edges, device):
        self._spec = spec
        self._device = device
        self._src_srt = None
        self._outdeg = None
        self.e = e = _check_edges(spec.edge_count(seed))
        chunk = (
            plan_chunk_edges(e, spec.n, device=device)
            if chunk_edges in (None, "auto")
            else int(chunk_edges)
        )
        self.chunk = max(1, min(chunk, max(e, 1), _MAX_CHUNK))
        k0, k1 = _spec_key_words(seed)
        self._key = (int(k0), int(k1))
        self._tables = _device_tables(spec, device)
        indeg_h = _indeg_host(spec, seed, e)
        self.indeg = torch.from_numpy(indeg_h).to(device)
        self.row_ptr = torch.from_numpy(_row_ptr_host(indeg_h)).to(device)

    def src_sorted(self) -> torch.Tensor:
        """dst-sorted edge sources, the gather-engine layout. The stream
        is born sorted, so chunk c fills positions [c·chunk, (c+1)·chunk)
        as drawn."""
        if self._src_srt is None:
            out = torch.empty(self.e, dtype=torch.int32, device=self._device)
            for c0 in range(0, self.e, self.chunk):
                count = min(self.chunk, self.e - c0)
                eid = torch.arange(c0, c0 + count, dtype=torch.int64, device=self._device)
                d = (_dst_chunk(self.row_ptr, self._spec.n, c0, count)
                     if _needs_dst(self._spec) else None)
                out[c0:c0 + count] = _src_at(self._spec, self._tables, *self._key, eid, d)
            self._src_srt = out
        return self._src_srt

    @property
    def outdeg(self) -> torch.Tensor:
        """Out-degree census (int32), for the auto-engine gate and the
        incremental orientation."""
        if self._outdeg is None:
            self._outdeg = torch.bincount(
                self.src_sorted(), minlength=self._spec.n
            ).to(torch.int32)
        return self._outdeg

    def inc_arrays(self):
        """(dst2, out_ptr): the src-sorted out-edge structures of the
        incremental engine, in the host layout's (src, dst, raw id) order.
        A stable sort by source keeps the dst-sorted position as the
        tie-break, which is that order."""
        out_ptr = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=self._device),
            torch.cumsum(self.outdeg, 0, dtype=torch.int64),
        ]).to(torch.int32)
        dst = torch.repeat_interleave(
            torch.arange(self._spec.n, dtype=torch.int32, device=self._device),
            self.indeg, output_size=self.e,
        )
        order = torch.sort(self.src_sorted(), stable=True).indices
        return dst[order], out_ptr


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def generate_edges(spec, seed: int = 0, chunk_edges=None,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The raw (src, dst) edge stream as host numpy int32 arrays, dst-sorted
    as born; drawn on ``device`` (the CUDA card unless the caller names
    one). This is the verification surface: it moves O(E) data to the
    host, which `prepare_generated_graph` avoids."""
    e = _check_edges(spec.edge_count(seed))
    if e == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    device = torch.device(device) if device is not None else A.default_device()
    k0, k1 = _spec_key_words(seed)
    key = (int(k0), int(k1))
    tables = _device_tables(spec, device)
    row_ptr = torch.from_numpy(_row_ptr_host(_indeg_host(spec, seed, e))).to(device)
    chunk = (
        max(1, min(int(chunk_edges), _MAX_CHUNK))
        if chunk_edges
        else min(max(e, 1), 1 << 22)
    )
    srcs, dsts = [], []
    for c0 in range(0, e, chunk):
        count = min(chunk, e - c0)
        eid = torch.arange(c0, c0 + count, dtype=torch.int64, device=device)
        d = _dst_chunk(row_ptr, spec.n, c0, count)
        s = _src_at(spec, tables, key[0], key[1], eid, d)
        srcs.append(s.cpu().numpy())
        dsts.append(d.cpu().numpy())
    return np.concatenate(srcs), np.concatenate(dsts)


def prepare_generated_graph(
    spec,
    seed: int = 0,
    betas=1.0,
    config=None,
    mesh=None,
    dtype=np.float32,
    engine: str = "auto",
    incremental_budget: Optional[int] = None,
    incremental_max_degree: Optional[int] = None,
    chunk_edges=None,
    device=None,
    mesh_axis: str = "agents",
    comm: str = "scatter",
) -> A.PreparedAgentGraph:
    """A `PreparedAgentGraph` generated on ``device`` (the CUDA card unless
    the caller names one): `prepare_agent_graph` without the host edge
    pipeline.

    The graph named by ``(spec, seed)`` is drawn and laid out on the
    device, with the same engine resolution and budget rules as the host
    prepare, so ``simulate_agents(prepared=...)`` consumes it unchanged.
    The layout equals ``sbr_tpu``'s for the same (spec, seed), and the
    host prepare of the raw stream (tested). ``engine="gather"`` builds
    pay for neither the out-degree census nor the incremental
    orientation. Only node-length data touches the host: β, the spec
    tables, the in-degrees and, for "auto", the out-degree census. With
    telemetry on, the build runs under the ``graphgen.build`` span.

    ``mesh`` (a 1-D ``DeviceMesh``; every rank calls this with the same
    arguments) builds each rank's shard on its own device, with the mesh
    padding of the host prepare (module docstring), under the
    ``graphgen.build_sharded`` span; ``comm`` is kept on the prepared graph
    and sets the padding as in `agents.prepare_agent_graph`."""
    if config is None:
        config = A.AgentSimConfig()
    dtype = np.dtype(dtype)
    if engine not in ("auto", "gather", "incremental"):
        raise ValueError(
            f"engine must be 'auto', 'gather', or 'incremental' for generated "
            f"graphs (got {engine!r})"
        )
    if comm not in ("scatter", "allgather_psum"):
        raise ValueError(f"Unknown comm strategy {comm!r}")
    if mesh is not None:
        from sbr_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    device = torch.device(device) if device is not None else A.default_device()
    n = spec.n
    d0 = int(incremental_max_degree) if incremental_max_degree is not None else 64
    betas_h = np.broadcast_to(np.asarray(betas, dtype=dtype), (n,)).copy()

    if mesh is not None:
        with obs.span("graphgen.build_sharded", spec=type(spec).__name__, n=n):
            return _prepare_mesh(spec, seed, betas_h, config, mesh, mesh_axis, dtype, comm,
                                 engine, incremental_budget, d0, chunk_edges, device)

    with obs.span("graphgen.build", spec=type(spec).__name__, n=n):
        built = _SingleBuild(spec, seed, chunk_edges, device)
        e = built.e
        if engine == "auto":
            engine = A._resolve_engine_from_outdeg(
                built.outdeg.cpu().numpy(), n, e, config, incremental_budget, d0,
                float(np.mean(betas_h, dtype=np.float64)),
            )
        if engine == "incremental" and e == 0:
            engine = "gather"
        budget, inc = 0, None
        if engine == "incremental":
            budget = incremental_budget or A._default_incremental_budget(n)
            dst2, out_ptr = built.inc_arrays()
            inc = (dst2, out_ptr, built.outdeg)
        return A.PreparedAgentGraph(
            n=n, n_edges=e, dtype=dtype, device=device, engine=engine,
            budget=int(budget), max_degree=d0,
            betas=A._tensor(betas_h, device), src=built.src_sorted(),
            row_ptr=built.row_ptr, indeg=built.indeg.to(A._TORCH_DTYPE[dtype]),
            inc=inc, mesh_axis=mesh_axis, comm=comm,
        )


def _local_edges(spec, tables, key, row_ptr, lo: int, hi: int, e: int, chunk: int,
                 device):
    """Sources and structural destinations of the edge positions [lo, hi),
    drawn in chunks; positions at or past E are left out."""
    srcs, dsts = [], []
    for c0 in range(lo, min(hi, e), chunk):
        count = min(chunk, min(hi, e) - c0)
        eid = torch.arange(c0, c0 + count, dtype=torch.int64, device=device)
        d = _dst_chunk(row_ptr, spec.n, c0, count)
        srcs.append(_src_at(spec, tables, key[0], key[1], eid, d))
        dsts.append(d)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return (torch.cat(srcs) if srcs else empty), (torch.cat(dsts) if dsts else empty)


def _inc_shard(src_l, dst_l, out_ptr, lo: int, el: int, e: int, n: int, n_gl: int,
               mesh, axis: str):
    """This rank's chunk of the src-sorted destinations, by a distributed
    counting sort: edges keyed by source (n for pad lanes), the ranks'
    histograms merged by `exclusive_psum` into this rank's prior counts,
    each edge scattered to out_ptr[src] + prior[src] + its stable rank
    among this rank's equal keys, and one tiled ``psum_scatter`` delivering
    chunk i to rank i. The order is (src, dst, raw id), the host re-sort's."""
    from sbr_tpu_torch.parallel import collectives as C
    from sbr_tpu_torch.parallel.mesh import axis_size

    device = src_l.device
    n_dev = axis_size(mesh, axis)
    key = torch.full((el,), n, dtype=torch.int64, device=device)
    key[:src_l.shape[0]] = src_l.to(torch.int64)
    val = torch.zeros(el, dtype=torch.int32, device=device)
    val[:dst_l.shape[0]] = dst_l
    hist = torch.bincount(key, minlength=n + 1).to(torch.int32)
    prior = C.exclusive_psum(hist, mesh, axis, n_dev).to(torch.int64)
    order = torch.sort(key, stable=True).indices
    k_s = key[order]
    start = (torch.cumsum(hist.to(torch.int64), 0) - hist)[k_s]
    rank = torch.arange(el, dtype=torch.int64, device=device) - start
    # out_ptr[n] = E: pad lanes stream past the last real edge
    pos = out_ptr.to(torch.int64)[k_s] + prior[k_s] + rank
    keep = pos < n_dev * el
    out = torch.zeros(n_dev * el, dtype=torch.int32, device=device)
    out[pos[keep]] = val[order][keep]
    local = C.psum_scatter(out, mesh, axis)
    gpos = lo + torch.arange(el, dtype=torch.int64, device=device)
    local = torch.where(gpos < e, local, n_gl)
    s_c = torch.clamp(out_ptr[:-1].to(torch.int64), lo, lo + el)
    e_c = torch.clamp(out_ptr[1:].to(torch.int64), lo, lo + el)
    lstart = torch.zeros(n_gl, dtype=torch.int32, device=device)
    ldeg = torch.zeros(n_gl, dtype=torch.int32, device=device)
    lstart[:n] = (s_c - lo).to(torch.int32)
    ldeg[:n] = (e_c - s_c).to(torch.int32)
    return local, lstart, ldeg


def _prepare_mesh(spec, seed, betas_h, config, mesh, mesh_axis, dtype, comm, engine,
                  incremental_budget, d0, chunk_edges, device) -> A.PreparedAgentGraph:
    """This rank's shard of the generated graph (module docstring), laid
    out as `agents.prepare_agent_graph` lays it under the same mesh."""
    from sbr_tpu_torch.parallel import collectives as C
    from sbr_tpu_torch.parallel.mesh import axis_index, axis_size

    n = spec.n
    n_dev = axis_size(mesh, mesh_axis)
    idx = axis_index(mesh, mesh_axis)
    e = _check_edges(spec.edge_count(seed))
    el = max(1, (e + (-e) % n_dev) // n_dev)
    chunk = (plan_chunk_edges(e, n, device=device) if chunk_edges in (None, "auto")
             else int(chunk_edges))
    chunk = max(1, min(chunk, el, _MAX_CHUNK))
    k0, k1 = _spec_key_words(seed)
    key = (int(k0), int(k1))
    tables = _device_tables(spec, device)
    indeg_h = _indeg_host(spec, seed, e)
    row_ptr = torch.from_numpy(_row_ptr_host(indeg_h)).to(device)
    lo = idx * el
    src_l, dst_l = _local_edges(spec, tables, key, row_ptr, lo, lo + el, e, chunk, device)

    outdeg = None
    if engine in ("auto", "incremental"):
        # each rank histograms its own positions; a psum merges them
        outdeg = C.psum(torch.bincount(src_l, minlength=n).to(torch.int32), mesh, mesh_axis)
    if engine == "auto":
        engine = A._resolve_engine_from_outdeg(
            outdeg.cpu().numpy(), n, e, config, incremental_budget, d0,
            float(np.mean(betas_h, dtype=np.float64)), mesh=mesh, mesh_axis=mesh_axis,
        )
    if engine == "incremental" and e == 0:
        engine = "gather"
    n_gl = A._pad_block(n, n_dev, comm, engine)
    n_pad = n_gl - n
    nb = n_gl // n_dev

    # the gather layout: pad lanes take source 0 and the sentinel n_gl
    src_sh = torch.zeros(el, dtype=torch.int32, device=device)
    src_sh[:src_l.shape[0]] = src_l
    dst_sh = torch.full((el,), n_gl, dtype=torch.int32, device=device)
    dst_sh[:dst_l.shape[0]] = dst_l
    seg_ids = torch.arange(n_gl + 2, dtype=torch.int32, device=device)
    row_table = torch.searchsorted(dst_sh, seg_ids, side="left", out_int32=True)

    budget, inc = 0, None
    if engine == "incremental":
        out_ptr = torch.cat([outdeg.new_zeros(1), torch.cumsum(outdeg, 0, dtype=torch.int32)])
        if os.environ.get("SBR_FLIGHT", "").strip() not in ("", "0"):
            # the exclusive_psum-bearing pass as one mark on the flight
            # recorder's collectives stream, fenced by a device sync; the
            # values are untouched
            import time as _time

            from sbr_tpu_torch.obs import flight as _flight

            t0 = _time.monotonic()
            inc = _inc_shard(src_l, dst_l, out_ptr, lo, el, e, n, n_gl, mesh, mesh_axis)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            _flight.shared().mark("collectives", "psum", t0, _time.monotonic(), tag="inc")
        else:
            inc = _inc_shard(src_l, dst_l, out_ptr, lo, el, e, n, n_gl, mesh, mesh_axis)
        budget = incremental_budget or A._default_incremental_budget(nb, floor=512)

    blk = slice(idx * nb, (idx + 1) * nb)
    betas_p = np.concatenate([betas_h, np.zeros(n_pad, betas_h.dtype)])
    indeg_p = np.concatenate([indeg_h, np.zeros(n_pad, indeg_h.dtype)]).astype(dtype)
    return A.PreparedAgentGraph(
        n=n, n_edges=e, dtype=dtype, device=device, engine=engine, budget=int(budget),
        max_degree=d0, betas=A._tensor(betas_p[blk], device), src=src_sh,
        row_ptr=row_table, indeg=A._tensor(indeg_p[blk], device), inc=inc,
        mesh=mesh, mesh_axis=mesh_axis, comm=comm, n_pad=n_pad,
    )


# ---------------------------------------------------------------------------
# Self-check (python -m sbr_tpu_torch.social.graphgen_cli --selfcheck)
# ---------------------------------------------------------------------------


def _selfcheck(n: int = 600, deg: float = 6.0, seed: int = 3, device=None) -> int:
    """Bitwise parity battery on ``device`` (the CUDA card unless the
    caller names one): the device's canonical layout against the host sort
    of the same raw stream, chunk invariance, and the fused simulation
    against the unfused one. Returns 0 on a pass, 1 on any failure.

    The reference's sharded block runs only with more than one device; here
    it runs when a process group of more than one rank is up
    (`parallel.initialize_distributed`; every rank runs the self-check):
    the sharded build of each engine against the host prepare under the
    same agent mesh, byte for byte. The two simulation lines hold the infection step's two lowerings to each
    other: the default ("auto") and "pallas" on the card are the CUDA
    kernel, "unfused" the plain step; on the CPU all three are the plain
    step ("interpret" stands in for "pallas")."""
    device = torch.device(device) if device is not None else A.default_device()
    failures = []

    def check(label, ok):
        print(("PASS  " if ok else "FAIL  ") + label)
        if not ok:
            failures.append(label)

    def same(a, b) -> bool:
        return np.array_equal(torch.as_tensor(a).cpu().numpy(), torch.as_tensor(b).cpu().numpy())

    specs = [
        ErdosRenyiSpec(n=n, avg_degree=deg),
        ScaleFreeSpec(n=n, avg_degree=deg, gamma=2.5),
        StochasticBlockSpec(n=n, avg_degree=deg, n_blocks=4, p_in=0.8),
    ]
    for spec in specs:
        name = type(spec).__name__
        src, dst = generate_edges(spec, seed=seed, device=device)
        _, src_h, _, indeg_h, row_ptr_h = A._canonicalize_graph(1.0, src, dst, n, np.float32)
        built = _SingleBuild(spec, seed, None, device)
        check(f"{name}: device src == host canonical src", same(built.src_sorted(), src_h))
        check(f"{name}: row_ptr match", same(built.row_ptr, row_ptr_h.astype(np.int32)))
        check(f"{name}: indeg match", same(built.indeg, indeg_h.astype(np.int32)))
        built2 = _SingleBuild(spec, seed, 97, device)
        check(f"{name}: chunk invariance (97-edge chunks)",
              same(built.src_sorted(), built2.src_sorted()))
        pg_d = prepare_generated_graph(spec, seed=seed, engine="incremental", device=device)
        pg_h = A.prepare_agent_graph(1.0, src, dst, n, engine="incremental", device=device)
        check(
            f"{name}: single-device incremental == host-prepared",
            all(same(a, b) for a, b in zip(pg_d.inc, pg_h.inc)) and same(pg_d.src, pg_h.src),
        )
        check(f"{name}: chunk invariance (incremental, 97-edge chunks)",
              same(built.inc_arrays()[0], built2.inc_arrays()[0]))

    spec = specs[0]
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from sbr_tpu_torch.parallel import make_agent_mesh

        mesh = make_agent_mesh(device=device)
        src, dst = generate_edges(spec, seed=seed, device=device)
        for eng in ("gather", "incremental"):
            pg_d = prepare_generated_graph(spec, seed=seed, mesh=mesh, engine=eng)
            pg_h = A.prepare_agent_graph(1.0, src, dst, n, mesh=mesh, engine=eng)
            ok = (same(pg_d.src, pg_h.src) and same(pg_d.row_ptr, pg_h.row_ptr)
                  and same(pg_d.indeg, pg_h.indeg))
            if eng == "incremental":
                ok = ok and all(same(a, b) for a, b in zip(pg_d.inc, pg_h.inc))
            check(f"sharded {eng}: generated == host-prepared (byte-identical)", ok)

    cfg = A.AgentSimConfig(n_steps=25, dt=0.1)
    pg = prepare_generated_graph(spec, seed=seed, config=cfg, device=device)
    kernel = "pallas" if device.type == "cuda" else "interpret"
    r_def = A.simulate_agents(prepared=pg, x0=0.02, config=cfg, seed=1)
    r_unf = A.simulate_agents(prepared=pg, x0=0.02,
                              config=dataclasses.replace(cfg, fused="unfused"), seed=1)
    r_int = A.simulate_agents(prepared=pg, x0=0.02,
                              config=dataclasses.replace(cfg, fused=kernel), seed=1)
    check("fused lax == unfused (bitwise)",
          same(r_def.informed, r_unf.informed) and same(r_def.t_inf, r_unf.t_inf))
    check("fused pallas-interpret == unfused (bitwise)",
          same(r_int.informed, r_unf.informed) and same(r_int.t_inf, r_unf.t_inf))

    print(f"\ngraphgen selfcheck: {len(failures)} failure(s)")
    return 1 if failures else 0
