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
the destination marginal, `tilt_threshold_table` tilts the source marginal
toward the withdrawing agents, and `generate_tilted_sources` draws the
dst-sorted sources against it, keyed by `epoch_key_words`. The table and
the sources equal ``sbr_tpu``'s bit for bit (tested).

Not ported yet: the sharded build (``mesh=`` raises ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch.core.integrate import xla_cumsum
from sbr_tpu_torch.social import agents as A
from sbr_tpu_torch.social.rng import _threefry2x32

__all__ = [
    "ErdosRenyiSpec",
    "ScaleFreeSpec",
    "StochasticBlockSpec",
    "epoch_indegrees",
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


def _indeg_host(spec, seed: int, e: int) -> np.ndarray:
    """The in-degree vector: one host multinomial draw over the spec's
    destination marginal, seeded from SeedSequence((seed, 1)). Uniform
    marginals draw it as a bincount of uniform integers, consumed in
    bounded chunks (a numpy Generator continues one bit stream across
    calls, so the chunking is bitwise the full draw)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    w = _spec_weights(spec)
    if w is None:
        indeg = np.zeros(spec.n, np.int64)
        done = 0
        while done < e:
            take = min(1 << 24, e - done)
            indeg += np.bincount(
                rng.integers(0, spec.n, size=take), minlength=spec.n
            )
            done += take
        return indeg.astype(np.int32)
    return rng.multinomial(e, w / w.sum()).astype(np.int32)


def epoch_key_words(seed: int, epoch: int) -> Tuple[np.uint32, np.uint32]:
    """Threefry key words of one panic-rewiring epoch, from
    SeedSequence((seed, 23, epoch)): a stream per epoch, apart from the
    base generation stream and the in-degree draws, the same in every
    process."""
    k0, k1 = np.random.SeedSequence((seed, 23, epoch)).generate_state(2, np.uint32)
    return np.uint32(k0), np.uint32(k1)


def epoch_indegrees(spec, seed: int, epoch: int, e: int) -> np.ndarray:
    """The in-degree vector of one rewiring epoch: the base spec's
    destination marginal, redrawn from SeedSequence((seed, 1, epoch)), so
    epoch graphs are independent realizations, deterministic in (seed,
    epoch). Uniform marginals draw at most 2^24 integers at a time, as the
    reference does (the chunking is part of the stream)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1, epoch)))
    w = _spec_weights(spec)
    if w is None:
        indeg = np.zeros(spec.n, np.int64)
        done = 0
        while done < e:
            take = min(1 << 24, e - done)
            indeg += np.bincount(rng.integers(0, spec.n, size=take), minlength=spec.n)
            done += take
        return indeg.astype(np.int32)
    return rng.multinomial(e, w / w.sum()).astype(np.int32)


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
    tables, the in-degrees and, for "auto", the out-degree census."""
    if mesh is not None:
        raise NotImplementedError("the sharded graph build (mesh=) is not ported yet")
    if config is None:
        config = A.AgentSimConfig()
    dtype = np.dtype(dtype)
    if engine not in ("auto", "gather", "incremental"):
        raise ValueError(
            f"engine must be 'auto', 'gather', or 'incremental' for generated "
            f"graphs (got {engine!r})"
        )
    device = torch.device(device) if device is not None else A.default_device()
    n = spec.n
    d0 = int(incremental_max_degree) if incremental_max_degree is not None else 64
    betas_h = np.broadcast_to(np.asarray(betas, dtype=dtype), (n,)).copy()

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
        inc=inc,
    )
