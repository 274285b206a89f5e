"""Multi-bank contagion on an interbank exposure network: the port of
``sbr_tpu.scenario.multibank``.

N banks, each one composed single-bank cell (`engine.solve_scenario_cell`
batched over the bank axis), coupled through cross-bank spillovers
iterated to a stable κ vector:

1. Solve all N banks with the current effective thresholds κ_eff.
2. Each RUN bank j inflicts a loss proportional to its peak withdrawal
   share AW_max_j on every counterparty holding exposure to it.
3. κ_eff_i ← clip(κ_i − lgd·Σ_{j→i} w_ij·loss_j, κ_floor, κ_i), damped by
   ``spec.contagion_damping``: counterparty losses erode bank i's solvency
   buffer, so a run elsewhere can make bank i runnable (contagion).
4. Repeat until the κ vector is stable (``contagion_tol``) or
   ``contagion_max_iter`` is exhausted.

The κ-erosion loop runs on the host: one batched dispatch of the N cells
and one host read (the round's κ change) a round. The exposure edges are
sorted by destination with `native.sort_edges_by_dst`, the agent engine's
canonical layout, and the per-bank spillover is a segmented sum by prefix
sums (`core.integrate.prefix_sum`, the same elementwise adds on the CPU
and the card; the reference's ``jnp.cumsum`` associates in XLA's order,
so the spillovers agree with it to rounding, not bit for bit).

An empty exposure network converges in one round with κ_eff the κ column
itself, so N uncoupled banks are N independent solves of the same batched
cell, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sbr_tpu_torch.core.integrate import prefix_sum
from sbr_tpu_torch.models.params import SolverConfig
from sbr_tpu_torch.models.results import Status
from sbr_tpu_torch.scenario.spec import ScenarioSpec, spec_fingerprint
from sbr_tpu_torch.social.agents import default_device
from sbr_tpu_torch.utils.checkpoint import dtype_name


@dataclasses.dataclass
class MultiBankResult:
    """Per-bank tensors plus the contagion loop's metadata."""

    spec: ScenarioSpec
    fingerprint: str
    xi: torch.Tensor  # (N,) NaN-masked crash times
    tau_bar_in: torch.Tensor  # (N,)
    aw_max: torch.Tensor  # (N,)
    status: torch.Tensor  # (N,) int32 Status codes
    kappa_eff: torch.Tensor  # (N,) final effective thresholds
    spillover: torch.Tensor  # (N,) final incoming exposure-weighted losses
    iterations: int
    converged: bool
    health: object  # batched diag.Health, leaves (N,)

    @property
    def bankrun(self):
        return self.status == int(Status.RUN)

    def __repr__(self) -> str:
        runs = int((self.status == int(Status.RUN)).sum())
        return (
            f"MultiBankResult(banks={self.spec.banks}, runs={runs}, "
            f"iterations={self.iterations}, converged={self.converged}, "
            f"fp={self.fingerprint[:12]})"
        )


def _seg_weighted(values: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Segmented sum over dst-sorted edge values:
    out[i] = Σ values[row_ptr[i] : row_ptr[i+1]], by differences of one
    exclusive prefix sum."""
    prefix = torch.cat([torch.zeros((1,), dtype=values.dtype, device=values.device),
                        prefix_sum(values)])
    return prefix[row_ptr[1:]] - prefix[row_ptr[:-1]]


def _exposure_layout(spec: ScenarioSpec):
    """The dst-sorted exposure layout through the agent engine's edge
    sorter: (src_sorted, w_sorted, row_ptr) with the edges into bank i in
    [row_ptr[i], row_ptr[i+1]); None without edges. The permutation comes
    from sorting edge ids as the payload (the sort is stable), so weights
    follow their edges exactly."""
    from sbr_tpu_torch.native import sort_edges_by_dst

    if not spec.exposure:
        return None
    src = np.asarray([e[0] for e in spec.exposure], np.int32)
    dst = np.asarray([e[1] for e in spec.exposure], np.int32)
    w = np.asarray([e[2] for e in spec.exposure], np.float64)
    eids, _dst_sorted, _indeg, row_ptr = sort_edges_by_dst(
        np.arange(src.shape[0], dtype=np.int32), dst, spec.banks
    )
    return src[eids], w[eids], np.asarray(row_ptr, np.int64)


def _bank_columns(spec: ScenarioSpec, params, dtype, device="cpu") -> list:
    """The 14 SCENARIO_KEYS columns, each of shape (N,), from one shared
    params struct or a list of one per bank, made in one host copy."""
    from sbr_tpu_torch.scenario.engine import SCENARIO_KEYS, _theta_values

    if isinstance(params, (list, tuple)):
        if len(params) != spec.banks:
            raise ValueError(f"got {len(params)} params structs for {spec.banks} banks")
        plist = list(params)
    else:
        plist = [params] * spec.banks
    values = [_theta_values(p) for p in plist]
    table = torch.tensor([[v[k] for v in values] for k in SCENARIO_KEYS], dtype=dtype)
    return list(table.to(device).unbind())


def solve_multibank(
    spec: ScenarioSpec,
    params,
    config: Optional[SolverConfig] = None,
    dtype=None,
    device=None,
) -> MultiBankResult:
    """Solve an N-bank contagion scenario (module docstring) on ``device``
    (default: the CUDA card) in ``dtype`` (default: float64). ``config=None``
    is the sweep default, refinement off."""
    from sbr_tpu_torch.scenario.engine import SCENARIO_KEYS, _validate_params, batch_fn

    if spec.banks < 2:
        raise ValueError("solve_multibank requires spec.banks >= 2")
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()

    # one params struct per bank before fingerprinting: a shared struct and
    # an N-list of it describe the same solve and key identically
    if isinstance(params, (list, tuple)):
        plist = list(params)
        if len(plist) != spec.banks:
            raise ValueError(f"got {len(plist)} params structs for {spec.banks} banks")
    else:
        plist = [params] * spec.banks
    for p in plist:
        _validate_params(dataclasses.replace(spec, banks=1, exposure=()), p)
    fp = spec_fingerprint(spec, tuple(plist), config, dtype)

    cols = _bank_columns(spec, plist, dtype, device)
    kappa_idx = SCENARIO_KEYS.index("kappa")
    kappa0 = cols[kappa_idx]
    layout = _exposure_layout(spec)
    if layout is not None:
        src_sorted, w_sorted, row_ptr = (
            torch.as_tensor(a).to(device) for a in layout
        )
        w_sorted = w_sorted.to(dtype)
    # keyed on the cell-program projection: banks, exposure and the
    # contagion knobs never reach the cell
    batch = batch_fn(spec, config, dtype_name(dtype))

    def dispatch(kappa_eff):
        args = list(cols)
        args[kappa_idx] = kappa_eff
        return batch(*args)

    alpha = torch.tensor(spec.contagion_damping, dtype=dtype, device=device)
    floor = torch.tensor(spec.kappa_floor, dtype=dtype, device=device)
    lgd = torch.tensor(spec.lgd, dtype=dtype, device=device)

    kappa_eff = kappa0
    spill = torch.zeros_like(kappa0)
    converged = False
    iterations = 0
    for it in range(1, spec.contagion_max_iter + 1):
        iterations = it
        xi, tau_in, aw_max, status, health = dispatch(kappa_eff)
        if layout is None:
            # no exposure: zero spillover, so the first round is the fixed
            # point, and κ_eff stays the κ column itself
            converged = True
            break
        loss = torch.where(status == int(Status.RUN), aw_max, 0.0)
        spill = _seg_weighted(w_sorted * loss[src_sorted], row_ptr)
        target = torch.minimum(torch.maximum(kappa0 - lgd * spill, floor), kappa0)
        new = (1.0 - alpha) * kappa_eff + alpha * target
        # the round's one host read
        delta = float((new - kappa_eff).abs().max())
        # <= so that an exactly stable vector converges at contagion_tol=0
        # (an all-no-run network has delta == 0.0 after round 1)
        if delta <= spec.contagion_tol:
            # κ stable: the results just computed are the fixed point's
            converged = True
            break
        if it == spec.contagion_max_iter:
            # budget exhausted: keep the κ_eff the reported xi/status/aw_max
            # were solved under (re-solving at it reproduces the result)
            break
        kappa_eff = new

    return MultiBankResult(
        spec=spec, fingerprint=fp, xi=xi, tau_bar_in=tau_in, aw_max=aw_max,
        status=status, kappa_eff=kappa_eff, spillover=spill,
        iterations=iterations, converged=converged, health=health,
    )
