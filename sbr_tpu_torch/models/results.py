"""Result records of the port, after ``sbr_tpu.models.results``.

Immutable dataclasses of tensors. No-run cells carry NaN plus an integer
status code, as the reference's do. Batched results (sweeps) hold tensors
of the cell grid's shape; a scalar solve holds 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from sbr_tpu_torch.diag.health import Health


def _fmt(x, digits: int = 6) -> str:
    """Human-readable scalar for reprs: 0-d tensors print as numbers,
    batched ones as their shape."""
    if isinstance(x, torch.Tensor):
        if x.dim() > 0:
            return f"<{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}>"
        x = x.item()
    if isinstance(x, bool):
        return str(x)
    if isinstance(x, float):
        return f"{x:.{digits}g}"
    return str(x)


class Status(enum.IntEnum):
    """Per-cell outcome codes, the reference's.

    - RUN: valid bank-run equilibrium.
    - NO_CROSSING: u at or above the max of the hazard; buffers coincide.
    - NO_ROOT: the bisection found no root of AW(ξ)=κ in the bracket.
    - FALSE_EQ: the root lies on the decreasing branch of the withdrawal
      path.
    """

    RUN = 0
    NO_CROSSING = 1
    NO_ROOT = 2
    FALSE_EQ = 3


@dataclasses.dataclass(frozen=True)
class LearningSolution:
    """Stage-1 output: uniform-grid samples of the CDF and PDF and, when
    ``closed_form`` is set, the exact logistic parameters, in which case the
    evaluators bypass interpolation.

    In a sweep over β the scalars ``t0``, ``dt`` and ``beta`` carry the
    sweep's row shape R and the samples have shape R + (n,); the
    evaluators broadcast against the cells.
    """

    grid: torch.Tensor  # R + (n,) uniform time grid over tspan
    cdf: torch.Tensor  # R + (n,) G(t) samples
    pdf: torch.Tensor  # R + (n,) g(t) samples
    t0: torch.Tensor  # R, grid start
    dt: torch.Tensor  # R, grid spacing
    beta: torch.Tensor  # R, learning rate (closed-form evaluation)
    x0: torch.Tensor  # R, initial condition
    closed_form: bool = False

    @property
    def device(self) -> torch.device:
        return self.cdf.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cdf.dtype

    def cdf_at(self, t):
        from sbr_tpu_torch.baseline.learning import logistic_cdf
        from sbr_tpu_torch.core.interp import interp_uniform

        if self.closed_form:
            return logistic_cdf(t, self.beta, self.x0)
        return interp_uniform(t, self.t0, self.dt, self.cdf)

    def pdf_at(self, t):
        from sbr_tpu_torch.baseline.learning import logistic_pdf
        from sbr_tpu_torch.core.interp import interp_uniform

        if self.closed_form:
            return logistic_pdf(t, self.beta, self.x0)
        return interp_uniform(t, self.t0, self.dt, self.pdf)


@dataclasses.dataclass(frozen=True)
class EquilibriumResult:
    """Stage-2/3 output. Scalars are tensors of the cell shape; the curve
    fields live on the [0, η] hazard grid (``None`` in the sweeps' lean
    cells, which need only the scalars). ``xi`` is NaN when no run occurs,
    with ``status`` recording why."""

    xi: torch.Tensor
    tau_bar_in_unc: torch.Tensor
    tau_bar_out_unc: torch.Tensor
    tau_in: torch.Tensor  # max(ξ - τ̄_IN, 0)
    tau_out: torch.Tensor  # max(ξ - τ̄_OUT, 0)
    bankrun: torch.Tensor  # bool
    status: torch.Tensor  # int32 Status code
    converged: torch.Tensor  # bool
    tolerance: torch.Tensor  # achieved |AW(ξ)-κ| (Inf when no root)
    tau_grid: torch.Tensor  # R + (n,) hazard grid on [0, η]
    hr: torch.Tensor  # R + (n,) hazard rate h(τ̄)
    aw_cum: Optional[torch.Tensor]  # (n,) cumulative aggregate withdrawals
    aw_out: Optional[torch.Tensor]  # (n,) exits
    aw_in: Optional[torch.Tensor]  # (n,) re-entries
    aw_max: torch.Tensor
    solve_time: float = 0.0  # host wall-clock of the convenience entry
    health: Optional[Health] = None

    def replace(self, **changes) -> "EquilibriumResult":
        return dataclasses.replace(self, **changes)

    def __repr__(self) -> str:
        return (
            f"EquilibriumResult(ξ={_fmt(self.xi)}, bankrun={_fmt(self.bankrun)}, "
            f"status={_fmt(self.status)}, τ̄_IN={_fmt(self.tau_bar_in_unc)}, "
            f"τ̄_OUT={_fmt(self.tau_bar_out_unc)}, AW_max={_fmt(self.aw_max)}, "
            f"solve_time={_fmt(self.solve_time, 3)}s)"
        )


@dataclasses.dataclass(frozen=True)
class LearningSolutionHetero:
    """K-group Stage-1 output: per-group CDF and PDF rows on one shared
    time grid (warped under the exact Ω path), the group axis leading."""

    grid: torch.Tensor  # (n,) shared time grid over tspan
    cdfs: torch.Tensor  # (K, n) per-group G_k(t)
    pdfs: torch.Tensor  # (K, n) per-group g_k(t)
    t0: torch.Tensor  # grid start
    dt: torch.Tensor  # FIRST grid spacing (use the local spacings of ``grid``)
    betas: torch.Tensor  # (K,) group learning rates
    dist: torch.Tensor  # (K,) group weights (simplex)
    # Health flags of the adaptive coupled-K ODE (ODE_BUDGET when an
    # interval exhausted its step budget); None on the other routes.
    ode_flags: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.cdfs.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cdfs.dtype

    def cdf_at(self, t):
        """G_k at time(s) t: shape (K, *t.shape), searchsorted
        interpolation on the shared grid."""
        from sbr_tpu_torch.core.interp import interp_shared

        return interp_shared(t, self.grid, self.cdfs)

    def pdf_at(self, t):
        from sbr_tpu_torch.core.interp import interp_shared

        return interp_shared(t, self.grid, self.pdfs)


@dataclasses.dataclass(frozen=True)
class EquilibriumResultHetero:
    """K-group Stage-2/3 output. Group-resolved fields carry a leading K
    axis; the first-crossing rejection of the hetero family maps onto
    FALSE_EQ."""

    xi: torch.Tensor
    tau_bar_in_uncs: torch.Tensor  # (K,)
    tau_bar_out_uncs: torch.Tensor  # (K,)
    hrs: torch.Tensor  # (K, n) per-group hazard rates on tau_grid
    tau_grid: torch.Tensor  # (n,) hazard grid on [0, η]
    bankrun: torch.Tensor  # bool
    status: torch.Tensor  # int32 Status code
    converged: torch.Tensor  # bool
    tolerance: torch.Tensor  # achieved |AW(ξ)-κ|
    solve_time: float = 0.0
    health: Optional[Health] = None

    def replace(self, **changes) -> "EquilibriumResultHetero":
        return dataclasses.replace(self, **changes)

    def __repr__(self) -> str:
        k = self.hrs.shape[0] if self.hrs.dim() >= 1 else "?"
        return (
            f"EquilibriumResultHetero(K={k}, ξ={_fmt(self.xi)}, "
            f"bankrun={_fmt(self.bankrun)}, status={_fmt(self.status)}, "
            f"solve_time={_fmt(self.solve_time, 3)}s)"
        )


@dataclasses.dataclass(frozen=True)
class AWHetero:
    """Group-decomposed aggregate-withdrawal curves on the learning grid."""

    t_grid: torch.Tensor  # (n,) learning grid
    aw_cum: torch.Tensor  # (n,) Σ_k dist_k · AW_k
    aw_out_groups: torch.Tensor  # (K, n)
    aw_in_groups: torch.Tensor  # (K, n)
    aw_groups: torch.Tensor  # (K, n) net per-group withdrawals
    aw_max: torch.Tensor  # scalar
