"""Parameter structs with the reference's defaults, derivations, validation
and copy-with-override semantics: the port of ``sbr_tpu.models.params``
(the baseline, heterogeneous-learning and interest-rate families).

- η = η̄ / β when η is not given; default tspan = (0, 2η).
- Copy-with-overrides carries the RESOLVED η and tspan of the base unless
  they are overridden explicitly. The Figure-5 heatmap sweeps β this way,
  so every cell keeps the base model's η = 15 rather than η̄/β.

Fields are plain Python floats and tuples; the solvers turn them into
tensors of the dtype and on the device they are asked for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


def _check(cond, msg: str) -> None:
    """Validate a constructor invariant; raise ``ValueError`` when it fails."""
    if not bool(cond):
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class LearningParams:
    """Stage-1 learning inputs."""

    beta: float
    tspan: Tuple[float, float]
    x0: float

    def __post_init__(self):
        _check(self.beta > 0, f"Communication speed beta must be positive, got {self.beta}")
        _check(len(self.tspan) == 2, "tspan must have length 2")
        _check(self.tspan[0] >= 0, f"Start time must be non-negative, got {self.tspan[0]}")
        _check(self.tspan[1] > self.tspan[0], f"End time must exceed start time, got {self.tspan}")
        _check(self.x0 >= 0, f"Initial condition x0 must be non-negative, got {self.x0}")


@dataclasses.dataclass(frozen=True)
class EconomicParams:
    """Stage-2/3 economic fundamentals plus the scenario engine's policy
    knobs (insured fraction, suspension time, lender-of-last-resort rate),
    which are inert until the scenario slice is ported."""

    u: float
    p: float
    kappa: float
    lam: float
    eta_bar: float
    eta: float
    insurance_cap: float = 0.0
    suspension_t: float = 0.0
    lolr_rate: float = 0.0

    def __post_init__(self):
        _check(self.u >= 0, f"Utility flow u must be non-negative, got {self.u}")
        _check(0 <= self.p <= 1, f"Prior probability p must be in [0,1], got {self.p}")
        _check(0 < self.kappa < 1, f"Solvency threshold kappa must be in (0,1), got {self.kappa}")
        _check(self.lam > 0, f"Exponential rate lam must be positive, got {self.lam}")
        _check(self.eta_bar > 0, f"Raw awareness window eta_bar must be positive, got {self.eta_bar}")
        _check(self.eta > 0, f"Normalized awareness window eta must be positive, got {self.eta}")
        _check(
            0 <= self.insurance_cap < 1,
            f"Insured fraction insurance_cap must be in [0,1), got {self.insurance_cap}",
        )
        _check(
            self.suspension_t >= 0,
            f"Suspension time suspension_t must be non-negative, got {self.suspension_t}",
        )
        _check(
            self.lolr_rate >= 0,
            f"LOLR injection rate lolr_rate must be non-negative, got {self.lolr_rate}",
        )


@dataclasses.dataclass(frozen=True)
class ModelParams:
    learning: LearningParams
    economic: EconomicParams


def make_model_params(
    beta: float = 1.0,
    eta: Optional[float] = None,
    eta_bar: float = 15.0,
    u: float = 0.1,
    p: float = 0.5,
    kappa: float = 0.6,
    lam: float = 0.01,
    tspan: Optional[Tuple[float, float]] = None,
    x0: float = 0.0001,
    insurance_cap: float = 0.0,
    suspension_t: float = 0.0,
    lolr_rate: float = 0.0,
) -> ModelParams:
    """Keyword constructor with the reference defaults (the Figure-3 model)."""
    if eta is None:
        eta = eta_bar / beta
    if tspan is None:
        tspan = (0.0, 2.0 * eta)
    return ModelParams(
        learning=LearningParams(beta=beta, tspan=tspan, x0=x0),
        economic=EconomicParams(
            u=u, p=p, kappa=kappa, lam=lam, eta_bar=eta_bar, eta=eta,
            insurance_cap=insurance_cap, suspension_t=suspension_t,
            lolr_rate=lolr_rate,
        ),
    )


def with_overrides(base: ModelParams, **kwargs) -> ModelParams:
    """Copy-with-overrides: pins the base's resolved eta and tspan unless
    they are overridden explicitly, including when only beta or eta_bar
    change (see the module docstring)."""
    current = dict(
        beta=base.learning.beta,
        eta=base.economic.eta,
        eta_bar=base.economic.eta_bar,
        u=base.economic.u,
        p=base.economic.p,
        kappa=base.economic.kappa,
        lam=base.economic.lam,
        tspan=base.learning.tspan,
        x0=base.learning.x0,
        insurance_cap=base.economic.insurance_cap,
        suspension_t=base.economic.suspension_t,
        lolr_rate=base.economic.lolr_rate,
    )
    unknown = set(kwargs) - set(current)
    _check(not unknown, f"Unknown parameter overrides: {sorted(unknown)}")
    current.update(kwargs)
    return make_model_params(**current)


# The scalar leaves of a baseline ModelParams: `solve_param_cell`'s column
# order first (beta, u, p, kappa, lam, eta, t0, t1, x0), then eta_bar and
# the policy knobs.
PARAMS_LEAF_NAMES = (
    "beta", "u", "p", "kappa", "lam", "eta", "t0", "t1", "x0", "eta_bar",
    "insurance_cap", "suspension_t", "lolr_rate",
)


def params_to_pytree(params: ModelParams) -> dict:
    """Flatten a `ModelParams` into a plain ``{name: scalar}`` dict, the
    same dict ``sbr_tpu.models.params.params_to_pytree`` makes. Lossless:
    it carries the resolved eta and tspan."""
    return {
        "beta": params.learning.beta,
        "u": params.economic.u,
        "p": params.economic.p,
        "kappa": params.economic.kappa,
        "lam": params.economic.lam,
        "eta": params.economic.eta,
        "t0": params.learning.tspan[0],
        "t1": params.learning.tspan[1],
        "x0": params.learning.x0,
        "eta_bar": params.economic.eta_bar,
        "insurance_cap": params.economic.insurance_cap,
        "suspension_t": params.economic.suspension_t,
        "lolr_rate": params.economic.lolr_rate,
    }


def pytree_to_params(tree: dict) -> ModelParams:
    """Rebuild a `ModelParams` from `params_to_pytree`'s dict (or the
    reference's), exactly: eta and tspan come from the tree verbatim, so
    ``pytree_to_params(params_to_pytree(p)) == p``. Leaves may be numpy
    or 0-d tensor scalars; they are stored as Python floats."""
    unknown = set(tree) - set(PARAMS_LEAF_NAMES)
    _check(not unknown, f"Unknown params leaves: {sorted(unknown)}")
    missing = set(PARAMS_LEAF_NAMES) - set(tree)
    _check(not missing, f"Missing params leaves: {sorted(missing)}")
    v = {k: float(tree[k]) for k in PARAMS_LEAF_NAMES}
    return ModelParams(
        learning=LearningParams(beta=v["beta"], tspan=(v["t0"], v["t1"]), x0=v["x0"]),
        economic=EconomicParams(
            u=v["u"], p=v["p"], kappa=v["kappa"], lam=v["lam"],
            eta_bar=v["eta_bar"], eta=v["eta"],
            insurance_cap=v["insurance_cap"],
            suspension_t=v["suspension_t"],
            lolr_rate=v["lolr_rate"],
        ),
    )


# ---------------------------------------------------------------------------
# Heterogeneity family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LearningParamsHetero:
    """K-group learning inputs. ``betas`` and ``dist`` are tuples, so the
    struct stays hashable; the solvers turn them into tensors."""

    betas: Tuple[float, ...]
    dist: Tuple[float, ...]
    tspan: Tuple[float, float]
    x0: float

    def __post_init__(self):
        _check(len(self.betas) > 0, "betas must be non-empty")
        _check(all(b > 0 for b in self.betas), f"All learning rates must be positive, got {self.betas}")
        _check(
            len(self.dist) == len(self.betas),
            f"Distribution length {len(self.dist)} must match betas length {len(self.betas)}",
        )
        _check(all(d >= 0 for d in self.dist), f"Distribution weights must be non-negative, got {self.dist}")
        _check(
            abs(sum(self.dist) - 1.0) < 1e-10,
            f"Distribution must sum to 1, got sum = {sum(self.dist)}",
        )
        _check(self.tspan[0] >= 0 and self.tspan[1] > self.tspan[0], f"Bad tspan {self.tspan}")
        _check(self.x0 >= 0, f"Initial condition x0 must be non-negative, got {self.x0}")

    @property
    def n_groups(self) -> int:
        return len(self.betas)


@dataclasses.dataclass(frozen=True)
class ModelParamsHetero:
    learning: LearningParamsHetero
    economic: EconomicParams


def make_hetero_params(
    betas,
    dist,
    eta_bar: float = 15.0,
    u: float = 0.1,
    p: float = 0.5,
    kappa: float = 0.6,
    lam: float = 0.01,
    tspan: Optional[Tuple[float, float]] = None,
    x0: float = 0.0001,
) -> ModelParamsHetero:
    """Keyword constructor: η = η̄/⟨β⟩ with ⟨β⟩ the dist-weighted mean."""
    betas = tuple(float(b) for b in betas)
    dist = tuple(float(d) for d in dist)
    beta_ave = float(np.dot(betas, dist))
    eta = eta_bar / beta_ave
    if tspan is None:
        tspan = (0.0, 2.0 * eta)
    return ModelParamsHetero(
        learning=LearningParamsHetero(betas=betas, dist=dist, tspan=tspan, x0=x0),
        economic=EconomicParams(u=u, p=p, kappa=kappa, lam=lam, eta_bar=eta_bar, eta=eta),
    )


# ---------------------------------------------------------------------------
# Interest-rate family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EconomicParamsInterest(EconomicParams):
    """Baseline economics plus the interest rate r and the maturity δ, with
    r < δ."""

    r: float = 0.0
    delta: float = 0.1

    def __post_init__(self):
        super().__post_init__()
        _check(self.r >= 0, f"Interest rate r must be non-negative, got {self.r}")
        _check(self.delta > 0, f"Recovery rate delta must be positive, got {self.delta}")
        _check(
            self.r < self.delta,
            f"Interest rate r must be less than recovery rate delta, got r={self.r}, delta={self.delta}",
        )


@dataclasses.dataclass(frozen=True)
class ModelParamsInterest:
    learning: LearningParams
    economic: EconomicParamsInterest


def make_interest_params(
    beta: float = 1.0,
    eta: Optional[float] = None,
    eta_bar: float = 15.0,
    u: float = 0.1,
    p: float = 0.5,
    kappa: float = 0.6,
    lam: float = 0.01,
    r: float = 0.0,
    delta: float = 0.1,
    tspan: Optional[Tuple[float, float]] = None,
    x0: float = 0.0001,
    insurance_cap: float = 0.0,
    suspension_t: float = 0.0,
    lolr_rate: float = 0.0,
) -> ModelParamsInterest:
    """Keyword constructor with the baseline's defaults and derivations."""
    if eta is None:
        eta = eta_bar / beta
    if tspan is None:
        tspan = (0.0, 2.0 * eta)
    return ModelParamsInterest(
        learning=LearningParams(beta=beta, tspan=tspan, x0=x0),
        economic=EconomicParamsInterest(
            u=u, p=p, kappa=kappa, lam=lam, eta_bar=eta_bar, eta=eta, r=r, delta=delta,
            insurance_cap=insurance_cap, suspension_t=suspension_t,
            lolr_rate=lolr_rate,
        ),
    )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static numerics knobs.

    - n_grid: points on the [0, tspan_end] learning grid and the [0, η]
      hazard grid.
    - bisect_iters: fixed bisection halvings; under ``numerics="adaptive"``
      the Chandrupatla budget.
    - ode_substeps: RK4 substeps per save interval (ODE-backed stages).
    - quad_order: Gauss-Legendre nodes per interval.
    - refine_crossings: refine buffer-time crossings by bisection on the
      continuous exact hazard (closed-form Stage 1 only). On for scalar
      solves; the sweep entry points default it off.
    - grid_warp: share of hazard-grid points placed through the logistic
      inverse-CDF map, which resolves the 1/β-wide transition at large β
      (closed-form Stage 1 only; 0 disables).
    - numerics: ``"adaptive"`` runs the convergence-masked kernels
      (`core.rootfind.chandrupatla`, `threshold_crossings_masked`, and
      `core.ode.bs32` for the hetero coupled-K ODE and the interest HJB);
      ``"fixed"`` runs fixed-iteration bisection, the scan crossings and
      fixed-substep RK4.
      ``"auto"`` resolves at construction from ``SBR_NUMERICS``
      (``adaptive`` when unset), so the stored value is always concrete.
    - ode_rtol / ode_atol: tolerances of the adaptive ODE pair.
    """

    n_grid: int = 4096
    bisect_iters: int = 90
    ode_substeps: int = 2
    quad_order: int = 8
    refine_crossings: bool = True
    grid_warp: float = 0.5
    numerics: str = "auto"
    ode_rtol: float = 1e-6
    ode_atol: float = 1e-9

    def __post_init__(self):
        _check(self.n_grid >= 16, "n_grid too small")
        _check(self.bisect_iters >= 1, "bisect_iters must be >= 1")
        _check(self.ode_substeps >= 1, "ode_substeps must be >= 1")
        _check(self.quad_order >= 1, "quad_order must be >= 1")
        _check(0.0 <= self.grid_warp <= 1.0, "grid_warp must be in [0, 1]")
        if self.numerics == "auto":
            resolved = os.environ.get("SBR_NUMERICS", "").strip().lower() or "adaptive"
            object.__setattr__(self, "numerics", resolved)
        _check(
            self.numerics in ("adaptive", "fixed"),
            f"numerics must be 'adaptive', 'fixed', or 'auto', got {self.numerics!r}",
        )
        _check(self.ode_rtol > 0, "ode_rtol must be positive")
        _check(self.ode_atol > 0, "ode_atol must be positive")

    @property
    def adaptive(self) -> bool:
        """Whether the convergence-masked adaptive kernels are active."""
        return self.numerics == "adaptive"
