"""The `Health` record: numerical-health diagnostics that ride next to a
result, the port of ``sbr_tpu.diag.health``.

A `Health` holds four tensors of one shape, one entry per solve (0-d for a
scalar solve, the cell grid's shape for a sweep):

- ``residual``       final |f(x*)| of the defining equation; NaN where not
                     applicable;
- ``bracket_width``  final bisection bracket width; NaN where not
                     applicable;
- ``iterations``     int32 iterations actually executed, summed by `merge`;
- ``flags``          int32 bitmask of the bits below.

Status codes classify economic outcomes; the flags classify numerical
trust. Only the `DIVERGENT_MASK` bits mean "do not trust this cell". The
bit values are the reference's, so masks compare across packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FALLBACK_IN_KNOT = 1 << 0  # no up-crossing; fell back to first above-level knot
FALLBACK_IN_DEFAULT = 1 << 1  # nothing above the level; returned `default`
FALLBACK_OUT_KNOT = 1 << 2  # no down-crossing; fell back to last above-level knot
FALLBACK_OUT_DEFAULT = 1 << 3  # nothing above the level; returned `default`
NO_BRACKET = 1 << 4  # bisection endpoints do not bracket a sign change
NONFINITE_RESIDUAL = 1 << 5  # final residual is NaN/Inf
NAN_INPUT = 1 << 6  # NaN among the primitive's inputs (curve, level, bracket)
NAN_OUTPUT = 1 << 7  # non-finite values in a computed result (iterate, curve)
FP_NOT_CONVERGED = 1 << 8  # fixed point hit max_iter without converging
FP_ABORTED = 1 << 9  # fixed point's ξ search exceeded η and gave up
ODE_BUDGET = 1 << 10  # adaptive ODE interval exhausted its step budget
GRAD_AT_NONEQUILIBRIUM = 1 << 11  # root candidate is not a RUN equilibrium
GRAD_ILL_CONDITIONED = 1 << 12  # |AW'(ξ)| near zero
GRAD_NONFINITE = 1 << 13  # a computed gradient came back NaN/Inf

FLAG_NAMES = {
    FALLBACK_IN_KNOT: "fallback_in_knot",
    FALLBACK_IN_DEFAULT: "fallback_in_default",
    FALLBACK_OUT_KNOT: "fallback_out_knot",
    FALLBACK_OUT_DEFAULT: "fallback_out_default",
    NO_BRACKET: "no_bracket",
    NONFINITE_RESIDUAL: "nonfinite_residual",
    NAN_INPUT: "nan_input",
    NAN_OUTPUT: "nan_output",
    FP_NOT_CONVERGED: "fp_not_converged",
    FP_ABORTED: "fp_aborted",
    ODE_BUDGET: "ode_budget",
    GRAD_AT_NONEQUILIBRIUM: "grad_at_nonequilibrium",
    GRAD_ILL_CONDITIONED: "grad_ill_conditioned",
    GRAD_NONFINITE: "grad_nonfinite",
}
ALL_FLAGS = tuple(FLAG_NAMES)

DIVERGENT_MASK = (
    NONFINITE_RESIDUAL | NAN_INPUT | NAN_OUTPUT | FP_NOT_CONVERGED | FP_ABORTED
)

_IN_FALLBACK_MASK = FALLBACK_IN_KNOT | FALLBACK_IN_DEFAULT


def flag_names(mask: int) -> list:
    """Decode a host-side int bitmask into sorted flag-name strings."""
    mask = int(mask)
    return [name for bit, name in FLAG_NAMES.items() if mask & bit]


def flag_bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    """``bit`` where ``cond`` holds, else 0, as int32."""
    return cond.to(torch.int32) * bit


@dataclasses.dataclass(frozen=True)
class Health:
    """Per-solve numerical-health tensors (see the module docstring)."""

    residual: torch.Tensor
    bracket_width: torch.Tensor
    iterations: torch.Tensor  # int32
    flags: torch.Tensor  # int32

    def __post_init__(self):
        # Health is telemetry, never part of a differentiated computation:
        # every leaf is cut from autograd at construction (identity on the
        # values), so a caller folding health.residual into a loss gets no
        # gradient through the residual's evaluation, as in the reference.
        for field in ("residual", "bracket_width", "iterations", "flags"):
            v = getattr(self, field)
            if isinstance(v, torch.Tensor) and v.requires_grad:
                object.__setattr__(self, field, v.detach())

    @classmethod
    def empty(cls, dtype=torch.float32, device="cpu") -> "Health":
        """A neutral health: nothing measured, nothing flagged."""
        nan = torch.full((), float("nan"), dtype=dtype, device=device)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return cls(residual=nan, bracket_width=nan, iterations=zero, flags=zero)

    @classmethod
    def of_flags(cls, flags: torch.Tensor, dtype=torch.float32) -> "Health":
        """Health carrying only a flag mask."""
        flags = flags.to(torch.int32)
        nan = torch.full(flags.shape, float("nan"), dtype=dtype, device=flags.device)
        return cls(
            residual=nan, bracket_width=nan,
            iterations=torch.zeros_like(flags), flags=flags,
        )

    @classmethod
    def of_nan_probe(cls, nan_in, nonfinite_out, iterations: int, dtype=torch.float32) -> "Health":
        """Health of a residual-free computation (cumulative quadrature):
        NaN inputs and non-finite outputs are its only failure modes;
        ``iterations`` records the panel count."""
        flags = flag_bit(nan_in, NAN_INPUT) | flag_bit(nonfinite_out, NAN_OUTPUT)
        h = cls.of_flags(flags, dtype if dtype.is_floating_point else torch.float32)
        return dataclasses.replace(h, iterations=torch.full_like(flags, int(iterations)))

    def merge(self, *others: "Health") -> "Health":
        """Combine healths of sequential stages: worst (NaN-ignoring max)
        residual and bracket, summed iterations, OR'd flags. Broadcasts."""
        h = self
        for o in others:
            h = Health(
                residual=torch.fmax(h.residual, o.residual),
                bracket_width=torch.fmax(h.bracket_width, o.bracket_width),
                iterations=h.iterations + o.iterations,
                flags=h.flags | o.flags,
            )
        return h

    def replace(self, **changes) -> "Health":
        return dataclasses.replace(self, **changes)


def as_out_crossing(h: Health) -> Health:
    """Re-key a crossing primitive's health as the OUT (down-)crossing:
    shift the generic fallback bits (0-1) into the OUT positions (2-3)."""
    fall = h.flags & _IN_FALLBACK_MASK
    return h.replace(flags=(h.flags & ~_IN_FALLBACK_MASK) | (fall << 2))


def or_reduce_flags(flags: torch.Tensor) -> torch.Tensor:
    """OR-reduce a flag-mask tensor to one 0-d int32 mask."""
    out = torch.zeros((), dtype=torch.int32, device=flags.device)
    for bit in ALL_FLAGS:
        out = out | flag_bit(((flags & bit) != 0).any(), bit)
    return out


def summarize(health: Health, status=None, worst_k: int = 5) -> dict:
    """Reduce a (possibly batched) Health to a JSON-ready census on the
    host, as the reference's `summarize` does: flag counts, divergent
    cells, effective-iteration statistics, the residual histogram of the
    cells whose root-find meant something (RUN cells when ``status`` is
    given), and the worst cells."""
    from sbr_tpu_torch.models.results import Status

    def host(x, dtype):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return np.atleast_1d(x.astype(dtype))

    res = host(health.residual, np.float64)
    shape = res.shape
    res = res.ravel()
    flags = host(health.flags, np.int64).ravel()
    iters = host(health.iterations, np.int64).ravel()
    status_flat = host(status, np.int64).ravel() if status is not None else None

    n = int(flags.size)
    flag_counts = {}
    for bit, name in FLAG_NAMES.items():
        c = int(((flags & bit) != 0).sum())
        if c:
            flag_counts[name] = c
    out = {
        "cells": n,
        "divergent": int(((flags & DIVERGENT_MASK) != 0).sum()),
        "flag_counts": flag_counts,
        "iterations_total": int(iters.sum()),
        "iterations_mean": round(float(iters.mean()), 2) if n else 0.0,
        "iterations_max": int(iters.max()) if n else 0,
    }

    finite = np.isfinite(res)
    if status_flat is not None:
        meaningful = finite & (status_flat == int(Status.RUN))
    else:
        degenerate = NO_BRACKET | FALLBACK_IN_DEFAULT | FALLBACK_OUT_DEFAULT
        meaningful = finite & ((flags & degenerate) == 0)
    if meaningful.any():
        r = res[meaningful]
        out["max_residual"] = float(r.max())
        exps = np.clip(np.floor(np.log10(np.clip(r, 1e-20, None))), -18.0, 2.0).astype(int)
        out["residual_hist"] = {
            f"1e{int(e):+d}": int((exps == e).sum()) for e in np.sort(np.unique(exps))
        }

    score = np.where(
        (flags & DIVERGENT_MASK) != 0, np.inf, np.where(meaningful, res, -np.inf)
    )
    worst = []
    for i in np.argsort(-score, kind="stable")[: max(worst_k, 0)]:
        i = int(i)
        if score[i] == -np.inf and flags[i] == 0:
            continue
        cell = {
            "index": [int(v) for v in np.unravel_index(i, shape)],
            "residual": float(res[i]) if meaningful[i] else None,
            "flags": flag_names(flags[i]),
        }
        if status_flat is not None:
            code = int(status_flat[i])
            cell["status"] = Status(code).name if code in Status._value2member_map_ else str(code)
        worst.append(cell)
    if worst:
        out["worst_cells"] = worst
    return out
