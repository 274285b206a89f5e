"""The public gradient API: the port of ``sbr_tpu.grad.api``.

Entry points over `grad.cell`'s differentiable solve, each on ``device``
(the CUDA card unless the caller names one) in ``dtype`` (float64 unless
named):

- `xi_and_grad(params)`: one equilibrium and dξ/dθ for the requested
  parameters, as a `GradResult` with grad-trust flags;
- `interest_xi_and_grad(params)`: the same for the interest-rate stack (θ
  also spans r and δ; the HJB differentiates through the fixed RK4);
- `sensitivity_surface(beta_values, u_values, base)`: the Figure-5 grid
  with ∂ξ/∂θ surfaces beside ξ. The reference vmaps value-and-grad twice;
  here the differentiated entries are given the cell shape (B, U), so one
  batched forward and one backward give every cell its own partials
  (cells are independent, so the gradient of their sum is each cell's);
- `scenario_xi_and_grad(spec, params)`: baseline- and interest-reducible
  scenario specs; every other composition raises.

Flags (bits of `diag.health`): ``GRAD_AT_NONEQUILIBRIUM`` (the root
candidate is not a RUN equilibrium), ``GRAD_ILL_CONDITIONED`` (|AW'(ξ)| ≤
`grad.cell.aprime_tol`) and ``GRAD_NONFINITE`` (a gradient is NaN or
Inf); `GRAD_UNTRUSTED_MASK` collects the three, and `flag_census` counts
them on the host.

Not ported: the reference's obs spans and ``grad`` flag-census events
(ROADMAP item 9, ``obs/``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sbr_tpu_torch.diag.health import (
    GRAD_AT_NONEQUILIBRIUM,
    GRAD_ILL_CONDITIONED,
    GRAD_NONFINITE,
    flag_bit,
)
from sbr_tpu_torch.grad.cell import (
    BASE_KEYS,
    INTEREST_KEYS,
    aprime_tol,
    baseline_cell,
    interest_cell,
)
from sbr_tpu_torch.models.params import ModelParams, SolverConfig, params_to_pytree
from sbr_tpu_torch.social.agents import default_device

GRAD_UNTRUSTED_MASK = GRAD_AT_NONEQUILIBRIUM | GRAD_ILL_CONDITIONED | GRAD_NONFINITE

WRT_DEFAULT = ("beta", "u", "kappa")


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class GradResult:
    """One differentiated equilibrium (or a batch of them). ``grads`` maps
    a parameter name to dξ/dθ of the root candidate, which is defined
    across run boundaries where the NaN-masked ξ is not; trust them per
    ``flags``."""

    xi: torch.Tensor  # NaN-masked, the forward solve's
    xi_candidate: torch.Tensor  # the unmasked differentiated root
    grads: dict  # name -> dξ/dθ
    aw_prime: torch.Tensor  # AW'(ξ), the IFT denominator
    status: torch.Tensor  # int32 Status code
    flags: torch.Tensor  # int32 GRAD_* bitmask

    @property
    def trusted(self) -> torch.Tensor:
        return (self.flags & GRAD_UNTRUSTED_MASK) == 0


@dataclasses.dataclass(frozen=True, eq=False)
class SensitivitySurface:
    """(B, U) sensitivity grids beside the ξ grid (Figure-5 shaped)."""

    beta_values: torch.Tensor
    u_values: torch.Tensor
    xi: torch.Tensor  # (B, U), NaN-masked
    grads: dict  # name -> (B, U) dξ/dθ
    aw_prime: torch.Tensor  # (B, U)
    status: torch.Tensor  # (B, U) int32
    flags: torch.Tensor  # (B, U) int32 GRAD_* bitmask


def _resolve(config: Optional[SolverConfig], dtype, device=None):
    """The defaults of every entry point: the sweep numerics (refinement
    off), float64, the CUDA card."""
    if config is None:
        config = SolverConfig(refine_crossings=False)
    dtype = torch.float64 if dtype is None else dtype
    device = torch.device(device) if device is not None else default_device()
    return config, dtype, device


def _validate_wrt(wrt, keys) -> Tuple[str, ...]:
    wrt = tuple(wrt)
    unknown = set(wrt) - set(keys)
    if not wrt or unknown:
        raise ValueError(f"wrt must be a non-empty subset of {keys}, got {wrt!r}")
    return wrt


def _with_nonfinite_flag(flags, grads: dict):
    bad = torch.zeros(flags.shape, dtype=torch.bool, device=flags.device)
    for g in grads.values():
        bad = bad | ~torch.isfinite(g)
    return flags | flag_bit(bad, GRAD_NONFINITE)


def _cell_outputs(cell, theta: dict, wrt, config, dtype, tol_ap=None):
    """ξ and its gradients in the ``wrt`` entries of one batch of cells:
    (xi, xi_candidate, grads, aw_prime, status, flags). Each ``wrt`` entry
    becomes a leaf of the cell shape, so every cell gets its own partials;
    the other entries keep their shapes (a row shared by many cells builds
    its tables once)."""
    shape = torch.broadcast_shapes(*(torch.as_tensor(v).shape for v in theta.values()))
    with torch.enable_grad():
        leaves = {
            k: torch.as_tensor(theta[k], dtype=dtype).detach().expand(shape).clone()
            .requires_grad_(True)
            for k in wrt
        }
        out = cell({**theta, **leaves}, config, dtype, aprime_tol_=tol_ap)
        xi_c = out["xi_candidate"]
        raw = torch.autograd.grad(xi_c.sum(), [leaves[k] for k in wrt], allow_unused=True)
    grads = {
        k: (g if g is not None else torch.zeros_like(leaves[k])).detach()
        for k, g in zip(wrt, raw)
    }
    flags = _with_nonfinite_flag(out["flags"], grads)
    return (out["xi"].detach(), xi_c.detach(), grads, out["aw_prime"], out["status"], flags)


def cell_value_and_grads(theta: dict, wrt, config: SolverConfig, dtype=torch.float64,
                         interest: bool = False, aprime_tol_=None):
    """The baseline (or interest) cell's value and gradients from a θ dict
    of tensors on one device (see `_cell_outputs` for the return shape);
    the building block of the served grads program. ``aprime_tol_`` is
    resolved by the caller when it keys a cache on it."""
    cell = interest_cell if interest else baseline_cell
    keys = INTEREST_KEYS if interest else BASE_KEYS
    return _cell_outputs(cell, {k: theta[k] for k in keys}, tuple(wrt), config, dtype,
                         tol_ap=aprime_tol_)


def _theta_values(params, keys, dtype, device) -> dict:
    tree = params_to_pytree(
        params if isinstance(params, ModelParams)
        else ModelParams(params.learning, params.economic)
    )
    if "r" in keys:
        tree["r"] = params.economic.r
        tree["delta"] = params.economic.delta
    return {k: torch.full((), float(tree[k]), dtype=dtype, device=device) for k in keys}


def flag_census(status, flags) -> dict:
    """JSON-ready counts of the grad-trust bits over a (batched) result.
    ``nonfinite_run`` is the gate signal: a NaN or Inf gradient at a RUN
    equilibrium is a defect, while on non-equilibrium cells it is the
    expected face of a degenerate bracket (already flagged untrusted)."""
    flags = np.atleast_1d(_host(flags).astype(np.int64)).ravel()
    status = np.atleast_1d(_host(status)).ravel()
    nonfinite = (flags & GRAD_NONFINITE) != 0
    return {
        "cells": int(flags.size),
        "run_cells": int((status == 0).sum()),
        "at_nonequilibrium": int(((flags & GRAD_AT_NONEQUILIBRIUM) != 0).sum()),
        "ill_conditioned": int(((flags & GRAD_ILL_CONDITIONED) != 0).sum()),
        "nonfinite": int(nonfinite.sum()),
        "nonfinite_run": int((nonfinite & (status == 0)).sum()),
        "untrusted": int(((flags & GRAD_UNTRUSTED_MASK) != 0).sum()),
    }


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scenario_xi_and_grad(spec, params, wrt=None, config: Optional[SolverConfig] = None,
                         dtype=None, device=None) -> GradResult:
    """ξ and dξ/dθ for a composed scenario: baseline- and interest-
    reducible `scenario.ScenarioSpec`s route to `xi_and_grad` /
    `interest_xi_and_grad` (so ξ stays the composed solve's, which
    dispatches to the same cells); every other composition (hetero or
    social learning, policy modifiers, several banks) raises
    `NotImplementedError` rather than answer with the gradient of another
    solve."""
    red = spec.grad_reduction()
    if red == "baseline":
        return xi_and_grad(params, wrt=wrt or WRT_DEFAULT, config=config, dtype=dtype,
                           device=device)
    if red == "interest":
        return interest_xi_and_grad(params, wrt=wrt or ("beta", "u", "kappa", "r"),
                                    config=config, dtype=dtype, device=device)
    raise NotImplementedError(
        f"gradient coverage: spec (learning={spec.learning!r}, "
        f"modifiers={spec.modifiers}, banks={spec.banks}) does not reduce to a "
        "grad-covered stack; only baseline- and interest-reducible compositions "
        "keep IFT gradients"
    )


def _point(cell, keys, params, wrt, config, dtype, device) -> GradResult:
    config, dtype, device = _resolve(config, dtype, device)
    wrt = _validate_wrt(wrt, keys)
    theta = _theta_values(params, keys, dtype, device)
    xi, xi_c, grads, aw_prime, status, flags = _cell_outputs(
        cell, theta, wrt, config, dtype, tol_ap=aprime_tol(dtype)
    )
    return GradResult(xi=xi, xi_candidate=xi_c, grads=grads, aw_prime=aw_prime,
                      status=status, flags=flags)


def xi_and_grad(params: ModelParams, wrt=WRT_DEFAULT, config: Optional[SolverConfig] = None,
                dtype=None, device=None) -> GradResult:
    """ξ and dξ/dθ at one parameter point (the baseline stack). ``wrt`` is
    a subset of `grad.cell.BASE_KEYS`. ξ is `solve_param_cell`'s bit for
    bit; each gradient costs one linearization of the residual at the
    root (grad/ift.py), not a re-run of the solver."""
    return _point(baseline_cell, BASE_KEYS, params, wrt, config, dtype, device)


def interest_xi_and_grad(params, wrt=("beta", "u", "kappa", "r"),
                         config: Optional[SolverConfig] = None, dtype=None,
                         device=None) -> GradResult:
    """ξ and dξ/dθ for the interest-rate stack (`ModelParamsInterest`); θ
    also spans ``r`` and ``delta`` (grad/cell.py)."""
    return _point(interest_cell, INTEREST_KEYS, params, wrt, config, dtype, device)


def sensitivity_surface(beta_values, u_values, base: ModelParams, wrt=WRT_DEFAULT,
                        config: Optional[SolverConfig] = None, dtype=None,
                        device=None) -> SensitivitySurface:
    """∂ξ/∂θ surfaces over the Figure-5 β×u grid. As in `beta_u_grid`, η
    and the tspan stay pinned at the base model's resolved values for
    every β, and the ξ grid is `beta_u_grid`'s bit for bit (tested). Each
    surface replaces a whole perturbed re-sweep of the grid."""
    config, dtype, device = _resolve(config, dtype, device)
    wrt = _validate_wrt(wrt, BASE_KEYS)
    beta_values = torch.as_tensor(beta_values, dtype=dtype, device=device)
    u_values = torch.as_tensor(u_values, dtype=dtype, device=device)
    econ, (t0, t1) = base.economic, base.learning.tspan
    theta = {
        k: torch.full((), float(v), dtype=dtype, device=device)
        for k, v in (("p", econ.p), ("kappa", econ.kappa), ("lam", econ.lam),
                     ("eta", econ.eta), ("t0", t0), ("t1", t1), ("x0", base.learning.x0))
    }
    theta.update(beta=beta_values.unsqueeze(-1), u=u_values)
    xi, _, grads, aw_prime, status, flags = _cell_outputs(
        baseline_cell, theta, wrt, config, dtype, tol_ap=aprime_tol(dtype)
    )
    return SensitivitySurface(
        beta_values=beta_values, u_values=u_values, xi=xi, grads=grads,
        aw_prime=aw_prime, status=status, flags=flags,
    )


def xi_value(params: ModelParams, config: Optional[SolverConfig] = None, dtype=None,
             device=None) -> torch.Tensor:
    """The gradient path's forward value alone, ``xi_candidate`` at
    ``params``, with no gradient computed: the finite-difference probe of
    `grad.parity`."""
    config, dtype, device = _resolve(config, dtype, device)
    with torch.no_grad():
        return baseline_cell(_theta_values(params, BASE_KEYS, dtype, device), config,
                             dtype)["xi_candidate"]
