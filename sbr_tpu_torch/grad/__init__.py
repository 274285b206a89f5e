"""Differentiable equilibria, PyTorch port (``sbr_tpu.grad``):
implicit-function-theorem gradients through the Stage 2-3 solve,
calibration to observed withdrawal curves, and gradient-based worst-case
stress search.

- `ift`: `implicit_root`, a ``torch.autograd.Function`` (one
  linearization at the root; no autograd through the solver's iterations);
- `cell`: the differentiable baseline and interest cells (ξ bit for bit
  the forward solve's);
- `api`: `xi_and_grad`, `interest_xi_and_grad`, `sensitivity_surface`,
  `scenario_xi_and_grad`, the grad-trust flags;
- `calibrate`: `fit_withdrawals` and the `synth_withdrawals` fixture;
- `stress`: `run_margin`, `stress_search`;
- `parity`: the IFT-against-finite-difference battery
  (``python -m sbr_tpu_torch.grad.parity``).

The hetero stack is not differentiable here, as in the reference.
"""

from sbr_tpu_torch.grad.api import (
    GRAD_UNTRUSTED_MASK,
    GradResult,
    SensitivitySurface,
    cell_value_and_grads,
    flag_census,
    interest_xi_and_grad,
    scenario_xi_and_grad,
    sensitivity_surface,
    xi_and_grad,
    xi_value,
)
from sbr_tpu_torch.grad.calibrate import CalibResult, fit_withdrawals, synth_withdrawals
from sbr_tpu_torch.grad.ift import implicit_root
from sbr_tpu_torch.grad.stress import StressResult, run_margin, stress_search

__all__ = [
    "CalibResult",
    "GRAD_UNTRUSTED_MASK",
    "GradResult",
    "SensitivitySurface",
    "StressResult",
    "cell_value_and_grads",
    "fit_withdrawals",
    "flag_census",
    "implicit_root",
    "interest_xi_and_grad",
    "run_margin",
    "scenario_xi_and_grad",
    "sensitivity_surface",
    "stress_search",
    "synth_withdrawals",
    "xi_and_grad",
    "xi_value",
]
