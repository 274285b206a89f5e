"""Numerics substrate of the port (``sbr_tpu.core``): grids and
interpolation, quadrature, crossings and bracketing root-finds, and the
fixed-step and adaptive ODE integrators, all batched over cells (`interp`
states the shapes)."""

from sbr_tpu_torch.core.integrate import cumtrapz, cumulative_gauss_legendre, trapz
from sbr_tpu_torch.core.interp import interp, interp_guided, interp_shared, interp_uniform, linspace
from sbr_tpu_torch.core.ode import bs32, rk4
from sbr_tpu_torch.core.rootfind import (
    bisect,
    chandrupatla,
    first_upcrossing,
    last_downcrossing,
    threshold_crossings_masked,
)

__all__ = [
    "bisect",
    "bs32",
    "chandrupatla",
    "cumtrapz",
    "cumulative_gauss_legendre",
    "first_upcrossing",
    "interp",
    "interp_guided",
    "interp_shared",
    "interp_uniform",
    "last_downcrossing",
    "linspace",
    "rk4",
    "threshold_crossings_masked",
    "trapz",
]
