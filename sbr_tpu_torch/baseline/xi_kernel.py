"""The ξ stage in one CUDA kernel (``csrc/xi_bisect.cu``): fixed-numerics
bisection of AW(ξ) = κ with closed-form Stage 1, one thread a cell.

`compute_xi` takes this route where `takes` holds: CUDA tensors of
float32 or float64, closed-form Stage 1, fixed numerics, the default
bracket and start, and no input that requires grad. It then returns what
the eager route returns, bit for bit (the same IEEE operations in the same
order; ``tests/test_torch_cuda.py``). Every other call, the CPU's among
them, stays on the eager route, which is also the kernel's plain version.

Inputs are taken by their strides against the output shape (a β column
against the cells, one x0 and κ on the device), so nothing is copied and
nothing is read on the host. Each launch adds one to
``_build.LAUNCHES["xi_bisect"]``.
"""

from __future__ import annotations

import ctypes

import torch

from sbr_tpu_torch import _build
from sbr_tpu_torch.diag.health import (
    NAN_INPUT,
    NAN_OUTPUT,
    NO_BRACKET,
    NONFINITE_RESIDUAL,
    Health,
)

KERNEL = "xi_bisect"

_FN = {torch.float32: "sbr_xi_bisect_f32", torch.float64: "sbr_xi_bisect_f64"}
# the five inputs, the layout, the cells, the steps, the tolerance, the flag
# bits, the eight outputs and the stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int, ctypes.c_double,
    ctypes.POINTER(ctypes.c_int32),
] + [ctypes.c_void_p] * 9

# dims of the output shape the kernel indexes (``kDims`` in the source)
MAX_DIMS = 4

_INPUTS = ("tau_in", "tau_out", "beta", "x0", "kappa")


def takes(tau_in, tau_out, ls, kappa, config) -> bool:
    """Whether the kernel computes `compute_xi` for these inputs (with the
    default bracket and start, which the caller checks)."""
    if not ls.closed_form or config.adaptive:
        return False
    ts = (tau_in, tau_out, ls.beta, ls.x0, kappa)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        return False
    first = tau_in
    if first.device.type != "cuda" or first.dtype not in _FN:
        return False
    if any(t.device != first.device or t.dtype != first.dtype or t.requires_grad for t in ts):
        return False
    try:
        shape = torch.broadcast_shapes(*(t.shape for t in ts))
    except RuntimeError:  # the eager route raises its own error
        return False
    return len(shape) <= MAX_DIMS and shape.numel() > 0


def layout(shape, tensors) -> list:
    """The kernel's ``layout`` argument: ``shape`` padded in front with 1
    to MAX_DIMS dims, then each tensor's strides, in elements, as a view
    expanded to ``shape`` (0 where it broadcasts)."""
    pad = MAX_DIMS - len(shape)
    out = [1] * pad + list(shape)
    for t in tensors:
        out += [0] * pad + list(t.expand(shape).stride())
    return out


def xi_bisect(tau_in, tau_out, beta, x0, kappa, iters: int, tol: float):
    """Launch the kernel on the current stream: ``iters`` bisection steps
    of every cell of the broadcast shape of the five inputs, accepted
    within ``tol``. Returns (xi, err, root_ok, is_increasing, Health), as
    `compute_xi(..., with_health=True)`; refuses what the kernel does not
    take."""
    ts = (tau_in, tau_out, beta, x0, kappa)
    dtype = tau_in.dtype
    if dtype not in _FN:
        raise NotImplementedError(f"the CUDA xi kernel takes float32 or float64, not {dtype}")
    for name, t in zip(_INPUTS, ts):
        if t.device.type != "cuda" or t.device != tau_in.device:
            raise ValueError(f"{name} must lie on the same CUDA device as tau_in")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    if len(shape) > MAX_DIMS:
        raise ValueError(f"the cells may have at most {MAX_DIMS} dims, got {tuple(shape)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    lay = layout(shape, ts)
    bits = (ctypes.c_int32 * 4)(NO_BRACKET, NONFINITE_RESIDUAL, NAN_INPUT, NAN_OUTPUT)
    dev = tau_in.device
    xi, err, residual, width = (torch.empty(shape, dtype=dtype, device=dev) for _ in range(4))
    root_ok, increasing = (torch.empty(shape, dtype=torch.bool, device=dev) for _ in range(2))
    iterations, flags = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(2))
    rc = _build.entry(KERNEL, _FN[dtype], _ARGTYPES)(
        *(t.data_ptr() for t in ts), (ctypes.c_int64 * len(lay))(*lay), shape.numel(),
        int(iters), float(tol), bits,
        *(t.data_ptr() for t in (xi, err, root_ok, increasing, residual, width, iterations,
                                 flags)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"xi_bisect kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES[KERNEL] += 1
    health = Health(residual=residual, bracket_width=width, iterations=iterations, flags=flags)
    return xi, err, root_ok, increasing, health
