"""Fused infection step: counter-Threefry draw → hazard → state update.

Every simulation engine in ``social.agents`` ends its step with the same
per-agent chain::

    frac   = counts / indeg
    p_inf  = 1 - exp(-β · frac · dt)
    draws  = threefry(key_step, agent_id)        ← N uniforms
    newly  = ~informed & (draws < p_inf)
    informed' = informed | newly
    t_inf'    = where(newly, t_next, t_inf)

The caller passes ``t_next``, the informed time of the step's newly
informed agents. The simulation passes the next grid time
dtype(k+1)·dtype(dt): the JAX package writes ``t + dt`` with t = k·dt,
and XLA on the CPU contracts that multiply-add into one fused
multiply-add, whose single rounding of (k+1)·dt is exactly that product.

Two lowerings compute it:

- the CUDA kernel ``csrc/infection_update.cu`` (one pass over the agents,
  no materialised draw or mask), for tensors on the card;
- ``_update_plain``, the same arithmetic in PyTorch ops, for tensors on
  the CPU and for holding the kernel to account on the card.

``AgentSimConfig.fused`` keeps the JAX package's names so configs carry
across: "auto" (or ``SBR_FUSED``) takes the kernel for CUDA tensors and the
plain version for CPU tensors; "pallas" names the kernel and raises on CPU
tensors; "lax", "unfused" and "interpret" name the plain version. Nothing
falls back from the kernel to the plain version: a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import os

import torch

from sbr_tpu_torch import _build
from sbr_tpu_torch.social.rng import _MASK32, _threefry2x32, _uniform_from_bits, fold_in

MODES = ("auto", "unfused", "lax", "pallas", "interpret")

KERNEL = "infection_update"

_KERNEL_FN = {torch.float32: "sbr_infection_update_f32", torch.float64: "sbr_infection_update_f64"}


def resolve_mode(mode: str, device: torch.device, rng_stream: str) -> str:
    """Concrete lowering, "kernel" or "plain", for a requested
    ``AgentSimConfig.fused`` value on tensors on ``device``."""
    if mode not in MODES:
        raise ValueError(f"fused must be one of {MODES}, got {mode!r}")
    if rng_stream != "counter":
        raise NotImplementedError(
            f"rng_stream={rng_stream!r} is not ported; only the 'counter' stream is"
        )
    if mode == "auto":
        env = os.environ.get("SBR_FUSED", "").strip().lower()
        if env and env not in MODES:
            # a typo'd override must not fall through to the default — the
            # user believes they pinned a lowering
            raise ValueError(f"SBR_FUSED must be one of {MODES}, got {env!r}")
        mode = env or "auto"
    on_cuda = torch.device(device).type == "cuda"
    if mode == "auto":
        return "kernel" if on_cuda else "plain"
    if mode == "pallas":
        if not on_cuda:
            raise ValueError("fused='pallas' runs the CUDA kernel: it needs CUDA tensors")
        return "kernel"
    return "plain"


def _update_plain(informed, t_inf, counts, betas, safe_deg, id0: int, k0: int,
                  k1: int, t_next: float, dt: float):
    """The infection update in PyTorch ops: the kernel's plain version, and
    the arithmetic of ``sbr_tpu.social.fused._update_lax`` in its order.

    ``id0`` is the global id of the first agent, (k0, k1) the step key's
    words, ``t_next`` the time written for a newly informed agent (exactly
    representable in the sim dtype). Returns (informed', t_inf')."""
    dtype = betas.dtype
    ids = (torch.arange(informed.shape[0], dtype=torch.int64, device=informed.device)
           + id0) & _MASK32
    x0, x1 = _threefry2x32(k0, k1, ids, torch.zeros_like(ids))
    draws = _uniform_from_bits(x0, x1, dtype)
    frac = counts.to(dtype) / safe_deg
    p_inf = 1.0 - torch.exp((-betas) * frac * dt)
    newly = ~informed & (draws < p_inf)
    return informed | newly, torch.where(newly, t_next, t_inf)


def _check_kernel_args(informed, t_inf, counts, betas, safe_deg):
    dtype = betas.dtype
    if dtype not in _KERNEL_FN:
        raise NotImplementedError(
            f"the CUDA infection kernel takes float32 or float64, not {dtype}"
        )
    n = informed.shape[0]
    for name, x, want in (
        ("informed", informed, torch.bool), ("t_inf", t_inf, dtype),
        ("counts", counts, torch.int32), ("betas", betas, dtype),
        ("safe_deg", safe_deg, dtype),
    ):
        if x.device.type != "cuda" or x.device != informed.device:
            raise ValueError(f"{name} must lie on the same CUDA device as informed")
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"{name} must have shape ({n},), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _update_cuda(informed, t_inf, counts, betas, safe_deg, id0: int, k0: int,
                 k1: int, t_next: float, dt: float):
    """Launch the CUDA kernel on the current stream. Same contract as
    ``_update_plain``; counts one launch in ``_build.LAUNCHES``."""
    _check_kernel_args(informed, t_inf, counts, betas, safe_deg)
    fn = getattr(_build.load(KERNEL), _KERNEL_FN[betas.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    informed2 = torch.empty_like(informed)
    t_inf2 = torch.empty_like(t_inf)
    rc = fn(
        informed.data_ptr(), t_inf.data_ptr(), counts.data_ptr(), betas.data_ptr(),
        safe_deg.data_ptr(), informed2.data_ptr(), t_inf2.data_ptr(),
        informed.shape[0], id0 & _MASK32, k0, k1, float(t_next), float(dt),
        torch.cuda.current_stream(informed.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"infection_update kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES[KERNEL] += 1
    return informed2, t_inf2


def infection_update(informed, t_inf, counts, betas, safe_deg, key, step_k: int,
                     id0: int, t_next: float, dt: float, rng_stream: str, mode: str):
    """One fused infection step for every engine's per-agent tail.

    ``key`` is a ``rng.prng_key`` pair and ``step_k`` the global step; the
    draw is keyed by global agent id ``id0 + i``, so every engine gives the
    same bits. A newly informed agent gets ``t_next`` as its informed time.
    Returns (informed', t_inf')."""
    lowering = resolve_mode(mode, informed.device, rng_stream)
    k0, k1 = fold_in(key, step_k)
    update = _update_cuda if lowering == "kernel" else _update_plain
    return update(informed, t_inf, counts, betas, safe_deg, id0, k0, k1, t_next, dt)
