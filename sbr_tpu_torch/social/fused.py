"""Fused per-agent steps: the infection step and the Bayesian belief step.

**Infection step.** Every simulation engine in ``social.agents`` ends its
step with the same per-agent chain::

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

**Belief step** (``infomodels`` "bayes" channel). Per agent, with the
withdrawn-neighbour fraction w and the log-likelihood ratios (llr0, llr1)
of a calm and a withdrawn observation::

    w        = counts / deg
    belief'  = belief + dt · (w·llr1 + (1−w)·llr0)
    newly    = ~informed & (awareness · belief' >= θ)
    informed' = informed | newly
    t_inf'    = where(newly, t_next, t_inf)

XLA on the CPU, inside the jitted simulation, contracts that line into two
fused multiply-adds, ``belief' = fma(dt, fma(w, llr1, (1−w)·llr0),
belief)``, each rounded once; the port computes exactly that (see
`_belief_plain`). A belief step dispatched op by op, outside ``jit``,
rounds every operation instead and differs in the last bit.

Two lowerings compute each step:

- a CUDA kernel (``csrc/infection_update.cu``, ``csrc/belief_update.cu``:
  one pass over the agents, no materialised draw, fraction or mask; the
  infection kernel draws only for the frontier, the agents not informed
  with a nonzero count, since no other agent's state can change), for
  tensors on the card;
- a plain version (``_update_plain``, ``_belief_plain``): the same
  arithmetic in PyTorch ops, for tensors on the CPU and for holding the
  kernel to account on the card.

``AgentSimConfig.fused`` keeps the JAX package's names so configs carry
across: "auto" (or ``SBR_FUSED``) takes the kernel for CUDA tensors and the
plain version for CPU tensors; "pallas" names the kernel and raises on CPU
tensors; "lax", "unfused" and "interpret" name the plain version. Nothing
falls back from a kernel to its plain version: a build or launch failure
raises. ``rng_stream="foldin"`` runs the plain version in every mode, by
the reference's own rule: its draw (two chained Threefry blocks through
``fold_in``) has no counter form to fuse.

**Types.** Both kernels take float32, float64, float16 and bfloat16. Below
32 bits the plain version rounds as XLA on the CPU rounds the reference's
step, which the tests hold it to: every operation in float32 rounded to
the dtype (PyTorch's CPU and CUDA half operations do the same), with the
scalars (dt, the llr constants, the delays) rounded to the dtype first
(`host_round`). The belief step's two multiply-adds are the exception:
XLA contracts them into fused multiply-adds in float16 (each a float32
fma rounded to float16), and in bfloat16 it rounds each operation.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from sbr_tpu_torch import _build
from sbr_tpu_torch.social.rng import (
    _MASK32,
    _scalar_uniform,
    _threefry2x32,
    _uniform_from_bits,
    fold_in,
)

MODES = ("auto", "unfused", "lax", "pallas", "interpret")

KERNEL = "infection_update"

_KERNEL_FN = {
    torch.float32: "sbr_infection_update_f32",
    torch.float64: "sbr_infection_update_f64",
    torch.float16: "sbr_infection_update_f16",
    torch.bfloat16: "sbr_infection_update_bf16",
}


def host_round(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` on the host, as a Python float that the
    dtype holds exactly. The reference rounds its weakly typed scalars (dt,
    the delays, the llr constants) to the state's dtype before an operation
    uses them; PyTorch would carry a Python scalar into a float16 or
    bfloat16 operation unrounded, in float32."""
    if dtype == torch.float64:
        return float(x)
    if dtype == torch.float16:
        return float(np.float16(x))
    if dtype == torch.float32:
        return float(np.float32(x))
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


def resolve_mode(mode: str, device: torch.device, rng_stream: str) -> str:
    """Concrete lowering, "kernel" or "plain", for a requested
    ``AgentSimConfig.fused`` value on tensors on ``device``."""
    if mode not in MODES:
        raise ValueError(f"fused must be one of {MODES}, got {mode!r}")
    if mode == "auto":
        env = os.environ.get("SBR_FUSED", "").strip().lower()
        if env and env not in MODES:
            # a typo'd override must not fall through to the default — the
            # user believes they pinned a lowering
            raise ValueError(f"SBR_FUSED must be one of {MODES}, got {env!r}")
        mode = env or "auto"
    if rng_stream != "counter":
        # the reference's rule, not a fallback: the foldin draw is two
        # chained blocks through fold_in, with no counter form for a kernel
        # to fuse, so every mode runs it unfused
        return "plain"
    on_cuda = torch.device(device).type == "cuda"
    if mode == "auto":
        return "kernel" if on_cuda else "plain"
    if mode == "pallas":
        if not on_cuda:
            raise ValueError("fused='pallas' runs the CUDA kernel: it needs CUDA tensors")
        return "kernel"
    return "plain"


def _update_plain(informed, t_inf, counts, betas, safe_deg, id0: int, k0: int,
                  k1: int, t_next: float, dt: float, rng_stream: str = "counter"):
    """The infection update in PyTorch ops: the kernel's plain version, and
    the arithmetic of ``sbr_tpu.social.fused._update_lax`` in its order,
    each operation rounded to the dtype as XLA on the CPU rounds it.

    ``id0`` is the global id of the first agent, (k0, k1) the step key's
    words, ``t_next`` the time written for a newly informed agent (exactly
    representable in the sim dtype). Under ``rng_stream="foldin"`` the
    draws are `rng._scalar_uniform` of each agent's folded key (the
    reference's unfused path). Returns (informed', t_inf')."""
    dtype = betas.dtype
    dt = host_round(dt, dtype)
    ids = (torch.arange(informed.shape[0], dtype=torch.int64, device=informed.device)
           + id0) & _MASK32
    zero = torch.zeros_like(ids)
    if rng_stream == "foldin":
        draws = _scalar_uniform(*_threefry2x32(k0, k1, zero, ids), dtype)
    else:
        draws = _uniform_from_bits(*_threefry2x32(k0, k1, ids, zero), dtype)
    frac = counts.to(dtype) / safe_deg
    p_inf = 1.0 - torch.exp((-betas) * frac * dt)
    newly = ~informed & (draws < p_inf)
    return informed | newly, torch.where(newly, t_next, t_inf)


def _check_cuda_args(what: str, dtype: torch.dtype, args) -> None:
    """Refuse what a kernel does not take: ``args`` is (name, tensor, dtype)
    triples, the first of which fixes the device and the length."""
    if dtype not in _KERNEL_FN:
        raise NotImplementedError(
            f"the CUDA {what} kernel takes float32, float64, float16 or bfloat16, "
            f"not {dtype}"
        )
    first = args[0][1]
    n = first.shape[0]
    for name, x, want in args:
        if x.device.type != "cuda" or x.device != first.device:
            raise ValueError(f"{name} must lie on the same CUDA device as {args[0][0]}")
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
    dtype = betas.dtype
    _check_cuda_args("infection", dtype, (
        ("informed", informed, torch.bool), ("t_inf", t_inf, dtype),
        ("counts", counts, torch.int32), ("betas", betas, dtype),
        ("safe_deg", safe_deg, dtype),
    ))
    fn = _build.entry(KERNEL, _KERNEL_FN[dtype], [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ])
    dt = host_round(dt, dtype)
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
    if lowering == "kernel":
        return _update_cuda(informed, t_inf, counts, betas, safe_deg, id0, k0, k1,
                            t_next, dt)
    return _update_plain(informed, t_inf, counts, betas, safe_deg, id0, k0, k1, t_next,
                         dt, rng_stream)


# ---------------------------------------------------------------------------
# Belief step (the "bayes" channel of infomodels)
# ---------------------------------------------------------------------------

BELIEF_MODES = ("auto", "lax", "pallas", "interpret")

BELIEF_KERNEL = "belief_update"

_BELIEF_FN = {
    torch.float32: "sbr_belief_update_f32",
    torch.float64: "sbr_belief_update_f64",
    torch.float16: "sbr_belief_update_f16",
    torch.bfloat16: "sbr_belief_update_bf16",
}


def resolve_belief_mode(mode: str, device: torch.device) -> str:
    """Concrete lowering of the belief step, "kernel" or "plain", for a
    requested ``AgentSimConfig.fused`` value on tensors on ``device``. The
    step draws no random numbers, so "unfused" is the plain version and
    no RNG stream enters."""
    if mode == "unfused":
        mode = "lax"
    if mode not in BELIEF_MODES:
        raise ValueError(f"belief mode must be one of {BELIEF_MODES}, got {mode!r}")
    if mode == "auto":
        env = os.environ.get("SBR_FUSED", "").strip().lower()
        if env == "unfused":
            env = "lax"
        if env and env not in BELIEF_MODES:
            raise ValueError(
                f"SBR_FUSED must be one of {BELIEF_MODES} for the belief "
                f"kernel, got {env!r}"
            )
        mode = env or "auto"
    on_cuda = torch.device(device).type == "cuda"
    if mode == "auto":
        return "kernel" if on_cuda else "plain"
    if mode == "pallas":
        if not on_cuda:
            raise ValueError("fused='pallas' runs the CUDA kernel: it needs CUDA tensors")
        return "kernel"
    return "plain"


def _two_sum(a, b):
    """(s, err) with s = a + b rounded and s + err = a + b exactly
    (Knuth's branch-free TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, err) with p = a·b rounded and p + err = a·b exactly (Dekker's
    product with Veltkamp's split; float64, no over- or underflow)."""
    p = a * b
    c = 134217729.0 * a  # 2^27 + 1
    ah = c - (c - a)
    al = a - ah
    c = 134217729.0 * b
    bh = c - (c - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s, err):
    """s + err, rounded to odd in s's precision: s when exact, else the
    neighbour of s toward err whose last significand bit is 1."""
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def _fma(a, b, c):
    """a·b + c rounded once, as a fused multiply-add rounds it, from
    separate IEEE operations, so it gives the same bits on the CPU and on
    the card.

    float32: the product is exact in float64, the sum is rounded to odd in
    float64 and then to nearest in float32; with 53 ≥ 24 + 2 bits that is
    the single rounding (Boldo and Melquiond, IEEE TC 2008). float64: the
    same paper's emulated FMA, the exact product and sum split into words
    and the low words' sum rounded to odd before the final add."""
    if c.dtype == torch.float32:
        s, err = _two_sum(a.double() * b.double(), c.double())
        return _round_to_odd(s, err).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, ev = _two_sum(tl, ul)
    return th + _round_to_odd(v, ev)


def _belief_plain(informed, t_inf, belief, counts, awareness, safe_deg,
                  thresholds, t_next: float, dt: float, llr0: float, llr1: float):
    """The belief step in PyTorch ops: the kernel's plain version, and the
    arithmetic of ``sbr_tpu.social.fused._belief_lax`` as XLA on the CPU
    rounds it inside the jitted simulation.

    XLA contracts ``belief + dt·(w·llr1 + (1−w)·llr0)`` into two fused
    multiply-adds, ``fma(dt, fma(w, llr1, (1−w)·llr0), belief)``, and the
    expression as written matches neither (about a quarter of float32
    lanes differ in the last bit). ``_fma`` rounds each once, exactly.
    The scalars are rounded to the belief's dtype, as the reference's are.
    Returns (informed', t_inf', belief')."""
    dtype = belief.dtype
    dev = belief.device
    dt, llr0, llr1 = (host_round(v, dtype) for v in (dt, llr0, llr1))
    # filled on the device, so that a CUDA graph can capture the step
    dt_, llr0_, llr1_ = (torch.full((), v, dtype=dtype, device=dev) for v in (dt, llr0, llr1))
    w = counts.to(dtype) / safe_deg
    if dtype == torch.bfloat16:
        # bfloat16: XLA rounds every operation, contracting none
        belief2 = belief + dt_ * (w * llr1_ + (1.0 - w) * llr0_)
    elif dtype == torch.float16:
        # float16: both multiply-adds contracted, each a float32 fma rounded
        # to float16
        def fma16(a, b, c):
            return _fma(a.float(), b.float(), c.float()).to(dtype)

        belief2 = fma16(dt_, fma16(w, llr1_, (1.0 - w) * llr0_), belief)
    else:
        belief2 = _fma(dt_, _fma(w, llr1_, (1.0 - w) * llr0_), belief)
    newly = ~informed & (awareness * belief2 >= thresholds)
    return informed | newly, torch.where(newly, t_next, t_inf), belief2


def _belief_cuda(informed, t_inf, belief, counts, awareness, safe_deg,
                 thresholds, t_next: float, dt: float, llr0: float, llr1: float):
    """Launch the CUDA belief kernel on the current stream. Same contract
    as ``_belief_plain``; counts one launch in ``_build.LAUNCHES``."""
    dtype = belief.dtype
    _check_cuda_args("belief", dtype, (
        ("informed", informed, torch.bool), ("t_inf", t_inf, dtype),
        ("belief", belief, dtype), ("counts", counts, torch.int32),
        ("awareness", awareness, dtype), ("safe_deg", safe_deg, dtype),
        ("thresholds", thresholds, dtype),
    ))
    fn = _build.entry(BELIEF_KERNEL, _BELIEF_FN[dtype], [ctypes.c_void_p] * 10 + [
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p,
    ])
    dt, llr0, llr1 = (host_round(v, dtype) for v in (dt, llr0, llr1))
    informed2 = torch.empty_like(informed)
    t_inf2 = torch.empty_like(t_inf)
    belief2 = torch.empty_like(belief)
    rc = fn(
        informed.data_ptr(), t_inf.data_ptr(), belief.data_ptr(), counts.data_ptr(),
        awareness.data_ptr(), safe_deg.data_ptr(), thresholds.data_ptr(),
        informed2.data_ptr(), t_inf2.data_ptr(), belief2.data_ptr(),
        informed.shape[0], float(t_next), float(dt), float(llr0), float(llr1),
        torch.cuda.current_stream(informed.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"belief_update kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES[BELIEF_KERNEL] += 1
    return informed2, t_inf2, belief2


def belief_update(informed, t_inf, belief, counts, awareness, safe_deg,
                  thresholds, t_next: float, dt: float, llr0: float, llr1: float,
                  mode: str):
    """One fused Bayesian observation step, the belief channel's analogue
    of `infection_update`: a pure function of the state, the counts, the
    per-agent awareness and thresholds and the llr constants. A newly
    crossing agent gets ``t_next`` as its informed time. Returns
    (informed', t_inf', belief')."""
    lowering = resolve_belief_mode(mode, informed.device)
    update = _belief_cuda if lowering == "kernel" else _belief_plain
    return update(informed, t_inf, belief, counts, awareness, safe_deg, thresholds,
                  t_next, dt, llr0, llr1)
