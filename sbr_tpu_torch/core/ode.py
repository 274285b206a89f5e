"""Fixed-step and adaptive ODE integration on a static save grid: the port
of ``sbr_tpu.core.ode``.

- `rk4`: classic RK4 with ``substeps`` uniform micro-steps per save
  interval, a Python loop over the intervals (the reference's
  ``lax.scan``).
- `bs32`: the Bogacki–Shampine 3(2) embedded pair with PI step-size
  control, marching each save interval under a per-interval attempt
  budget. The reference's scan of per-interval ``lax.while_loop``s
  becomes one host loop of passes. With ``lane_ndim`` leading lane
  dimensions it is the reference under ``vmap``, except that each lane
  marches through its own intervals: a pass makes one attempt (or one
  budget-exhausted bridge step, the reference's ``lax.cond``) for every
  lane that has one to make, and a lane whose interval ends in that pass
  saves its value and moves to its next interval. So the loop runs as
  many passes as the busiest lane has attempts in all, not, as a
  lockstep ``vmap`` does, the sum over intervals of the most attempts any
  lane makes there. Every lane's arithmetic is its unbatched run's, in
  the same order, so a lane's result does not depend on the lanes solved
  beside it.

Arithmetic follows the reference operation by operation. ``err_norm``'s
``jnp.mean`` is, under XLA, a sum times ``dtype(1/n)``, and so it is here.
``norm ** (-0.7/3)`` may round apart from XLA's power by an ulp, which can
move an accept/reject decision and so a step count (the tests state the
measured spread).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sbr_tpu_torch import obs
from sbr_tpu_torch.diag.health import ODE_BUDGET, Health, flag_bit

# `run_passes` asks the device whether the march has ended once every this
# many passes; the passes past the end are masked no-ops.
CHECK_EVERY = 8


def _probe_health(y0, ts, out, iterations, state_ndim: int, dtype) -> Health:
    """The reference's NaN probe of an integration, per lane: NaN in the
    initial state or the grid, non-finite values in the trajectory;
    ``iterations`` is the tensor of attempts (or an int)."""
    lane = y0.dim() - state_ndim
    state_dims = tuple(range(lane, y0.dim()))
    nan_y0 = torch.isnan(y0).any(dim=state_dims) if state_dims else torch.isnan(y0)
    nan_in = nan_y0 | torch.isnan(ts).any(-1)
    out_dims = tuple(range(lane, out.dim()))
    nonfinite = (~torch.isfinite(out)).any(dim=out_dims)
    h = Health.of_nan_probe(nan_in, nonfinite, 0, dtype)
    return h.replace(iterations=torch.as_tensor(iterations, dtype=torch.int32,
                                                device=h.flags.device).expand(h.flags.shape))


def run_passes(one_pass, state: dict, done, eager: bool = False) -> dict:
    """Apply ``one_pass`` (a function from a state dict of tensors to the
    next) in chunks of `CHECK_EVERY` passes until ``done(state)``, which is
    asked between chunks. On the card the first chunk runs eagerly as a
    warm-up, then one chunk is captured into a CUDA graph over static
    copies of the state and replayed: the same kernels in the same order,
    without the host's cost of launching each. ``eager`` runs every pass
    eagerly on the card too, as autograd needs (a replayed graph records
    no backward); the results are the same bits."""
    first = next(iter(state.values()))
    if first.device.type != "cuda" or eager:
        while not done(state):
            for _ in range(CHECK_EVERY):
                state = one_pass(state)
        return state
    dev = first.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        if not done(state):
            for _ in range(CHECK_EVERY):
                state = one_pass(state)
    torch.cuda.current_stream(dev).wait_stream(side)
    if done(state):
        return state
    static = {k: v.clone() for k, v in state.items()}
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        s = static
        for _ in range(CHECK_EVERY):
            s = one_pass(s)
        for k, v in static.items():
            v.copy_(s[k])
    obs.prof.note_capture("ode.passes", time.perf_counter() - t0)
    while not done(static):
        graph.replay()
    return static


def rk4(f, y0, ts, args=None, substeps: int = 1, with_health: bool = False):
    """Integrate dy/dt = f(t, y, args) over the 1-D save grid ``ts`` with
    classic RK4, ``substeps`` uniform micro-steps per interval.

    Returns ys of shape (n,) + y0.shape with ys[0] == y0; with
    ``with_health`` also a `Health` flagging NaN in the initial state or
    the grid and non-finite values in the trajectory, whose iterations
    count the micro-steps."""
    y = y0
    outs = [y0]
    for i in range(ts.shape[0] - 1):
        t0, t1 = ts[i], ts[i + 1]
        h = (t1 - t0) / substeps
        for j in range(substeps):
            t = t0 + j * h
            k1 = f(t, y, args)
            k2 = f(t + 0.5 * h, y + 0.5 * h * k1, args)
            k3 = f(t + 0.5 * h, y + 0.5 * h * k2, args)
            k4 = f(t + h, y + h * k3, args)
            y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        outs.append(y)
    out = torch.stack(outs)
    if not with_health:
        return out
    return out, Health.of_nan_probe(
        nan_in=torch.isnan(y0).any() | torch.isnan(ts).any(),
        nonfinite_out=(~torch.isfinite(out)).any(),
        iterations=(ts.shape[0] - 1) * substeps,
        dtype=out.dtype,
    )


def bs32(
    f,
    y0,
    ts,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps_per_interval: int = 32,
    with_health: bool = False,
    lane_ndim: int = 0,
):
    """Integrate dy/dt = f(t, y, args) over the save grid ``ts`` with the
    adaptive Bogacki–Shampine 3(2) pair (module docstring).

    ``y0`` has shape L + S: ``lane_ndim`` leading lane dimensions L, each
    lane its own solve, and the state S. ``ts`` has shape R + (n,) with R
    broadcastable to L; ``f`` receives t of shape L (0-d without lanes).
    Returns ys of shape L + (n,) + S with ys[..., 0, ...] == y0; save
    points are hit exactly. The step size and the controller's error
    memory carry across intervals; an interval that exhausts
    ``max_steps_per_interval`` attempts is bridged by one unchecked step
    and flagged `ODE_BUDGET`. With ``with_health`` returns ``(ys,
    Health)`` per lane, whose ``iterations`` count every attempt."""
    dtype, dev = y0.dtype, y0.device
    lanes = y0.shape[:lane_ndim]
    state = y0.shape[lane_ndim:]
    k = len(state)
    state_dims = tuple(range(lane_ndim, y0.dim()))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    tiny = float(torch.finfo(dtype).tiny)

    def c(v):
        return torch.full((), float(v), dtype=dtype, device=dev)

    rtol_, atol_, safety = c(rtol), c(atol), c(0.9)
    inv_n = c(np_dtype(1) / np_dtype(max(int(np.prod(state)), 1)))

    def st(x):
        """A lane-shaped tensor against the state dimensions."""
        return x.reshape(x.shape + (1,) * k)

    def step(t, y, h, k1):
        hs = st(h)
        k2 = f(t + 0.5 * h, y + 0.5 * hs * k1, args)
        k3 = f(t + 0.75 * h, y + 0.75 * hs * k2, args)
        y3 = y + hs * (2.0 / 9.0 * k1 + 1.0 / 3.0 * k2 + 4.0 / 9.0 * k3)
        k4 = f(t + h, y3, args)
        err = hs * (5.0 / 72.0 * k1 - 1.0 / 12.0 * k2 - 1.0 / 9.0 * k3 + 1.0 / 8.0 * k4)
        return y3, err, k4

    def err_norm(err, y, y3):
        scale = atol_ + rtol_ * torch.maximum(y.abs(), y3.abs())
        r = err / scale
        sq = r * r
        mean = sq.sum(dim=state_dims) * inv_n if k else sq
        return torch.sqrt(mean)

    n = ts.shape[-1]
    lane_n = int(np.prod(lanes)) if lanes else 1
    state_n = int(np.prod(state)) if state else 1

    def expand(x):
        return x.expand(lanes) if lanes else x

    # Each lane marches through its own intervals: one attempt per lane
    # per pass, so the loop runs as many passes as the busiest lane needs,
    # not the sum over intervals of the busiest lane's attempts there.
    t = expand(ts[..., 0]).clone()
    t1 = expand(ts[..., 1]).clone()
    h = t1 - t
    march = dict(
        i=torch.zeros(lanes, dtype=torch.int64, device=dev),
        t=t,
        t1=t1,
        span=t1 - t,
        h=h,
        hh=torch.minimum(torch.clamp(h, min=tiny), t1 - t),
        ep=torch.ones(lanes, dtype=dtype, device=dev),
        used=torch.zeros(lanes, dtype=torch.int32, device=dev),
        nfails=torch.zeros(lanes, dtype=torch.int32, device=dev),
        nsteps=torch.zeros(lanes, dtype=torch.int32, device=dev),
        k1=f(t, y0, args),
        y=y0.clone(),
    )
    # the save points, and a spare column that lanes with nothing to save
    # write into: (lanes, n + 1, state)
    out = torch.zeros((lane_n, n + 1, state_n), dtype=dtype, device=dev)
    out[:, 0] = y0.reshape(lane_n, state_n)
    spare = torch.full((), n, dtype=torch.int64, device=dev)
    ts_lanes = ts.expand(*lanes, n) if lanes else ts

    def one_pass(s):
        i, t, t1, hh, ep, used, y, k1 = (s[k] for k in ("i", "t", "t1", "hh", "ep", "used", "y", "k1"))
        live = i < n - 1
        attempt = live & (t < t1) & (used < max_steps_per_interval)
        # budget exhausted short of t1: one unchecked step bridges the rest
        bridge = live & ~attempt & ((t1 - t) > 0)
        h_x = torch.where(attempt, torch.minimum(hh, t1 - t), t1 - t)
        y3, err, k4 = step(t, y, h_x, k1)
        norm = torch.clamp(err_norm(err, y, y3), min=tiny)
        accept = norm <= 1.0
        fac = safety * norm ** (-0.7 / 3.0) * ep ** (0.4 / 3.0)
        fac = torch.clamp(fac, 0.2, 2.0)
        fac = torch.where(accept, fac, torch.clamp(fac, max=1.0) * safety)
        t2 = torch.where(accept, torch.minimum(t + h_x, t1), t)
        # pin the endpoint exactly once the clamped step lands on it
        t2 = torch.where(accept & (hh >= t1 - t), t1, t2)
        take = st((attempt & accept) | bridge)
        t = torch.where(attempt, t2, t)
        y = torch.where(take, y3, y)
        k1 = torch.where(take, k4, k1)
        hh = torch.where(attempt, torch.clamp(h_x * fac, min=tiny), hh)
        ep = torch.where(attempt & accept, norm, ep)
        used = used + attempt.to(torch.int32)

        # lanes whose interval ends in this pass: save, account, move on
        fin = live & ~((t < t1) & (used < max_steps_per_interval)) & (~((t1 - t) > 0) | bridge)
        ex_i = (fin & bridge).to(torch.int32)
        # zero-width intervals (duplicate knots) keep the inherited step
        h = torch.where(fin & (s["span"] > 0), hh, s["h"])
        col = torch.where(fin, i + 1, spare).reshape(lane_n, 1, 1).expand(lane_n, 1, state_n)
        out.scatter_(1, col, y.reshape(lane_n, 1, state_n))
        i = i + fin.to(torch.int64)
        t_next = torch.gather(ts_lanes, -1, torch.clamp(i + 1, max=n - 1).unsqueeze(-1)).squeeze(-1)
        t = torch.where(fin, t1, t)
        t1 = torch.where(fin, t_next, t1)
        span = torch.where(fin, t1 - t, s["span"])
        return dict(
            i=i, t=t, t1=t1, span=span, h=h,
            hh=torch.where(fin, torch.minimum(torch.clamp(h, min=tiny), span), hh),
            ep=ep, used=torch.where(fin, 0, used),
            nfails=s["nfails"] + ex_i,
            nsteps=s["nsteps"] + torch.where(fin, used + ex_i, 0),
            k1=k1, y=y,
        )

    march = run_passes(one_pass, march, lambda s: not bool((s["i"] < n - 1).any()))
    nsteps, nfails = march["nsteps"], march["nfails"]
    out = out[:, :n].reshape(*lanes, n, *state)
    if not with_health:
        return out
    health = _probe_health(y0, ts, out, nsteps, k, dtype)
    return out, health.replace(flags=health.flags | flag_bit(nfails > 0, ODE_BUDGET))
