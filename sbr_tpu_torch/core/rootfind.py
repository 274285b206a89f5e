"""Branchless threshold-crossing detection and batched bracketing
root-finds: the port of ``sbr_tpu.core.rootfind``.

Every function works on whole batches of cells at once (torch has no
``vmap`` of a while loop). A curve has shape R + (n,) and is shared by the
cells that broadcast against its row shape R; levels, brackets and results
have the cell shape C (`core.interp` states the convention).

- `first_upcrossing` / `last_downcrossing`: the scan pair, boolean
  transitions over every knot of every cell.
- `threshold_crossings_masked`: both crossings through per-row block
  tables and O(√n) per-cell work; bit-identical indices and results to
  the scan pair, including the fallback ladder and NaN semantics.
- `bisect`: fixed-iteration bisection, one Python loop step per halving.
- `chandrupatla`: the convergence-masked IQI/bisection hybrid. Converged
  lanes freeze exactly as in the reference's ``while_loop``; the batch
  stops once no lane is active (checked on the host every
  `CHECK_EVERY` iterations) or at the budget. Frozen lanes keep their
  state, so per-lane results do not depend on when the batch stops.
  Inside `no_host_reads` it runs the whole budget without the check, the
  form a CUDA graph can capture; its results are bitwise the same.

Masks reach ``argmax`` as ``uint8`` views (``torch.argmax`` takes no
``bool``); it returns the first maximal index, so the first True, or 0
when there is none, as ``jnp.argmax`` of a mask does.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from sbr_tpu_torch.core.interp import take_last
from sbr_tpu_torch.diag.health import (
    FALLBACK_IN_DEFAULT,
    FALLBACK_IN_KNOT,
    NAN_INPUT,
    NAN_OUTPUT,
    NO_BRACKET,
    NONFINITE_RESIDUAL,
    Health,
    flag_bit,
)

# Host checks of "any lane still active" in `chandrupatla`: one every this
# many iterations (iterations run past the last active lane are no-ops on
# the results). Each check is one device-to-host sync, but the loop is
# bound by the host's dispatch, and the syncs cost less than the spread
# between calls: on an H100 (700 W) the float32 500×500 Figure-5 grid took
# 116-169 ms with a check every iteration, 120-167 ms every 4th and
# 147-163 ms with none (`chip_smoke.py profile`).
CHECK_EVERY = 1

_NO_HOST_READS = contextvars.ContextVar("no_host_reads", default=False)


@contextlib.contextmanager
def no_host_reads():
    """Within this block (in this thread), `chandrupatla` never reads the
    device from the host: it runs its whole budget, which a CUDA graph
    can capture. Frozen lanes keep their state, so every output equals the
    checked form's bit for bit."""
    token = _NO_HOST_READS.set(True)
    try:
        yield
    finally:
        _NO_HOST_READS.reset(token)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return mask.contiguous().view(torch.uint8).argmax(-1)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along the last axis (n−1 when none)."""
    n = mask.shape[-1]
    return (n - 1) - torch.flip(mask, (-1,)).view(torch.uint8).argmax(-1)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _gather_last(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx[..., k]]``: ``idx`` of shape C + (k,) against a
    table of shape R + (n,); returns broadcast(R, C) + (k,)."""
    shape = torch.broadcast_shapes(table.shape[:-1], idx.shape[:-1])
    return torch.gather(
        table.expand(*shape, table.shape[-1]), -1, idx.expand(*shape, idx.shape[-1])
    )


def _nan_like_flags(flags: torch.Tensor, dtype) -> torch.Tensor:
    return torch.full(flags.shape, float("nan"), dtype=dtype, device=flags.device)


def _crossing_health(y, level, has_cross, has_above) -> Health:
    """Health of one crossing detection: which rung of the fallback ladder
    fired (generic IN-positioned bits) plus NaN poison in the curve or the
    level."""
    flags = torch.where(
        has_cross,
        0,
        torch.where(has_above, FALLBACK_IN_KNOT, FALLBACK_IN_DEFAULT),
    ).to(torch.int32)
    nan_in = torch.isnan(y).any(-1) | torch.isnan(level)
    flags = flags | flag_bit(nan_in, NAN_INPUT)
    return Health(
        residual=_nan_like_flags(flags, y.dtype),
        bracket_width=_nan_like_flags(flags, y.dtype),
        iterations=torch.zeros_like(flags),
        flags=flags,
    )


def _interp_cross(x, y, level, i):
    x1 = take_last(x, i)
    x2 = take_last(x, i + 1)
    y1 = take_last(y, i)
    y2 = take_last(y, i + 1)
    dy = y2 - y1
    # flat segments only reach here in fallback lanes, whose value is unused
    safe = torch.where(dy == 0, torch.ones_like(dy), dy)
    return x1 + (level - y1) * (x2 - x1) / safe


def _levels(y, level, default):
    level = torch.as_tensor(level, dtype=y.dtype, device=y.device)
    default = torch.as_tensor(default, dtype=y.dtype, device=y.device)
    return level, default


def first_upcrossing(x, y, level, default, return_flag: bool = False, with_health: bool = False):
    """First t where ``y`` crosses ``level`` from below, linearly
    interpolated. Fallbacks: the first above-level knot when there is no
    up-crossing, ``default`` when nothing is above. With ``return_flag``
    also returns whether a genuine crossing was found; with ``with_health``
    a `Health` of the fallback rung and NaN poison is appended."""
    level, default = _levels(y, level, default)
    above = y > level.unsqueeze(-1)
    up = ~above[..., :-1] & above[..., 1:]
    has_up = up.any(-1)
    t_cross = _interp_cross(x, y, level, _first_true(up))
    has_above = above.any(-1)
    t = torch.where(has_up, t_cross, torch.where(has_above, take_last(x, _first_true(above)), default))
    out = (t, has_up) if return_flag else (t,)
    if with_health:
        out = out + (_crossing_health(y, level, has_up, has_above),)
    return out if len(out) > 1 else out[0]


def last_downcrossing(x, y, level, default, return_flag: bool = False, with_health: bool = False):
    """Last t where ``y`` crosses ``level`` from above, linearly
    interpolated. Fallbacks: the last above-level knot, then ``default``.
    Health (opt-in) reports in the generic IN-positioned bits; callers
    re-key it with `diag.health.as_out_crossing`."""
    level, default = _levels(y, level, default)
    above = y > level.unsqueeze(-1)
    dn = above[..., :-1] & ~above[..., 1:]
    has_dn = dn.any(-1)
    t_cross = _interp_cross(x, y, level, _last_true(dn))
    has_above = above.any(-1)
    t = torch.where(has_dn, t_cross, torch.where(has_above, take_last(x, _last_true(above)), default))
    out = (t, has_dn) if return_flag else (t,)
    if with_health:
        out = out + (_crossing_health(y, level, has_dn, has_above),)
    return out if len(out) > 1 else out[0]


def bisect(f, lo, hi, num_iters: int = 90, x0=None, with_health: bool = False):
    """Fixed-iteration bisection for a root of ``f`` in [lo, hi], the
    reference's update rule: positive error contracts the upper bound,
    negative the lower, and the next iterate is the midpoint of the
    retained half, starting from ``x0`` (default: the bracket midpoint).

    Returns the final iterate; with ``with_health`` ``(x, Health)``, where
    three extra evaluations of ``f`` give the final residual, the bracket
    check and NaN sentinels, and ``iterations`` is the budget."""
    x = 0.5 * (lo + hi) if x0 is None else x0
    lo_c, hi_c = lo, hi
    for _ in range(num_iters):
        pos = f(x) > 0
        # 0.5·(x + lo) where pos, 0.5·(x + hi) elsewhere, as the reference
        x, lo_c, hi_c = (
            0.5 * (x + torch.where(pos, lo_c, hi_c)),
            torch.where(pos, lo_c, x),
            torch.where(pos, x, hi_c),
        )
    if not with_health:
        return x

    res = f(x).abs()
    dtype = res.dtype
    lo_t, hi_t = (torch.as_tensor(v, dtype=dtype, device=res.device) for v in (lo, hi))
    no_bracket = f(lo_t) * f(hi_t) > 0
    nan_in = torch.isnan(lo_t) | torch.isnan(hi_t)
    if x0 is not None:
        nan_in = nan_in | torch.isnan(torch.as_tensor(x0, dtype=dtype, device=res.device))
    flags = (
        flag_bit(no_bracket, NO_BRACKET)
        | flag_bit(~torch.isfinite(res), NONFINITE_RESIDUAL)
        | flag_bit(nan_in, NAN_INPUT)
        | flag_bit(torch.isnan(x), NAN_OUTPUT)
    )
    health = Health(
        residual=res,
        bracket_width=(torch.as_tensor(hi_c, dtype=dtype, device=res.device) - lo_c).abs(),
        iterations=torch.full(flags.shape, num_iters, dtype=torch.int32, device=res.device),
        flags=flags,
    )
    return x, health


def chandrupatla(f, lo, hi, budget: int = 90, x0=None, atol=0.0, with_health: bool = False):
    """Convergence-masked Chandrupatla bracketing for a root of ``f`` in
    [lo, hi], the adaptive sibling of `bisect`.

    Inverse-quadratic interpolation where the iterates justify it,
    bisection otherwise. A lane freezes once its bracket shrinks below
    ``2·eps·|x| + atol`` or it hits an exact zero; the batch stops when
    every lane has frozen (checked every `CHECK_EVERY` iterations, never
    inside `no_host_reads`) or at ``budget``. With ``with_health`` returns
    ``(x, Health)`` from the loop state: final |f(x)|, bracket width,
    per-lane iterations actually run and the bracket and NaN flags."""
    b = lo
    a = hi
    dtype = torch.promote_types(a.dtype, b.dtype)
    a = a.to(dtype)
    b = b.to(dtype)
    fa = f(a)
    fb = f(b)
    shape = torch.broadcast_shapes(fa.shape, fb.shape)
    finfo = torch.finfo(dtype)
    eps, tiny = finfo.eps, finfo.tiny

    a, b, fa, fb = (v.expand(shape) for v in (a, b, fa, fb))
    c, fc = a, fa
    if x0 is None:
        t = torch.full(shape, 0.5, dtype=dtype, device=a.device)
    else:
        span = b - a
        safe = torch.where(span == 0, torch.ones_like(span), span)
        x0_t = torch.as_tensor(x0, dtype=dtype, device=a.device)
        t = torch.clamp((x0_t - a) / safe, 0.001, 0.999).expand(shape)
    a0, b0, fa0, fb0 = a, b, fa, fb

    active = torch.ones(shape, dtype=torch.bool, device=a.device)
    iters = torch.zeros(shape, dtype=torch.int32, device=a.device)
    check = not _NO_HOST_READS.get()
    it = 0
    while it < budget:
        if check and it % CHECK_EVERY == 0 and it > 0 and not bool(active.any()):
            break
        it += 1
        xt = a + t * (b - a)
        ft = f(xt)
        same = _sign(ft) == _sign(fa)
        c2 = torch.where(same, a, b)
        fc2 = torch.where(same, fa, fb)
        b2 = torch.where(same, b, a)
        fb2 = torch.where(same, fb, fa)
        a2, fa2 = xt, ft

        xm = torch.where(fa2.abs() < fb2.abs(), a2, b2)
        tol = 2.0 * eps * xm.abs() + atol
        tlim = tol / torch.clamp((b2 - a2).abs(), min=tiny)
        converged = (tlim > 0.5) | (ft == 0)

        xi_ = (a2 - b2) / (c2 - b2 + tiny)
        phi = (fa2 - fb2) / (fc2 - fb2 + tiny)
        iqi_ok = (phi * phi < xi_) & ((1.0 - phi) * (1.0 - phi) < 1.0 - xi_)
        t_iqi = fa2 / (fb2 - fa2 + tiny) * fc2 / (fb2 - fc2 + tiny) + (
            c2 - a2
        ) / (b2 - a2 + tiny) * fa2 / (fc2 - fa2 + tiny) * fb2 / (fc2 - fb2 + tiny)
        t2 = torch.where(iqi_ok, torch.minimum(torch.maximum(t_iqi, tlim), 1.0 - tlim), 0.5)

        still = active & ~converged
        a = torch.where(active, a2, a)
        b = torch.where(active, b2, b)
        c = torch.where(active, c2, c)
        fa = torch.where(active, fa2, fa)
        fb = torch.where(active, fb2, fb)
        fc = torch.where(active, fc2, fc)
        t = torch.where(still, t2, t)
        iters = iters + active.to(torch.int32)
        active = still

    best_a = fa.abs() < fb.abs()
    x = torch.where(best_a, a, b)
    if not with_health:
        return x

    res = torch.where(best_a, fa, fb).abs()
    no_bracket = fa0 * fb0 > 0
    nan_in = torch.isnan(a0) | torch.isnan(b0)
    if x0 is not None:
        nan_in = nan_in | torch.isnan(torch.as_tensor(x0, dtype=dtype, device=a.device))
    flags = (
        flag_bit(no_bracket, NO_BRACKET)
        | flag_bit(~torch.isfinite(res), NONFINITE_RESIDUAL)
        | flag_bit(nan_in, NAN_INPUT)
        | flag_bit(torch.isnan(x), NAN_OUTPUT)
    )
    return x, Health(residual=res, bracket_width=(b - a).abs(), iterations=iters, flags=flags)


def _crossing_block_size(n: int) -> int:
    """Block size of `threshold_crossings_masked`: the power of two nearest
    √n, at least 8."""
    s = 8
    while s * s < n:
        s *= 2
    return s


def threshold_crossings_masked(x, y, level, default, with_health: bool = False):
    """Both crossings of ``y`` against ``level`` by a two-level block
    search, bit-identical to `first_upcrossing` + `last_downcrossing`.

    The first up-crossing is e − 1, with d the first not-above index and e
    the first above index past d; the last down-crossing is e′, with d′
    the last not-above index and e′ the last above index before d′; the
    fallback knots are the first and last above indices. "Not above" is
    ``~(y > level)``, so NaN samples count as not-above and NaN levels
    disable every crossing, as on the scan path. The block tables (per
    block max for "contains above", min for "contains not-above") depend
    only on ``y``, so they are built once per row and shared by its cells.

    Returns ``(t_in, has_up, t_out, has_dn)``; with ``with_health`` appends
    the IN- and generic-keyed OUT-crossing healths."""
    level, default = _levels(y, level, default)
    n = y.shape[-1]
    s = _crossing_block_size(n)
    B = -(-n // s)
    pad = B * s - n
    rows = y.shape[:-1]
    dev = y.device

    z = torch.where(torch.isnan(y), float("-inf"), y)
    bmax = F.pad(z, (0, pad), value=float("-inf")).reshape(*rows, B, s).amax(-1)
    bmin = F.pad(z, (0, pad), value=float("inf")).reshape(*rows, B, s).amin(-1)
    y_pad = F.pad(y, (0, pad), value=float("nan"))

    idx_b = torch.arange(B, device=dev)
    idx_s = torch.arange(s, device=dev)
    lev = level.unsqueeze(-1)

    abv_b = bmax > lev
    nab_b = bmin <= lev
    has_above = abv_b.any(-1)
    has_nab = nab_b.any(-1)

    def block(b):
        """Above / not-above element masks of block ``b`` of every cell."""
        pos = b.unsqueeze(-1) * s + idx_s
        v = _gather_last(y_pad, pos)
        valid = pos < n
        gt = v > lev
        return valid & gt, valid & ~gt

    # fallback knots: first / last above index
    b_j = _first_true(abv_b)
    j_first = b_j * s + _first_true(block(b_j)[0])
    b_j2 = _last_true(abv_b)
    j_last = b_j2 * s + _last_true(block(b_j2)[0])

    # first up-crossing: d = first not-above, e = first above past d
    b_d = _first_true(nab_b)
    above_d, nab_d = block(b_d)
    d_off = _first_true(nab_d)
    cand_in = above_d & (idx_s > d_off.unsqueeze(-1))
    e_in_ok = cand_in.any(-1)
    abv_after = abv_b & (idx_b > b_d.unsqueeze(-1))
    b_e = _first_true(abv_after)
    above_e, _ = block(b_e)
    e = torch.where(e_in_ok, b_d * s + _first_true(cand_in), b_e * s + _first_true(above_e))
    has_up = has_nab & (e_in_ok | abv_after.any(-1))
    i_up = torch.clamp(e - 1, 0, n - 2)

    # last down-crossing: d' = last not-above, e' = last above before d'
    b_d2 = _last_true(nab_b)
    above_d2, nab_d2 = block(b_d2)
    d2_off = _last_true(nab_d2)
    cand2_in = above_d2 & (idx_s < d2_off.unsqueeze(-1))
    e2_in_ok = cand2_in.any(-1)
    abv_before = abv_b & (idx_b < b_d2.unsqueeze(-1))
    b_e2 = _last_true(abv_before)
    above_e2, _ = block(b_e2)
    e2 = torch.where(e2_in_ok, b_d2 * s + _last_true(cand2_in), b_e2 * s + _last_true(above_e2))
    has_dn = has_nab & (e2_in_ok | abv_before.any(-1))
    i_dn = torch.clamp(e2, 0, n - 2)

    t_up = _interp_cross(x, y, level, i_up)
    t_dn = _interp_cross(x, y, level, i_dn)
    # without an above knot the fallback index may point into the padding;
    # its value is discarded, but the gather must stay in bounds
    j_first = torch.clamp(j_first, max=n - 1)
    j_last = torch.clamp(j_last, max=n - 1)
    t_in = torch.where(has_up, t_up, torch.where(has_above, take_last(x, j_first), default))
    t_out = torch.where(has_dn, t_dn, torch.where(has_above, take_last(x, j_last), default))
    out = (t_in, has_up, t_out, has_dn)
    if with_health:
        out = out + (
            _crossing_health(y, level, has_up, has_above),
            _crossing_health(y, level, has_dn, has_above),
        )
    return out
