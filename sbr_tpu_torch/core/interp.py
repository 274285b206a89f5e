"""Static grids and linear interpolation on them: the port of
``sbr_tpu.core.interp``, plus `linspace`, which makes the solver's grids,
and the batched gather and search helpers the solver stages share.

Batching convention of the port (torch has no ``vmap`` of the solver): a
table sampled on a grid has shape R + (n,), where R is the "row" shape of
what it depends on (one β in a u-sweep: R = (); a β×u sweep: R = (n_b, 1);
a batch of independent cells: R = (N,)); a per-cell quantity has the cell
shape C, which R broadcasts to. Extrapolation clamps to the boundary
values, as the reference's evaluators do.
"""

from __future__ import annotations

import numpy as np
import torch

from sbr_tpu_torch.social.fused import _fma


def linspace(start, stop, num: int, dtype: torch.dtype = torch.float64, device="cpu") -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` bit for bit, as XLA compiles it.

    ``torch.linspace`` fills from both ends and differs from JAX on a
    quarter to most of the points. JAX computes
    ``start·(1 − i/div) + stop·(i/div)`` and pins the last point to
    ``stop``; XLA turns ``i/div`` into ``i·r`` with r = 1/div rounded,
    reassociates ``stop·(i·r)`` into ``i·(stop·r)`` and contracts the
    multiply-adds. With start = 0, the grids every solver stage builds,
    that is ``i·(stop·r)`` rounded once, which this reproduces exactly.
    ``start`` and ``stop`` may be tensors of a row shape R; the result has
    shape R + (num,).
    """
    start, stop = (
        v.to(dtype=dtype, device=device) if isinstance(v, torch.Tensor)
        # filled on the device: a host copy cannot be captured in a CUDA graph
        else torch.full((), float(v), dtype=dtype, device=device)
        for v in (start, stop)
    )
    shape = torch.broadcast_shapes(start.shape, stop.shape)
    start, stop = start.expand(shape), stop.expand(shape)
    if num == 1:
        return start.unsqueeze(-1).clone()
    div = num - 1
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    r = torch.full((), float(np_dtype(1) / np_dtype(div)), dtype=dtype, device=device)
    i = torch.arange(div, dtype=dtype, device=device)
    one_minus = _fma(-i, r.expand(div), torch.ones_like(i))
    out = _fma(
        i.expand(*shape, div),
        (stop * r).unsqueeze(-1).expand(*shape, div),
        start.unsqueeze(-1) * one_minus,
    )
    return torch.cat([out, stop.unsqueeze(-1)], dim=-1)


def take_last(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` elementwise: the batch dims of ``table`` (shape
    R + (n,)) broadcast against ``idx`` (shape C); returns shape
    broadcast(R, C). The table is expanded as a view, never copied."""
    shape = torch.broadcast_shapes(table.shape[:-1], idx.shape)
    n = table.shape[-1]
    return torch.gather(
        table.expand(*shape, n), -1, idx.expand(shape).unsqueeze(-1)
    ).squeeze(-1)


def searchsorted_right(seq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``searchsorted(seq, values, side="right")`` per row: ``seq`` has
    shape R + (n,) with R's trailing dims of size 1 where the cells vary,
    ``values`` the cell shape C. Rows are searched in place, not expanded
    to one copy per cell."""
    n = seq.shape[-1]
    shape = torch.broadcast_shapes(seq.shape[:-1], values.shape)
    if seq.numel() == n:
        return torch.searchsorted(seq.reshape(n), values.expand(shape).contiguous(), right=True)
    batch = list(seq.shape[:-1])
    batch = [1] * (len(shape) - len(batch)) + batch
    while batch and batch[-1] == 1:
        batch.pop()
    if list(shape[: len(batch)]) != batch:
        raise ValueError(f"rows {tuple(seq.shape[:-1])} do not lead the cells {tuple(shape)}")
    rows = int(np.prod(batch))
    out = torch.searchsorted(
        seq.reshape(rows, n), values.expand(shape).reshape(rows, -1).contiguous(), right=True
    )
    return out.reshape(shape)


def interp(x, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` sampled at 1-D sorted knots ``xp``,
    ``jnp.interp`` bit for bit; clamps outside [xp[0], xp[-1]]. ``fp`` may
    carry leading row dims R (shape R + (n,)), which ``x`` broadcasts
    against, as ``vmap`` of ``jnp.interp`` over rows does."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    f_lo = take_last(fp, i - 1)
    df = take_last(fp, i) - f_lo
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = dx.abs() <= eps
    # jnp.interp is jitted, and XLA fuses the blend into one multiply-add
    slope = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, f_lo, _fma(slope, df, f_lo))
    f = torch.where(x < xp[0], fp[..., 0], f)
    return torch.where(x > xp[-1], fp[..., -1], f)


def _segment_blend(x, xp, fp, i0):
    """Clamped linear blend on the bracket [xp[i0], xp[i0+1]]; zero-width
    segments take the left value."""
    x0 = take_last(xp, i0)
    x1 = take_last(xp, i0 + 1)
    denom = torch.where(x1 > x0, x1 - x0, torch.ones_like(x1))
    w = torch.clamp(((x - x0) / denom).to(fp.dtype), 0.0, 1.0)
    return take_last(fp, i0) * (1.0 - w) + take_last(fp, i0 + 1) * w


def interp_shared(x, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of rows ``fp`` (R + (n,)) sampled at SHARED
    sorted 1-D knots ``xp`` (n,), every row at every ``x``: the result has
    shape R + x.shape, and one search serves every row. Duplicate knots:
    the left value wins."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    n = xp.shape[0]
    i0 = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1, 0, n - 2)
    x0 = xp[i0]
    x1 = xp[i0 + 1]
    denom = torch.where(x1 > x0, x1 - x0, torch.ones_like(x1))
    w = torch.clamp(((x - x0) / denom).to(fp.dtype), 0.0, 1.0)
    return fp[..., i0] * (1.0 - w) + fp[..., i0 + 1] * w


def interp_guided(x, xp: torch.Tensor, fp: torch.Tensor, i_guess) -> torch.Tensor:
    """Linear interpolation at sorted knots ``xp`` with a bracketing-index
    guess accurate to ±1 knot (`baseline.solver.warped_grid_index`): the
    guess is corrected locally by stepping up at most twice from one knot
    below it. Clamps outside [xp[0], xp[-1]]."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    n = xp.shape[-1]
    i0 = torch.clamp(torch.as_tensor(i_guess, dtype=torch.int64, device=xp.device) - 1, 0, n - 2)
    for _ in range(2):
        i0 = torch.where((x >= take_last(xp, i0 + 1)) & (i0 < n - 2), i0 + 1, i0)
    return _segment_blend(x, xp, fp, i0)


def interp_uniform(x, t0, dt, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` sampled on the uniform grid
    t0 + i·dt: index arithmetic instead of a search. ``fp`` has shape
    R + (n,) and ``t0``, ``dt`` shape R; ``x`` broadcasts against R."""
    x = torch.as_tensor(x, dtype=fp.dtype, device=fp.device)
    n = fp.shape[-1]
    s = torch.clamp((x - t0) / dt, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(s).to(torch.int64), 0, n - 2)
    w = (s - i0).to(fp.dtype)
    return take_last(fp, i0) * (1.0 - w) + take_last(fp, i0 + 1) * w
