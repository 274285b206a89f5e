"""Quadrature primitives: the port of ``sbr_tpu.core.integrate``.

Cumulative integrals along the last axis end in a prefix sum whose
summation order differs from XLA's (and between the CPU and the card), so
they agree with the reference to the last bits, not bit for bit. On the
CPU it is ``torch.cumsum``, sequential along each row. On the card it is
`prefix_sum`: ``torch.cumsum`` there picks its algorithm by the number of
rows (on an H100 a row's bits change with the row count below 1,024
rows), which would make a cell's answer depend on the cells batched with
it; the doubling scan's bits do not.
"""

from __future__ import annotations

import numpy as np
import torch

from sbr_tpu_torch.diag.health import Health


def _quad_health(values, csum, n_panels: int) -> Health:
    """Health of one cumulative quadrature: NaN among the integrand samples
    and non-finite values in the cumulative result; iterations counts
    panels. Reduced over the last axis, so batched rows keep their own."""
    return Health.of_nan_probe(
        nan_in=torch.isnan(values).any(-1),
        nonfinite_out=(~torch.isfinite(csum)).any(-1),
        iterations=n_panels,
        dtype=csum.dtype,
    )


def trapz(y, x=None, dx=1.0):
    """Trapezoid integral along the last axis."""
    d = torch.diff(x, dim=-1) if x is not None else dx
    return (0.5 * (y[..., 1:] + y[..., :-1]) * d).sum(-1)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by doubling (Hillis and
    Steele): ⌈log2 n⌉ passes of elementwise adds, so each row's bits depend
    on that row alone. Each sum has at most ⌈log2 n⌉ levels of rounding."""
    k, n = 1, x.shape[-1]
    while k < n:
        x = torch.cat([x[..., :k], x[..., k:] + x[..., :-k]], dim=-1)
        k *= 2
    return x


# Row width of XLA's blocked cumulative sum (its reduce_window lowering).
_XLA_SCAN_BASE = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in XLA's association, bit
    for bit ``jnp.cumsum`` on the CPU, eager or under ``jit``.

    XLA lowers a cumulative sum to a blocked scan of base 16: it pads the
    row with zeros to a multiple of 16, views it as (m, 16), takes a
    sequential prefix along each block row, scans the m block totals the
    same way (recursively), and adds each row's exclusive carry, the total
    of the rows before it (zero for the first). This function repeats that
    order with elementwise adds only (15 column adds a level), so it gives
    the same bits on the CPU and on the card, where ``torch.cumsum`` sums
    in another order that changes with the row count. The panic-rewiring
    tilt table (`social.graphgen.tilt_threshold_table`) quantizes such a
    prefix into uint32 buckets, and needs it bit for bit."""
    n = x.shape[-1]
    if n == 0:
        return x.clone()
    m = -(-n // _XLA_SCAN_BASE)
    xp = torch.nn.functional.pad(x, (0, m * _XLA_SCAN_BASE - n))
    xp = xp.reshape(*x.shape[:-1], m, _XLA_SCAN_BASE)
    cols = [xp[..., 0]]
    for j in range(1, _XLA_SCAN_BASE):
        cols.append(cols[-1] + xp[..., j])
    rows = torch.stack(cols, dim=-1)
    if m > 1:
        totals = xla_cumsum(rows[..., -1])
        carry = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
        rows = rows + carry.unsqueeze(-1)
    return rows.reshape(*x.shape[:-1], m * _XLA_SCAN_BASE)[..., :n]


def _cum_from_zero(inc: torch.Tensor) -> torch.Tensor:
    csum = prefix_sum(inc) if inc.is_cuda else torch.cumsum(inc, dim=-1)
    return torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)


def cumtrapz(y, x=None, dx=1.0, with_health: bool = False):
    """Cumulative trapezoid along the last axis, zero at the first knot:
    ``int[i] = int[i-1] + 0.5·(y[i-1] + y[i])·(x[i] − x[i-1])``. With
    ``with_health`` returns ``(out, Health)``."""
    d = torch.diff(x, dim=-1) if x is not None else dx
    out = _cum_from_zero(0.5 * (y[..., 1:] + y[..., :-1]) * d)
    if with_health:
        return out, _quad_health(y, out, int(y.shape[-1]) - 1)
    return out


def cumulative_gauss_legendre(f, grid: torch.Tensor, order: int = 8, with_health: bool = False):
    """Cumulative integral of callable ``f`` at the knots of ``grid``
    (shape R + (n,)), zero at ``grid[..., 0]``.

    Composite Gauss-Legendre with ``order`` nodes per interval. The node
    sum of each panel runs in node order, one node at a time, so it rounds
    the same way on every device and never holds more than one node's
    evaluations. With ``with_health`` also returns a `Health` flagging NaN
    integrand samples and a non-finite result."""
    nodes, weights = np.polynomial.legendre.leggauss(order)
    a = grid[..., :-1]
    b = grid[..., 1:]
    half = 0.5 * (b - a)
    mid = 0.5 * (a + b)
    acc = None
    nan_in = torch.zeros(grid.shape[:-1], dtype=torch.bool, device=grid.device)
    for node, weight in zip(nodes, weights):
        node_t = torch.full((), float(node), dtype=grid.dtype, device=grid.device)
        weight_t = torch.full((), float(weight), dtype=grid.dtype, device=grid.device)
        vals = f(mid + half * node_t)
        if with_health:
            nan_in = nan_in | torch.isnan(vals).any(-1)
        term = weight_t * vals
        acc = term if acc is None else acc + term
    out = _cum_from_zero(half * acc)
    if with_health:
        return out, Health.of_nan_probe(
            nan_in, (~torch.isfinite(out)).any(-1), int(grid.shape[-1]) - 1, out.dtype
        )
    return out
