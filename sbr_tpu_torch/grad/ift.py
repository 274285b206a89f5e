"""Implicit-function-theorem differentiation of roots: the port of
``sbr_tpu.grad.ift``.

Every root the solve computes (the buffer crossings where h(τ̄) = u, the
crash time ξ where AW(ξ) = κ) comes out of a bracketing solver
(`core.rootfind.bisect` / `chandrupatla`). Autograd through those
iterations is wrong, not just slow: a bisection iterate is a chain of
midpoint selections, piecewise constant in the parameters, so its
gradient is an exact 0 wherever the brackets do not move with them. The
derivative is free at the root instead: if f(x*, θ) = 0 and ∂f/∂x ≠ 0,
then dx*/dθ = −(∂f/∂θ)/(∂f/∂x), one linearization of the residual.

`implicit_root` is that rule as a `torch.autograd.Function` (the
reference's ``jax.custom_jvp``): the forward runs the caller's solver
under ``torch.no_grad()``; the backward takes ∂f/∂x at x* by autograd on a
detached x, floors it away from zero (sign-preserving), and returns the
vector-Jacobian product of f in the operand with ``−g/(∂f/∂x)``. Lanes
are independent, so a batch of roots is a per-lane division, as the
reference's vmapped diagonal solve is.

Contract: every tensor that carries a gradient flows through ``operand``
(a dict of tensors); ``f(x, operand)`` and ``solve(operand)`` are pure
functions of their arguments. The backward runs no host read, so it can
be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import torch


class _ImplicitRoot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, solve, keys, fx_floor, *values):
        with torch.no_grad():
            x = solve(dict(zip(keys, values)))
        ctx.f, ctx.keys, ctx.fx_floor = f, keys, fx_floor
        ctx.save_for_backward(x, *values)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *values = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            op = {
                k: (v.detach().requires_grad_(True) if need else v.detach())
                for k, v, need in zip(ctx.keys, values, needs)
            }
            r = ctx.f(x_, op)
            (fx,) = torch.autograd.grad(r, x_, torch.ones_like(r), retain_graph=True)
            floor = (
                float(torch.finfo(fx.dtype).tiny) ** 0.5
                if ctx.fx_floor is None
                else float(ctx.fx_floor)
            )
            fx_safe = torch.where(
                fx.abs() >= floor, fx,
                torch.where(fx >= 0, torch.full_like(fx, floor), torch.full_like(fx, -floor)),
            )
            targets = [op[k] for k, need in zip(ctx.keys, needs) if need]
            grads = iter(
                torch.autograd.grad(r, targets, -g / fx_safe, allow_unused=True)
                if targets else ()
            )
        out = []
        for v, need in zip(values, needs):
            gv = next(grads) if need else None
            if need and gv is None:
                gv = torch.zeros_like(v)
            out.append(gv)
        return (None, None, None, None, *out)


def implicit_root(f, solve, operand: dict, fx_floor: Optional[float] = None) -> torch.Tensor:
    """x*(operand) with IFT derivatives: forward ``solve(operand)``,
    reverse −(∂f/∂operand)ᵀ·g/(∂f/∂x) at x* (module docstring).

    - ``f(x, operand) -> residual``: the defining equation, differentiable
      in both slots.
    - ``solve(operand) -> x*``: any root-finder; never differentiated.
    - ``fx_floor``: |∂f/∂x| is floored at this magnitude, keeping its
      sign, before the division, so an ill-conditioned root (AW'(ξ) → 0
      at the withdrawal curve's peak) gives a large but finite gradient;
      callers flag it (`GRAD_ILL_CONDITIONED`). The default √tiny of the
      dtype overflows only for |∂f/∂θ| beyond max·√tiny.
    """
    keys = tuple(operand)
    values = tuple(operand[k] for k in keys)
    return _ImplicitRoot.apply(f, solve, keys, fx_floor, *values)
