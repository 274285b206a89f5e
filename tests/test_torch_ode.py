"""The port's ODE integrators (sbr_tpu_torch.core.ode) against
sbr_tpu.core.ode, on the CPU, in float64.

Contracts:

- `rk4`: trajectories within F64_TOL = 1e-12 of the reference (measured
  4.4e-16 on these cases), the health's flags and micro-step count exact.
- `bs32` is the reference's algorithm operation by operation: against
  the reference run op by op (``jax.disable_jit()``), trajectories, attempt
  counts and flags are equal bit for bit (the logistic cases below).
  Against the compiled reference (what ``sbr_tpu`` runs), flags are exact,
  attempt counts within BS32_COUNT_SPREAD = 12% and values within
  BS32_TOL = 1e-6, the solver's own rtol; measured on the coupled cases:
  counts within 8.8% and values within 1.2e-7 (tests/torch_parity_report.py
  extensions). The reason: XLA compiles the loop
  with its own fused multiply-adds and ``pow``, and the embedded error
  estimate cancels seven to nine digits, so those last bits move an error
  norm by ~1e-9 relative and flip an accept/reject decision whose norm
  lies that close to 1; a flipped decision moves the trajectory by up to
  the local tolerance. Before the first flip the two agree within 1e-15
  and count alike (`test_bs32_short_horizon_matches_exactly`).
- Lanes: `bs32` with ``lane_ndim`` is the reference under ``vmap``. Each
  lane of a batched call equals, bit for bit, the same lane solved alone
  (a lane whose loop has ended is frozen) and the op-by-op reference's
  solve of that lane.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.core import ode as jode  # noqa: E402
from sbr_tpu_torch.core import ode as tode  # noqa: E402
from sbr_tpu_torch.diag.health import ODE_BUDGET  # noqa: E402

F64_TOL = 1e-12
BS32_TOL = 1e-6
BS32_COUNT_SPREAD = 0.12

BETAS = np.array([0.125, 12.5])
DIST = np.array([0.9, 0.1])
X0 = 1e-4


def _jrhs(t, g, args):
    return (1.0 - g) * jnp.asarray(BETAS) * jnp.dot(jnp.asarray(DIST), g)


_TB, _TD = torch.tensor(BETAS), torch.tensor(DIST)


def _trhs(t, g, args):
    return (1.0 - g) * _TB * torch.dot(_TD, g)


def _logistic_j(t, y, beta):
    return beta * y * (1.0 - y)


def _logistic_t(t, y, beta):
    return beta * y * (1.0 - y)


def _grid(n, t1=44.0):
    return np.linspace(0.0, t1, n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("substeps", [1, 3])
def test_rk4_matches_reference(substeps):
    ts = _grid(129)
    want, jh = jode.rk4(_jrhs, jnp.full(2, X0), jnp.asarray(ts), substeps=substeps, with_health=True)
    got, th = tode.rk4(_trhs, torch.full((2,), X0, dtype=torch.float64), torch.tensor(ts),
                       substeps=substeps, with_health=True)
    assert got.shape == want.shape == (129, 2)
    assert np.abs(_np(got) - _np(want)).max() <= F64_TOL
    assert int(th.flags) == int(jh.flags) == 0
    assert int(th.iterations) == int(jh.iterations) == 128 * substeps


def test_rk4_health_flags_nan_input():
    ts = _grid(17)
    y0 = np.array([np.nan, X0])
    _, jh = jode.rk4(_jrhs, jnp.asarray(y0), jnp.asarray(ts), with_health=True)
    _, th = tode.rk4(_trhs, torch.tensor(y0), torch.tensor(ts), with_health=True)
    assert int(th.flags) == int(jh.flags) != 0


def _bs32_pair(n, max_steps=32, t1=44.0):
    ts = _grid(n, t1)
    want, jh = jode.bs32(_jrhs, jnp.full(2, X0), jnp.asarray(ts), with_health=True,
                         max_steps_per_interval=max_steps)
    got, th = tode.bs32(_trhs, torch.full((2,), X0, dtype=torch.float64), torch.tensor(ts),
                        with_health=True, max_steps_per_interval=max_steps)
    return want, jh, got, th


@pytest.mark.parametrize("n", [65, 257])
def test_bs32_matches_reference_within_the_stated_spread(n):
    want, jh, got, th = _bs32_pair(n)
    assert got.shape == want.shape == (n, 2)
    assert int(th.flags) == int(jh.flags)
    assert np.abs(_np(got) - _np(want)).max() <= BS32_TOL
    ref_count = int(jh.iterations)
    assert abs(int(th.iterations) - ref_count) <= BS32_COUNT_SPREAD * ref_count


def test_bs32_short_horizon_matches_exactly():
    want, jh, got, th = _bs32_pair(10, t1=44.0 * 9 / 256)
    assert np.abs(_np(got) - _np(want)).max() <= 1e-15
    assert int(th.iterations) == int(jh.iterations)


def test_bs32_budget_flag_matches_reference():
    # four attempts an interval cannot follow the fast group: intervals
    # end in the unchecked bridge and raise ODE_BUDGET, in both packages
    ts = _grid(33)
    want, jh = jode.bs32(_jrhs, jnp.full(2, X0), jnp.asarray(ts), with_health=True,
                         max_steps_per_interval=2)
    got, th = tode.bs32(_trhs, torch.full((2,), X0, dtype=torch.float64), torch.tensor(ts),
                        with_health=True, max_steps_per_interval=2)
    assert int(jh.flags) & ODE_BUDGET
    assert int(th.flags) == int(jh.flags)
    assert int(th.iterations) == int(jh.iterations)


def _op_by_op(fn):
    with jax.disable_jit():
        return fn()


def test_bs32_zero_width_intervals_equal_op_by_op_reference():
    ts = np.sort(np.concatenate([_grid(20, 10.0), [2.5, 2.5, 7.0]]))
    want, jh = _op_by_op(lambda: jode.bs32(
        _logistic_j, jnp.asarray(X0), jnp.asarray(ts), args=jnp.asarray(1.5), with_health=True))
    got, th = tode.bs32(_logistic_t, torch.tensor(X0, dtype=torch.float64), torch.tensor(ts),
                        args=torch.tensor(1.5, dtype=torch.float64), with_health=True)
    assert _np(got).tobytes() == _np(want).tobytes()
    assert int(th.iterations) == int(jh.iterations)
    assert int(th.flags) == int(jh.flags)


def test_bs32_lanes_are_the_reference_per_lane_and_batch_invariant():
    ts = _grid(25, 15.0)
    betas = np.array([0.5, 3.0, 20.0])
    y0 = torch.full((3,), X0, dtype=torch.float64)
    got, th = tode.bs32(_logistic_t, y0, torch.tensor(ts), args=torch.tensor(betas),
                        with_health=True, lane_ndim=1, max_steps_per_interval=8)
    assert got.shape == (3, 25)
    assert int(th.flags[2]) & ODE_BUDGET  # the fast lane runs out of attempts
    for i, b in enumerate(betas):
        want, jh = _op_by_op(lambda: jode.bs32(
            _logistic_j, jnp.asarray(X0), jnp.asarray(ts), args=jnp.asarray(b),
            with_health=True, max_steps_per_interval=8))
        assert _np(got[i]).tobytes() == _np(want).tobytes()
        assert int(th.iterations[i]) == int(jh.iterations)
        assert int(th.flags[i]) == int(jh.flags)
        alone, h = tode.bs32(_logistic_t, torch.tensor(X0, dtype=torch.float64),
                             torch.tensor(ts), args=torch.tensor(b, dtype=torch.float64),
                             with_health=True, max_steps_per_interval=8)
        assert torch.equal(alone, got[i])
        assert int(h.iterations) == int(th.iterations[i]) and int(h.flags) == int(th.flags[i])
