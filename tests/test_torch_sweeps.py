"""The port's sweeps (sbr_tpu_torch.sweeps.baseline_sweeps) against
sbr_tpu's, on the CPU, at n_grid 512.

Grids: the 12×12 β/u axes of tests/test_numerics.py, and a 12×12 subgrid
of the Figure-5 tile (β = 1/amt with amt = linspace(1e-4, 1, 500), so β
reaches 10^4, where the warped grid and the float32 saturation guard
matter; u = linspace(0.001, 1, 500)). Both share one compiled reference
program per (numerics, dtype).

Contracts, port against live sbr_tpu:

- status grids and ``Health.flags`` exact in float64 and float32
  (measured: no differing cell here, nor on a 100×100 Figure-5 subgrid at
  n_grid 1024 in either dtype); the fixed path's iteration counts exact;
- ξ and AW_max within the scalar tolerances of
  tests/test_torch_baseline.py (float64 1e-12, measured 3.6e-15; float32
  2e-5, measured 1.9e-6; tests/torch_parity_report.py prints them);
- adaptive iteration counts equal on at least 80% of the cells and their
  mean within 10% (measured: 88-96% equal, means within 7%): XLA's ``exp``
  rounds apart from glibc's on ~15% of float64 arguments, and the
  Chandrupatla stopping test is decided in the last bits.

And the port's own invariants: fixed and adaptive give equal statuses and
ξ within 1e-10 (sbr_tpu's relation, tests/test_numerics.py); a β×u grid
equals the same cells solved row by row or as independent lanes, bit for
bit (cells do not depend on the batching).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.baseline.learning import solve_learning as j_solve_learning  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.sweeps import baseline_sweeps as jsw  # noqa: E402
from sbr_tpu_torch.baseline.learning import solve_learning  # noqa: E402
from sbr_tpu_torch.diag.health import summarize  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.sweeps import baseline_sweeps as tsw  # noqa: E402
from sbr_tpu_torch.utils.status import status_counts  # noqa: E402

CPU = "cpu"
TOL = {np.float64: 1e-12, np.float32: 2e-5}
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
MODES = ["fixed", "adaptive"]

_IDX = np.linspace(0, 499, 12).astype(int)
AXES = {
    "golden": (np.linspace(0.25, 3.0, 12), np.linspace(0.01, 0.99, 12)),
    "figure5": ((1.0 / np.linspace(1e-4, 1.0, 500))[_IDX], np.linspace(0.001, 1.0, 500)[_IDX]),
}


def _cfg(mod, mode):
    return mod.SolverConfig(n_grid=512, bisect_iters=60, refine_crossings=False, numerics=mode)


@functools.lru_cache(maxsize=None)
def _port_grid(axes, mode, t_dtype):
    betas, us = AXES[axes]
    return tsw.beta_u_grid(betas, us, tparams.make_model_params(), _cfg(tparams, mode),
                           dtype=t_dtype, device=CPU)


@functools.lru_cache(maxsize=None)
def _ref_grid(axes, mode, np_dtype):
    betas, us = AXES[axes]
    return jsw.beta_u_grid(betas, us, jparams.make_model_params(), config=_cfg(jparams, mode),
                           dtype=np_dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    """Bytes of a tensor: equal NaNs compare equal, unlike torch.equal."""
    return _np(x).tobytes()


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), np.abs(got[ok] - want[ok]).max()


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axes", sorted(AXES))
def test_grid_matches_reference(axes, mode, np_dtype, t_dtype):
    g = _port_grid(axes, mode, t_dtype)
    j = _ref_grid(axes, mode, np_dtype)
    assert g.status.shape == (12, 12) and g.status.dtype == torch.int32
    assert g.xi.dtype == t_dtype and g.xi.device.type == "cpu"
    diff = np.argwhere(_np(g.status) != np.asarray(j.status))
    assert diff.size == 0, f"differing cells {diff.tolist()}"
    assert np.array_equal(_np(g.health.flags), np.asarray(j.health.flags))
    _close(g.xi, j.xi, TOL[np_dtype])
    _close(g.max_aw, j.max_aw, TOL[np_dtype])
    it, jit_ = _np(g.health.iterations), np.asarray(j.health.iterations)
    if mode == "fixed":
        assert np.array_equal(it, jit_) and it.min() == 60
    else:
        assert (it == jit_).mean() >= 0.8
        assert abs(it.mean() - jit_.mean()) <= 0.1 * jit_.mean()
    assert status_counts(g.status) == status_counts(j.status)
    ours, theirs = summarize(g.health, g.status), summarize(j.health, j.status)
    for key in ("cells", "divergent", "flag_counts"):
        assert ours[key] == theirs[key]


def test_figure5_subgrid_exercises_the_high_beta_columns():
    g = _port_grid("figure5", "fixed", torch.float32)
    assert float(g.beta_values.max()) == pytest.approx(1e4)
    counts = status_counts(g.status)
    assert counts["RUN"] > 0 and counts["NO_CROSSING"] > 0


@pytest.mark.parametrize("axes", sorted(AXES))
def test_fixed_and_adaptive_agree(axes):
    fixed = _port_grid(axes, "fixed", torch.float64)
    adaptive = _port_grid(axes, "adaptive", torch.float64)
    assert torch.equal(fixed.status, adaptive.status)
    _close(adaptive.xi, fixed.xi, 1e-10)
    assert adaptive.health.iterations.double().mean() < 0.5 * fixed.health.iterations.double().mean()


@pytest.mark.parametrize("mode", MODES)
def test_cells_do_not_depend_on_the_batching(mode):
    """The whole grid, its β rows in two halves, and every cell as an
    independent lane (the layout a server would batch): equal bit for bit."""
    betas, us = AXES["figure5"]
    cfg = _cfg(tparams, mode)
    base = tparams.make_model_params()
    whole = _port_grid("figure5", mode, torch.float64)
    halves = [tsw.beta_u_grid(b, us, base, cfg, device=CPU) for b in (betas[:5], betas[5:])]
    for f in ("xi", "max_aw", "status"):
        assert _bits(getattr(whole, f)) == _bits(torch.cat([getattr(h, f) for h in halves]))
    bb, uu = np.meshgrid(betas, us, indexing="ij")
    e = base.economic
    lanes = tsw.solve_param_cell(torch.from_numpy(bb.ravel()), torch.from_numpy(uu.ravel()),
                                 e.p, e.kappa, e.lam, e.eta, 0.0, 30.0, 1e-4, cfg, device=CPU)
    for got, want in zip((lanes[0], lanes[2], lanes[3]), (whole.xi, whole.max_aw, whole.status)):
        assert _bits(got.reshape(12, 12)) == _bits(want)
    assert _bits(lanes[4].flags.reshape(12, 12)) == _bits(whole.health.flags)


@pytest.mark.parametrize("mode", MODES)
def test_u_sweep_matches_reference(mode):
    """Figure 4's sweep, one Stage 1 shared, refinement on (the scalar
    solve's SolverConfig), at n_grid 512."""
    us = np.linspace(0.001, 0.2, 40)
    tm, jm = tparams.make_model_params(), jparams.make_model_params()
    tcfg = tparams.SolverConfig(n_grid=512, numerics=mode)
    jcfg = jparams.SolverConfig(n_grid=512, numerics=mode)
    r = tsw.u_sweep(solve_learning(tm.learning, tcfg, device=CPU), us, tm.economic, tcfg)
    j = jsw.u_sweep(j_solve_learning(jm.learning, jcfg), us, jm.economic, jcfg)
    assert np.array_equal(_np(r.status), np.asarray(j.status))
    assert np.array_equal(_np(r.health.flags), np.asarray(j.health.flags))
    for f in ("collapse_times", "return_times", "max_withdrawals"):
        _close(getattr(r, f), getattr(j, f), TOL[np.float64])
    counts = status_counts(r.status)
    assert counts["RUN"] > 0 and counts["NO_CROSSING"] + counts["NO_ROOT"] > 0


def test_sharding_is_not_ported():
    """mesh= is ported (tests/test_torch_parallel.py); a mesh axis that does
    not divide its value array is refused before any collective, as
    sbr_tpu's sharding refuses it."""
    from torch_mesh import AxisStub

    m = tparams.make_model_params()
    with pytest.raises(ValueError, match="does not divide"):
        tsw.beta_u_grid([1.0], [0.1, 0.2, 0.3], m, mesh=AxisStub(b=(1, 0), u=(2, 1)))
    ls = solve_learning(m.learning, tparams.SolverConfig(n_grid=64), device=CPU)
    with pytest.raises(ValueError, match="does not divide"):
        tsw.u_sweep(ls, [0.1], m.economic, mesh=AxisStub(u=(2, 0)))


def test_program_version_is_the_reference():
    assert tsw.GRID_PROGRAM_VERSION == jsw.GRID_PROGRAM_VERSION


def test_f32_mode_disagreement_is_the_reference_s():
    """In float32, on a few cells, Chandrupatla exhausts its 90-step budget
    and stops far from the root (|AW−κ| ≈ 0.33, NO_ROOT) where the fixed
    bisection finds one (|AW−κ| < 1e-4, RUN). Two such cells of the
    Figure-5 tile, (225, 120) and (385, 70), at the sweep default n_grid
    4096: sbr_tpu does the same, and the port's statuses, residuals and
    iteration counts follow it in both modes."""
    betas500, us500 = (1.0 / np.linspace(1e-4, 1.0, 500)), np.linspace(0.001, 1.0, 500)
    betas, us = betas500[[225, 385]], us500[[120, 70]]
    ours, theirs = {}, {}
    for mode in MODES:
        ours[mode] = tsw.beta_u_grid(
            betas, us, tparams.make_model_params(),
            tparams.SolverConfig(refine_crossings=False, numerics=mode),
            dtype=torch.float32, device=CPU)
        theirs[mode] = jsw.beta_u_grid(
            betas, us, jparams.make_model_params(),
            config=jparams.SolverConfig(refine_crossings=False, numerics=mode),
            dtype=np.float32)
        assert np.array_equal(_np(ours[mode].status), np.asarray(theirs[mode].status))
        assert np.array_equal(_np(ours[mode].health.iterations),
                              np.asarray(theirs[mode].health.iterations))
        _close(ours[mode].health.residual, theirs[mode].health.residual, TOL[np.float32])
    diagonal = [(0, 0), (1, 1)]
    for c in diagonal:
        assert int(ours["fixed"].status[c]) == 0 and float(ours["fixed"].health.residual[c]) < 1e-4
        assert int(ours["adaptive"].status[c]) == 2 and int(ours["adaptive"].health.iterations[c]) == 90
        assert float(ours["adaptive"].health.residual[c]) > 0.3
