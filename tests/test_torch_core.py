"""The port's numerics substrate (sbr_tpu_torch.core, diag.health) against
sbr_tpu's, on the CPU.

Contracts:

- `linspace` equals ``jnp.linspace`` bit for bit on every grid the solver
  builds (start 0; float32 and float64; n 512, 1024, 4096), and within
  one ulp from other starts;
- the interpolators, the crossing scans and the crossing interpolation
  equal sbr_tpu's bit for bit on the same inputs (the same IEEE
  operations); the cumulative quadratures agree within 16 ulp of the
  integral's largest value (measured: 5; ``torch.cumsum`` sums in another
  order than XLA's scan);
- `threshold_crossings_masked` equals the port's own scan pair bit for
  bit, including NaN poison and the fallback rungs (the proofs of
  tests/test_numerics.py, mirrored);
- `bisect` and `chandrupatla` equal sbr_tpu's bit for bit, per-lane
  iteration counts included, when the function rounds the same way in
  both (XLA fuses ``x·x − c`` into one multiply-add inside its loops, so
  the port's test functions call the exact FMA); `chandrupatla` agrees
  with `bisect` to 1e-10 and does not depend on how often the host
  checks for active lanes;
- `Health` merges, re-keys and summarizes as sbr_tpu's does.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sbr_tpu.core import integrate as ji  # noqa: E402
from sbr_tpu.core import rootfind as jr  # noqa: E402
from sbr_tpu.diag import health as jh  # noqa: E402
from sbr_tpu_torch.core import integrate as ti  # noqa: E402
from sbr_tpu_torch.core import rootfind as tr  # noqa: E402
from sbr_tpu_torch.diag import health as th  # noqa: E402
from sbr_tpu_torch.social.fused import _fma  # noqa: E402

# both packages export a function `interp` that shadows the module
jp = importlib.import_module("sbr_tpu.core.interp")
tp = importlib.import_module("sbr_tpu_torch.core.interp")

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.tobytes()


# -- linspace -----------------------------------------------------------------


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
@pytest.mark.parametrize("n", [512, 1024, 4096])
def test_linspace_bitwise_on_solver_grids(np_dtype, t_dtype, n):
    """Learning grids (0, 2η), hazard grids (0, η) at the η's the sweeps
    pin, the warp's quantile axis (0, 1). torch.linspace misses these."""
    for stop in (30.0, 15.0, 1.0, 5.0, 0.15, 7.3, 1e4):
        want = np.asarray(jnp.linspace(np_dtype(0.0), np_dtype(stop), n, dtype=np_dtype))
        got = tp.linspace(0.0, stop, n, t_dtype)
        assert _bits(got) == want.tobytes(), stop
    torch_misses = torch.linspace(0.0, 15.0, n, dtype=t_dtype).numpy() != np.asarray(
        jnp.linspace(np_dtype(0.0), np_dtype(15.0), n, dtype=np_dtype))
    assert torch_misses.any()


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_linspace_rows_and_other_starts(np_dtype, t_dtype):
    """A row of stops gives one grid per row, each the scalar grid; a start
    other than 0 is within one ulp (XLA's vector and tail loops round the
    `1 − i·r` term apart)."""
    stops = np.asarray([15.0, 7.5, 0.3], np_dtype)
    got = tp.linspace(0.0, _t(stops, t_dtype).unsqueeze(-1), 1024, t_dtype)
    assert got.shape == (3, 1, 1024)
    for k, s in enumerate(stops):
        assert _bits(got[k, 0]) == np.asarray(jnp.linspace(np_dtype(0), s, 1024, dtype=np_dtype)).tobytes()
    for start, stop in ((0.001, 0.2), (0.5, 4.0), (-3.0, 7.5)):
        want = np.asarray(jnp.linspace(np_dtype(start), np_dtype(stop), 1024, dtype=np_dtype))
        got = tp.linspace(start, stop, 1024, t_dtype).numpy()
        ulp = np.spacing(np.abs(want).astype(np_dtype))
        assert np.all(np.abs(got - want) <= ulp)


# -- interpolation ------------------------------------------------------------


def test_interpolators_bitwise():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0.0, 10.0, 200))
    xp[50] = xp[49]  # a duplicate knot, as in the warped grid
    fp = np.sin(xp)
    x = rng.uniform(-1.0, 11.0, 300)
    assert _bits(tp.interp(_t(x), _t(xp), _t(fp))) == np.asarray(jp.interp(x, xp, fp)).tobytes()
    assert _bits(tp.interp_shared(_t(x), _t(xp), _t(fp))) == np.asarray(
        jp.interp_shared(x, xp, fp)).tobytes()
    guess = np.clip(np.searchsorted(xp, x) + rng.integers(-1, 2, x.size), 0, 199)
    assert _bits(tp.interp_guided(_t(x), _t(xp), _t(fp), torch.as_tensor(guess))) == np.asarray(
        jp.interp_guided(x, xp, fp, guess)).tobytes()
    grid = np.linspace(0.0, 10.0, 101)
    rows = np.stack([np.cos(grid), np.exp(-grid)])
    got = tp.interp_uniform(_t(x), _t(0.0), _t(0.1), _t(rows).unsqueeze(1))
    for k in range(2):
        want = np.asarray(jp.interp_uniform(x, 0.0, 0.1, rows[k]))
        assert _bits(got[k]) == want.tobytes()


def test_take_last_and_row_search():
    table = torch.arange(24, dtype=torch.float64).reshape(2, 1, 12)
    idx = torch.tensor([[0, 3, 11], [5, 5, 1]])
    got = tp.take_last(table, idx)
    assert got.tolist() == [[0.0, 3.0, 11.0], [17.0, 17.0, 13.0]]
    seq = torch.tensor([[0.0, 1.0, 1.0, 2.0], [0.0, 5.0, 6.0, 7.0]]).unsqueeze(1)
    vals = torch.tensor([[1.0, 0.5, 3.0], [5.0, 6.5, -1.0]])
    want = [np.searchsorted(seq[k, 0].numpy(), vals[k].numpy(), side="right").tolist() for k in range(2)]
    assert tp.searchsorted_right(seq, vals).tolist() == want
    assert tp.searchsorted_right(seq[0, 0], vals).tolist() == np.searchsorted(
        seq[0, 0].numpy(), vals.numpy(), side="right").tolist()


# -- quadrature ---------------------------------------------------------------


def _within_ulps(got, want, k):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.spacing(np.abs(want).max())
    assert np.all(np.abs(got - want) <= k * scale), np.abs(got - want).max() / scale


def test_quadratures_within_ulps():
    x = np.linspace(0.0, 15.0, 512)
    y = np.exp(0.01 * x) / (1.0 + np.exp(-(x - 7.0)))
    _within_ulps(ti.trapz(_t(y), x=_t(x)), ji.trapz(y, x=x), 4)
    out, h = ti.cumtrapz(_t(y), x=_t(x), with_health=True)
    jout, jhh = ji.cumtrapz(jnp.asarray(y), x=jnp.asarray(x), with_health=True)
    _within_ulps(out, jout, 16)
    assert int(h.flags) == int(jhh.flags) == 0 and int(h.iterations) == int(jhh.iterations)

    def f_j(t):
        return jnp.exp(0.01 * t) / (1.0 + jnp.exp(-(t - 7.0)))

    def f_t(t):
        return torch.exp(0.01 * t) / (1.0 + torch.exp(-(t - 7.0)))

    for order in (1, 4, 8):
        out, h = ti.cumulative_gauss_legendre(f_t, _t(x), order=order, with_health=True)
        jout, jhh = ji.cumulative_gauss_legendre(f_j, jnp.asarray(x), order=order, with_health=True)
        _within_ulps(out, jout, 16)
        assert int(h.flags) == int(jhh.flags) and int(h.iterations) == int(jhh.iterations)


def test_quadrature_health_flags_nan():
    y = np.ones(32)
    y[7] = np.nan
    _, h = ti.cumtrapz(_t(y), dx=0.1, with_health=True)
    _, jhh = ji.cumtrapz(jnp.asarray(y), dx=0.1, with_health=True)
    assert int(h.flags) == int(jhh.flags) == th.NAN_INPUT | th.NAN_OUTPUT


# -- crossings ----------------------------------------------------------------


def _scan_pair(x, y, level, default):
    t_in, has_up, h_in = tr.first_upcrossing(x, y, level, default, return_flag=True, with_health=True)
    t_out, has_dn, h_out = tr.last_downcrossing(x, y, level, default, return_flag=True, with_health=True)
    return t_in, has_up, t_out, has_dn, h_in, h_out


def _assert_crossings_identical(x, y, level, default):
    x, y = _t(x), _t(y)
    ref = _scan_pair(x, y, level, default)
    got = tr.threshold_crossings_masked(x, y, level, default, with_health=True)
    for name, r, g in zip(("t_in", "has_up", "t_out", "has_dn"), ref[:4], got[:4]):
        assert _bits(r) == _bits(g), f"{name}: scan={r} blocked={g}"
    for name, r, g in zip(("h_in", "h_out"), ref[4:], got[4:]):
        assert _bits(r.flags) == _bits(g.flags), name
    return ref


class TestMaskedCrossings:
    @pytest.mark.parametrize("n", [17, 100, 256, 257, 1000])
    def test_random_curves_bit_identical(self, n):
        rng = np.random.default_rng(n)
        x = np.linspace(0.0, 10.0, n)
        for _ in range(5):
            y = np.cumsum(rng.normal(size=n))
            level = float(np.quantile(y, rng.uniform(0.05, 0.95)))
            _assert_crossings_identical(x, y, level, 10.0)

    def test_hazard_shaped_curve(self):
        x = np.linspace(0.0, 15.0, 512)
        y = np.exp(-0.5 * (x - 6.0) ** 2) * 0.8
        for level in [-0.1, 0.0, 0.2, 0.5, 0.79999, 0.8, 0.9]:
            _assert_crossings_identical(x, y, level, 15.0)

    def test_fallback_rungs_and_flags(self):
        x = _t(np.linspace(0.0, 1.0, 64))
        got = tr.threshold_crossings_masked(x, torch.full((64,), 2.0, dtype=torch.float64), 1.0, 9.0,
                                            with_health=True)
        assert float(got[0]) == 0.0 and float(got[2]) == 1.0
        assert int(got[4].flags) & th.FALLBACK_IN_KNOT
        got2 = tr.threshold_crossings_masked(x, torch.zeros(64, dtype=torch.float64), 1.0, 9.0,
                                             with_health=True)
        assert float(got2[0]) == float(got2[2]) == 9.0
        assert int(got2[4].flags) & th.FALLBACK_IN_DEFAULT
        _assert_crossings_identical(np.linspace(0.0, 1.0, 64), np.zeros(64), 1.0, 9.0)

    def test_nan_poison_bit_identical(self):
        x = np.linspace(0.0, 1.0, 128)
        y = np.sin(x * 7.0)
        for poison in [slice(0, 5), slice(60, 70), slice(120, 128)]:
            yp = y.copy()
            yp[poison] = np.nan
            _assert_crossings_identical(x, yp, 0.3, 2.0)
        _assert_crossings_identical(x, np.full(128, np.nan), 0.3, 2.0)
        _assert_crossings_identical(x, y, np.nan, 2.0)
        got = tr.threshold_crossings_masked(_t(x), _t(np.full(128, np.nan)), 0.3, 2.0, with_health=True)
        assert int(got[4].flags) & th.NAN_INPUT

    def test_exact_knot_touch(self):
        x = np.linspace(0.0, 1.0, 33)
        y = np.zeros(33)
        y[10:20] = 1.0
        y[15] = 0.5
        _assert_crossings_identical(x, y, 0.5, 3.0)
        _assert_crossings_identical(x, y, 1.0, 3.0)

    def test_rows_of_cells(self):
        """The sweep layout: curves of shape (rows, 1, n) against levels of
        shape (rows, cells) equal the scan, cell by cell."""
        rng = np.random.default_rng(7)
        x = _t(np.linspace(0.0, 5.0, 200))
        ys = _t(np.cumsum(rng.normal(size=(3, 200)), axis=-1)).unsqueeze(1)
        levels = _t(rng.normal(size=(3, 8)))
        blocked = tr.threshold_crossings_masked(x, ys, levels, 5.0)
        for k in range(3):
            for c in range(8):
                ref = _scan_pair(x, ys[k, 0], levels[k, c], 5.0)
                for r, g in zip(ref[:4], blocked):
                    assert _bits(r) == _bits(g[k, c])


def test_scan_pair_equals_reference_bitwise():
    """Same curve, same level: the reference's crossing values, flags and
    fallback rungs, bit for bit."""
    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 15.0, 300)
    for trial in range(6):
        y = np.cumsum(rng.normal(size=300))
        if trial == 5:
            y[40:60] = np.nan
        level = float(np.quantile(y[np.isfinite(y)], 0.3 + 0.1 * trial))
        ours = _scan_pair(_t(x), _t(y), level, 15.0)
        t_in, up, h_in = jr.first_upcrossing(x, y, level, 15.0, return_flag=True, with_health=True)
        t_out, dn, h_out = jr.last_downcrossing(x, y, level, 15.0, return_flag=True, with_health=True)
        for r, g in zip((t_in, up, t_out, dn), ours[:4]):
            assert np.asarray(r).tobytes() == _bits(g)
        assert int(h_in.flags) == int(ours[4].flags) and int(h_out.flags) == int(ours[5].flags)


def test_argmax_of_masks_takes_the_first_true():
    """The tie-break every crossing index rests on: the first maximal
    index of a uint8 view, 0 for an all-False row, as jnp.argmax."""
    m = torch.tensor([[0, 1, 1, 0, 1], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]], dtype=torch.bool)
    assert tr._first_true(m).tolist() == [1, 0, 0, 4]
    assert tr._last_true(m).tolist() == [4, 4, 4, 4]
    assert tr._first_true(m).tolist() == np.asarray(jnp.argmax(jnp.asarray(m.numpy()), axis=-1)).tolist()


# -- root-finds ---------------------------------------------------------------

CS = np.linspace(0.5, 8.0, 64)


def _batteries():
    tcs = _t(CS)
    # (name, jax f, port f with XLA's loop-body multiply-add, hi)
    return [
        ("cube", lambda x: x * x * x - CS, lambda x: _fma(x * x, x, -tcs), 2.5),
        ("square", lambda x: x * x - CS, lambda x: _fma(x, x, -tcs), 3.0),
        ("logistic", lambda x: 1.0 / (1.0 + jnp.exp(-CS * x)) - 0.7,
         lambda x: 1.0 / (1.0 + torch.exp(-tcs * x)) - 0.7, 9.0),
    ]


@pytest.mark.parametrize("which", [0, 1])
def test_rootfinds_bitwise_with_equal_function_values(which):
    name, jf, tf, hi = _batteries()[which]
    lo_t, hi_t = torch.zeros(64, dtype=torch.float64), torch.full((64,), hi, dtype=torch.float64)
    jx, jhh = jax.jit(lambda: jr.chandrupatla(jf, jnp.zeros(64), jnp.full(64, hi), budget=90,
                                              with_health=True))()
    x, h = tr.chandrupatla(tf, lo_t, hi_t, budget=90, with_health=True)
    assert np.asarray(jx).tobytes() == _bits(x)
    assert np.asarray(jhh.iterations).tolist() == h.iterations.tolist()
    assert np.asarray(jhh.flags).tolist() == h.flags.tolist()
    bx, bh = jax.jit(lambda: jr.bisect(jf, jnp.zeros(64), jnp.full(64, hi), num_iters=90,
                                       with_health=True))()
    x, h = tr.bisect(tf, lo_t, hi_t, num_iters=90, with_health=True)
    assert np.asarray(bx).tobytes() == _bits(x)
    assert np.asarray(bh.flags).tolist() == h.flags.tolist()
    assert h.iterations.tolist() == [90] * 64


def test_chandrupatla_agrees_with_bisect():
    for _, _, tf, hi in _batteries():
        lo_t, hi_t = torch.zeros(64, dtype=torch.float64), torch.full((64,), hi, dtype=torch.float64)
        xb = tr.bisect(tf, lo_t, hi_t, num_iters=90)
        xc, h = tr.chandrupatla(tf, lo_t, hi_t, budget=90, with_health=True)
        np.testing.assert_allclose(xc.numpy(), xb.numpy(), rtol=0, atol=1e-10)
        assert h.iterations.max() < 40


def test_chandrupatla_does_not_depend_on_the_host_check(monkeypatch):
    """Frozen lanes keep their state: checking for active lanes every
    iteration, every 4th or never gives the same bits and counts."""
    _, _, tf, hi = _batteries()[2]
    lo_t, hi_t = torch.zeros(64, dtype=torch.float64), torch.full((64,), hi, dtype=torch.float64)
    runs = []
    for every in (1, 4, 1000):
        monkeypatch.setattr(tr, "CHECK_EVERY", every)
        x, h = tr.chandrupatla(tf, lo_t, hi_t, budget=90, with_health=True)
        runs.append((_bits(x), h.iterations.tolist(), _bits(h.residual)))
    assert runs[0] == runs[1] == runs[2]


def test_chandrupatla_degenerate_brackets():
    x, h = tr.chandrupatla(lambda x: x * x + 1.0, _t(-2.0), _t(2.0), budget=50, with_health=True)
    assert int(h.flags) & th.NO_BRACKET and -2.0 <= float(x) <= 2.0
    _, h = tr.chandrupatla(lambda x: x - 0.5, _t(np.nan), _t(2.0), budget=20, with_health=True)
    assert int(h.flags) & th.NAN_INPUT
    x = tr.chandrupatla(lambda x: x * x - 2.0, _t(0.0), _t(2.0), x0=_t(1.5))
    assert float(x) == pytest.approx(np.sqrt(2.0), abs=1e-12)
    cs = _t([1.0, 1.0 + 1e-14])
    _, h = tr.chandrupatla(lambda x: x - cs, torch.zeros(2, dtype=torch.float64),
                           torch.full((2,), 100.0, dtype=torch.float64), budget=90, with_health=True)
    assert h.iterations[0] <= h.iterations[1] <= 90


def test_nan_sign_as_jax():
    """jnp.sign keeps NaN; torch.sign maps it to 0, which would make a NaN
    lane 'same sign' as a zero."""
    v = _t([np.nan, 0.0, -2.0, 3.0])
    got = tr._sign(v).numpy()
    want = np.asarray(jnp.sign(jnp.asarray(v.numpy())))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[1:], want[1:])


# -- health -------------------------------------------------------------------


def test_health_bits_and_merge_match_reference():
    for name in ("FALLBACK_IN_KNOT", "NO_BRACKET", "NAN_INPUT", "FP_ABORTED", "ODE_BUDGET",
                 "GRAD_NONFINITE", "DIVERGENT_MASK"):
        assert getattr(th, name) == getattr(jh, name)
    assert th.FLAG_NAMES == jh.FLAG_NAMES
    a = th.Health(_t([1e-9, np.nan]), _t([0.1, 0.2]), torch.tensor([3, 4], dtype=torch.int32),
                  torch.tensor([th.FALLBACK_IN_KNOT, th.NAN_INPUT], dtype=torch.int32))
    b = th.Health(_t([np.nan, 1e-3]), _t([0.3, np.nan]), torch.tensor([90, 90], dtype=torch.int32),
                  torch.tensor([th.FALLBACK_IN_DEFAULT, 0], dtype=torch.int32))
    ja = jh.Health(*(jnp.asarray(getattr(a, f).numpy()) for f in ("residual", "bracket_width", "iterations", "flags")))
    jb = jh.Health(*(jnp.asarray(getattr(b, f).numpy()) for f in ("residual", "bracket_width", "iterations", "flags")))
    m, jm = a.merge(th.as_out_crossing(b)), ja.merge(jh.as_out_crossing(jb))
    for f in ("residual", "bracket_width", "iterations", "flags"):
        assert _bits(getattr(m, f)) == np.asarray(getattr(jm, f)).tobytes(), f
    assert int(th.or_reduce_flags(m.flags)) == int(jh.or_reduce_flags(jm.flags))
    status = np.asarray([0, 2])
    assert th.summarize(m, status) == jh.summarize(jm, status)
    assert th.summarize(m) == jh.summarize(jm)
