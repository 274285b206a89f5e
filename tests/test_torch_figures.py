"""The port's figure layer (sbr_tpu_torch.figures) against sbr_tpu's, on
the CPU.

Figures are compared by their DATA, never by PDF bytes: each saved figure
is reduced to its axes' line data (``get_xydata``), mesh arrays, axis
limits and texts, captured by wrapping each package's ``master._save``.

Contracts, in float64 (conftest pins fixed numerics):

- every builder's data equals the reference builder's on the two
  packages' solves within F64_TOL = 1e-12 (the slice-3 contract; measured
  spreads of the solves are ~1e-14, tests/test_torch_baseline.py), texts
  equal;
- the golden figure scalars of tests/test_golden_figures.py at its pins
  and tolerances;
- ``master --fast --device cpu`` against ``sbr_tpu``'s ``master --fast``,
  section by section: the printed manifest (statuses through the status
  summaries, the fixed-point iterations at Figure 12 — 50 under the
  suite's fixed numerics, 45 adaptive — ξ and Δξ) line for
  line, figure data within 1e-12, the closure's agent curves bit for bit
  (the host graph needs the reference's numpy edge stream,
  ``SBR_NATIVE=0``; where the two fixed points' windows round apart, the
  reference's fixed point is carried across, as in
  tests/test_torch_closure.py);
- ``--f32`` (Section 1) against the reference with x64 off: statuses equal,
  floats within F32_TOL = 2e-5 (the slice-3 float32 contract);
- the paper path as tests/test_master_cli.py drives it: 9 tiles, a resume
  of 7, the tex naming the large heatmap, AW_max within 2e-5 of the
  reference's float32 tiled run and statuses equal;
- `write_tex`'s text is the reference's apart from the title line; a
  no-run outcome skips its figure without counting as missing;
  ``--device cuda`` without a card exits non-zero; the default output is
  ``output_torch/``, never the reference's committed ``output/``.
"""

import contextlib
import dataclasses
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import matplotlib  # noqa: E402

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from sbr_tpu import figures as jfig  # noqa: E402
from sbr_tpu.baseline import learning as jl  # noqa: E402
from sbr_tpu.baseline import solver as js  # noqa: E402
from sbr_tpu.figures import master as jmaster  # noqa: E402
from sbr_tpu.figures import plotting as jplot  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.social import closure as jclosure  # noqa: E402
from sbr_tpu.social import solver as jsocial  # noqa: E402
from sbr_tpu.utils import checkpoint as jckpt  # noqa: E402
from sbr_tpu_torch import figures as tfig  # noqa: E402
from sbr_tpu_torch.baseline import learning as tl  # noqa: E402
from sbr_tpu_torch.baseline import solver as ts  # noqa: E402
from sbr_tpu_torch.figures import master as tmaster  # noqa: E402
from sbr_tpu_torch.figures import plotting as tplot  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.social import closure as tclosure  # noqa: E402
from sbr_tpu_torch.social import solver as tsocial  # noqa: E402
from sbr_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

CPU = "cpu"
F64_TOL = 1e-12
F32_TOL = 2e-5
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
SECTIONS = (1, 2, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the closure runs the
    agent engines on the CPU; see tests/test_torch_closure.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Figure data
# ---------------------------------------------------------------------------


def fig_data(fig) -> list:
    """Per axes: its lines' (label, xy), its meshes' arrays and
    coordinates, its limits and its texts (annotations included)."""
    out = []
    for ax in fig.axes:
        meshes = [(np.asarray(c.get_array(), dtype=np.float64),
                   np.asarray(c.get_coordinates(), dtype=np.float64))
                  for c in ax.collections if hasattr(c, "get_coordinates")]
        out.append({
            "title": ax.get_title(),
            "lines": [(ln.get_label(), np.asarray(ln.get_xydata(), dtype=np.float64))
                      for ln in ax.get_lines()],
            "meshes": meshes,
            "xlim": np.asarray(ax.get_xlim(), dtype=np.float64),
            "ylim": np.asarray(ax.get_ylim(), dtype=np.float64),
            "texts": [t.get_text() for t in ax.texts],
        })
    return out


def _gap(a, b) -> float:
    """Largest |a − b| over the finite entries; the non-finite entries
    (NaN, ±inf) must sit in the same places with the same values."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    ok = np.isfinite(a)
    assert np.array_equal(ok, np.isfinite(b)), "non-finite patterns differ"
    assert np.array_equal(a[~ok], b[~ok], equal_nan=True)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def assert_same_figure(got: list, want: list, tol: float, texts: bool = True) -> float:
    """Every array of the two figures' data within ``tol`` (NaNs by
    position); labels, titles and (when ``texts``) texts equal. Returns
    the largest gap."""
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert [lbl for lbl, _ in g["lines"]] == [lbl for lbl, _ in w["lines"]]
        for (_, a), (_, b) in zip(g["lines"], w["lines"]):
            worst = max(worst, _gap(a, b))
        assert len(g["meshes"]) == len(w["meshes"])
        for (va, ca), (vb, cb) in zip(g["meshes"], w["meshes"]):
            worst = max(worst, _gap(va, vb), _gap(ca, cb))
        worst = max(worst, _gap(g["xlim"], w["xlim"]), _gap(g["ylim"], w["ylim"]))
        if texts:
            assert g["texts"] == w["texts"] and g["title"] == w["title"]
    assert worst <= tol, worst
    return worst


def _close(fig) -> list:
    data = fig_data(fig)
    plt.close(fig)
    return data


@contextlib.contextmanager
def captured(module, monkeypatch):
    """Record every figure ``module.main`` saves: {figure-relative path: data}."""
    seen = {}
    save = module._save

    def recording(fig, path):
        parts = Path(path).parts
        seen["/".join(parts[parts.index("figures") + 1:])] = fig_data(fig)
        save(fig, path)

    monkeypatch.setattr(module, "_save", recording)
    yield seen
    monkeypatch.setattr(module, "_save", save)


def as_numpy(obj):
    """A reference result as nested numpy (`fixed_point_from_numpy`'s input)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


def _record(monkeypatch, module, name, store):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.setdefault(name, []).append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


_MASK = [
    (re.compile(r"(section|paper heatmap) time: [0-9.]+s"), r"\1 time: -"),
    (re.compile(r"Total execution time: [0-9.]+ seconds"), "Total execution time: -"),
]


def _manifest_lines(text: str, root: Path) -> list:
    """The printed manifest with the output root and the times masked."""
    lines = []
    for line in text.replace(str(root), "OUT").splitlines():
        for pat, sub in _MASK:
            line = pat.sub(sub, line)
        lines.append(line)
    return lines


def _run(module, argv, monkeypatch, root: Path):
    """``module.main(argv)`` with its figures, its printout and the solves
    of interest recorded."""
    rec = {}
    mods = ((jsocial, jclosure, jckpt) if module is jmaster
            else (tsocial, tclosure, tckpt))
    _record(monkeypatch, mods[0], "solve_equilibrium_social", rec)
    _record(monkeypatch, mods[1], "close_loop", rec)
    _record(monkeypatch, mods[2], "run_tiled_grid", rec)
    buf = io.StringIO()
    with captured(module, monkeypatch) as figs, contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, figs, _manifest_lines(buf.getvalue(), root), rec


# ---------------------------------------------------------------------------
# The builders
# ---------------------------------------------------------------------------

JCFG = jparams.SolverConfig(n_grid=512, bisect_iters=60)
TCFG = tparams.SolverConfig(n_grid=512, bisect_iters=60)


@pytest.fixture(scope="module")
def baseline_solved():
    jm, tm = jparams.make_model_params(), tparams.make_model_params()
    jls = jl.solve_learning(jm.learning, JCFG)
    tls = tl.solve_learning(tm.learning, TCFG, device=CPU)
    jres = js.solve_equilibrium_baseline(jls, jm.economic, JCFG)
    tres = ts.solve_equilibrium_baseline(tls, tm.economic, TCFG)
    return (jm, jls, jres), (tm, tls, tres)


def test_plot_learning_distribution(baseline_solved):
    (jm, jls, _), (tm, tls, _) = baseline_solved
    want = _close(jplot.plot_learning_distribution([jls], jm.learning.tspan, [jm.learning.beta]))
    got = _close(tplot.plot_learning_distribution([tls], tm.learning.tspan, [tm.learning.beta]))
    assert_same_figure(got, want, F64_TOL)


def test_plot_hazard_rate_decomposition(baseline_solved):
    (jm, jls, jres), (tm, tls, tres) = baseline_solved
    want = _close(jplot.plot_hazard_rate_decomposition(jres, jls, jm.economic))
    got = _close(tplot.plot_hazard_rate_decomposition(tres, tls, tm.economic))
    assert_same_figure(got, want, F64_TOL)


def test_plot_equilibrium(baseline_solved):
    (jm, jls, jres), (tm, tls, tres) = baseline_solved
    assert bool(tres.bankrun)
    want = _close(jplot.plot_equilibrium(jres, jls, jm.economic))
    got = _close(tplot.plot_equilibrium(tres, tls, tm.economic))
    assert_same_figure(got, want, F64_TOL)


def test_plot_comp_stat_panels(baseline_solved):
    from sbr_tpu.sweeps import u_sweep as ju_sweep
    from sbr_tpu_torch.sweeps import u_sweep as tu_sweep

    (jm, jls, _), (tm, tls, _) = baseline_solved
    us = np.linspace(0.01, 1.5, 64)
    jsw = ju_sweep(jls, us, jm.economic, JCFG)
    tsw = tu_sweep(tls, us, tm.economic, TCFG)
    assert np.array_equal(tsw.status.numpy(), np.asarray(jsw.status))
    want = jplot.plot_comp_stat_withdrawals_and_collapse(
        np.asarray(jsw.u_values), np.asarray(jsw.max_withdrawals),
        np.asarray(jsw.collapse_times), jm.economic.kappa,
        return_times=np.asarray(jsw.return_times))
    got = tplot.plot_comp_stat_withdrawals_and_collapse(
        tsw.u_values, tsw.max_withdrawals, tsw.collapse_times, tm.economic.kappa,
        return_times=tsw.return_times)
    for g, w in zip(got, want):
        assert_same_figure(_close(g), _close(w), F64_TOL)


def test_plot_heatmap_aw(baseline_solved):
    from sbr_tpu.sweeps import beta_u_grid as jgrid
    from sbr_tpu_torch.sweeps import beta_u_grid as tgrid

    (jm, _, _), (tm, _, _) = baseline_solved
    amt = np.linspace(0.05, 1.0, 8)
    us = np.linspace(0.01, 1.0, 8)
    jg = jgrid(1.0 / amt, us, jm, config=JCFG)
    tg = tgrid(1.0 / amt, us, tm, config=TCFG, device=CPU)
    want = _close(jplot.plot_heatmap_aw(amt, us, np.asarray(jg.max_aw).T))
    got = _close(tplot.plot_heatmap_aw(amt, us, tg.max_aw.numpy().T))
    assert_same_figure(got, want, F64_TOL)
    assert got[0]["meshes"] and want[0]["meshes"]


def test_plot_aw_hetero():
    from sbr_tpu.hetero import get_aw_hetero as jaw
    from sbr_tpu.hetero import solve_equilibrium_hetero as jsolve
    from sbr_tpu.hetero import solve_learning_hetero as jlearn
    from sbr_tpu_torch.hetero import get_aw_hetero as taw
    from sbr_tpu_torch.hetero import solve_equilibrium_hetero as tsolve
    from sbr_tpu_torch.hetero import solve_learning_hetero as tlearn

    kw = dict(betas=[0.125, 12.5], dist=[0.9, 0.1], eta_bar=30.0, u=0.1, p=0.9, kappa=0.3,
              lam=0.1)
    jm, tm = jparams.make_hetero_params(**kw), tparams.make_hetero_params(**kw)
    jlsh = jlearn(jm.learning, JCFG)
    tlsh = tlearn(tm.learning, TCFG, device=CPU)
    jres, tres = jsolve(jlsh, jm.economic, JCFG), tsolve(tlsh, tm.economic, TCFG)
    assert bool(tres.bankrun)
    want = _close(jplot.plot_aw_hetero(jres, jaw(jres, jlsh), jm.economic, jm.learning.betas))
    got = _close(tplot.plot_aw_hetero(tres, taw(tres, tlsh), tm.economic, tm.learning.betas))
    assert_same_figure(got, want, F64_TOL)


def test_plot_value_function():
    from sbr_tpu.interest import solve_equilibrium_interest as jsolve
    from sbr_tpu_torch.interest import solve_equilibrium_interest as tsolve

    jm = jparams.make_interest_params(u=0.0, r=0.06, delta=0.1)
    tm = tparams.make_interest_params(u=0.0, r=0.06, delta=0.1)
    jres = jsolve(jl.solve_learning(jm.learning, JCFG), jm.economic, JCFG)
    tres = tsolve(tl.solve_learning(tm.learning, TCFG, device=CPU), tm.economic, TCFG)
    want = _close(jplot.plot_value_function(jres, jm.economic))
    got = _close(tplot.plot_value_function(tres, tm.economic))
    assert_same_figure(got, want, F64_TOL)


def test_plot_agent_closure(monkeypatch):
    """The closure figure from the reference's fixed point carried across
    (the agents' curves are then bit for bit, tests/test_torch_closure.py)."""
    monkeypatch.setenv("SBR_NATIVE", "0")  # the reference's numpy edge stream
    jm, tm = jparams.make_model_params(**FIG12), tparams.make_model_params(**FIG12)
    want_fp = jsocial.solve_equilibrium_social(jm, JCFG, max_iter=500)
    got_fp = tsocial.fixed_point_from_numpy(as_numpy(want_fp), device=CPU)
    small = dict(n_agents=2000, avg_degree=15.0, dt=0.1, t_max=12.0)
    jc = jclosure.close_loop(jm, fp=want_fp, **small)
    tc = tclosure.close_loop(tm, fp=got_fp, device=CPU, **small)
    want = _close(jplot.plot_agent_closure(jc))
    got = _close(tplot.plot_agent_closure(tc))
    assert assert_same_figure(got, want, F64_TOL) == 0.0


def test_package_exports_match():
    assert tfig.__all__ == jfig.__all__
    assert tmaster.MANIFEST == jmaster.MANIFEST
    assert tmaster._EXTRAS == jmaster._EXTRAS
    assert (tmaster.PAPER_HEATMAP, tmaster.CLOSURE_FIG) == (jmaster.PAPER_HEATMAP,
                                                            jmaster.CLOSURE_FIG)


# ---------------------------------------------------------------------------
# The golden figure scalars (tests/test_golden_figures.py, on the port)
# ---------------------------------------------------------------------------


def _port_baseline(**overrides):
    base = tparams.make_model_params()
    m = tparams.with_overrides(base, **overrides) if overrides else base
    ls = tl.solve_learning(m.learning, device=CPU)
    return ts.solve_equilibrium_baseline(ls, m.economic)


@pytest.mark.parametrize("overrides, xi, aw_max", [
    ({}, 10.215435605, 0.618230571),
    ({"beta": 3.0}, 3.256394431, 0.744437002),
    ({"u": 0.01}, 9.660277550, 0.847096205),
])
def test_golden_baseline_figure_scalars(overrides, xi, aw_max):
    res = _port_baseline(**overrides)
    assert bool(res.bankrun)
    assert float(res.xi) == pytest.approx(xi, abs=1e-5)
    assert float(res.aw_max) == pytest.approx(aw_max, abs=1e-5)


def test_golden_hetero_figure_scalars():
    from sbr_tpu_torch.hetero import get_aw_hetero, solve_equilibrium_hetero, solve_learning_hetero

    m = tparams.make_hetero_params(
        betas=[0.125, 12.5], dist=[0.9, 0.1], eta_bar=30.0, u=0.1, p=0.9, kappa=0.3, lam=0.1
    )
    lsh = solve_learning_hetero(m.learning, device=CPU)
    res = solve_equilibrium_hetero(lsh, m.economic)
    assert bool(res.bankrun)
    assert float(res.xi) == pytest.approx(16.875766906, abs=1e-4)
    assert float(get_aw_hetero(res, lsh).aw_max) == pytest.approx(0.319828704, abs=1e-4)


def test_golden_social_delta_xi_vs_word_of_mouth():
    m = tparams.make_model_params(**FIG12)
    social = tsocial.solve_equilibrium_social(m, tol=1e-4, max_iter=500, device=CPU)
    assert bool(social.converged)
    lw = tl.solve_learning(tparams.LearningParams(beta=0.9, tspan=(0.0, m.economic.eta),
                                                  x0=1e-4), device=CPU)
    wom = ts.solve_equilibrium_baseline(lw, m.economic)
    assert bool(wom.bankrun)
    assert float(social.xi) == pytest.approx(8.925581642, abs=1e-3)
    assert float(wom.xi) == pytest.approx(9.189793981, abs=1e-5)
    assert float(social.xi) - float(wom.xi) == pytest.approx(-0.264212339, abs=2e-3)


# ---------------------------------------------------------------------------
# master --fast against sbr_tpu's master --fast
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fast_runs(tmp_path_factory):
    """Both packages' whole ``--fast`` replication, once: (rc, figures,
    printed manifest, recorded solves) each."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SBR_NATIVE", "0")  # the reference's numpy edge stream
        jroot = tmp_path_factory.mktemp("ref_fast")
        troot = tmp_path_factory.mktemp("port_fast")
        want = _run(jmaster, ["--fast", "--platform", "cpu", "--output", str(jroot)], mp, jroot)
        got = _run(tmaster, ["--fast", "--device", CPU, "--output", str(troot)], mp, troot)
    finally:
        mp.undo()
    return want, got, jroot, troot


def _section_figures(sec: int) -> list:
    return list(tmaster.MANIFEST[sec]) + list(tmaster._EXTRAS.get(sec, []))


def _section_lines(lines: list, sec: int) -> list:
    start = lines.index(f"SECTION {sec}/4: " + {1: "Baseline", 2: "Heterogeneity",
                                                  3: "Interest Rates",
                                                  4: "Social Learning"}[sec])
    end = next((i for i in range(start + 1, len(lines)) if lines[i].startswith("SECTION ")
                or lines[i] == "REPLICATION COMPLETE"), len(lines))
    return lines[start:end]


@pytest.mark.parametrize("sec", SECTIONS)
def test_master_fast_section_matches_reference(fast_runs, sec):
    (jrc, jfigs, jlines, jrec), (trc, tfigs, tlines, trec), _, troot = fast_runs
    assert jrc == trc == 0
    # the printed manifest: statuses (the status summaries), ξ, iterations
    assert _section_lines(tlines, sec) == _section_lines(jlines, sec)
    for name in _section_figures(sec):
        if name == tmaster.PAPER_HEATMAP:
            continue
        assert (troot / "figures" / name).exists()
        if name == tmaster.CLOSURE_FIG:
            continue  # below: the agents' curves are held bit for bit
        assert_same_figure(tfigs[name], jfigs[name], F64_TOL)
    if sec == 4:
        (jfp,), (tfp,) = jrec["solve_equilibrium_social"], trec["solve_equilibrium_social"]
        # 50 under the suite's fixed numerics (45 with the adaptive default)
        assert int(tfp.iterations) == int(jfp.iterations) == 50
        assert bool(tfp.converged) and bool(jfp.converged)


def test_master_fast_closure_matches_reference(fast_runs, monkeypatch):
    """The closure figure: the fixed point's curves within 1e-12, the
    agents' curves bit for bit. Where the two fixed points' withdrawal
    windows round apart, the reference's fixed point is carried across."""
    (_, jfigs, _, jrec), (_, tfigs, _, trec), _, _ = fast_runs
    (jcomp,), (tcomp,) = jrec["close_loop"], trec["close_loop"]
    name = tmaster.CLOSURE_FIG
    for g, w in zip(tfigs[name], jfigs[name]):
        fp_g, sim_g = (xy for _, xy in g["lines"][:2])
        fp_w, sim_w = (xy for _, xy in w["lines"][:2])
        assert _gap(fp_g, fp_w) <= F64_TOL
    if (tcomp.exit_delay, tcomp.reentry_delay) != (jcomp.exit_delay, jcomp.reentry_delay):
        monkeypatch.setenv("SBR_NATIVE", "0")
        (jfp,) = jrec["solve_equilibrium_social"]
        kw = dict(n_agents=20_000, avg_degree=15.0, dt=0.1, t_max=16.0)
        tcomp = tclosure.close_loop(tparams.make_model_params(**FIG12), device=CPU,
                                    fp=tsocial.fixed_point_from_numpy(as_numpy(jfp), CPU), **kw)
        assert (tcomp.exit_delay, tcomp.reentry_delay) == (jcomp.exit_delay,
                                                           jcomp.reentry_delay)
        assert np.array_equal(tcomp.aw_sim, jcomp.aw_sim)
        assert np.array_equal(tcomp.g_sim, jcomp.g_sim)
    else:
        for g, w in zip(tfigs[name], jfigs[name]):
            assert np.array_equal(g["lines"][1][1], w["lines"][1][1])


def test_master_fast_writes_every_artifact(fast_runs):
    (_, _, jlines, _), (_, _, tlines, _), jroot, troot = fast_runs
    for sec in SECTIONS:
        for name in tmaster.MANIFEST[sec]:
            assert (troot / "figures" / name).exists()
    assert (troot / "figures" / tmaster.CLOSURE_FIG).exists()
    assert (troot / "replication_figures.pdf").exists()
    assert not (troot / "replication_figures.pdf.tmp").exists()
    # the closing manifest lists the same figures in the same order
    tail = lambda lines: lines[lines.index("REPLICATION COMPLETE"):]  # noqa: E731
    assert tail(tlines) == tail(jlines)
    jtex = (jroot / "replication_figures.tex").read_text().splitlines()
    ttex = (troot / "replication_figures.tex").read_text().splitlines()
    assert len(ttex) == len(jtex)
    diff = [(a, b) for a, b in zip(ttex, jtex) if a != b]
    assert len(diff) == 1 and diff[0][0].startswith(r"\title{")


def test_master_f32_section_matches_reference_without_x64(tmp_path, monkeypatch):
    """Section 1 in float32 (the reference with x64 off): the printed
    manifest (statuses) equal, every figure's data within F32_TOL."""
    jroot, troot = tmp_path / "ref", tmp_path / "port"
    try:
        want = _run(jmaster, ["--sections", "1", "--fast", "--f32", "--platform", "cpu",
                              "--output", str(jroot)], monkeypatch, jroot)
    finally:
        jax.config.update("jax_enable_x64", True)  # the reference's --f32 turns it off
    got = _run(tmaster, ["--sections", "1", "--fast", "--f32", "--device", CPU,
                         "--output", str(troot)], monkeypatch, troot)
    assert want[0] == got[0] == 0
    assert _section_lines(got[2], 1) == _section_lines(want[2], 1)
    for name in tmaster.MANIFEST[1]:
        assert_same_figure(got[1][name], want[1][name], F32_TOL)


# ---------------------------------------------------------------------------
# The paper path (tests/test_master_cli.py, on the port)
# ---------------------------------------------------------------------------


def _paper_argv(out: Path, ckpt: Path, res: int = 24, tile: int = 8) -> list:
    return ["--output", str(out), "--sections", "", "--paper", "--paper-res", str(res),
            "--paper-tile", str(tile), "--checkpoint-dir", str(ckpt)]


def test_paper_heatmap_generates_and_resumes(tmp_path, monkeypatch):
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    pdf = out / "figures" / tmaster.PAPER_HEATMAP
    rc, figs, _, rec = _run(tmaster, _paper_argv(out, ckpt) + ["--device", CPU],
                            monkeypatch, out)
    assert rc == 0 and pdf.exists()
    tiles = sorted(ckpt.glob("tile_*.npz"))
    assert len(tiles) == 9  # 24/8 × 24/8

    # an interrupt: the artifact gone and two tiles lost
    pdf.unlink()
    tiles[0].unlink()
    tiles[4].unlink()
    rc, _, lines, _ = _run(tmaster, _paper_argv(out, ckpt) + ["--device", CPU],
                           monkeypatch, out)
    assert rc == 0 and pdf.exists()
    assert any("resumed 7 tiles" in line for line in lines)
    assert "comp_stat_cross_heatmap_AW_large.pdf" in (out / "replication_figures.tex").read_text()

    # against the reference's float32 tiled run of the same grid
    jout = tmp_path / "ref"
    try:
        jrc, jfigs, _, jrec = _run(jmaster, _paper_argv(jout, tmp_path / "jckpt")
                                   + ["--platform", "cpu"], monkeypatch, jout)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert jrc == 0
    jgrid, tgrid = jrec["run_tiled_grid"][-1], rec["run_tiled_grid"][-1]
    assert np.array_equal(tgrid.status.numpy(), np.asarray(jgrid.status))
    assert _gap(tgrid.max_aw.numpy(), np.asarray(jgrid.max_aw)) <= F32_TOL
    assert_same_figure(figs[tmaster.PAPER_HEATMAP], jfigs[tmaster.PAPER_HEATMAP], F32_TOL)


# ---------------------------------------------------------------------------
# The other checks
# ---------------------------------------------------------------------------


def test_write_tex_is_the_reference_text_apart_from_the_title(tmp_path):
    for sections, skip in (([1, 2, 3, 4], ()), ([1, 4], {"baseline/hazard_rate.pdf"})):
        for sub, mod in (("j", jmaster), ("t", tmaster)):
            figdir = tmp_path / sub / "figures" / "social_learning"
            figdir.mkdir(parents=True, exist_ok=True)
            (figdir / "agent_vs_fixed_point.pdf").write_bytes(b"")
            mod.write_tex(tmp_path / sub, sections, skip=skip)
        jtex = (tmp_path / "j" / "replication_figures.tex").read_text().splitlines()
        ttex = (tmp_path / "t" / "replication_figures.tex").read_text().splitlines()
        diff = [(a, b) for a, b in zip(ttex, jtex) if a != b]
        assert len(ttex) == len(jtex) and len(diff) == 1
        title, ref_title = diff[0]
        assert title.endswith(r"(sbr\_tpu\_torch PyTorch/CUDA port)}")
        assert title.replace(r"sbr\_tpu\_torch PyTorch/CUDA port", r"sbr\_tpu TPU-native framework") == ref_title


def test_no_run_outcome_skips_its_figure_and_is_not_missing(tmp_path, monkeypatch):
    solve = tsocial.solve_equilibrium_social

    def no_run(*args, **kwargs):
        res = solve(*args, **kwargs)
        eq = res.equilibrium
        return res.replace(equilibrium=eq.replace(bankrun=torch.zeros_like(eq.bankrun)))

    monkeypatch.setattr(tsocial, "solve_equilibrium_social", no_run)
    out = tmp_path / "out"
    rc, figs, lines, _ = _run(tmaster, ["--sections", "4", "--fast", "--device", CPU,
                                        "--output", str(out)], monkeypatch, out)
    assert rc == 0
    assert "social_learning/social_learning_equilibrium.pdf" not in figs
    assert tmaster.CLOSURE_FIG not in figs  # no window without a run
    assert any("(skipped: no-run outcome)" in line for line in lines)
    tex = (out / "replication_figures.tex").read_text()
    assert "social_learning_equilibrium.pdf" not in tex
    assert "baseline_equilibrium.pdf" in tex


def test_device_cuda_without_a_card_exits_non_zero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tmaster.main(["--sections", "", "--output", str(tmp_path / "out")]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_default_output_is_not_the_reference_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmaster.main(["--sections", "", "--device", CPU]) == 0
    assert (tmp_path / "output_torch" / "replication_figures.tex").exists()
    assert not (tmp_path / "output").exists()


# ---------------------------------------------------------------------------
# The built-in PDF writer (machines without matplotlib, the GPU machine too)
# ---------------------------------------------------------------------------


def check_pdf(path: Path) -> int:
    """A PDF's structure: every xref offset opens its object, every
    Flate stream inflates, every image holds width × height × 3 bytes.
    Returns the page count."""
    import zlib

    data = Path(path).read_bytes()
    assert data.startswith(b"%PDF-1.4") and data.rstrip().endswith(b"%%EOF")
    xref = int(re.search(rb"startxref\n(\d+)\n", data).group(1))
    table = data[xref:].split(b"trailer")[0].split(b"\n")[3:]
    offsets = [int(row[:10]) for row in table if row.strip()]
    for i, off in enumerate(offsets, start=1):
        assert data[off:].startswith(b"%d 0 obj" % i)
    for m in re.finditer(rb"<<([^<>]*(?:<<[^<>]*>>[^<>]*)*)>>\nstream\n", data):
        head = m.group(1)
        n = int(re.search(rb"/Length (\d+)", head).group(1))
        raw = zlib.decompress(data[m.end():m.end() + n])
        if b"/Subtype /Image" in head:
            w = int(re.search(rb"/Width (\d+)", head).group(1))
            h = int(re.search(rb"/Height (\d+)", head).group(1))
            assert len(raw) == w * h * 3
    return int(re.search(rb"/Type /Pages /Kids \[[^\]]*\] /Count (\d+)", data).group(1))


def test_builtin_backend_draws_the_matplotlib_data(baseline_solved, monkeypatch, tmp_path):
    """Every builder drawn by the built-in writer holds exactly the lines,
    mesh values, titles and texts that matplotlib holds, and writes a
    well-formed PDF."""
    from sbr_tpu_torch.figures import backend

    (_, _, _), (tm, tls, tres) = baseline_solved
    amt, us = np.linspace(0.05, 1.0, 8), np.linspace(0.01, 1.0, 8)
    heat = np.random.default_rng(0).random((8, 8))
    builds = {
        "learning": lambda: tplot.plot_learning_distribution([tls], tm.learning.tspan,
                                                             [tm.learning.beta]),
        "hazard": lambda: tplot.plot_hazard_rate_decomposition(tres, tls, tm.economic),
        "equilibrium": lambda: tplot.plot_equilibrium(tres, tls, tm.economic),
        "heatmap": lambda: tplot.plot_heatmap_aw(amt, us, heat),
        "panels": lambda: tplot.plot_comp_stat_withdrawals_and_collapse(
            us, np.where(us < 0.5, us, np.nan), us + 1.0, 0.6, return_times=us)[1],
    }
    for name, build in builds.items():
        want = build()
        monkeypatch.setattr(backend, "_matplotlib", lambda: None)  # as on the GPU machine
        assert backend.name() == "built-in PDF writer"
        got = build()
        monkeypatch.undo()
        assert type(got).__module__ == "sbr_tpu_torch.figures.pdfplot"
        g, w = fig_data(got), _close(want)
        for ga, wa in zip(g, w):
            assert ga["title"] == wa["title"] and ga["texts"] == wa["texts"]
            assert [lbl for lbl, _ in ga["lines"]] == [lbl for lbl, _ in wa["lines"]]
            for (_, a), (_, b) in zip(ga["lines"], wa["lines"]):
                assert np.array_equal(a, b, equal_nan=True), name
            for (va, ca), (vb, cb) in zip(ga["meshes"], wa["meshes"]):
                assert np.array_equal(va, vb, equal_nan=True)
                assert _gap(ca, cb) <= F64_TOL
        got.savefig(tmp_path / f"{name}.pdf")
        assert check_pdf(tmp_path / f"{name}.pdf") == 1


def test_master_with_the_builtin_backend(fast_runs, monkeypatch, tmp_path):
    """The replication run with the built-in writer (what the GPU machine,
    which has no matplotlib, draws with): the same figures and data as the
    matplotlib run, well-formed PDFs, and the combined document's pages."""
    from sbr_tpu_torch.figures.pdfplot import PdfPages, figure

    from sbr_tpu_torch.figures import backend

    _, (_, mfigs, _, _), _, _ = fast_runs
    monkeypatch.setattr(backend, "_matplotlib", lambda: None)  # as on the GPU machine
    out = tmp_path / "out"
    rc, figs, lines, _ = _run(tmaster, ["--sections", "1,2,4", "--fast", "--device", CPU,
                                        "--output", str(out)], monkeypatch, out)
    assert rc == 0 and lines[0] == "Figures drawn with built-in PDF writer"
    assert set(figs) == {f for sec in (1, 2, 4) for f in _section_figures(sec)
                         if f != tmaster.PAPER_HEATMAP}
    for name, got in figs.items():
        assert check_pdf(out / "figures" / name) == 1
        for ga, wa in zip(got, mfigs[name]):
            assert [lbl for lbl, _ in ga["lines"]] == [lbl for lbl, _ in wa["lines"]]
            for (_, a), (_, b) in zip(ga["lines"], wa["lines"]):
                assert np.array_equal(a, b, equal_nan=True), name
            assert ga["texts"] == wa["texts"]
    doc = PdfPages(tmp_path / "doc.pdf")
    for k in range(3):
        fig = figure(figsize=(8.27, 11.69))
        fig.text(0.5, 0.6, f"page {k}", ha="center", va="center", fontsize=20)
        doc.savefig(fig)
    doc.close()
    assert check_pdf(tmp_path / "doc.pdf") == 3
