"""Measured spreads of the port's solve against sbr_tpu on the CPU: the
numbers behind the tolerances that tests/test_torch_{core,baseline,sweeps,
social,closure}.py state. Prints one JSON line per comparison.

    python tests/torch_parity_report.py            # every section
    python tests/torch_parity_report.py social     # the named sections

Runs in a few minutes on one CPU core: scalar solves at n_grid 1024, the
golden 12×12 axes at n_grid 512, an every-fifth 100×100 subgrid of the
Figure-5 tile at n_grid 1024, a 200-point u-sweep, the social and
information fixed points, and the rounding facts (``exp``, ``linspace``,
the fixed point's compiled damping line and ξ march) the contracts rest on.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ["SBR_NUMERICS"] = "fixed"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbr_tpu.baseline import learning as jl, solver as js  # noqa: E402
from sbr_tpu.models import params as jp  # noqa: E402
from sbr_tpu.sweeps import baseline_sweeps as jsw  # noqa: E402
from sbr_tpu_torch.baseline import learning as tl, solver as ts  # noqa: E402
from sbr_tpu_torch.core.interp import linspace  # noqa: E402
from sbr_tpu_torch.models import params as tp  # noqa: E402
from sbr_tpu_torch.sweeps import baseline_sweeps as tsw  # noqa: E402

DTYPES = ((np.float64, torch.float64), (np.float32, torch.float32))


def emit(kind: str, **fields) -> None:
    print(json.dumps({"comparison": kind, **fields}), flush=True)


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0


def facts() -> None:
    x = np.random.default_rng(0).uniform(-30.0, 5.0, 100_000)
    emit("exp_f64_jnp_vs_torch_share",
         value=float((np.asarray(jnp.exp(x)) != torch.exp(torch.from_numpy(x)).numpy()).mean()))
    for np_dtype, t_dtype in DTYPES:
        j = np.asarray(jnp.linspace(np_dtype(0), np_dtype(15), 1024, dtype=np_dtype))
        emit("linspace_0_15_1024_points_differing", dtype=np_dtype.__name__,
             torch_linspace=int((torch.linspace(0, 15, 1024, dtype=t_dtype).numpy() != j).sum()),
             port_linspace=int((linspace(0.0, 15.0, 1024, t_dtype).numpy() != j).sum()))


def scalars() -> None:
    cases = ({}, {"beta": 3.0}, {"u": 0.01}, {"u": 5.0}, {"p": 0.9, "kappa": 0.3, "lam": 0.1},
             {"beta": 0.3, "u": 0.02}, {"beta": 40.0, "u": 0.5})
    for np_dtype, t_dtype in DTYPES:
        for mode in ("fixed", "adaptive"):
            gaps, status_equal = [], True
            for kw in cases:
                tm = tp.with_overrides(tp.make_model_params(), **kw)
                jm = jp.with_overrides(jp.make_model_params(), **kw)
                tc = tp.SolverConfig(numerics=mode, n_grid=1024)
                jc = jp.SolverConfig(numerics=mode, n_grid=1024)
                r = ts.solve_equilibrium_baseline(
                    tl.solve_learning(tm.learning, tc, dtype=t_dtype, device="cpu"), tm.economic, tc)
                jls = jl.solve_learning(jm.learning, jc, dtype=np_dtype)
                e = jm.economic
                jr = js._jitted_core(jc)(jls, *(jnp.asarray(v, np_dtype) for v in
                                               (e.u, e.p, e.kappa, e.lam, e.eta, jls.grid[-1])))
                status_equal &= int(r.status) == int(jr.status)
                gaps += [_gap(getattr(r, f).numpy(), getattr(jr, f)) for f in
                         ("xi", "tau_bar_in_unc", "tau_bar_out_unc", "aw_max")]
            emit("scalar_solves", dtype=np_dtype.__name__, numerics=mode, cases=len(cases),
                 status_equal=status_equal, max_abs=max(gaps))


def grids() -> None:
    idx = np.arange(0, 500, 5)
    axes = {
        "golden_12x12_n512": (np.linspace(0.25, 3.0, 12), np.linspace(0.01, 0.99, 12), 512, 60),
        "figure5_100x100_n1024": ((1.0 / np.linspace(1e-4, 1.0, 500))[idx],
                                  np.linspace(0.001, 1.0, 500)[idx], 1024, 90),
    }
    for name, (betas, us, n_grid, iters) in axes.items():
        for np_dtype, t_dtype in DTYPES:
            for mode in ("fixed", "adaptive"):
                kw = dict(n_grid=n_grid, bisect_iters=iters, refine_crossings=False, numerics=mode)
                g = tsw.beta_u_grid(betas, us, tp.make_model_params(), tp.SolverConfig(**kw),
                                    dtype=t_dtype, device="cpu")
                j = jsw.beta_u_grid(betas, us, jp.make_model_params(), config=jp.SolverConfig(**kw),
                                    dtype=np_dtype)
                it, jit_ = g.health.iterations.numpy(), np.asarray(j.health.iterations)
                emit("beta_u_grid", grid=name, dtype=np_dtype.__name__, numerics=mode,
                     status_differing=int((g.status.numpy() != np.asarray(j.status)).sum()),
                     flags_differing=int((g.health.flags.numpy() != np.asarray(j.health.flags)).sum()),
                     xi_max_abs=_gap(g.xi.numpy(), j.xi), aw_max_abs=_gap(g.max_aw.numpy(), j.max_aw),
                     iterations_equal_share=float((it == jit_).mean()),
                     iterations_mean=[float(it.mean()), float(jit_.mean())])


def u_sweeps() -> None:
    us = np.linspace(0.001, 0.2, 200)
    for mode in ("fixed", "adaptive"):
        tm, jm = tp.make_model_params(), jp.make_model_params()
        tc, jc = tp.SolverConfig(n_grid=1024, numerics=mode), jp.SolverConfig(n_grid=1024, numerics=mode)
        r = tsw.u_sweep(tl.solve_learning(tm.learning, tc, device="cpu"), us, tm.economic, tc)
        j = jsw.u_sweep(jl.solve_learning(jm.learning, jc), us, jm.economic, jc)
        emit("u_sweep", numerics=mode, cells=len(us),
             status_differing=int((r.status.numpy() != np.asarray(j.status)).sum()),
             xi_max_abs=_gap(r.collapse_times.numpy(), j.collapse_times),
             aw_max_abs=_gap(r.max_withdrawals.numpy(), j.max_withdrawals))


def social() -> None:
    from sbr_tpu.infomodels import meanfield as jmf
    from sbr_tpu.infomodels.spec import InfoModelSpec as JSpec
    from sbr_tpu.social import dynamics as jd, solver as jsol
    from sbr_tpu_torch.infomodels import meanfield as tmf
    from sbr_tpu_torch.infomodels.spec import InfoModelSpec as TSpec
    from sbr_tpu_torch.social import dynamics as td, solver as tsol
    from sbr_tpu_torch.social.fused import _fma

    # the compiled damping line and ξ march inside the fixed point's loop
    g = np.random.default_rng(0)
    a, b = g.random(100_000), g.random(100_000)
    alpha = 0.3
    compiled = np.asarray(jax.jit(lambda x, y: (1.0 - alpha) * x + alpha * y)(a, b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fma = _fma(torch.full_like(ta, 1.0 - alpha), ta, alpha * tb).numpy()
    emit("damping_line_alpha_0.3_lanes_differing", as_written=int((compiled != (1.0 - alpha) * a + alpha * b).sum()),
         fma_1_minus_alpha_first=int((compiled != fma).sum()), lanes=len(a))
    etas = g.uniform(1.0, 100.0, 100_000)
    march = np.asarray(jax.jit(lambda e: e / 500.0)(etas))
    emit("eta_over_500_lanes_differing", as_division=int((march != etas / 500.0).sum()),
         as_reciprocal_product=int((march != etas * (1.0 / 500.0)).sum()), lanes=len(etas))

    for seed in range(3):
        g = np.random.default_rng(seed)
        grid = np.linspace(0.0, float(g.uniform(5.0, 40.0)), 257)
        aw = np.abs(np.cumsum(g.normal(0.0, 0.05, 257))) + g.uniform(0.0, 0.3)
        beta, x0 = float(g.uniform(0.2, 3.0)), float(g.uniform(1e-5, 0.1))
        j = jd.solve_forced_learning(beta, jnp.asarray(aw), jnp.asarray(grid), x0)
        t = td.solve_forced_learning(beta, torch.from_numpy(aw), torch.from_numpy(grid), x0)
        emit("forced_learning", seed=seed, cdf_max_abs=_gap(t.cdf, j.cdf),
             pdf_max_abs=_gap(t.pdf, j.pdf))

    fig12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)

    def fp_row(kind, j, t, **kw):
        emit(kind, **kw, iterations=[int(j.iterations), int(t.iterations)],
             flags=[int(j.health.flags), int(t.health.flags)],
             health_iterations=[int(j.health.iterations), int(t.health.iterations)],
             xi_max_abs=_gap(t.xi, j.xi), aw_max_abs=_gap(t.aw, j.aw),
             g_max_abs=_gap(t.learning.cdf, j.learning.cdf),
             history_err_max_abs=_gap(t.history_err, j.history_err))

    for np_dtype, t_dtype in DTYPES:
        for n_grid in (4096, 1024):
            for mode in ("fixed", "adaptive"):
                jc = jp.SolverConfig(n_grid=n_grid, numerics=mode)
                tc = tp.SolverConfig(n_grid=n_grid, numerics=mode)
                j = jsol.solve_equilibrium_social(jp.make_model_params(**fig12), jc, max_iter=500,
                                                  dtype=np_dtype)
                t = tsol.solve_equilibrium_social(tp.make_model_params(**fig12), tc, max_iter=500,
                                                  dtype=t_dtype, device="cpu")
                fp_row("social_fixed_point", j, t, dtype=np_dtype.__name__, n_grid=n_grid,
                       numerics=mode)

    groups = ((0.3, 2.0, 1.0), (0.5, 3.0, 3.0), (0.2, 4.5, 0.5))
    specs = {"bayes": dict(channel="bayes"), "bayes_groups": dict(channel="bayes", groups=groups),
             "gossip_groups": dict(groups=groups),
             "gossip_rewire": dict(dynamics="rewire", rewire_bias=1.0, epoch_steps=5)}
    g = np.random.default_rng(3)
    grid = np.linspace(0.0, 12.0, 301)
    aw = np.clip(np.cumsum(g.normal(0.0, 0.03, 301)), 0.0, 1.0)
    for name, kw in specs.items():
        j = jmf.info_learning_curve(JSpec(**kw), 0.9, jnp.asarray(aw), jnp.asarray(grid), 1e-3)
        t = tmf.info_learning_curve(TSpec(**kw), 0.9, torch.from_numpy(aw),
                                    torch.from_numpy(grid), 1e-3)
        emit("info_learning_curve", spec=name, cdf_max_abs=_gap(t.cdf, j.cdf),
             pdf_max_abs=_gap(t.pdf, j.pdf))
    for name, n_grid in (("bayes", 512), ("gossip_groups", 256), ("gossip_rewire", 256)):
        j = jmf.solve_fixed_point_info(JSpec(**specs[name]), jp.make_model_params(**fig12),
                                       config=jp.SolverConfig(n_grid=n_grid), max_iter=500)
        t = tmf.solve_fixed_point_info(TSpec(**specs[name]), tp.make_model_params(**fig12),
                                       config=tp.SolverConfig(n_grid=n_grid), max_iter=500,
                                       device="cpu")
        fp_row("info_fixed_point", j, t, spec=name, n_grid=n_grid)


SECTIONS = {"facts": facts, "scalars": scalars, "grids": grids, "u_sweeps": u_sweeps,
            "social": social}

if __name__ == "__main__":
    for name in sys.argv[1:] or SECTIONS:
        SECTIONS[name]()
