"""Measured spreads of the port's solve against sbr_tpu on the CPU: the
numbers behind the tolerances that tests/test_torch_{core,baseline,sweeps,
social,closure,ode,hetero,interest,policy_sweeps}.py state. Prints one
JSON line per comparison.

    python tests/torch_parity_report.py            # every section
    python tests/torch_parity_report.py social     # the named sections

Runs in a few minutes on one CPU core: scalar solves at n_grid 1024, the
golden 12×12 axes at n_grid 512, an every-fifth 100×100 subgrid of the
Figure-5 tile at n_grid 1024, a 200-point u-sweep, the social and
information fixed points, the rounding facts (``exp``, ``linspace``,
the fixed point's compiled damping line and ξ march) the contracts rest on,
and (``extensions``, about a minute) the ODE integrators, the hetero and
interest solves and the (β, u, r) policy sweep. ``ops`` (not in the
default run: several minutes) counts the ops a full-width extension solve
dispatches.
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


def extensions() -> None:
    from sbr_tpu.core import ode as jode
    from sbr_tpu.hetero import learning as jhl, solver as jhs
    from sbr_tpu.interest import solver as jis
    from sbr_tpu.sweeps import policy_sweeps as jps
    from sbr_tpu_torch.core import ode as tode
    from sbr_tpu_torch.hetero import hetero_solution_from_numpy
    from sbr_tpu_torch.hetero import learning as thl, solver as ths
    from sbr_tpu_torch.interest import solver as tis
    from sbr_tpu_torch.sweeps import policy_sweeps as tps

    betas, dist, x0 = np.array([0.125, 12.5]), np.array([0.9, 0.1]), 1e-4
    tb, td = torch.tensor(betas), torch.tensor(dist)
    for n in (65, 257):
        ts_ = np.linspace(0.0, 44.0, n)
        jy, jh = jode.bs32(lambda t, g, a: (1 - g) * betas * jnp.dot(dist, g),
                           jnp.full(2, x0), jnp.asarray(ts_), with_health=True)
        ty, th = tode.bs32(lambda t, g, a: (1 - g) * tb * torch.dot(td, g),
                           torch.full((2,), x0, dtype=torch.float64), torch.tensor(ts_),
                           with_health=True)
        emit("bs32_coupled_vs_compiled", n=n, max_abs=_gap(ty, jy),
             attempts=[int(th.iterations), int(jh.iterations)],
             count_spread=abs(int(th.iterations) - int(jh.iterations)) / int(jh.iterations))
    sec2 = dict(betas=(0.125, 12.5), dist=(0.9, 0.1), eta_bar=30.0, u=0.1, p=0.9, kappa=0.3,
                lam=0.1)
    mild = dict(sec2, betas=(0.5, 2.0), dist=(0.5, 0.5), eta_bar=15.0)
    for numerics, warp, model in (("fixed", 0.5, sec2), ("adaptive", 0.5, sec2),
                                  ("fixed", 0.0, mild), ("adaptive", 0.0, sec2)):
        kw = dict(n_grid=384, numerics=numerics, grid_warp=warp)
        jm, tm = jp.make_hetero_params(**model), tp.make_hetero_params(**model)
        jc, tc = jp.SolverConfig(**kw), tp.SolverConfig(**kw)
        jlh = jhl.solve_learning_hetero(jm.learning, jc)
        tlh = thl.solve_learning_hetero(tm.learning, tc, device="cpu")
        jr = jhs.solve_equilibrium_hetero(jlh, jm.economic, jc)
        own = ths.solve_equilibrium_hetero(tlh, tm.economic, tc)
        carried = ths.solve_equilibrium_hetero(hetero_solution_from_numpy(
            *(np.array(x) for x in (jlh.grid, jlh.cdfs, jlh.pdfs, jlh.t0, jlh.dt, jlh.betas,
                                    jlh.dist)),
            ode_flags=None if jlh.ode_flags is None else np.array(jlh.ode_flags),
            device="cpu"), tm.economic, tc)
        emit("hetero", numerics=numerics, grid_warp=warp, betas=model["betas"],
             grid_max_abs=_gap(tlh.grid, jlh.grid), cdfs_max_abs=_gap(tlh.cdfs, jlh.cdfs),
             own_xi_max_abs=_gap(own.xi, jr.xi), own_hrs_max_abs=_gap(own.hrs, jr.hrs),
             carried_xi_max_abs=_gap(carried.xi, jr.xi),
             carried_hrs_max_abs=_gap(carried.hrs, jr.hrs),
             status=[int(own.status), int(jr.status)],
             flags=[int(own.health.flags), int(jr.health.flags)])
    for numerics in ("fixed", "adaptive"):
        for model in (dict(beta=1.0, u=0.0, r=0.06), dict(beta=3.0, u=0.05, r=0.02)):
            jm, tm = jp.make_interest_params(**model), tp.make_interest_params(**model)
            jc, tc = (m.SolverConfig(n_grid=512, numerics=numerics) for m in (jp, tp))
            jr = jis.solve_equilibrium_interest(jl.solve_learning(jm.learning, jc), jm.economic, jc)
            tr = tis.solve_equilibrium_interest(
                tl.solve_learning(tm.learning, tc, device="cpu"), tm.economic, tc)
            emit("interest", numerics=numerics, **model, v_max_abs=_gap(tr.v, jr.v),
                 xi_max_abs=_gap(tr.base.xi, jr.base.xi),
                 tau_max_abs=max(_gap(tr.base.tau_bar_in_unc, jr.base.tau_bar_in_unc),
                                 _gap(tr.base.tau_bar_out_unc, jr.base.tau_bar_out_unc)),
                 status=[int(tr.base.status), int(jr.base.status)],
                 flags=[int(tr.base.health.flags), int(jr.base.health.flags)])
    axes = (np.linspace(0.5, 3.0, 3), np.linspace(0.0, 0.45, 3), np.linspace(0.0, 0.09, 3))
    for numerics in ("fixed", "adaptive"):
        for np_dtype, t_dtype in DTYPES:
            jc, tc = (m.SolverConfig(n_grid=256, numerics=numerics, refine_crossings=False,
                                     bisect_iters=60) for m in (jp, tp))
            jr = jps.policy_sweep_interest(*axes, jp.make_interest_params(u=0.0, delta=0.1), jc,
                                           dtype=np_dtype)
            tr = tps.policy_sweep_interest(*axes, tp.make_interest_params(u=0.0, delta=0.1), tc,
                                           dtype=t_dtype, device="cpu")
            it_t, it_j = tr.health.iterations.numpy(), np.asarray(jr.health.iterations)
            emit("policy_sweep", numerics=numerics, dtype=np_dtype.__name__,
                 status_equal=bool(np.array_equal(tr.status.numpy(), np.asarray(jr.status))),
                 flags_equal=bool(np.array_equal(tr.health.flags.numpy(),
                                                 np.asarray(jr.health.flags))),
                 xi_max_abs=_gap(tr.xi, jr.xi), aw_max_abs=_gap(tr.aw_max, jr.aw_max),
                 iterations_equal_share=float((it_t == it_j).mean()),
                 iterations_mean=[float(it_t.mean()), float(it_j.mean())])


def ops() -> None:
    """PyTorch ops (views apart) that one full-width extension solve
    dispatches on the CPU: the count of kernels it launches on the card,
    from which the chip runs' times are predicted. Several minutes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from sbr_tpu_torch.hetero import learning as thl, solver as ths
    from sbr_tpu_torch.interest import solver as tis
    from sbr_tpu_torch.sweeps import policy_sweeps as tps

    views = ("aten::view", "aten::_unsafe_view", "aten::expand", "aten::slice", "aten::select",
             "aten::unsqueeze", "aten::squeeze", "aten::t", "aten::permute", "aten::alias",
             "aten::detach", "aten::reshape", "aten::transpose", "aten::split", "aten::unbind")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func._schema.name.startswith(views):
                self.n += 1
            return func(*args, **(kwargs or {}))

    def count(fn):
        with Count() as c:
            fn()
        return c.n

    sec2 = tp.make_hetero_params(betas=(0.125, 12.5), dist=(0.9, 0.1), eta_bar=30.0, u=0.1,
                                 p=0.9, kappa=0.3, lam=0.1)
    sec3 = tp.make_interest_params(u=0.0, r=0.06, delta=0.1)
    base = tp.make_interest_params(u=0.0, delta=0.1)
    axes = (np.linspace(0.5, 3.0, 10), np.linspace(0.0, 0.45, 10), np.linspace(0.0, 0.09, 10))
    for numerics in ("fixed", "adaptive"):
        cfg = tp.SolverConfig(numerics=numerics)
        emit("ops", case="section2", numerics=numerics, ops=count(
            lambda: ths.solve_equilibrium_hetero(
                thl.solve_learning_hetero(sec2.learning, cfg, device="cpu"), sec2.economic, cfg)))
        emit("ops", case="section3", numerics=numerics, ops=count(
            lambda: tis.solve_equilibrium_interest(
                tl.solve_learning(sec3.learning, cfg, device="cpu"), sec3.economic, cfg)))
        cfg = tp.SolverConfig(numerics=numerics, refine_crossings=False)
        emit("ops", case="policy_stretch_f32", numerics=numerics, ops=count(
            lambda: tps.policy_sweep_interest(*axes, base, cfg, dtype=torch.float32,
                                              device="cpu")))


SECTIONS = {"facts": facts, "scalars": scalars, "grids": grids, "u_sweeps": u_sweeps,
            "social": social, "extensions": extensions, "ops": ops}

if __name__ == "__main__":
    for name in sys.argv[1:] or [k for k in SECTIONS if k != "ops"]:
        SECTIONS[name]()
