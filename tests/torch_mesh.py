"""Multi-process gloo groups on the CPU for the sharded tests of the port
(tests/test_torch_parallel.py, tests/test_torch_sharded_agents.py).

`run_group(world, cases, tmp)` starts ``world`` processes of this file,
each a rank of one ``gloo`` process group that rendezvous through a
``FileStore`` under ``tmp`` (no TCP port, so test workers cannot collide).
Every rank runs each case, a ``(name, kwargs)`` pair naming a ``case_*``
function below, and writes what it returns (a dict of numpy arrays) to its
own npz. The caller gets one dict a rank, keyed ``"<i>/<field>"`` for the
i-th case. Every rank sets one intra-op thread; every wait is bounded, and
the ranks are killed in a ``finally`` if they outlive it.

    python tests/torch_mesh.py RANK WORLD STORE OUT CASES_JSON
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 420


def run_group(world: int, cases, tmp) -> list:
    """Run ``cases`` on every rank of a ``world``-rank gloo group; one dict
    of numpy arrays a rank."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    for k in ("MASTER_ADDR", "SBR_TILE_CACHE_DIR"):
        env.pop(k, None)
    spec = json.dumps(cases)
    procs, outs = [], [tmp / f"rank{r}.npz" for r in range(world)]
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(r), str(world), str(store), str(outs[r]), spec],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO),
                ))
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{logs[r].read_text()[-4000:]}")
    results = []
    for path in outs:
        with np.load(path, allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
    return results


class AxisStub:
    """A stand-in for a ``DeviceMesh`` that is never communicated over: its
    axis sizes, this rank's coordinate on each and a device type, which is
    what the sharded entry points read before their first collective; so
    their argument checks run in one process without a group.
    ``axes`` maps an axis name to (size, this rank's index)."""

    def __init__(self, device_type: str = "cpu", **axes):
        self.device_type = device_type
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(size for size, _ in axes.values())
        self._index = {name: i for name, (_, i) in axes.items()}

    def get_local_rank(self, axis: str) -> int:
        return self._index[axis]


@contextlib.contextmanager
def world_one():
    """A block in which the mesh helpers may bring up this process's
    world-size-1 group, destroyed on the way out."""
    import torch.distributed as dist

    fresh = not dist.is_initialized()
    try:
        yield
    finally:
        if fresh and dist.is_initialized():
            dist.destroy_process_group()


def case_result(results: list, i: int) -> list:
    """The i-th case's fields, one dict a rank."""
    pre = f"{i}/"
    return [{k[len(pre):]: v for k, v in r.items() if k.startswith(pre)} for r in results]


# ---------------------------------------------------------------------------
# Cases: each runs on every rank and returns a dict of numpy arrays
# ---------------------------------------------------------------------------


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _sim_fields(res) -> dict:
    return {f: _np(getattr(res, f)) for f in ("informed", "t_inf", "informed_frac",
                                               "withdrawn_frac", "full_recount_steps",
                                               "t_grid")}


def _betas(kind: str, n: int):
    return 1.0 if kind == "scalar" else np.random.default_rng(9).lognormal(0.0, 0.5, n)


def case_agents(n: int, deg: float, steps: int, comm: str, engine: str, window, dtype: str,
                budget=None, max_degree=None, graph: str = "er", betas: str = "scalar",
                devices=None, launch_cap=None, measure: bool = False,
                rng_stream: str = "counter") -> dict:
    """The sharded agent simulation on a 1-D mesh of ``devices`` (default:
    every rank)."""
    from sbr_tpu_torch.parallel import make_agent_mesh
    from sbr_tpu_torch.social import agents as A

    src, dst = (A.erdos_renyi_edges(n, deg, seed=1) if graph == "er"
                else A.scale_free_edges(n, deg, gamma=2.2, seed=1))
    cfg = A.AgentSimConfig(n_steps=steps, dt=0.1, exit_delay=window[0],
                           reentry_delay=window[1], max_steps_per_launch=launch_cap,
                           rng_stream=rng_stream)
    mesh = make_agent_mesh(devices, device="cpu")
    kw = dict(config=cfg, mesh=mesh, dtype=np.dtype(dtype), comm=comm,
              incremental_budget=budget, incremental_max_degree=max_degree)
    pg = A.prepare_agent_graph(_betas(betas, n), src, dst, n,
                               engine="measure" if measure else engine, **kw)
    res = A.simulate_agents(prepared=pg, x0=0.01, config=cfg, seed=5)
    out = _sim_fields(res)
    out["engine"] = np.array(pg.engine)
    out["src"], out["row_ptr"] = _np(pg.src), _np(pg.row_ptr)
    out["betas"], out["indeg"] = _np(pg.betas), _np(pg.indeg)
    if pg.inc is not None:
        for k, v in zip(("dst2", "lstart", "ldeg"), pg.inc):
            out[k] = _np(v)
    out["budget"] = np.array(pg.budget)
    if pg.measured_steps_per_sec is not None:
        out["measured"] = np.array([lbl for lbl, _ in pg.measured_steps_per_sec])
    return out


def case_exclusive_psum(n_dev: int, length: int, dtype: str) -> dict:
    """`exclusive_psum` of each rank's seeded vector, and the vectors."""
    import torch

    from sbr_tpu_torch.parallel import exclusive_psum, make_agent_mesh

    mesh = make_agent_mesh(device="cpu")
    rank = mesh.get_local_rank("agents")
    x = np.random.default_rng(100 + rank).standard_normal(length)
    if dtype.startswith("int"):
        x = (x * 1000).astype(dtype)
    else:
        x = x.astype(dtype)
    got = exclusive_psum(torch.from_numpy(x), mesh, "agents", n_dev)
    return {"x": x, "excl": got.numpy()}


def _prepared_arrays(pg) -> dict:
    out = {"src": _np(pg.src), "row_ptr": _np(pg.row_ptr), "betas": _np(pg.betas),
           "indeg": _np(pg.indeg), "engine": np.array(pg.engine), "budget": np.array(pg.budget),
           "n_pad": np.array(pg.n_pad)}
    if pg.inc is not None:
        for k, v in zip(("dst2", "lstart", "ldeg"), pg.inc):
            out[k] = _np(v)
    return out


def case_graphgen(spec: str, n: int, deg: float, seed: int, engine: str, comm: str = "scatter",
                  chunk_edges=None) -> dict:
    """The sharded graph build, beside the host prepare of the same raw
    stream under the same mesh (prefixes ``gen_`` and ``host_``)."""
    from sbr_tpu_torch.parallel import make_agent_mesh
    from sbr_tpu_torch.social import agents as A
    from sbr_tpu_torch.social import graphgen as G

    sp = {"er": G.ErdosRenyiSpec(n=n, avg_degree=deg),
          "sf": G.ScaleFreeSpec(n=n, avg_degree=deg, gamma=2.5),
          "sbm": G.StochasticBlockSpec(n=n, avg_degree=deg, n_blocks=4, p_in=0.8)}[spec]
    mesh = make_agent_mesh(device="cpu")
    pg_d = G.prepare_generated_graph(sp, seed=seed, mesh=mesh, engine=engine, comm=comm,
                                     chunk_edges=chunk_edges)
    src, dst = G.generate_edges(sp, seed=seed, device="cpu")
    pg_h = A.prepare_agent_graph(1.0, src, dst, n, mesh=mesh, engine=engine, comm=comm,
                                 device="cpu")
    out = {f"gen_{k}": v for k, v in _prepared_arrays(pg_d).items()}
    out.update({f"host_{k}": v for k, v in _prepared_arrays(pg_h).items()})
    cfg = A.AgentSimConfig(n_steps=20, dt=0.1, exit_delay=0.1, reentry_delay=2.0)
    res = A.simulate_agents(prepared=pg_d, x0=0.02, config=cfg, seed=1)
    out.update({f"sim_{k}": v for k, v in _sim_fields(res).items()})
    return out


def case_selfcheck(n: int = 600) -> dict:
    """The graph self-check's exit code under the mesh, and its output."""
    import contextlib
    import io

    from sbr_tpu_torch.social.graphgen import _selfcheck

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _selfcheck(n=n, device="cpu")
    return {"rc": np.array(rc), "out": np.array(buf.getvalue())}


def case_closure(n_agents: int, n_reps: int, graph: str, seeds=None) -> dict:
    """`close_loop` under an agent mesh."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.parallel import make_agent_mesh
    from sbr_tpu_torch.social.closure import close_loop
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

    mesh = make_agent_mesh(device="cpu")
    spec = ErdosRenyiSpec(n=n_agents, avg_degree=12.0) if graph == "er" else None
    comp = close_loop(n_agents=n_agents, avg_degree=12.0, n_reps=n_reps, seed=0,
                      config=SolverConfig(n_grid=512, bisect_iters=60), mesh=mesh,
                      graph=spec, seeds=seeds, t_max=6.0, device="cpu")
    return {"aw_sim": comp.aw_sim, "g_sim": comp.g_sim, "t": comp.t}


def _grid_fields(res, names=("xi", "max_aw", "status")) -> dict:
    out = {f: _np(getattr(res, f)) for f in names}
    if getattr(res, "health", None) is not None:
        out.update({f"health_{f}": _np(getattr(res.health, f))
                    for f in ("residual", "bracket_width", "iterations", "flags")})
    return out


def case_u_sweep(n_u: int, n_grid: int) -> dict:
    """The Figure-4 u-sweep with u cut over a 1-D "u" mesh of every rank."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.parallel import make_agent_mesh
    from sbr_tpu_torch.sweeps.baseline_sweeps import u_sweep

    cfg = SolverConfig(n_grid=n_grid, bisect_iters=60)
    m = make_model_params()
    ls = solve_learning(m.learning, cfg, device="cpu")
    mesh = make_agent_mesh(axis_name="u", device="cpu")
    res = u_sweep(ls, np.linspace(0.001, 0.9, n_u), m.economic, cfg, mesh=mesh)
    return _grid_fields(res, ("collapse_times", "max_withdrawals", "return_times", "status"))


def case_grid(shape, n_b: int, n_u: int, n_grid: int, dtype: str) -> dict:
    """A β×u grid on a (b, u) mesh of the given shape."""
    import torch

    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.parallel import make_grid_mesh
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    mesh = make_grid_mesh(shape=tuple(shape), device="cpu")
    res = beta_u_grid(np.linspace(0.5, 4.0, n_b), np.linspace(0.01, 0.3, n_u),
                      make_model_params(), SolverConfig(n_grid=n_grid), mesh=mesh,
                      dtype=getattr(torch, dtype))
    return _grid_fields(res)


def case_tiled(shape, n_b: int, n_u: int, tile, n_grid: int, ckpt: str) -> dict:
    """`run_tiled_grid` on a (b, u) mesh with a shared checkpoint directory,
    run twice (the second a pure resume), and a tile shape the mesh does
    not divide (its error text, or "")."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.parallel import make_grid_mesh
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    mesh = make_grid_mesh(shape=tuple(shape), device="cpu")
    args = (np.linspace(0.5, 4.0, n_b), np.linspace(0.01, 0.3, n_u), make_model_params())
    cfg = SolverConfig(n_grid=n_grid, bisect_iters=60)
    rep1, rep2 = {}, {}
    res = run_tiled_grid(*args, config=cfg, tile_shape=tuple(tile), checkpoint_dir=ckpt,
                         mesh=mesh, report=rep1)
    again = run_tiled_grid(*args, config=cfg, tile_shape=tuple(tile), checkpoint_dir=ckpt,
                           mesh=mesh, report=rep2)
    try:
        run_tiled_grid(*args, config=cfg, tile_shape=(3, 3), mesh=mesh)
        err = ""
    except ValueError as e:
        err = str(e)
    out = _grid_fields(res)
    out.update({f"again_{k}": v for k, v in _grid_fields(again).items()})
    out["computed"] = np.array([rep1["counts"]["computed"], rep2["counts"]["computed"]])
    out["err"] = np.array(err)
    return out


def case_policy(shape, n_b: int, n_u: int, n_r: int, n_grid: int) -> dict:
    """The (β, u, r) policy sweep on a (b, u) mesh."""
    from sbr_tpu_torch.models.params import SolverConfig, make_interest_params
    from sbr_tpu_torch.parallel import make_grid_mesh
    from sbr_tpu_torch.sweeps.policy_sweeps import policy_sweep_interest

    mesh = make_grid_mesh(shape=tuple(shape), device="cpu")
    res = policy_sweep_interest(np.linspace(0.5, 3.0, n_b), np.linspace(0.0, 0.4, n_u),
                                np.linspace(0.0, 0.09, n_r),
                                make_interest_params(u=0.0, delta=0.1),
                                SolverConfig(n_grid=n_grid, bisect_iters=60), mesh=mesh)
    return _grid_fields(res, ("xi", "aw_max", "status"))


def case_hetero(k: int, n_grid: int, dtype: str, grid_warp: float = 0.5,
                beta_hi: float = 5.0) -> dict:
    """The K-sharded hetero solve on a 1-D "k" mesh of every rank."""
    import torch

    from sbr_tpu_torch.hetero import solve_hetero_sharded
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.parallel import make_agent_mesh

    mesh = make_agent_mesh(axis_name="k", device="cpu")
    lsh, res, aw = solve_hetero_sharded(hetero_params(k, beta_hi=beta_hi), mesh,
                                        SolverConfig(n_grid=n_grid, bisect_iters=60,
                                                     grid_warp=grid_warp),
                                        dtype=getattr(torch, dtype))
    return {"cdfs": _np(lsh.cdfs), "hrs": _np(res.hrs), "tau_in": _np(res.tau_bar_in_uncs),
            "tau_out": _np(res.tau_bar_out_uncs), "xi": _np(res.xi),
            "status": _np(res.status), "flags": _np(res.health.flags),
            "aw_cum": _np(aw.aw_cum), "aw_max": _np(aw.aw_max),
            "aw_groups": _np(aw.aw_groups)}


def hetero_params(k: int, pkg: str = "sbr_tpu_torch", beta_hi: float = 5.0):
    """The reference test's K-group model (tests/test_hetero.py), in
    either package; ``beta_hi`` caps the log-uniform β range (the RK4
    route's step count grows with the fastest group)."""
    import importlib

    params = importlib.import_module(f"{pkg}.models.params")
    rng = np.random.default_rng(0)
    betas = np.exp(rng.uniform(np.log(0.2), np.log(beta_hi), k))
    dist = rng.dirichlet(np.ones(k))
    return params.make_hetero_params(betas=betas, dist=dist / dist.sum(), eta_bar=15.0, u=0.1,
                                     p=0.5, kappa=0.6, lam=0.01)


def _dispatch(name: str, kwargs: dict) -> dict:
    return globals()[f"case_{name}"](**kwargs)


def main(argv) -> int:
    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    cases = json.loads(argv[4])
    import torch

    torch.set_num_threads(1)
    from sbr_tpu_torch.parallel import initialize_distributed

    assert initialize_distributed(f"file://{store}", num_processes=world, process_id=rank,
                                  backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
    import torch.distributed as dist

    try:
        arrays = {}
        for i, (name, kwargs) in enumerate(cases):
            for k, v in _dispatch(name, kwargs).items():
                arrays[f"{i}/{k}"] = v
        np.savez(out, **arrays)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
