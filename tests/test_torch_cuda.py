"""The port's CUDA kernels on the card, held to their plain PyTorch
versions. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither jax nor sbr_tpu, so it also runs on a GPU
machine without JAX, where the suite's conftest (which pins JAX) is
skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sbr_tpu_torch as st  # noqa: E402
from sbr_tpu_torch import _build  # noqa: E402
from sbr_tpu_torch.social import fused, rng  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_infection_kernel_matches_plain(cuda_device, np_dtype, n):
    g = np.random.default_rng(n)
    informed = g.random(n) < 0.3
    t_inf = np.where(informed, g.uniform(-1.0, 2.0, n), np.inf).astype(np_dtype)
    deg = g.integers(0, 9, n)
    counts = np.minimum(g.integers(0, 9, n), deg).astype(np.int32)
    ts = [torch.from_numpy(a).to(cuda_device) for a in (
        informed, t_inf, counts, g.lognormal(0.5, 0.5, n).astype(np_dtype),
        np.maximum(deg, 1).astype(np_dtype),
    )]
    k0, k1 = rng.fold_in(rng.prng_key(5), 17)
    t_next = float(np_dtype(1.8))
    before = _build.LAUNCHES[fused.KERNEL]
    got = fused._update_cuda(*ts, 7, k0, k1, t_next, 0.1)
    want = fused._update_plain(*ts, 7, k0, k1, t_next, 0.1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fused.KERNEL] == before + 1
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_simulation_on_card_equals_cpu_in_float64(cuda_device, engine):
    n = 3000
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=2)
    cfg = st.AgentSimConfig(n_steps=30, dt=0.1, exit_delay=0.5, reentry_delay=2.0)
    kw = dict(x0=0.01, config=cfg, seed=1, engine=engine, dtype=np.float64)
    cpu = st.simulate_agents(1.0, src, dst, n, device="cpu", **kw)
    before = _build.LAUNCHES[fused.KERNEL]
    card = st.simulate_agents(1.0, src, dst, n, device=cuda_device, **kw)
    assert _build.LAUNCHES[fused.KERNEL] == before + cfg.n_steps
    for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float16, torch.int32, torch.float16, torch.float16)]
    with pytest.raises(NotImplementedError):
        fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float32, torch.int64, torch.float32, torch.float32)]
    with pytest.raises(ValueError, match="counts"):
        fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)


def _belief_inputs(n, np_dtype, device):
    g = np.random.default_rng(n + 1)
    informed = g.random(n) < 0.1
    t_inf = np.where(informed, g.uniform(-1.0, 2.0, n), np.inf).astype(np_dtype)
    deg = g.integers(0, 15, n)
    counts = np.minimum(g.integers(0, 15, n), deg).astype(np.int32)
    arrays = (informed, t_inf, g.normal(0.5, 2.0, n).astype(np_dtype), counts,
              g.uniform(0.5, 3.0, n).astype(np_dtype), np.maximum(deg, 1).astype(np_dtype),
              g.logistic(3.0, 1.5, n).astype(np_dtype))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_belief_kernel_matches_plain(cuda_device, np_dtype, n):
    ts = _belief_inputs(n, np_dtype, cuda_device)
    llr0, llr1 = (float(np_dtype(v)) for v in st.InfoModelSpec(channel="bayes").llr)
    args = (float(np_dtype(1.8)), 0.05, llr0, llr1)
    before = _build.LAUNCHES[fused.BELIEF_KERNEL]
    got = fused._belief_cuda(*ts, *args)
    want = fused._belief_plain(*ts, *args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fused.BELIEF_KERNEL] == before + 1
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_bayes_on_card_equals_cpu_with_carried_fields(cuda_device, np_dtype):
    from sbr_tpu_torch.infomodels import engine

    spec = st.InfoModelSpec(channel="bayes")
    graph = st.ErdosRenyiSpec(3000, 8.0)
    cfg = st.AgentSimConfig(n_steps=30, dt=0.1, reentry_delay=2.0)
    fields = [f.numpy() for f in engine._agent_fields(spec, graph.n, 1, 0.9, np_dtype, "cpu")]
    kw = dict(x0=0.01, config=cfg, seed=1, dtype=np_dtype)
    cpu = st.simulate_info(spec, graph, device="cpu",
                           fields=engine.agent_fields_from_numpy(*fields, "cpu"), **kw)
    before = _build.LAUNCHES[fused.BELIEF_KERNEL]
    card = st.simulate_info(spec, graph, device=cuda_device,
                            fields=engine.agent_fields_from_numpy(*fields, cuda_device), **kw)
    assert _build.LAUNCHES[fused.BELIEF_KERNEL] == before + cfg.n_steps
    for f in ("informed", "t_inf", "belief", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


@pytest.mark.parametrize("engine", ["gather", "incremental"])
@pytest.mark.parametrize("kind", ["er", "sf", "sbm"])
def test_generated_graph_on_card_equals_cpu(cuda_device, kind, engine):
    spec = {"er": st.ErdosRenyiSpec(5000, 6.0), "sf": st.ScaleFreeSpec(5000, 6.0),
            "sbm": st.StochasticBlockSpec(5000, 6.0)}[kind]
    cpu = st.prepare_generated_graph(spec, seed=3, engine=engine, device="cpu")
    card = st.prepare_generated_graph(spec, seed=3, engine=engine, device=cuda_device)
    assert card.engine == cpu.engine
    for a, b in zip((cpu.src, cpu.row_ptr, cpu.indeg, *(cpu.inc or ())),
                    (card.src, card.row_ptr, card.indeg, *(card.inc or ()))):
        assert torch.equal(a, b.cpu())


def test_belief_kernel_refuses_what_it_does_not_take(cuda_device):
    args = (1.0, 0.1, -0.4, 5.8)
    ts = _belief_inputs(8, np.float32, cuda_device)
    half = [t.to(torch.float16) if t.is_floating_point() else t for t in ts]
    with pytest.raises(NotImplementedError):
        fused._belief_cuda(*half, *args)
    wrong = list(ts)
    wrong[3] = wrong[3].to(torch.int64)
    with pytest.raises(ValueError, match="counts"):
        fused._belief_cuda(*wrong, *args)


# -- the flagship equilibrium solve (no kernel: plain PyTorch on the card) --


def test_argmax_of_masks_takes_the_first_true_on_card(cuda_device):
    """The crossing indices rest on argmax of a uint8 mask returning its
    first maximal index (0 for an all-False row), on the card as on the
    CPU, for long rows split across thread blocks too."""
    from sbr_tpu_torch.core import rootfind

    g = np.random.default_rng(0)
    m = g.random((64, 4096)) < 0.002
    m[3] = False
    m[5] = True
    mask = torch.from_numpy(m)
    for f in (rootfind._first_true, rootfind._last_true):
        assert torch.equal(f(mask.to(cuda_device)).cpu(), f(mask))
    assert int(rootfind._first_true(mask.to(cuda_device))[3]) == 0


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_golden_scalars_on_card(cuda_device, numerics):
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params, with_overrides

    cfg = SolverConfig(numerics=numerics)
    out = {}
    for name, kw in (("fig3", {}), ("beta3", {"beta": 3.0}), ("u5", {"u": 5.0})):
        m = with_overrides(make_model_params(), **kw)
        ls = solve_learning(m.learning, cfg)
        assert ls.device.type == "cuda"
        out[name] = solve_equilibrium_baseline(ls, m.economic, cfg)
    r = out["fig3"]
    for got, want in ((r.xi, 10.215436), (r.tau_bar_in_unc, 7.327538),
                      (r.tau_bar_out_unc, 10.446095), (r.aw_max, 0.618231)):
        assert abs(float(got) - want) < 1e-6
    assert abs(float(out["beta3"].xi) - 3.256394) < 1e-6
    assert int(out["u5"].status) == 1 and np.isnan(float(out["u5"].xi))


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_on_card_equals_cpu(cuda_device, dtype, numerics):
    """A 24×24 subgrid of Figure 5 at n_grid 512: equal statuses, and ξ
    and AW_max within the port's tolerances against the reference
    (float64 1e-12, float32 2e-5): the card's exp and log round apart from
    the CPU's."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    idx = np.linspace(0, 499, 24).astype(int)
    betas = (1.0 / np.linspace(1e-4, 1.0, 500))[idx]
    us = np.linspace(0.001, 1.0, 500)[idx]
    cfg = SolverConfig(n_grid=512, bisect_iters=60, refine_crossings=False, numerics=numerics)
    cpu = beta_u_grid(betas, us, make_model_params(), cfg, dtype=dtype, device="cpu")
    card = beta_u_grid(betas, us, make_model_params(), cfg, dtype=dtype)
    assert card.status.device.type == "cuda"
    assert torch.equal(card.status.cpu(), cpu.status)
    assert torch.equal(card.health.flags.cpu(), cpu.health.flags)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    for f in ("xi", "max_aw"):
        a, b = getattr(cpu, f), getattr(card, f).cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(a)
        assert float((a[ok] - b[ok]).abs().max()) <= tol


def test_u_sweep_on_card_equals_cpu(cuda_device):
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import u_sweep

    m = make_model_params()
    cfg = SolverConfig(n_grid=1024)
    us = np.linspace(0.001, 0.2, 200)
    cpu = u_sweep(solve_learning(m.learning, cfg, device="cpu"), us, m.economic, cfg)
    card = u_sweep(solve_learning(m.learning, cfg, device=cuda_device), us, m.economic, cfg)
    assert torch.equal(card.status.cpu(), cpu.status)
    a, b = cpu.collapse_times, card.collapse_times.cpu()
    ok = ~torch.isnan(a)
    assert torch.equal(torch.isnan(a), torch.isnan(b)) and float((a[ok] - b[ok]).abs().max()) <= 1e-12


FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_social_fixed_point_on_card_equals_cpu(cuda_device, numerics):
    """The Figure-12 fixed point at n_grid 1024 in float64: iterations,
    flags and statuses equal; ξ and AW within 1e-10, the port's tolerance
    against the reference (the card's exp rounds apart from the CPU's)."""
    m = st.make_model_params(**FIG12)
    cfg = st.SolverConfig(n_grid=1024, numerics=numerics)
    cpu = st.solve_equilibrium_social(m, cfg, max_iter=500, device="cpu")
    card = st.solve_equilibrium_social(m, cfg, max_iter=500)
    assert card.aw.device.type == "cuda" and bool(card.converged)
    for a, b in ((cpu.iterations, card.iterations), (cpu.converged, card.converged),
                 (cpu.aborted, card.aborted), (cpu.equilibrium.status, card.equilibrium.status),
                 (cpu.health.flags, card.health.flags)):
        assert int(a) == int(b.cpu())
    for a, b in ((cpu.xi, card.xi), (cpu.aw, card.aw), (cpu.learning.cdf, card.learning.cdf)):
        assert float((a - b.cpu()).abs().max()) <= 1e-10


def test_gossip_close_loop_on_card_launches_the_kernel_each_step(cuda_device):
    """From one fixed point, the host-graph closure on the card launches the
    infection kernel once a step and a member, and its curves lie within a
    few agents' share of the CPU's (float32 simulation: the card's expf
    may flip a draw at the threshold)."""
    m = st.make_model_params(**FIG12)
    fp = st.solve_equilibrium_social(m, st.SolverConfig(n_grid=1024), max_iter=500, device="cpu")
    kw = dict(fp=fp, n_agents=5000, avg_degree=15.0, dt=0.1, t_max=12.0, n_reps=2)
    cpu = st.close_loop(m, device="cpu", **kw)
    before = _build.LAUNCHES[fused.KERNEL]
    card = st.close_loop(m, **kw)
    assert _build.LAUNCHES[fused.KERNEL] - before == 2 * len(card.t)
    assert (cpu.exit_delay, cpu.reentry_delay) == (card.exit_delay, card.reentry_delay)
    assert np.abs(cpu.g_sim - card.g_sim).max() <= 0.02
    assert card.err_aw_rms < 0.1


def test_bayes_close_loop_on_card_equals_cpu_with_carried_fields(cuda_device, monkeypatch):
    """The bayes closure with the CPU's per-agent fields on both devices:
    bit for bit, one belief launch a step and a member."""
    from sbr_tpu_torch.infomodels import engine

    m = st.make_model_params(**FIG12)
    spec = st.InfoModelSpec(channel="bayes")
    fp = st.solve_fixed_point_info(spec, m, config=st.SolverConfig(n_grid=512), max_iter=500,
                                   device="cpu")
    draw = engine._agent_fields

    def cpu_fields(spec_, n, seed, beta, dtype, device):
        return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

    monkeypatch.setattr(engine, "_agent_fields", cpu_fields)
    kw = dict(fp=fp, infomodel=spec, n_agents=4000, avg_degree=15.0, dt=0.05, g0=0.2,
              t_max=4.0, n_reps=2)
    cpu = st.close_loop(m, device="cpu", **kw)
    before = _build.LAUNCHES[fused.BELIEF_KERNEL]
    card = st.close_loop(m, **kw)
    assert _build.LAUNCHES[fused.BELIEF_KERNEL] - before == 2 * len(card.t)
    np.testing.assert_array_equal(cpu.aw_sim, card.aw_sim)
    np.testing.assert_array_equal(cpu.g_sim, card.g_sim)


@pytest.mark.parametrize("vary", ["sim", "graph"])
def test_population_query_on_card_equals_cpu(cuda_device, monkeypatch, vary):
    """A bayes population query from one fixed point, with the CPU's
    per-agent fields on both devices: the record is the CPU's exactly, and
    the belief kernel runs once a step and a member (no plain fallback)."""
    from sbr_tpu_torch.infomodels import engine, population_query

    m = st.make_model_params(**FIG12)
    spec = st.InfoModelSpec(channel="bayes")
    fp = st.solve_fixed_point_info(spec, m, config=st.SolverConfig(n_grid=256), max_iter=500,
                                   device="cpu")
    draw = engine._agent_fields

    def cpu_fields(spec_, n, seed, beta, dtype, device):
        return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

    monkeypatch.setattr(engine, "_agent_fields", cpu_fields)
    kw = dict(seeds=3, vary=vary, seed=4, g0=None, fp=fp)
    graph = st.ErdosRenyiSpec(3000, 10.0)
    cpu = population_query(spec, graph, m, device="cpu", **kw)
    _build.reset_launches()
    card = population_query(spec, graph, m, device=cuda_device, **kw)
    steps = int(round(float(m.economic.eta) / 0.1))
    assert _build.LAUNCHES[fused.BELIEF_KERNEL] == 3 * max(steps, 2)
    assert _build.LAUNCHES[fused.KERNEL] == 0
    assert card == cpu


SERVE_BUCKETS = (1, 8, 64, 512)


def _served_vs_eager(dtype, numerics, buckets):
    """Dispatch one full bucket of distinct queries per bucket through a
    card engine, and the same columns through the eager solve_param_cell;
    returns the engine and the pairs (served, eager) of (6, bucket) arrays."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.engine import _query_columns
    from sbr_tpu_torch.serve.loadgen import build_pool
    from sbr_tpu_torch.sweeps.baseline_sweeps import solve_param_cell

    cfg = SolverConfig(n_grid=1024, bisect_iters=60, refine_crossings=False, numerics=numerics)
    engine = Engine(config=cfg, dtype=dtype, serve=ServeConfig(buckets=buckets), device="cuda")
    pairs = []
    try:
        for b in buckets:
            pool = build_pool(b, b)
            recs = engine._dispatch(pool)
            served = np.array([[r[k] for r in recs] for k in
                               ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual")])
            cols = torch.from_numpy(_query_columns(pool, np.dtype(str(dtype)[6:]))).cuda()
            xi, tau, aw, status, health = solve_param_cell(*cols, cfg, dtype, "cuda")
            eager = torch.stack([xi, tau, aw, status.to(dtype), health.flags.to(dtype),
                                 health.residual]).double().cpu().numpy()
            pairs.append((served, eager))
    finally:
        engine.close()
    return engine, pairs


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_served_graph_replay_equals_eager_solve(cuda_device, dtype, numerics):
    """Every bucket's replayed CUDA graph answers bit for bit as the eager
    solve_param_cell on the card (the adaptive root-find runs its whole
    budget in the graph, its host checks in the eager call)."""
    engine, pairs = _served_vs_eager(dtype, numerics, SERVE_BUCKETS)
    for served, eager in pairs:
        nan = np.isnan(eager)
        assert np.array_equal(np.isnan(served), nan)
        assert served[~nan].tobytes() == eager[~nan].tobytes()
    assert engine.graphs.captured == {b: 1 for b in SERVE_BUCKETS}
    assert engine.graphs.replays == len(SERVE_BUCKETS) and engine.graphs.eager_runs == 0


def test_warm_engine_captures_nothing_new(cuda_device):
    """A warm replay (new queries, buckets already captured) adds no
    capture; a repeated query is an LRU hit."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool

    cfg = SolverConfig(n_grid=512, bisect_iters=40, refine_crossings=False)
    with Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)), device="cuda") as engine:
        engine.query_many(build_pool(1, 8), timeout=300)
        engine.query_many(build_pool(2, 1), timeout=300)
        assert engine.graphs.captured == {1: 1, 8: 1}
        fresh = engine.query_many(build_pool(3, 8) + build_pool(4, 1), timeout=300)
        again = engine.query_many(build_pool(3, 8), timeout=300)
        assert engine.graphs.captured == {1: 1, 8: 1}
        assert engine.graphs.replays == engine.live.totals["batches"]
    assert all(r.source == "computed" for r in fresh)
    assert all(r.source == "lru" for r in again)


def test_served_answers_do_not_depend_on_the_bucket(cuda_device):
    """The same queries answered in buckets 1, 8, 64 and 512 on the card:
    bit for bit (torch.cumsum's bits there depend on the row count, so the
    cumulative integrals use the doubling prefix sum)."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool

    pool = build_pool(21, 8)
    cfg = SolverConfig(n_grid=1024, bisect_iters=60, refine_crossings=False)
    signatures = []
    for buckets in ((1,), (8,), (64,), (512,)):
        with Engine(config=cfg, serve=ServeConfig(buckets=buckets), device="cuda") as engine:
            res = engine.query_many(pool, timeout=300)
        signatures.append([(np.float64(r.xi).tobytes(), np.float64(r.tau_bar_in).tobytes(),
                            np.float64(r.aw_max).tobytes(), r.status, r.flags) for r in res])
    assert signatures[0] == signatures[1] == signatures[2] == signatures[3]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cumulative_integrals_do_not_depend_on_the_row_count(cuda_device, dtype):
    from sbr_tpu_torch.core import integrate

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(2048, 4095, dtype=dtype, device="cuda", generator=g)
    full = integrate._cum_from_zero(x)
    for rows in (1, 2, 8, 512):
        assert torch.equal(integrate._cum_from_zero(x[:rows].contiguous()), full[:rows])
    ref = np.cumsum(x.cpu().numpy().astype(np.longdouble), -1)  # extended precision
    err = np.abs(full[:, 1:].cpu().numpy().astype(np.longdouble) - ref).max() / ref.max()
    assert float(err) < (1e-15 if dtype == torch.float64 else 1e-6)


# ---------------------------------------------------------------------------
# Slice 6: the recount gather kernel and the extensions on the card
# ---------------------------------------------------------------------------


# (agents, packed, branch, staging cluster): every branch the size rule
# chooses, reached by the mask's size. Packed: 125 and 125,000 bytes (the
# whole table in a block), 250,001 and 500,000 (split), 10^6 (global).
# Unpacked: 1,000, 400,000 and 10^6 bytes (the whole table, staged by
# clusters of 1, 2 and 4), 2,000,008 and 4,000,000 (split), 8,000,000
# (global).
RECOUNT_CASES = [
    (1000, True, "shared", 1), (1_000_000, True, "shared", 1), (2_000_003, True, "split", 1),
    (4_000_000, True, "split", 1), (8_000_000, True, "global", 1),
    (1000, False, "shared", 1), (400_000, False, "shared", 2), (1_000_000, False, "shared", 4),
    (2_000_003, False, "split", 4), (4_000_000, False, "split", 4),
    (8_000_000, False, "global", 1),
]


@pytest.mark.parametrize("n,packed,branch,cluster", RECOUNT_CASES)
def test_recount_kernel_matches_plain(cuda_device, n, packed, branch, cluster):
    from sbr_tpu_torch.benchmarks import ablate_pallas_recount as abl
    from sbr_tpu_torch.social import recount

    wd, src, t = abl.make_inputs(n, 300_000, cuda_device)
    mask = t["packed"] if packed else t["wd_u8"]
    layout = "packed" if packed else "unpacked"
    plain = recount.bit_gather_plain if packed else recount.bool_gather_plain
    entry = recount.bit_gather if packed else recount.bool_gather
    for ids in (t["src"], t["src_2d"]):
        before = _build.LAUNCHES[recount.KERNEL]
        got = entry(mask, ids)
        want = plain(mask, ids)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[recount.KERNEL] == before + 1
        plan = recount.plan_for(mask, ids, packed=packed)
        assert recount.LAST_PLAN[layout] == plan and recount.LAST_BRANCH[layout] == branch
        assert plan.cluster == cluster
        assert got.shape == ids.shape and got.dtype == torch.int32
        assert torch.equal(got, want)
        assert np.array_equal(got.reshape(-1).cpu().numpy(), wd[src].astype(np.int32))


@pytest.mark.parametrize("n", [1_000_000, 8_000_000])
@pytest.mark.parametrize("packed", [True, False])
def test_recount_kernel_on_the_other_side_of_the_size_rule(cuda_device, packed, n):
    # the branch the threshold does not choose, as chip_smoke.py times it
    from sbr_tpu_torch.benchmarks import ablate_pallas_recount as abl
    from sbr_tpu_torch.social import recount

    _, _, t = abl.make_inputs(n, 300_000, cuda_device)
    mask = t["packed"] if packed else t["wd_u8"]
    plan = recount.plan_for(mask, t["src"], packed=packed)
    other = recount.plan_for(mask, t["src"], packed=packed,
                             shared_max=0 if plan.branch == "shared" else 1 << 30)
    assert other.branch != plan.branch
    got = recount.launch(mask, t["src"], other, packed=packed)
    plain = recount.bit_gather_plain if packed else recount.bool_gather_plain
    assert torch.equal(got, plain(mask, t["src"]))
    assert recount.LAST_PLAN["packed" if packed else "unpacked"] == other


@pytest.mark.parametrize("n", [200_000, 1_000_000])
def test_recount_unpacked_bytes_other_than_0_and_1_read_as_they_are(cuda_device, n):
    from sbr_tpu_torch.social import recount

    g = np.random.default_rng(3)
    mask = torch.from_numpy(g.choice(np.array([0, 1, 2, 255], np.uint8), n)).to(cuda_device)
    ids = torch.from_numpy(g.integers(0, mask.numel(), 300_001).astype(np.int32)).to(cuda_device)
    got = recount.bool_gather(mask, ids)
    assert recount.LAST_BRANCH["unpacked"] == "shared"
    assert recount.LAST_PLAN["unpacked"].cluster == (1 if n < 262_144 else 4)
    assert torch.equal(got, recount.bool_gather_plain(mask, ids))
    mask[mask > 1] = 1  # back to 0/1: the bit table again
    assert torch.equal(recount.bool_gather(mask, ids), recount.bool_gather_plain(mask, ids))


# (packed, mask bytes, branch): a mask view one byte in, of a length that
# is no multiple of 16, for every branch (and each unpacked staging cluster)
RAGGED_MASKS = [
    (True, 1001, "shared"), (True, 250_001, "split"), (True, 600_001, "global"),
    (False, 1001, "shared"), (False, 300_001, "shared"), (False, 600_001, "shared"),
    (False, 2_000_009, "split"), (False, 4_200_001, "global"),
]


@pytest.mark.parametrize("n_edges", [1, 3, 131_071, 300_001])
@pytest.mark.parametrize("packed,mask_bytes,branch", RAGGED_MASKS)
def test_recount_kernel_on_ragged_views(cuda_device, packed, mask_bytes, branch, n_edges):
    from sbr_tpu_torch.social import recount

    # views one element in: ids 4 bytes off 16-byte alignment, the mask 1
    # byte off
    g = np.random.default_rng(n_edges)
    mask_full = torch.from_numpy(
        g.integers(0, 256 if packed else 2, mask_bytes + 1).astype(np.uint8)).to(cuda_device)
    mask = mask_full[1:]
    n_ids = mask.numel() * (8 if packed else 1)
    src_full = torch.from_numpy(g.integers(0, n_ids, n_edges + 1).astype(np.int32))
    layout = "packed" if packed else "unpacked"
    entry = recount.bit_gather if packed else recount.bool_gather
    plain = recount.bit_gather_plain if packed else recount.bool_gather_plain
    for ids in (src_full[1:].to(cuda_device), src_full.to(cuda_device)[1:],
                src_full.to(cuda_device)[1:].view(1, -1)):
        before = _build.LAUNCHES[recount.KERNEL]
        got = entry(mask, ids)
        want = plain(mask, ids)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[recount.KERNEL] == before + 1
        assert recount.LAST_PLAN[layout] == recount.plan_for(mask, ids, packed=packed)
        assert recount.LAST_BRANCH[layout] == branch
        assert got.shape == ids.shape and torch.equal(got, want)


@pytest.mark.parametrize("packed,mask_bytes,branch", [
    (True, 1000, "shared"), (True, 250_001, "split"), (True, 600_000, "global"),
    (False, 1000, "shared"), (False, 2_000_008, "split"), (False, 4_200_000, "global"),
])
def test_recount_kernel_reads_zero_outside_the_mask(cuda_device, packed, mask_bytes, branch):
    from sbr_tpu_torch.social import recount

    mask = torch.full((mask_bytes,), 255 if packed else 1, dtype=torch.uint8, device=cuda_device)
    n_ids = mask.numel() * (8 if packed else 1)
    ids = torch.tensor([0, n_ids - 1, n_ids, -1, -(2 ** 31), 2 ** 31 - 1, 5] * 100,
                       dtype=torch.int32, device=cuda_device)
    got = (recount.bit_gather if packed else recount.bool_gather)(mask, ids)
    assert recount.LAST_BRANCH["packed" if packed else "unpacked"] == branch
    assert got.cpu().tolist() == [1, 1, 0, 0, 0, 0, 1] * 100


def test_recount_kernel_refuses_what_it_does_not_take(cuda_device):
    from sbr_tpu_torch.social import recount

    packed = torch.zeros(16, dtype=torch.uint8, device=cuda_device)
    ids = torch.zeros(256, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        recount.bit_gather(packed, ids.to(torch.int64))
    with pytest.raises(ValueError, match="share a device"):
        recount.bit_gather(packed.cpu(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        recount.bool_gather(packed, ids.view(16, 16).t())


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("case", ["section2", "section3", "policy"])
def test_extensions_on_card_equal_cpu(cuda_device, case, numerics):
    import sbr_tpu_torch.models as tm
    from sbr_tpu_torch.hetero import solve_equilibrium_hetero, solve_learning_hetero
    from sbr_tpu_torch.interest import solve_equilibrium_interest
    from sbr_tpu_torch.sweeps.policy_sweeps import policy_sweep_interest

    def solve(dev):
        if case == "section2":
            cfg = st.SolverConfig(n_grid=512, numerics=numerics)
            m = tm.make_hetero_params(betas=(0.125, 12.5), dist=(0.9, 0.1), eta_bar=30.0, u=0.1,
                                      p=0.9, kappa=0.3, lam=0.1)
            r = solve_equilibrium_hetero(solve_learning_hetero(m.learning, cfg, device=dev),
                                         m.economic, cfg)
            return r.status, r.health.flags, (r.xi, r.tau_bar_in_uncs, r.hrs)
        if case == "section3":
            cfg = st.SolverConfig(n_grid=512, numerics=numerics)
            m = tm.make_interest_params(u=0.0, r=0.06, delta=0.1)
            r = solve_equilibrium_interest(st.solve_learning(m.learning, cfg, device=dev),
                                           m.economic, cfg)
            return r.base.status, r.base.health.flags, (r.base.xi, r.v, r.hr_effective)
        cfg = st.SolverConfig(n_grid=256, numerics=numerics, refine_crossings=False)
        r = policy_sweep_interest([0.5, 3.0], [0.0, 0.45], [0.0, 0.09],
                                  tm.make_interest_params(u=0.0, delta=0.1), cfg, device=dev)
        return r.status, r.health.flags, (r.xi, r.aw_max)

    cpu, card = solve("cpu"), solve(cuda_device)
    assert torch.equal(cpu[0], card[0].cpu()) and torch.equal(cpu[1], card[1].cpu())
    # values that pass through bs32 may differ by a step decision
    # (tests/test_torch_ode.py); the others are held to the port's 1e-12
    tol = 1e-6 if (numerics == "adaptive" and case != "section2") else 1e-12
    for a, b in zip(cpu[2], card[2]):
        b = b.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(a)
        assert float((a[ok] - b[ok]).abs().max()) <= tol


# ---------------------------------------------------------------------------
# Panic rewiring and the gradient layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["er", "sf"])
@pytest.mark.parametrize("bias", [0.0, 4.0])
def test_tilt_table_and_sources_on_card_equal_cpu(cuda_device, graph, bias):
    """The tilt table (XLA's blocked prefix, its float32 divide, product and
    saturating cast) and the tilted sources are the CPU's bit for bit."""
    from sbr_tpu_torch.infomodels import engine
    from sbr_tpu_torch.social import graphgen

    n = 300_007
    spec = st.ErdosRenyiSpec(n, 10.0) if graph == "er" else st.ScaleFreeSpec(n, 10.0)
    wd = torch.from_numpy(np.random.default_rng(1).random(n) < 0.25)
    out = []
    for dev in ("cpu", cuda_device):
        thr = graphgen.tilt_threshold_table(engine._base_source_weights(spec, dev), wd.to(dev),
                                            bias)
        src = graphgen.generate_tilted_sources(n, spec.edge_count(3),
                                               graphgen.epoch_key_words(3, 2), thr,
                                               chunk_edges=1 << 20)
        out.append((thr.cpu(), src.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert int(out[1][0][-1]) == 2**32 - 1


@pytest.mark.parametrize("channel", ["gossip", "bayes"])
def test_rewire_on_card_launches_steps_and_equals_cpu(cuda_device, channel):
    """A rewire run launches its channel's kernel once a step and the
    other never, and equals the CPU's bit for bit (fields carried)."""
    from sbr_tpu_torch.infomodels import engine
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    n = 30_000
    spec = st.InfoModelSpec(channel=channel, dynamics="rewire", epoch_steps=7)
    graph = st.ErdosRenyiSpec(n, 8.0)
    cfg = st.AgentSimConfig(n_steps=30, dt=0.05, reentry_delay=1.0)
    fields = [f.numpy() for f in engine._agent_fields(spec, n, 4, 1.5, np.float32, "cpu")]
    kw = dict(beta=1.5, x0=0.01, config=cfg, seed=4)
    cpu = st.simulate_info(spec, graph, device="cpu",
                           fields=engine.agent_fields_from_numpy(*fields, "cpu"), **kw)
    kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
    _build.reset_launches()
    card = st.simulate_info(spec, graph, device=cuda_device,
                            fields=engine.agent_fields_from_numpy(*fields, cuda_device), **kw)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES[kernel], _build.LAUNCHES[other]) == (cfg.n_steps, 0)
    assert card.epochs == cpu.epochs == 5
    names = ("informed", "t_inf", "informed_frac", "withdrawn_frac") + (
        ("belief",) if channel == "bayes" else ())
    for f in names:
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


def test_grads_on_card_equal_cpu(cuda_device):
    """A sensitivity subgrid on the card: statuses and flags the CPU's, ξ
    within 1e-12, the partials of trusted cells within 1e-10 relative."""
    from sbr_tpu_torch import grad

    cfg = st.SolverConfig(n_grid=512, bisect_iters=60, refine_crossings=False)
    betas, us = np.linspace(0.5, 2.5, 8), np.linspace(0.03, 0.3, 8)
    out = [grad.sensitivity_surface(betas, us, st.make_model_params(), config=cfg, device=d)
           for d in ("cpu", cuda_device)]
    a, b = out[0], out[1]
    assert torch.equal(a.status, b.status.cpu()) and torch.equal(a.flags, b.flags.cpu())
    trusted = (a.flags == 0) & (a.status == 0)
    assert int(trusted.sum()) > 0
    for k in a.grads:
        x, y = a.grads[k][trusted], b.grads[k].cpu()[trusted]
        assert float(((x - y).abs() / x.abs()).max()) <= 1e-10, k
    ok = ~torch.isnan(a.xi)
    assert float((a.xi[ok] - b.xi.cpu()[ok]).abs().max()) <= 1e-12


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
def test_served_grads_graph_replay_equals_eager(cuda_device, numerics):
    """The grads program captured into a CUDA graph, its backward inside
    the capture, answers bit for bit as `cell_value_and_grads` run
    eagerly on the card, in every bucket."""
    from sbr_tpu_torch.grad.api import WRT_DEFAULT, cell_value_and_grads
    from sbr_tpu_torch.grad.cell import BASE_KEYS
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.engine import _query_columns
    from sbr_tpu_torch.serve.loadgen import build_pool

    cfg = st.SolverConfig(n_grid=512, bisect_iters=40, refine_crossings=False,
                          numerics=numerics)
    pool = build_pool(9, 8)
    cols = torch.tensor(_query_columns(pool, np.float64), device=cuda_device)
    _, _, grads, _, _, gflags = cell_value_and_grads(dict(zip(BASE_KEYS, cols)), WRT_DEFAULT,
                                                     cfg, torch.float64)
    want = torch.stack([grads[k] for k in WRT_DEFAULT]).cpu().numpy()
    for buckets in ((1,), (8,)):
        with Engine(config=cfg, serve=ServeConfig(buckets=buckets), device="cuda") as engine:
            res = engine.query_many(pool, grads=True, timeout=300)
            assert engine.graphs.captured_grads == {buckets[0]: 1}
            assert engine.graphs.eager_runs == 0
        got = np.array([[r.grads[k] for k in WRT_DEFAULT] for r in res]).T
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert got[~np.isnan(got)].tobytes() == want[~np.isnan(want)].tobytes()
        assert [r.grad_flags for r in res] == [int(f) for f in gflags.cpu()]


TILED_CFG = dict(n_grid=256, bisect_iters=60, refine_crossings=False)


def _tiled_grid(device, dtype, numerics, **kw):
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    return run_tiled_grid(np.linspace(0.3, 3.0, 24), np.linspace(0.01, 0.95, 20),
                          st.make_model_params(),
                          config=st.SolverConfig(numerics=numerics, **TILED_CFG),
                          tile_shape=(7, 6), dtype=dtype, device=device, **kw)


@pytest.mark.parametrize("numerics", ["fixed", "adaptive"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_grid_on_card_equals_cpu(cuda_device, dtype, numerics):
    """A ragged 24×20 grid in 7×6 tiles on the card and on the CPU:
    statuses equal, floats within 1e-12 (float64) or 2e-5 (float32)."""
    card = _tiled_grid(cuda_device, dtype, numerics)
    cpu = _tiled_grid("cpu", dtype, numerics)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert torch.equal(card.status, cpu.status)
    for f in ("xi", "max_aw"):
        a, b = getattr(card, f), getattr(cpu, f)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(a)
        assert float((a[ok] - b[ok]).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_grid_on_card_is_monolithic_bit_for_bit(cuda_device, dtype):
    tiled = _tiled_grid(cuda_device, dtype, "adaptive")
    mono = st.beta_u_grid(np.linspace(0.3, 3.0, 24), np.linspace(0.01, 0.95, 20),
                          st.make_model_params(),
                          config=st.SolverConfig(numerics="adaptive", **TILED_CFG),
                          dtype=dtype, device=cuda_device)
    for f in ("xi", "max_aw", "status"):
        assert getattr(tiled, f).numpy().tobytes() == getattr(mono, f).cpu().numpy().tobytes()


def test_faulted_and_resumed_on_card_equals_fault_free(cuda_device, tmp_path):
    from sbr_tpu_torch.resilience import FaultPlan, faults

    clean = _tiled_grid(cuda_device, torch.float64, "adaptive")
    faults.install(FaultPlan({"seed": 1, "rules": [
        {"point": "tile.compute", "kind": "transient", "at_hits": [2]},
        {"point": "tile.result", "kind": "nan", "at_hits": [3], "cells": 4},
        {"point": "checkpoint.save", "kind": "corrupt", "at_hits": [4]},
    ]}))
    try:
        report = {}
        faulted = _tiled_grid(cuda_device, torch.float64, "adaptive",
                              checkpoint_dir=tmp_path, report=report)
    finally:
        faults.install(None)
    assert len(report["repairs"]) == 4 and all(r["repaired"] for r in report["repairs"])
    report = {}
    resumed = _tiled_grid(cuda_device, torch.float64, "adaptive", checkpoint_dir=tmp_path,
                          report=report)
    assert report["counts"]["computed"] == 1
    for f in ("xi", "max_aw", "status"):
        want = getattr(clean, f).numpy().tobytes()
        assert getattr(faulted, f).numpy().tobytes() == want
        assert getattr(resumed, f).numpy().tobytes() == want
