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


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_ranges_put_no_event_on_the_device(cuda_device, monkeypatch, engine):
    """Under a CPU and CUDA profiler the step loop's ranges are host
    operations only: the device's timeline holds the same kernels as with
    the ranges off, none named after a range, and the answer is the same."""
    from torch.profiler import ProfilerActivity, profile

    from sbr_tpu_torch.obs import prof

    n = 20_000
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=3)
    cfg = st.AgentSimConfig(n_steps=20, dt=0.1, exit_delay=0.5, reentry_delay=2.0)
    pg = st.prepare_agent_graph(1.0, src, dst, n, config=cfg, engine=engine, device=cuda_device)

    def traced():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            r = st.simulate_agents(prepared=pg, x0=0.01, config=cfg, seed=4)
            torch.cuda.synchronize()
        events = list(p.profiler.kineto_results.events())
        device = [e.name() for e in events
                  if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
        return r, device, [e.name() for e in events if e.name().startswith("agents.")]

    with monkeypatch.context() as m:
        m.setattr(prof, "ranges_on", lambda: False)
        plain, device_off, host_off = traced()
    ranged, device_on, host_on = traced()
    assert host_off == [] and host_on.count("agents.step") == cfg.n_steps
    assert not [name for name in device_on if name.startswith("agents.")]
    assert sorted(device_on) == sorted(device_off)
    for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac", "full_recount_steps"):
        assert torch.equal(getattr(plain, f), getattr(ranged, f)), f


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    # float16 has a kernel of its own now: it runs, equal to its plain version
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float16, torch.int32, torch.float16, torch.float16)]
    for w, k in zip(fused._update_plain(*ts, 0, 1, 2, 0.1, 0.1),
                    fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)):
        assert torch.equal(w, k)
    ints = [t.to(torch.int16) if t.is_floating_point() else t for t in ts]
    with pytest.raises(NotImplementedError):
        fused._update_cuda(*ints, 0, 1, 2, 0.1, 0.1)
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float32, torch.int64, torch.float32, torch.float32)]
    with pytest.raises(ValueError, match="counts"):
        fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)


ALL_TYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16]


def _frontier_inputs(n, dtype, frontier, device, seed=0, pad=0):
    """The infection step's inputs with the frontier (not informed, counts
    != 0) "mixed", "late" (97% informed, as late in a run: most lanes
    hold no frontier agent), "none" (every agent informed) or "all" (none
    informed, every count at least 1). ``pad`` > 0 makes informed, counts
    and t_inf views that start ``pad`` elements into a larger buffer, so
    none of them is 16-byte aligned."""
    g = np.random.default_rng(seed)
    informed = g.random(n) < (0.97 if frontier == "late" else 0.3)
    deg = g.integers(0, 9, n)
    counts = np.minimum(g.integers(0, 9, n), deg).astype(np.int32)
    if frontier == "none":
        informed[:] = True
    elif frontier == "all":
        informed[:] = False
        counts = np.maximum(counts, 1)
        deg = np.maximum(deg, counts)
    t_inf = np.where(informed, g.uniform(-1.0, 2.0, n), np.inf)
    arrays = (informed, t_inf, counts, g.lognormal(0.5, 0.5, n),
              np.maximum(deg, 1).astype(np.float64))
    ts = [torch.from_numpy(a).to(device) for a in arrays]
    ts = [t.to(dtype) if t.is_floating_point() else t for t in ts]
    if pad:
        for k in (0, 1, 2):
            buf = torch.zeros(n + pad, dtype=ts[k].dtype, device=device)
            buf[pad:] = ts[k]
            ts[k] = buf[pad:]
            assert ts[k].data_ptr() % 16 != 0 and ts[k].is_contiguous()
    return ts


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _kernel_equals_plain(ts, id0, dtype):
    k0, k1 = rng.fold_in(rng.prng_key(5), 17)
    t_next = fused.host_round(1.8, dtype)
    before = _build.LAUNCHES[fused.KERNEL]
    got_i, got_t = fused._update_cuda(*ts, id0, k0, k1, t_next, 0.1)
    want_i, want_t = fused._update_plain(*ts, id0, k0, k1, t_next, 0.1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fused.KERNEL] == before + 1
    assert torch.equal(got_i, want_i)
    assert torch.equal(_bits(got_t), _bits(want_t))
    return want_i, want_t


# ragged lengths: one under and over a multiple of a lane's 4 agents and of
# 8 and 16, of a warp's 32 lanes, of a warp's tile (128 agents) and a
# block's (1,024), and of 512 and 4,096
RAGGED_N = [1, 3, 5, 7, 9, 15, 17, 31, 33, 127, 129, 511, 513, 1023, 1025, 4095, 4097]


@pytest.mark.parametrize("frontier", ["none", "all", "mixed", "late"])
@pytest.mark.parametrize("dtype", ALL_TYPES)
@pytest.mark.parametrize("n", RAGGED_N + [100_003])
def test_infection_kernel_frontier_extremes_and_ragged_n(cuda_device, dtype, n, frontier):
    """Bit for bit the plain version, which computes every lane, at an
    empty and a full frontier and at every ragged tail."""
    ts = _frontier_inputs(n, dtype, frontier, cuda_device, seed=n)
    want_i, _ = _kernel_equals_plain(ts, 7, dtype)
    if frontier == "none":
        assert bool(want_i.all())


@pytest.mark.parametrize("pad", [1, 3])
@pytest.mark.parametrize("dtype", ALL_TYPES)
@pytest.mark.parametrize("n", [33, 4097, 100_003])
def test_infection_kernel_on_unaligned_views(cuda_device, dtype, n, pad):
    """informed, counts and t_inf as views that start off a 16-byte
    boundary (as the sharded gather's counts slice may) take the scalar
    path, bit for bit the plain version."""
    ts = _frontier_inputs(n, dtype, "mixed", cuda_device, seed=n + pad, pad=pad)
    _kernel_equals_plain(ts, 7, dtype)


@pytest.mark.parametrize("frontier", ["mixed", "late"])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_infection_kernel_walks_several_tiles_a_warp(cuda_device, dtype, pad, frontier):
    """Past 2 x 128 agents for every warp the card holds at once, each warp
    of the persistent grid takes two tiles or more, so the next tile's
    loads fly while it decides one: aligned and on unaligned views, on a
    wide and a sparse frontier."""
    n = 3_000_017
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert n > 2 * 128 * 64 * sms  # 64 warps an SM at most
    ts = _frontier_inputs(n, dtype, frontier, cuda_device, seed=n + pad, pad=pad)
    _kernel_equals_plain(ts, 7, dtype)


@pytest.mark.parametrize("dtype", ALL_TYPES)
def test_infection_kernel_id_wraps_at_two_to_the_32(cuda_device, dtype):
    """The draw's counter id0 + i wraps modulo 2^32 inside the launch."""
    n = 5000
    ts = _frontier_inputs(n, dtype, "all", cuda_device, seed=11)
    want_i, want_t = _kernel_equals_plain(ts, 2**32 - 2000, dtype)
    # past the wrap, agent 2000 + j draws with the counter j
    k0, k1 = rng.fold_in(rng.prng_key(5), 17)
    tail_i, tail_t = fused._update_plain(*(t[2000:] for t in ts), 0, k0, k1,
                                         fused.host_round(1.8, dtype), 0.1)
    assert torch.equal(want_i[2000:], tail_i)
    assert torch.equal(_bits(want_t[2000:]), _bits(tail_t))


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


HALF_TYPES = [torch.float16, torch.bfloat16]


@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_half_infection_kernel_matches_plain(cuda_device, dtype, n):
    """float16 and bfloat16: every operation rounded to the type in both,
    the uniform clamped below 1.0; bit for bit."""
    g = np.random.default_rng(n + 7)
    informed = g.random(n) < 0.3
    deg = g.integers(0, 9, n)
    arrays = (informed, np.where(informed, g.uniform(-1.0, 2.0, n), np.inf),
              np.minimum(g.integers(0, 9, n), deg).astype(np.int32),
              g.lognormal(0.5, 0.5, n), np.maximum(deg, 1).astype(np.float64))
    ts = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    ts = [t.to(dtype) if t.is_floating_point() else t for t in ts]
    k0, k1 = rng.fold_in(rng.prng_key(5), 17)
    t_next = fused.host_round(1.8, dtype)
    before = _build.LAUNCHES[fused.KERNEL]
    got = fused._update_cuda(*ts, 7, k0, k1, t_next, 0.1)
    want = fused._update_plain(*ts, 7, k0, k1, t_next, 0.1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fused.KERNEL] == before + 1
    assert got[1].dtype == dtype
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("n", [1, 1000, 100_003])
def test_half_belief_kernel_matches_plain(cuda_device, dtype, n):
    """float16 (the two multiply-adds each a float32 fma rounded to
    float16) and bfloat16 (every operation rounded): bit for bit."""
    ts = [t.to(dtype) if t.is_floating_point() else t
          for t in _belief_inputs(n, np.float32, cuda_device)]
    llr0, llr1 = (fused.host_round(v, dtype) for v in st.InfoModelSpec(channel="bayes").llr)
    args = (fused.host_round(1.8, dtype), 0.05, llr0, llr1)
    before = _build.LAUNCHES[fused.BELIEF_KERNEL]
    got = fused._belief_cuda(*ts, *args)
    want = fused._belief_plain(*ts, *args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[fused.BELIEF_KERNEL] == before + 1
    for w, k in zip(want, got):
        assert torch.equal(w, k)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_simulation_on_card_equals_cpu(cuda_device, dtype):
    """A float16 or bfloat16 run on the card through the kernel equals the
    CPU's plain run bit for bit."""
    ml_dtypes = pytest.importorskip("ml_dtypes")  # numpy's bfloat16
    np_dtype = np.dtype(getattr(ml_dtypes, dtype) if dtype == "bfloat16" else dtype)
    n = 3000
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=2)
    cfg = st.AgentSimConfig(n_steps=30, dt=0.1, exit_delay=0.5, reentry_delay=2.0)
    kw = dict(x0=0.01, config=cfg, seed=1, dtype=np_dtype)
    cpu = st.simulate_agents(1.0, src, dst, n, device="cpu", **kw)
    before = _build.LAUNCHES[fused.KERNEL]
    card = st.simulate_agents(1.0, src, dst, n, device=cuda_device, **kw)
    assert _build.LAUNCHES[fused.KERNEL] == before + cfg.n_steps
    for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_foldin_on_card_equals_cpu(cuda_device, engine):
    """The foldin stream runs unfused on the card too (the reference's
    rule): no kernel launch, and the CPU's run bit for bit."""
    n = 3000
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=2)
    cfg = st.AgentSimConfig(n_steps=25, dt=0.1, exit_delay=0.5, reentry_delay=2.0,
                            rng_stream="foldin")
    kw = dict(x0=0.01, config=cfg, seed=1, engine=engine, dtype=np.float32)
    cpu = st.simulate_agents(1.0, src, dst, n, device="cpu", **kw)
    before = _build.LAUNCHES[fused.KERNEL]
    card = st.simulate_agents(1.0, src, dst, n, device=cuda_device, **kw)
    assert _build.LAUNCHES[fused.KERNEL] == before
    for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


def test_engine_captures_every_bucket_before_it_serves(cuda_device):
    """A fleet worker's warm start: one capture a bucket, none later."""
    from sbr_tpu_torch.serve import Engine, ServeConfig

    eng = Engine(config=st.SolverConfig(n_grid=64, bisect_iters=20, refine_crossings=False),
                 serve=ServeConfig(buckets=(1, 8)), device=cuda_device)
    try:
        assert eng.capture_programs() == 2
        assert dict(eng.graphs.captured) == {1: 1, 8: 1}
        assert eng.capture_programs() == 0
        r = eng.query(st.make_model_params())
        assert dict(eng.graphs.captured) == {1: 1, 8: 1} and r.status in (0, 1, 2, 3, 4)
    finally:
        eng.close()


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
    # float16 has a kernel of its own now: it runs, equal to its plain version
    half = [t.to(torch.float16) if t.is_floating_point() else t for t in ts]
    for w, k in zip(fused._belief_plain(*half, *args), fused._belief_cuda(*half, *args)):
        assert torch.equal(w, k)
    ints = [t.to(torch.int16) if t.is_floating_point() else t for t in ts]
    with pytest.raises(NotImplementedError):
        fused._belief_cuda(*ints, *args)
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


# -- the ξ stage's kernel (csrc/xi_bisect.cu) against the eager route --


def _xi_eager(ti, to, ls, kappa, cfg):
    """The eager route on the card: an explicit bracket equal to the
    default one, which the kernel's dispatch leaves to PyTorch."""
    return st.baseline.compute_xi(ti, to, ls, kappa, cfg, lo=ti, hi=to, with_health=True)


@pytest.mark.parametrize("dtype, rows, cols", [
    (torch.float32, slice(500, 1000), slice(4500, 5000)),
    (torch.float32, slice(2000, 2500), slice(1000, 1500)),
    (torch.float64, "sub64", "sub64"),
])
def test_xi_kernel_equals_eager_bit_for_bit(cuda_device, dtype, rows, cols):
    """A 500×500 tile of the paper's Figure-5 grid (n_grid 4096, 90 steps)
    in float32 (two tiles where roots, cells without one and cells without
    a crossing mix), and a 64×64 subgrid of the grid in float64: xi, err,
    root_ok, is_increasing and every Health field carry the eager route's
    bits."""
    from sbr_tpu_torch.baseline import xi_kernel
    from xi_cases import assert_same_stage, grid_inputs, subgrid

    if rows == "sub64":
        rows = cols = subgrid(64)
    else:
        rows, cols = np.arange(5000)[rows], np.arange(5000)[cols]
    ls, ti, to, kappa, cfg = grid_inputs(rows, cols, dtype, cuda_device, n_grid=4096, iters=90)
    before = _build.LAUNCHES[xi_kernel.KERNEL]
    got = st.baseline.compute_xi(ti, to, ls, kappa, cfg, with_health=True)
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before + 1
    want = _xi_eager(ti, to, ls, kappa, cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before + 1
    assert got[0].shape == (len(rows), len(cols))
    assert_same_stage(got, want)
    assert bool(got[2].any()) and not bool(got[2].all())


@pytest.mark.parametrize("iters", [1, 90])
@pytest.mark.parametrize("column", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_xi_kernel_edge_lanes_equal_eager(cuda_device, dtype, column, iters):
    """NaN ends, τ̄_IN = τ̄_OUT, no bracket and an infinite end, against a
    scalar β and a column of three, after one step and after 90."""
    from xi_cases import assert_same_stage, edge_inputs

    ls, ti, to, kappa = edge_inputs(dtype, column, cuda_device)
    cfg = st.SolverConfig(n_grid=64, bisect_iters=iters, numerics="fixed")
    got = st.baseline.compute_xi(ti, to, ls, kappa, cfg, with_health=True)
    assert_same_stage(got, _xi_eager(ti, to, ls, kappa, cfg))
    short = st.baseline.compute_xi(ti, to, ls, kappa, cfg)
    assert len(short) == 4
    for a, b in zip(short, got):
        assert torch.equal(torch.isnan(a) if a.is_floating_point() else a,
                           torch.isnan(b) if b.is_floating_point() else b)


def test_xi_kernel_launches_only_where_it_takes(cuda_device):
    """One launch a fixed closed-form call; none under adaptive numerics,
    sampled (ODE-backed) Stage 1, a half type or an input that requires
    grad, whose answers stay the eager route's."""
    import dataclasses

    from sbr_tpu_torch.baseline import xi_kernel
    from sbr_tpu_torch.baseline.learning import learning_solution_from_samples
    from xi_cases import grid_inputs, subgrid

    ls, ti, to, kappa, cfg = grid_inputs(subgrid(24), subgrid(24), torch.float32, cuda_device)
    compute = st.baseline.compute_xi
    before = _build.LAUNCHES[xi_kernel.KERNEL]
    compute(ti, to, ls, kappa, cfg, with_health=True)
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before + 1
    half = dataclasses.replace(ls, **{f: getattr(ls, f).half() for f in (
        "grid", "cdf", "pdf", "t0", "dt", "beta", "x0")})
    eager = [
        (ti, to, ls, kappa, dataclasses.replace(cfg, numerics="adaptive")),
        (ti, to, learning_solution_from_samples(ls.grid, ls.cdf, ls.pdf), kappa, cfg),
        (ti.half(), to.half(), half, kappa.half(), cfg),
        (ti.clone().requires_grad_(True), to, ls, kappa, cfg),
    ]
    for args in eager:
        assert not xi_kernel.takes(*args)
        compute(*args, with_health=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[xi_kernel.KERNEL] == before + 1


def test_xi_kernel_refuses_what_it_does_not_take(cuda_device):
    from sbr_tpu_torch.baseline import xi_kernel

    ts = [torch.full((4, 4), 0.5, dtype=torch.float32, device=cuda_device) for _ in range(5)]
    with pytest.raises(NotImplementedError):
        xi_kernel.xi_bisect(*(t.half() for t in ts), 90, 1e-4)
    with pytest.raises(ValueError, match="kappa"):
        xi_kernel.xi_bisect(*ts[:4], ts[4].double(), 90, 1e-4)
    with pytest.raises(ValueError, match="kappa"):
        xi_kernel.xi_bisect(*ts[:4], ts[4].cpu(), 90, 1e-4)
    with pytest.raises(ValueError, match="dims"):
        xi_kernel.xi_bisect(ts[0].reshape(1, 1, 1, 4, 4), *ts[1:], 90, 1e-4)
    with pytest.raises(ValueError, match="iters"):
        xi_kernel.xi_bisect(*ts, 0, 1e-4)


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


# ---------------------------------------------------------------------------
# Slice 11: the replication run and the run log on the card
# ---------------------------------------------------------------------------


def _figure_run(device, out):
    """``master --fast`` on ``device``: (exit code, {figure: [per-axes line
    data]}, the printed lines without times and paths, the closure)."""
    import contextlib
    import io
    from pathlib import Path

    from sbr_tpu_torch.figures import master
    from sbr_tpu_torch.social import closure

    figs, comps = {}, []
    save, close_loop = master._save, closure.close_loop

    def recording(fig, path):
        parts = Path(path).parts
        figs["/".join(parts[parts.index("figures") + 1:])] = [
            [np.asarray(ln.get_xydata(), np.float64) for ln in ax.get_lines()]
            + [np.asarray(c.get_array(), np.float64) for c in ax.collections
               if hasattr(c, "get_coordinates")]
            for ax in fig.axes]
        save(fig, path)

    def recorded(*args, **kwargs):
        comps.append(close_loop(*args, **kwargs))
        return comps[-1]

    buf = io.StringIO()
    master._save, closure.close_loop = recording, recorded
    try:
        with contextlib.redirect_stdout(buf):
            rc = master.main(["--fast", "--device", device, "--output", str(out)])
    finally:
        master._save, closure.close_loop = save, close_loop
    lines = [ln for ln in buf.getvalue().replace(str(out), "OUT").splitlines()
             if "time" not in ln]
    return rc, figs, lines, comps[0]


def test_master_fast_on_card_equals_cpu(cuda_device, tmp_path):
    """The whole --fast replication on the card and on the CPU: the printed
    manifest (statuses, iterations) equal, every figure's data within
    1e-12 (float64; the slice contracts of the card against the CPU), the
    closure's agent curves bit for bit when the two windows are equal."""
    from sbr_tpu_torch.figures.master import CLOSURE_FIG

    card = _figure_run("cuda", tmp_path / "card")
    cpu = _figure_run("cpu", tmp_path / "cpu")
    assert card[0] == cpu[0] == 0
    assert card[2] == cpu[2]
    assert card[1].keys() == cpu[1].keys()
    for name in cpu[1]:
        for ax_card, ax_cpu in zip(card[1][name], cpu[1][name]):
            for a, b in zip(ax_card, ax_cpu):
                assert a.shape == b.shape
                ok = np.isfinite(b)
                assert np.array_equal(np.isfinite(a), ok), name
                if name != CLOSURE_FIG:
                    assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= 1e-12, name
    ccard, ccpu = card[3], cpu[3]
    if (ccard.exit_delay, ccard.reentry_delay) == (ccpu.exit_delay, ccpu.reentry_delay):
        assert np.array_equal(ccard.aw_sim, ccpu.aw_sim)
        assert np.array_equal(ccard.g_sim, ccpu.g_sim)


def test_measured_grid_footprint_grows_with_cells(cuda_device):
    from sbr_tpu_torch.obs import mem
    from sbr_tpu_torch.sweeps.baseline_sweeps import grid_tile_footprint
    from sbr_tpu_torch.utils.checkpoint import resolve_tile_shape

    cfg = st.SolverConfig(n_grid=256, bisect_iters=30, refine_crossings=False)
    small = grid_tile_footprint(8, 8, cfg, device=cuda_device)
    big = grid_tile_footprint(64, 64, cfg, device=cuda_device)
    assert 0 < small["total_bytes"] < big["total_bytes"]
    assert big["out_bytes"] > small["out_bytes"] and big["source"] == "measured"
    assert mem.device_capacity() == torch.cuda.get_device_properties(0).total_memory
    shape, plan = resolve_tile_shape(5000, 5000, "auto", cfg, torch.float32, device=cuda_device)
    assert plan["verdict"] == "ok" and shape[0] == shape[1] >= 8


def test_span_inside_a_cuda_graph_capture_is_a_no_op(cuda_device, tmp_path):
    """Instrumentation inside a capture would fence or read the host and
    break it: every site is silent while the stream captures. A served
    bucket captured with a run active answers bit for bit as before."""
    import json

    from sbr_tpu_torch import obs

    x = torch.arange(8.0, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2.0  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    with obs.run_context(run_dir=str(tmp_path / "r")) as run:
        with torch.cuda.graph(graph):
            with obs.span("inside") as sp:
                y = x * 2.0
                sp.sync(y)
            obs.event("inside_event")
            obs.log_status("inside", torch.zeros(4, dtype=torch.int32, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        engine_pairs = _served_vs_eager(torch.float64, "fixed", (8,))[1]
    assert torch.equal(y, x * 2.0)
    events = [json.loads(line) for line in (run.run_dir / "events.jsonl").read_text().splitlines()]
    assert not [e for e in events if e.get("stage") == "inside" or e["kind"] == "inside_event"]
    for served, eager in engine_pairs:
        nan = np.isnan(eager)
        assert np.array_equal(np.isnan(served), nan)
        assert served[~nan].tobytes() == eager[~nan].tobytes()
    assert obs.prof.trace_counts().get("serve.bucket", 0) >= 1


def test_served_run_dir_on_card_equals_cpu(cuda_device, tmp_path):
    """An engine on the card with a run directory: bucket captures under
    their ``serve.compile`` spans, ``serve_batch`` events, a live.json that
    `report serve` passes, and the same answers and event sequence as an
    engine on the CPU."""
    import json

    from sbr_tpu_torch.obs import report
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool

    pool = build_pool(3, 12)
    cfg = st.SolverConfig(n_grid=256, bisect_iters=40, refine_crossings=False)
    out = {}
    for dev in ("cuda", "cpu"):
        run_dir = tmp_path / dev
        with Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)), run_dir=str(run_dir),
                    device=dev) as engine:
            answers = engine.query_many(pool, timeout=600)
            engine.query_many(pool, timeout=600)  # LRU hits
            graphs = engine.statz()["graphs"]
        events = [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]
        out[dev] = (answers, graphs, [(e["kind"], e.get("stage") or e.get("action"))
                                      for e in events if e["kind"] in
                                      ("stage_start", "stage_end", "serve_batch", "fleet")])
        assert report.main(["serve", str(run_dir), "--json"]) == 0
    (card, graphs, seq), (cpu, _, cpu_seq) = out["cuda"], out["cpu"]
    assert sum(graphs["captured"].values()) >= 1 and graphs["eager_runs"] == 0
    assert seq == cpu_seq and ("stage_start", "serve.compile[8]") in seq
    for a, b in zip(card, cpu):
        assert (a.status, a.flags) == (b.status, b.flags)
        assert np.isnan(a.xi) == np.isnan(b.xi)
        assert np.isnan(a.xi) or abs(a.xi - b.xi) <= 1e-12


@pytest.mark.parametrize("channel", ["bayes", "gossip"])
def test_served_population_launches_members_times_steps_under_a_run(cuda_device, channel,
                                                                    tmp_path):
    """A population query served on the card under a run directory
    launches its channel's kernel members × steps times, the other kernel
    never, and logs the query's ``infomodel`` event."""
    import json

    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    doc = {"graph": {"model": "erdos_renyi", "n": 4000, "avg_degree": 10.0},
           "infomodel": {"channel": channel}, "seeds": 3, "vary": "sim", "g0": None}
    kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
    steps = int(round(float(m.economic.eta) / 0.1))
    with Engine(config=st.SolverConfig(n_grid=256), serve=ServeConfig(buckets=(1,)),
                run_dir=str(tmp_path / "run"), device="cuda") as engine:
        before = dict(_build.LAUNCHES)
        rec = engine.query_population(m, doc)
        torch.cuda.synchronize()
        after = dict(_build.LAUNCHES)
    assert after.get(kernel, 0) - before.get(kernel, 0) == 3 * steps
    assert after.get(other, 0) == before.get(other, 0)
    events = [json.loads(line) for line in
              (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    queries = [e for e in events if e["kind"] == "infomodel"
               and e.get("action") == "population_query"]
    assert len(queries) == 1 and queries[0]["run_probability"] == rec["run_probability"]


@pytest.mark.parametrize("switch", ["SBR_FLIGHT", "SBR_DEMAND", "SBR_TRACE_SAMPLE"])
def test_served_mix_on_card_is_bitwise_the_same_with_a_recorder(cuda_device, switch,
                                                                 monkeypatch, tmp_path):
    """The served mix on the card with one recorder on (every query traced
    when tracing is) answers the same bits as with it off."""
    from sbr_tpu_torch.obs import trace
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    pool = build_pool(5, 16)
    mix = [pool[i] for i in query_mix(5, 16, 96)] + build_pool(9, 24)
    cfg = st.SolverConfig(n_grid=256, bisect_iters=40, refine_crossings=False)
    bits = {}
    for on in (False, True):
        for var in ("SBR_FLIGHT", "SBR_DEMAND", "SBR_TRACE_SAMPLE"):
            monkeypatch.delenv(var, raising=False)
        if on:
            monkeypatch.setenv(switch, "1")
        with Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)), device="cuda",
                    run_dir=str(tmp_path / str(on))) as engine:
            res = []
            for i in range(0, len(mix), 8):
                ctxs = [trace.mint("loadgen") for _ in mix[i : i + 8]]
                res += engine.query_many(mix[i : i + 8], timeout=600, traces=ctxs)
                for c in ctxs:
                    engine.trace_writer().commit(c)
            text = engine.prometheus()
        bits[on] = [(r.status, r.flags, np.float64(r.xi).tobytes(),
                     np.float64(r.aw_max).tobytes()) for r in res]
        prefix = {"SBR_FLIGHT": "sbr_flight", "SBR_DEMAND": "sbr_demand"}.get(switch)
        if prefix:
            assert (prefix in text) == on
    assert bits[True] == bits[False]


@pytest.mark.parametrize("channel", ["bayes", "gossip"])
def test_traced_population_query_on_card_equals_cpu(cuda_device, channel, monkeypatch,
                                                    tmp_path):
    """A population query traced over HTTP, on the card and on the CPU,
    each from the CPU's fixed point and per-agent fields: the records are
    equal but for latency and trace id, each a ``worker.request`` root,
    and the card launches its channel's kernel members × steps times."""
    import json

    from sbr_tpu_torch.infomodels import engine as ie
    from sbr_tpu_torch.infomodels import population as pop
    from sbr_tpu_torch.obs import trace
    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.loadgen import http_request
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    monkeypatch.setenv("SBR_TRACE_SAMPLE", "1")
    m = st.make_model_params(**FIG12)
    cfg = st.SolverConfig(n_grid=256)
    spec = st.InfoModelSpec(channel=channel)
    fp = st.solve_fixed_point_info(spec, m, config=cfg, max_iter=500, device="cpu")
    draw, query = ie._agent_fields, pop.population_query

    def cpu_fields(spec_, n, seed, beta, dtype, device):
        return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

    monkeypatch.setattr(ie, "_agent_fields", cpu_fields)
    monkeypatch.setattr(pop, "population_query", lambda *a, **k: query(*a, fp=fp, **k))
    doc = {**FIG12, "population": {"graph": {"model": "erdos_renyi", "n": 3000,
                                             "avg_degree": 10.0},
                                   "infomodel": {"channel": channel}, "seeds": 3,
                                   "vary": "sim", "g0": None}}
    kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
    out = {}
    for dev in ("cuda", "cpu"):
        engine = Engine(config=cfg, serve=ServeConfig(buckets=(1,)), device=dev,
                        run_dir=str(tmp_path / dev)).start()
        endpoint = None
        try:
            endpoint = ServeEndpoint(engine).start()
            before = dict(_build.LAUNCHES)
            code, body, hdrs = http_request(endpoint.port, "/query", doc, timeout=600)
            torch.cuda.synchronize()
            after = dict(_build.LAUNCHES)
        finally:
            if endpoint is not None:
                endpoint.close()
            engine.close()
        rec = json.loads(body)
        assert code == 200 and rec["trace_id"] == hdrs[trace.TRACE_HEADER]
        spans, bad = trace.load_spans(tmp_path / dev)
        assert bad == 0 and [s["name"] for s in spans] == ["worker.request"]
        assert spans[0]["route"] == "population" and spans[0]["status"] == 200
        out[dev] = ({k: v for k, v in rec.items() if k not in ("latency_ms", "trace_id")},
                    {k: after.get(k, 0) - before.get(k, 0) for k in (kernel, other)})
    steps = int(round(float(m.economic.eta) / 0.1))
    assert out["cuda"][1] == {kernel: 3 * steps, other: 0}
    assert out["cpu"][1] == {kernel: 0, other: 0}
    assert out["cuda"][0] == out["cpu"][0]


# -- slice 14: the numerics audit ---------------------------------------------


def test_audit_battery_on_card_is_stable(cuda_device, tmp_path):
    """The whole battery on the card twice: goldens, then a classifying
    run in which every probe passes with the same fingerprint; the gossip
    probe launches the infection kernel once a step."""
    from sbr_tpu_torch.obs import audit

    before = _build.LAUNCHES[fused.KERNEL]
    gold = audit.run_battery(reg_dir=tmp_path, update=True, device=cuda_device, emit=False)
    assert _build.LAUNCHES[fused.KERNEL] - before == 20
    again = audit.run_battery(reg_dir=tmp_path, device=cuda_device, emit=False)
    assert again["ok"] and not again["drift"] and not again["missing"], again
    assert gold["key"]["platform"] == "cuda" and gold["key"]["device_name"]
    for name, p in gold["probes"].items():
        assert again["probes"][name]["verdict"] == "pass"
        assert again["probes"][name]["fingerprint"] == p["fingerprint"], name


@pytest.mark.parametrize("name", ["graphgen.layout", "infomodel.gossip"])
def test_audit_bitwise_probes_on_card_equal_cpu(cuda_device, name):
    """The two probes whose surfaces are device-independent bits: the
    generated edge stream, and the gossip trajectory (the kernel on the
    card, the plain step on the CPU)."""
    from sbr_tpu_torch.obs import audit

    probe = audit.probes()[name]
    card, cpu = probe.fn(device=cuda_device), probe.fn(device="cpu")
    assert card["fingerprint"] == cpu["fingerprint"]
    assert card["values"] == cpu["values"]


# -- slice 15: the serving fleet ----------------------------------------------


def _fleet_env():
    """Worker processes find the package from the repository root."""
    import os
    from pathlib import Path

    return {"PYTHONPATH": str(Path(__file__).resolve().parents[1]),
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "2")}


def test_fleet_workers_on_card_answer_as_an_in_process_engine(cuda_device, tmp_path,
                                                             monkeypatch):
    """Two worker processes on the card behind the router answer the
    seeded mix bit for bit like an in-process engine on the card."""
    from types import SimpleNamespace

    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.endpoint import query_result_doc
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix, run_fleet

    for k, v in _fleet_env().items():
        monkeypatch.setenv(k, v)
    shape = dict(fleet=2, queries=48, pool=6, group=4, n_grid=128, bisect_iters=30,
                 buckets="1,8", seed=3)
    args = SimpleNamespace(**shape, run_dir=None, cache_dir=None, fleet_dir=None, device=None,
                           fleet_kill_after=None, answers_out=str(tmp_path / "a.json"),
                           trace_out=None, audit_fault=None, audit_wait=0)
    summary = run_fleet(args)
    assert summary["failures"] == [] and summary["fleet_lost"] == 0
    assert summary["device"].startswith("cuda")
    import json

    answers = json.loads((tmp_path / "a.json").read_text())
    cfg = st.SolverConfig(n_grid=128, bisect_iters=30, refine_crossings=False)
    engine = Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)), device=cuda_device)
    try:
        res = engine.query_many(build_pool(3, 6))
    finally:
        engine.close()
    want = [query_result_doc(res[i]) for i in query_mix(3, 6, 48)]
    fields = ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual")
    assert [{f: a[f] for f in fields} for a in answers] == [{f: w[f] for f in fields}
                                                            for w in want]


def test_prewarm_drain_on_card_equals_beta_u_grid(cuda_device, tmp_path):
    """A drained plan's tiles on the card are `beta_u_grid` on the card,
    bit for bit."""
    import json

    from sbr_tpu_torch.resilience.elastic import TileCache
    from sbr_tpu_torch.serve.prewarm import PLAN_SCHEMA, PrewarmController, _plan_tiles
    from sbr_tpu_torch.utils.checkpoint import to_host

    cfg = st.SolverConfig(n_grid=128, bisect_iters=40, refine_crossings=False)
    plan = {"schema": PLAN_SCHEMA, "plan_fingerprint": "c0ffee" * 2 + "abcd",
            "tiles": [{"bin": "1,2", "betas": [0.8, 1.6], "us": [0.1, 0.3, 0.5], "rank": 1}]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    ctl = PrewarmController(plan_file=tmp_path / "plan.json", cache_dir=str(tmp_path / "c"),
                            config=cfg, device=cuda_device, ttl_s=60)
    try:
        snap = ctl.drain(timeout_s=600)
    finally:
        ctl.close()
    assert snap["status"] == "done" and snap["warm"] == 2 and snap["counts"]["computed"] == 2
    cache = TileCache(tmp_path / "c")
    for t in _plan_tiles(plan):
        base = st.make_model_params(beta=t["betas"][0])
        got = cache.load(cache.key(base, cfg, None, t["betas"], t["us"]), tile="t")
        want = st.beta_u_grid(np.array(t["betas"]), np.array(t["us"]), base, config=cfg,
                              device=cuda_device)
        for f, h in zip(("xi", "max_aw", "status"), to_host(want.xi, want.max_aw, want.status)):
            assert got[f].dtype == h.dtype and np.array_equal(got[f], h, equal_nan=f != "status")


def test_embedded_prewarm_on_card_leaves_answers_and_tiles_bitwise(cuda_device, tmp_path,
                                                                   monkeypatch):
    """``SBR_PREWARM=1`` in an engine on the card: the controller's thread
    drains the plan between rounds of queries that capture and replay
    buckets 1 and 8. The answers equal an ``SBR_PREWARM=0`` engine's bit
    for bit, and the tiles `beta_u_grid`'s on the card."""
    import json
    import time

    from sbr_tpu_torch.resilience.elastic import TileCache
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.endpoint import query_result_doc
    from sbr_tpu_torch.serve.loadgen import build_pool
    from sbr_tpu_torch.serve.prewarm import PLAN_SCHEMA, _plan_tiles
    from sbr_tpu_torch.utils.checkpoint import to_host

    cfg = st.SolverConfig(n_grid=128, bisect_iters=40, refine_crossings=False)
    plan = {"schema": PLAN_SCHEMA, "plan_fingerprint": "e1bedded" * 2,
            "tiles": [{"bin": "0,0", "betas": [0.8, 1.6, 3.2], "us": [0.1, 0.3, 0.5],
                       "rank": 1}]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    monkeypatch.setenv("SBR_PREWARM_PLAN", str(tmp_path / "plan.json"))
    monkeypatch.setenv("SBR_TILE_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("SBR_PREWARM_POLL_S", "0.1")
    monkeypatch.delenv("SBR_SERVE_SLO_MS", raising=False)
    rounds = (1, 8, 1, 8)
    traffic = build_pool(5, sum(rounds))
    fields = ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual")
    answers, snap, captured = {}, None, {}
    for switch in ("1", "0"):
        monkeypatch.setenv("SBR_PREWARM", switch)
        engine = Engine(config=cfg, serve=ServeConfig(buckets=(1, 8)),
                        device=cuda_device).start()
        ctl, got, i = engine.prewarm, [], 0
        try:
            for r, n in enumerate(rounds):
                deadline = time.monotonic() + 300
                while (ctl is not None and r == 1 and ctl.snapshot()["tiles_done"] == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                got += [query_result_doc(x) for x in engine.query_many(traffic[i:i + n],
                                                                       timeout=600)]
                i += n
                time.sleep(0.3)
            deadline = time.monotonic() + 300
            while ctl is not None and ctl.status == "sweeping" and time.monotonic() < deadline:
                time.sleep(0.05)
            if ctl is not None:
                snap = ctl.snapshot()
            captured[switch] = dict(engine.graphs.captured)
        finally:
            engine.close()
        answers[switch] = [{f: a[f] for f in fields} for a in got]
    assert answers["1"] == answers["0"]
    assert captured["1"] == captured["0"] == {1: 1, 8: 1}
    assert snap["status"] == "done" and snap["warm"] == snap["tiles_total"] == 3
    cache = TileCache(tmp_path / "c")
    for t in _plan_tiles(plan):
        base = st.make_model_params(beta=t["betas"][0])
        got = cache.load(cache.key(base, cfg, None, t["betas"], t["us"]), tile="t")
        want = st.beta_u_grid(np.array(t["betas"]), np.array(t["us"]), base, config=cfg,
                              device=cuda_device)
        for f, h in zip(("xi", "max_aw", "status"), to_host(want.xi, want.max_aw, want.status)):
            assert got[f].dtype == h.dtype and np.array_equal(got[f], h, equal_nan=f != "status")


@pytest.mark.parametrize("channel", ["bayes", "gossip"])
def test_routed_population_launches_members_times_steps(cuda_device, channel, tmp_path):
    """A population query routed to a worker in this process (the pieces
    `serve.fleet.main` assembles) launches its channel's kernel members ×
    steps times there, the other kernel never."""
    import json

    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.fleet import WorkerAnnouncer, _worker_stats
    from sbr_tpu_torch.serve.loadgen import http_request
    from sbr_tpu_torch.serve.router import Router
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    doc = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25,
           "population": {"graph": {"model": "erdos_renyi", "n": 3000, "avg_degree": 8.0},
                          "infomodel": {"channel": channel}, "seeds": 3, "vary": "sim",
                          "g0": None}}
    kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
    engine = Engine(config=st.SolverConfig(n_grid=256), serve=ServeConfig(buckets=(1,)),
                    device=cuda_device).start()
    endpoint = ServeEndpoint(engine).start()
    ann = WorkerAnnouncer(tmp_path, f"http://127.0.0.1:{endpoint.port}", ttl_s=600)
    router = None
    try:
        ann.beat(**_worker_stats(engine))
        router = Router(tmp_path, poll_s=0.05).start()
        before = dict(_build.LAUNCHES)
        code, body, _ = http_request(router.port, "/query", doc, timeout=600)
        torch.cuda.synchronize()
        after = dict(_build.LAUNCHES)
    finally:
        if router is not None:
            router.close()
        endpoint.close()
        engine.close()
        ann.withdraw()
    assert code == 200 and json.loads(body)["source"] == "computed"
    steps = int(round(float(m.economic.eta) / 0.1))
    assert {k: after.get(k, 0) - before.get(k, 0) for k in (kernel, other)} == \
        {kernel: 3 * steps, other: 0}


@pytest.mark.parametrize("engine,comm", [("gather", "scatter"), ("gather", "allgather_psum"),
                                         ("incremental", "scatter")])
def test_sharded_world_one_on_card_equals_single_device(cuda_device, engine, comm):
    """A world-size-1 NCCL mesh on the card: the sharded engines are the
    single-device run bit for bit, and the "scatter" comm and the
    incremental fallback launch the recount kernel (a budget of 8 makes
    the fallback fire)."""
    import torch.distributed as dist

    from sbr_tpu_torch.parallel import make_agent_mesh
    from sbr_tpu_torch.social import recount

    n = 5003
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=4)
    cfg = st.AgentSimConfig(n_steps=30, dt=0.1, exit_delay=0.1, reentry_delay=2.0)
    kw = dict(x0=0.01, config=cfg, seed=3, engine=engine, incremental_budget=8)
    one = st.simulate_agents(1.0, src, dst, n, device=cuda_device, **kw)
    fresh = not dist.is_initialized()
    try:
        mesh = make_agent_mesh(device="cuda")
        assert dist.get_backend() == "nccl"
        before = _build.LAUNCHES[recount.KERNEL]
        sh = st.simulate_agents(1.0, src, dst, n, mesh=mesh, comm=comm, **kw)
        launched = _build.LAUNCHES[recount.KERNEL] - before
    finally:
        if fresh and dist.is_initialized():
            dist.destroy_process_group()
    for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(one, f), getattr(sh, f)), f
    if comm == "scatter":
        assert launched == int(sh.full_recount_steps.sum()) > 0
    else:
        assert launched == 0


@pytest.mark.parametrize("n,e,seed,epoch", [
    (3000, 18_013, 0, 0), (97, 4_500, 3, 2), (1, 300, 11, 7), (1000, 0, 4, 4),
    (2**31 - 5, 100_000, 9, 1), (10_000_000, (1 << 24) + 12_345, 5, 3),
])
def test_pcg64_indegrees_equal_the_host_draw(cuda_device, n, e, seed, epoch):
    """The card's in-degrees of an epoch are numpy's bincount of the host
    draw entry for entry: one and many threads, a range of one, none
    drawn, a range near 2^31 (rejections near their most likely), and a
    draw across the host's 2^24-id chunks. Two launches a draw."""
    from sbr_tpu_torch.social import graphgen as gg
    from sbr_tpu_torch.social import pcg64

    before = _build.LAUNCHES[pcg64.KERNEL]
    got = pcg64.uniform_indegrees(gg._epoch_rng(seed, epoch), n, e, cuda_device)
    assert _build.LAUNCHES[pcg64.KERNEL] == before + 2
    assert got.dtype == torch.int64 and int(got.sum()) == e
    if n < 2**24:
        want = (gg.epoch_indegrees(st.ErdosRenyiSpec(n=n, avg_degree=1.0), seed, epoch, e)
                if n > 1 else np.array([e]))
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    else:  # compare the nonzero entries: a 2^31-entry host table is 8 GiB
        ids = np.concatenate([np.zeros(0, np.int32)] + list(
            gg._uniform_ids(gg._epoch_rng(seed, epoch), n, e)))
        nodes, counts = np.unique(ids, return_counts=True)
        nz = torch.nonzero(got).flatten()
        np.testing.assert_array_equal(nz.cpu().numpy(), nodes)
        np.testing.assert_array_equal(got[nz].cpu().numpy(), counts)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003, 10_000_000])
@pytest.mark.parametrize("p", [0.0, 1e-4, 0.01, 0.5, 1.0])
def test_pcg64_bernoulli_equals_the_host_draw(cuda_device, n, p):
    from sbr_tpu_torch.social import pcg64

    rng = np.random.default_rng(n + 7)
    got = pcg64.bernoulli(rng, n, p, cuda_device)
    np.testing.assert_array_equal(got.cpu().numpy(), rng.random(n) < p)


@pytest.mark.parametrize("n,x0,seed", [(1000, 1e-9, 4), (1000, 0.0, 4), (20_000, 0.01, 8),
                                       (10_000_000, 0.01, 123)])
def test_seeds_on_card_equal_the_host_draw(cuda_device, n, x0, seed):
    """The initial informed mask on the card is the host's, the seed that
    the host guarantees when none was drawn included (x0 1e-9)."""
    from sbr_tpu_torch.social import agents

    got = agents._seeds_on(np.random.default_rng(seed), n, x0, False, cuda_device)
    want = agents._draw_seeds(np.random.default_rng(seed), n, x0, False)
    assert want.any() == (x0 > 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_rewired_bayes_on_card_equals_cpu(cuda_device):
    """A rewired bayes run on the card, its in-degrees and seeds drawn by
    the card, is the CPU run bit for bit."""
    from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info
    from sbr_tpu_torch.social import pcg64

    spec = InfoModelSpec(channel="bayes", dynamics="rewire", epoch_steps=5)
    graph = st.ErdosRenyiSpec(n=30_000, avg_degree=6.0)
    cfg = st.AgentSimConfig(n_steps=12, dt=0.05, reentry_delay=3.0)
    kw = dict(x0=0.01, config=cfg, seed=21, dtype=np.float32)
    cpu = simulate_info(spec, graph, device="cpu", **kw)
    before = _build.LAUNCHES[pcg64.KERNEL]
    card = simulate_info(spec, graph, device=cuda_device, **kw)
    assert _build.LAUNCHES[pcg64.KERNEL] == before + 1 + 2 * card.epochs == before + 7
    for f in ("informed", "t_inf", "belief", "informed_frac", "withdrawn_frac"):
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f
