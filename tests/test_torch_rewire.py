"""The port's panic rewiring (sbr_tpu_torch.infomodels.engine's
``dynamics="rewire"`` and its graphgen helpers) against sbr_tpu's, on the
CPU.

Contracts, all bit for bit:

- `core.integrate.xla_cumsum` is ``jnp.cumsum`` (XLA's blocked base-16
  order) in float32 and float64, at every tested length;
- `tilt_threshold_table` is the reference's uint32 table, the saturated
  last entries (XLA's float → uint32 conversion clamps 2^32 to 2^32 − 1)
  and bias 0 included; `epoch_key_words` and `epoch_indegrees` are the
  reference's draws, and `epoch_indegrees_on` is the same draw on a
  device (on the card, its kernel's: tests/test_torch_cuda.py);
- `generate_tilted_sources` is the reference's, for Erdős–Rényi and
  scale-free tables, and does not depend on the chunk;
- `simulate_info(dynamics="rewire")`: fractions, ``informed``, ``t_inf``,
  ``belief`` and ``epochs`` in gossip and in bayes (with the reference's
  per-agent fields carried across: the thresholds' float32 ``log`` rounds
  apart between the frameworks, tests/test_torch_infomodels.py), when
  ``epoch_steps`` divides ``n_steps`` and when it does not;
- a rewire closure and a rewire population record equal the reference's
  from a carried fixed point;
- telemetry: under a run, each epoch's ``rewire_epoch`` event and the
  bayes belief census equal the reference's (the census's float32 mean
  within 1e-6 relative: its sum associates apart), and so does a static
  bayes run's census.

Besides: a bias-0 rewire is the static model up to graph realizations
(the reference's physics check), and SBM bases and ``prepared=`` are
refused.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sbr_tpu.infomodels import engine as je  # noqa: E402
from sbr_tpu.infomodels import meanfield as jmf  # noqa: E402
from sbr_tpu.infomodels import population as jpop  # noqa: E402
from sbr_tpu.infomodels.spec import InfoModelSpec as JSpec  # noqa: E402
from sbr_tpu.models.params import SolverConfig as JConfig  # noqa: E402
from sbr_tpu.models.params import make_model_params as jmodel  # noqa: E402
from sbr_tpu.social import agents as ja  # noqa: E402
from sbr_tpu.social import closure as jc  # noqa: E402
from sbr_tpu.social import graphgen as jg  # noqa: E402
from sbr_tpu_torch.core.integrate import xla_cumsum  # noqa: E402
from sbr_tpu_torch.infomodels import engine as te  # noqa: E402
from sbr_tpu_torch.infomodels import population as tpop  # noqa: E402
from sbr_tpu_torch.infomodels.spec import InfoModelSpec as TSpec  # noqa: E402
from sbr_tpu_torch.models.params import make_model_params as tmodel  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402
from sbr_tpu_torch.social import closure as tc  # noqa: E402
from sbr_tpu_torch.social import graphgen as tg  # noqa: E402
from sbr_tpu_torch.social import pcg64  # noqa: E402
from sbr_tpu_torch.social.solver import fixed_point_from_numpy  # noqa: E402
from torch_events import assert_same_events, events  # noqa: E402

CPU = "cpu"
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
GROUPS = ((0.3, 2.0, 1.0), (0.5, 3.0, 3.0), (0.2, 4.5, 0.5))
N = 3001
DTYPES = [np.float32, np.float64]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores, where the agent engines' small CPU ops wait
    on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def as_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


def _graphs(kind: str, n: int = N, deg: float = 6.0):
    if kind == "er":
        return jg.ErdosRenyiSpec(n, deg), tg.ErdosRenyiSpec(n, deg)
    return jg.ScaleFreeSpec(n, deg, gamma=2.5), tg.ScaleFreeSpec(n, deg, gamma=2.5)


def _reference_fields(spec, n, seed, beta, dtype, device):
    """The reference's per-agent fields, as the port's `_agent_fields`
    returns them."""
    jspec = JSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})
    return tuple(torch.from_numpy(np.array(f)).to(device)
                 for f in je._agent_fields(jspec, n, seed, beta, dtype))


# ---------------------------------------------------------------------------
# XLA's prefix order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 257, 4097, 16**4 + 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_xla_cumsum_is_jnp_cumsum_bitwise(n, dtype):
    rng = np.random.default_rng(n)
    # three decades of magnitude, so that the association shows in the bits
    x = (rng.random(n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(dtype)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    got = xla_cumsum(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if n >= 4097:
        # a sequential sum rounds apart on these inputs: the order matters
        assert not np.array_equal(np.cumsum(x, dtype=dtype), want)


# ---------------------------------------------------------------------------
# The tilted source table and the epoch draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("kind", ["er", "sf"])
def test_tilt_threshold_table_bitwise(kind, bias):
    jgraph, tgraph = _graphs(kind)
    wd = np.random.default_rng(7).random(N) < 0.3
    base_j = je._base_source_weights(jgraph, jnp.float32)
    base_t = te._base_source_weights(tgraph, CPU)
    np.testing.assert_array_equal(np.asarray(base_j), base_t.numpy())
    want = np.asarray(jg.tilt_threshold_table(base_j, jnp.asarray(wd), bias))
    got = tg.tilt_threshold_table(base_t, torch.from_numpy(wd), bias)
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got[-1]) == 2**32 - 1 and bool((torch.diff(got) >= 0).all())


def test_tilt_threshold_table_saturates_where_the_cdf_is_one():
    """A tail of weights too small to move the float32 prefix: every entry
    there has cdf = 1, so cdf·2^32 = 2^32, which XLA's conversion clamps to
    2^32 − 1. An unsigned wrap of the int64 word would give 0 instead."""
    w = np.concatenate([np.ones(40), np.full(60, 1e-12)]).astype(np.float32)
    wd = np.zeros(100, bool)
    wd[[3, 17]] = True
    want = np.asarray(jg.tilt_threshold_table(jnp.asarray(w), jnp.asarray(wd), 2.0))
    got = tg.tilt_threshold_table(torch.from_numpy(w), torch.from_numpy(wd), 2.0).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got[39:] == 2**32 - 1).all() and (want[39:] == 2**32 - 1).all()
    # the withdrawing slots carry (1 + bias)× a calm slot's mass
    assert got[3] - got[2] == pytest.approx(3 * (got[2] - got[1]), rel=1e-3)


@pytest.mark.parametrize("kind", ["er", "sf"])
def test_epoch_draws_equal_the_reference(kind):
    jgraph, tgraph = _graphs(kind)
    e = 18_013
    for seed, epoch in ((0, 0), (3, 1), (3, 2), (11, 7)):
        assert tg.epoch_key_words(seed, epoch) == jg.epoch_key_words(seed, epoch)
        want = jg.epoch_indegrees(jgraph, seed, epoch, e)
        got = tg.epoch_indegrees(tgraph, seed, epoch, e)
        assert got.dtype == want.dtype and int(got.sum()) == e
        np.testing.assert_array_equal(got, want)
    assert tg.epoch_key_words(3, 1) != tg.epoch_key_words(3, 2)


@pytest.mark.parametrize("kind", ["er", "sf"])
def test_epoch_indegrees_on_the_device_equal_the_host_draw(kind):
    """On the CPU `epoch_indegrees_on` is the host draw entry for entry, as
    int64 (tests/test_torch_cuda.py holds the card's kernel to it). The
    draw's ids are one stream of 32-bit words however it is chunked, the
    premise of the card's kernel, which draws an epoch in one pass; and
    the uint32 draw is the reference's int64 one, and leaves the stream as
    it does."""
    _, tgraph = _graphs(kind)
    r64, r32, rsmall = (tg._epoch_rng(3, 2) for _ in range(3))
    ids = np.concatenate(list(tg._uniform_ids(r32, tgraph.n, 40_000)))
    np.testing.assert_array_equal(ids, r64.integers(0, tgraph.n, size=40_000))
    assert r64.bit_generator.state == r32.bit_generator.state
    small = [rsmall.integers(0, tgraph.n, size=k) for k in (1, 999, 7, 13_000, 25_993)]
    np.testing.assert_array_equal(np.concatenate(small), ids)
    for seed, epoch, e in ((0, 0, 18_013), (3, 2, 4_500), (11, 7, 0)):
        want = tg.epoch_indegrees(tgraph, seed, epoch, e)
        got = tg.epoch_indegrees_on(tgraph, seed, epoch, e, CPU)
        assert got.dtype == torch.int64 and int(got.sum()) == e
        np.testing.assert_array_equal(got.numpy(), want)


def test_the_card_draws_start_from_the_host_stream():
    """The host side of the card's PCG64 draws (`social.pcg64`): the
    stream after ``n`` doubles, which the guaranteed seed comes from, is
    where ``rng.random(n)`` leaves the generator, and the caller's
    generator does not move; a generator holding a 32-bit half is refused.
    On the CPU `_seeds_on` is `_draw_seeds`, the guaranteed seed included
    (tests/test_torch_cuda.py holds the card's kernels to the host)."""
    for seed, n in ((0, 1), (4, 1000), (9, 123_457)):
        rng = np.random.default_rng(seed)
        state = rng.bit_generator.state
        after = pcg64.advanced(rng, n).integers(0, n)
        assert rng.bit_generator.state == state
        rng.random(n)
        assert after == rng.integers(0, n)
    held = np.random.default_rng(3)
    held.integers(0, 10, dtype=np.uint32)
    with pytest.raises(ValueError, match="32-bit half"):
        pcg64._head(held)
    for n, x0, seed in ((1000, 1e-9, 4), (5000, 0.01, 8)):
        want = ta._draw_seeds(np.random.default_rng(seed), n, x0, False)
        got = ta._seeds_on(np.random.default_rng(seed), n, x0, False, CPU)
        assert got.dtype == torch.bool and int(want.sum()) >= 1
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["er", "sf"])
def test_generate_tilted_sources_bitwise_across_chunks(kind):
    jgraph, tgraph = _graphs(kind)
    wd = np.random.default_rng(2).random(N) < 0.2
    thr_j = jg.tilt_threshold_table(je._base_source_weights(jgraph, jnp.float32),
                                    jnp.asarray(wd), 4.0)
    thr_t = tg.tilt_threshold_table(te._base_source_weights(tgraph, CPU),
                                    torch.from_numpy(wd), 4.0)
    e = 20_011
    key = jg.epoch_key_words(5, 3)
    want = np.asarray(jg.generate_tilted_sources(N, e, key, thr_j, chunk_edges=4096))
    for chunk in (1000, 1 << 14, None):
        got = tg.generate_tilted_sources(N, e, tg.epoch_key_words(5, 3), thr_t,
                                         chunk_edges=chunk)
        assert got.dtype == torch.int32 and got.shape == (e,)
        np.testing.assert_array_equal(got.numpy(), want)
    # the tilt moves mass onto the withdrawing agents
    share = float(wd[want].mean())
    assert share > 2 * float(wd.mean())
    assert tg.generate_tilted_sources(N, 0, key, thr_t).shape == (0,)


# ---------------------------------------------------------------------------
# The rewire simulation
# ---------------------------------------------------------------------------

RUN_FIELDS = ("t_grid", "informed_frac", "withdrawn_frac", "informed", "t_inf")


def _assert_same_run(want, got, bayes: bool):
    names = RUN_FIELDS + (("belief",) if bayes else ())
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      _np(getattr(got, name)), err_msg=name)
    assert got.epochs == want.epochs
    assert (got.agent_steps, got.belief_updates) == (want.agent_steps, want.belief_updates)
    if not bayes:
        assert got.belief is None and want.belief is None


@pytest.mark.parametrize("steps, epoch_steps", [(30, 10), (31, 7)])
@pytest.mark.parametrize("kind", ["er", "sf"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gossip_rewire_bitwise(dtype, kind, steps, epoch_steps):
    jgraph, tgraph = _graphs(kind, deg=8.0)
    spec = dict(dynamics="rewire", rewire_bias=4.0, epoch_steps=epoch_steps)
    cfg = dict(n_steps=steps, dt=0.1, reentry_delay=1.2)
    kw = dict(beta=1.5, x0=0.03, seed=4, dtype=dtype)
    want = je.simulate_info(JSpec(**spec), jgraph, config=ja.AgentSimConfig(**cfg), **kw)
    got = te.simulate_info(TSpec(**spec), tgraph, config=ta.AgentSimConfig(**cfg),
                           device=CPU, **kw)
    _assert_same_run(want, got, bayes=False)
    assert got.epochs == -(-steps // epoch_steps)
    # withdrawals happened and re-entry returned some agents
    assert float(got.withdrawn_frac.max()) > 0.0 and bool(got.informed.any())


@pytest.mark.parametrize("groups", [(), GROUPS])
@pytest.mark.parametrize("steps, epoch_steps", [(30, 10), (29, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bayes_rewire_bitwise_with_carried_fields(dtype, steps, epoch_steps, groups):
    jgraph, tgraph = _graphs("er", deg=8.0)
    spec = dict(channel="bayes", dynamics="rewire", rewire_bias=2.0,
                epoch_steps=epoch_steps, groups=groups)
    cfg = dict(n_steps=steps, dt=0.1, exit_delay=0.2, reentry_delay=1.5)
    kw = dict(x0=0.03, seed=6, dtype=dtype)
    want = je.simulate_info(JSpec(**spec), jgraph, config=ja.AgentSimConfig(**cfg), **kw)
    fields = _reference_fields(TSpec(**spec), N, 6, 0.9, dtype, CPU)
    got = te.simulate_info(TSpec(**spec), tgraph, config=ta.AgentSimConfig(**cfg),
                           device=CPU, fields=fields, **kw)
    _assert_same_run(want, got, bayes=True)
    assert got.belief_updates == N * steps


@pytest.mark.parametrize("channel, dynamics", [("gossip", "rewire"), ("bayes", "rewire"),
                                               ("bayes", "static")])
def test_infomodel_events_equal_the_reference(channel, dynamics, tmp_path):
    from sbr_tpu import obs as jobs
    from sbr_tpu_torch import obs

    jgraph, tgraph = _graphs("er", deg=8.0)
    spec = dict(channel=channel, dynamics=dynamics, rewire_bias=2.0, epoch_steps=8)
    cfg = dict(n_steps=29, dt=0.1, exit_delay=0.2, reentry_delay=1.5)
    kw = dict(x0=0.03, seed=6, dtype=np.float32)
    for mod, name in ((jobs, "warm"), (jobs, "ref")):
        with mod.run_context(run_dir=str(tmp_path / name)):
            je.simulate_info(JSpec(**spec), jgraph, config=ja.AgentSimConfig(**cfg), **kw)
    fields = _reference_fields(TSpec(**spec), N, 6, 0.9, np.float32, CPU)
    with obs.run_context(run_dir=str(tmp_path / "port")):
        te.simulate_info(TSpec(**spec), tgraph, config=ta.AgentSimConfig(**cfg), device=CPU,
                         fields=fields, **kw)
    got, want = events(tmp_path / "port"), events(tmp_path / "ref")
    assert_same_events(got, want, {"infomodel", "stage_start", "stage_end"}, rtol=1e-6)
    actions = [e["action"] for e in got if e["kind"] == "infomodel"]
    assert actions.count("rewire_epoch") == (4 if dynamics == "rewire" else 0)
    assert actions.count("belief_census") == (channel == "bayes")


def test_rewire_carries_the_initial_state_and_belief0():
    """informed0 / t_inf0 (negative: informed before the window) and a
    scalar belief0 enter the first epoch as the reference's do."""
    jgraph, tgraph = _graphs("er")
    rng = np.random.default_rng(8)
    kw = dict(x0=0.0, seed=2, dtype=np.float64, informed0=rng.random(N) < 0.05,
              t_inf0=-rng.uniform(0, 1, N))
    cfg = dict(n_steps=17, dt=0.1, reentry_delay=0.9)
    for channel in ("gossip", "bayes"):
        spec = dict(channel=channel, dynamics="rewire", epoch_steps=6)
        extra = dict(belief0=0.8) if channel == "bayes" else {}
        want = je.simulate_info(JSpec(**spec), jgraph, config=ja.AgentSimConfig(**cfg),
                                **kw, **extra)
        fields = _reference_fields(TSpec(**spec), N, 2, 0.9, np.float64, CPU)
        got = te.simulate_info(TSpec(**spec), tgraph, config=ta.AgentSimConfig(**cfg),
                               device=CPU, fields=fields, **kw, **extra)
        _assert_same_run(want, got, bayes=channel == "bayes")


def test_bias_zero_rewire_matches_static_physics():
    """The reference's physics check on the port: with bias 0 a rewired
    gossip run is the static model up to graph realizations (the scalar
    awareness cancels in the gossip β), so the final informed fractions
    agree within 0.1."""
    g = tg.ErdosRenyiSpec(n=4000, avg_degree=12.0)
    cfg = ta.AgentSimConfig(n_steps=60, dt=0.1)
    static = te.simulate_info(TSpec(), g, beta=1.0, x0=0.02, config=cfg, seed=3, device=CPU)
    rewired = te.simulate_info(TSpec(dynamics="rewire", rewire_bias=0.0, epoch_steps=10), g,
                               beta=1.0, x0=0.02, config=cfg, seed=3, device=CPU)
    assert rewired.epochs == 6 and static.epochs == 1
    g_st = float(static.informed_frac[-1])
    g_rw = float(rewired.informed_frac[-1])
    assert abs(g_st - g_rw) < 0.1, (g_st, g_rw)


def test_rewire_refuses_sbm_and_prepared():
    spec = TSpec(dynamics="rewire")
    cfg = ta.AgentSimConfig(n_steps=5, dt=0.1)
    sbm = tg.StochasticBlockSpec(n=100, avg_degree=5.0)
    for channel in ("gossip", "bayes"):
        with pytest.raises(ValueError, match="rewire"):
            te.simulate_info(TSpec(channel=channel, dynamics="rewire"), sbm, config=cfg,
                             device=CPU)
    with pytest.raises(ValueError, match="rewire"):
        je.simulate_info(JSpec(dynamics="rewire"), jg.StochasticBlockSpec(n=100, avg_degree=5.0),
                         config=ja.AgentSimConfig(n_steps=5, dt=0.1))
    graph = tg.ErdosRenyiSpec(200, 4.0)
    pg = tg.prepare_generated_graph(graph, config=cfg, device=CPU)
    with pytest.raises(ValueError, match="prepared"):
        te.simulate_info(spec, graph, config=cfg, prepared=pg)


# ---------------------------------------------------------------------------
# Rewire closures and populations
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gossip", "bayes"])
def rewire_fp(request):
    """The reference's mean-field fixed point of a rewire spec (n_grid 256)
    and the port's carried copy of it."""
    spec = dict(channel=request.param, dynamics="rewire", rewire_bias=1.0, epoch_steps=4)
    want = jmf.solve_fixed_point_info(JSpec(**spec), jmodel(**FIG12),
                                      config=JConfig(n_grid=256), max_iter=500)
    return spec, want, fixed_point_from_numpy(as_numpy(want), device=CPU)


def test_rewire_closure_equals_the_reference(rewire_fp, monkeypatch):
    spec, want_fp, got_fp = rewire_fp
    monkeypatch.setattr(te, "_agent_fields", _reference_fields)
    kw = dict(n_agents=2500, avg_degree=10.0, dt=0.1, g0=0.05, t_max=5.0, n_reps=2)
    a = jc.close_loop(jmodel(**FIG12), infomodel=JSpec(**spec), fp=want_fp, **kw)
    b = tc.close_loop(tmodel(**FIG12), infomodel=TSpec(**spec), fp=got_fp, device=CPU, **kw)
    assert (a.exit_delay, a.reentry_delay) == (b.exit_delay, b.reentry_delay)
    for name in ("t", "aw_sim", "g_sim", "aw_fp", "g_fp"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.err_aw_sup, a.err_aw_rms, a.err_g_rms) == (b.err_aw_sup, b.err_aw_rms,
                                                         b.err_g_rms)
    assert b.infomodel == TSpec(**spec) and b.n_reps == 2


@pytest.mark.parametrize("vary", ["sim", "graph"])
def test_rewire_population_record_equals_the_reference(rewire_fp, monkeypatch, vary):
    spec, want_fp, got_fp = rewire_fp
    monkeypatch.setattr(te, "_agent_fields", _reference_fields)
    kw = dict(seeds=2, vary=vary, seed=5, g0=0.02)
    want = jpop.population_query(JSpec(**spec), jg.ErdosRenyiSpec(n=700, avg_degree=10.0),
                                 jmodel(**FIG12), fp=want_fp, **kw)
    got = tpop.population_query(TSpec(**spec), tg.ErdosRenyiSpec(n=700, avg_degree=10.0),
                                tmodel(**FIG12), fp=got_fp, device=CPU, **kw)
    assert got == want
    assert got["dynamics"] == "rewire"
    assert len(got["crossing_times"]) == 2
