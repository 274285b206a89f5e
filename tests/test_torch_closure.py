"""The port's information-model mean field (sbr_tpu_torch.infomodels.
meanfield) and the equilibrium → agent closure (sbr_tpu_torch.social.
closure) against sbr_tpu's, on the CPU.

Contracts, in float64:

- `observed_fraction` is the reference's formula (equal bit for bit);
- `info_learning_curve` for bayes, K-group gossip and the rewire tilt:
  within 1e-13 (measured 3.6e-15: cumulative sums in another order, and
  ``torch.sigmoid`` against XLA's logistic);
- `solve_fixed_point_info`: iterations, flags, statuses and the merged
  ``Health.iterations`` equal; ξ, AW and G within FP_TOL = 1e-10 (measured
  7.8e-16 for bayes, 2.8e-14 for the rewire curve); a gossip-reducible
  spec is `solve_equilibrium_social` itself, bit for bit;
- `close_loop` from a fixed point carried across
  (`fixed_point_from_numpy`): the window, ``aw_sim``, ``g_sim`` and the
  per-member rows equal the reference's bit for bit, on the host
  Erdős–Rényi graph (the reference's numpy edge stream, ``SBR_NATIVE=0``),
  on a generated graph, with the ``seeds=`` axis, from scratch
  (``g0=None``), and for bayes with the reference's per-agent fields
  patched in (the thresholds' float32 ``log`` rounds apart between the
  frameworks, tests/test_torch_infomodels.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sbr_tpu.infomodels import engine as je  # noqa: E402
from sbr_tpu.infomodels import meanfield as jmf  # noqa: E402
from sbr_tpu.infomodels.spec import InfoModelSpec as JSpec  # noqa: E402
from sbr_tpu.models.params import SolverConfig as JConfig  # noqa: E402
from sbr_tpu.models.params import make_model_params as jmodel  # noqa: E402
from sbr_tpu.social import closure as jc  # noqa: E402
from sbr_tpu.social import graphgen as jg  # noqa: E402
from sbr_tpu.social.solver import solve_equilibrium_social as jsolve  # noqa: E402
from sbr_tpu_torch.infomodels import engine as te  # noqa: E402
from sbr_tpu_torch.infomodels import meanfield as tmf  # noqa: E402
from sbr_tpu_torch.infomodels.spec import InfoModelSpec as TSpec  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig as TConfig  # noqa: E402
from sbr_tpu_torch.models.params import make_model_params as tmodel  # noqa: E402
from sbr_tpu_torch.social import closure as tc  # noqa: E402
from sbr_tpu_torch.social import graphgen as tg  # noqa: E402
from sbr_tpu_torch.social import solver as tsol  # noqa: E402

CPU = "cpu"
FP_TOL = 1e-10
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
GROUPS = ((0.3, 2.0, 1.0), (0.5, 3.0, 3.0), (0.2, 4.5, 0.5))
SPECS = {
    "bayes": dict(channel="bayes"),
    "bayes_groups": dict(channel="bayes", groups=GROUPS),
    "gossip_groups": dict(groups=GROUPS),
    "gossip_rewire": dict(dynamics="rewire", rewire_bias=1.0, epoch_steps=5),
}
# a small closure: the Figure-12 window on 5000 agents
SMALL = dict(n_agents=5000, avg_degree=15.0, dt=0.1, t_max=12.0)


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


def _gap(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def as_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


@pytest.fixture(scope="module")
def social_fp():
    """The reference's Figure-12 fixed point at n_grid 1024, and the
    port's carried copy of it."""
    want = jsolve(jmodel(**FIG12), JConfig(n_grid=1024), max_iter=500)
    return want, tsol.fixed_point_from_numpy(as_numpy(want), device=CPU)


@pytest.fixture(scope="module")
def bayes_fp():
    """The reference's and the port's own bayes fixed points at n_grid 512
    (test_infomodels' fixture)."""
    cfg = dict(n_grid=512)
    want = jmf.solve_fixed_point_info(JSpec(channel="bayes"), jmodel(**FIG12),
                                      config=JConfig(**cfg), max_iter=500)
    got = tmf.solve_fixed_point_info(TSpec(channel="bayes"), tmodel(**FIG12),
                                     config=TConfig(**cfg), max_iter=500, device=CPU)
    return want, got


def _assert_info_fp_agrees(want, got):
    for name in ("iterations", "converged", "aborted"):
        assert int(_np(getattr(want, name))) == int(_np(getattr(got, name))), name
    assert int(want.equilibrium.status) == int(got.equilibrium.status)
    assert int(want.health.flags) == int(got.health.flags)
    assert int(want.health.iterations) == int(got.health.iterations)
    for a, b in ((want.xi, got.xi), (want.aw, got.aw), (want.learning.cdf, got.learning.cdf),
                 (want.learning.pdf, got.learning.pdf), (want.history_err, got.history_err)):
        assert _gap(a, b) <= FP_TOL


def _assert_same_loop(a, b):
    assert (a.exit_delay, a.reentry_delay) == (b.exit_delay, b.reentry_delay)
    for name in ("t", "aw_sim", "g_sim", "aw_fp", "g_fp"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.err_aw_sup, a.err_aw_rms, a.err_g_rms) == (b.err_aw_sup, b.err_aw_rms, b.err_g_rms)
    assert (a.n_agents, a.n_reps) == (b.n_agents, b.n_reps)


# ---------------------------------------------------------------------------
# Mean field
# ---------------------------------------------------------------------------


def test_observed_fraction_tilt():
    aw = np.asarray([0.0, 0.1, 0.37, 1.0])
    for kw in (dict(dynamics="rewire", rewire_bias=4.0), dict(dynamics="rewire", rewire_bias=0.0),
               {}):
        want = np.asarray(jmf.observed_fraction(jnp.asarray(aw), JSpec(**kw)))
        got = tmf.observed_fraction(torch.from_numpy(aw), TSpec(**kw))
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(tmf.observed_fraction(aw, TSpec(**kw)), want)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_info_learning_curve(name):
    g = np.random.default_rng(3)
    grid = np.linspace(0.0, 12.0, 301)
    aw = np.clip(np.cumsum(g.normal(0.0, 0.03, 301)), 0.0, 1.0)
    want = jmf.info_learning_curve(JSpec(**SPECS[name]), 0.9, jnp.asarray(aw),
                                   jnp.asarray(grid), 1e-3)
    got = tmf.info_learning_curve(TSpec(**SPECS[name]), 0.9, torch.from_numpy(aw),
                                  torch.from_numpy(grid), 1e-3)
    assert got.closed_form is False
    assert _gap(want.cdf, got.cdf) <= 1e-13 and _gap(want.pdf, got.pdf) <= 1e-13
    assert float(want.beta) == float(got.beta)


def test_bayes_fixed_point_matches_reference(bayes_fp):
    want, got = bayes_fp
    assert bool(got.converged) and bool(got.equilibrium.bankrun)
    _assert_info_fp_agrees(want, got)


@pytest.mark.parametrize("name", ["gossip_groups", "gossip_rewire"])
def test_gossip_info_fixed_points_match_reference(name):
    cfg = dict(n_grid=256)
    want = jmf.solve_fixed_point_info(JSpec(**SPECS[name]), jmodel(**FIG12),
                                      config=JConfig(**cfg))
    got = tmf.solve_fixed_point_info(TSpec(**SPECS[name]), tmodel(**FIG12),
                                     config=TConfig(**cfg), device=CPU)
    assert bool(got.converged)
    _assert_info_fp_agrees(want, got)


def test_gossip_reducible_spec_is_the_social_fixed_point():
    cfg = TConfig(n_grid=256)
    info = tmf.solve_fixed_point_info(TSpec(), tmodel(**FIG12), config=cfg, device=CPU)
    social = tsol.solve_equilibrium_social(tmodel(**FIG12), config=cfg, device=CPU)
    for a, b in ((info.aw, social.aw), (info.xi, social.xi), (info.learning.cdf,
                                                             social.learning.cdf)):
        assert torch.equal(a, b)
    assert int(info.iterations) == int(social.iterations)


# ---------------------------------------------------------------------------
# close_loop, bitwise from a carried fixed point
# ---------------------------------------------------------------------------


def test_close_loop_host_graph_is_bitwise(social_fp, monkeypatch):
    monkeypatch.setenv("SBR_NATIVE", "0")  # the reference's numpy edge stream
    want_fp, got_fp = social_fp
    a = jc.close_loop(jmodel(**FIG12), fp=want_fp, **SMALL)
    b = tc.close_loop(tmodel(**FIG12), fp=got_fp, device=CPU, **SMALL)
    _assert_same_loop(a, b)
    # the Figure-12 window: exits ~ξ−τ̄_OUT after learning, re-entry later
    assert 0.0 <= b.exit_delay < b.reentry_delay < np.inf
    assert b.err_aw_rms < 0.1 and b.aw_seeds is None


def test_close_loop_foldin_stream_is_bitwise(social_fp, monkeypatch):
    """`close_loop` takes no stream argument: its members draw with the
    default config's stream. With "foldin" made the default in both
    packages, the loop is bit for bit the reference's, and differs from the
    counter run (the streams are different realizations)."""
    import functools

    from sbr_tpu.social import agents as ja
    from sbr_tpu_torch.social import agents as ta

    monkeypatch.setenv("SBR_NATIVE", "0")
    want_fp, got_fp = social_fp
    counter = tc.close_loop(tmodel(**FIG12), fp=got_fp, device=CPU, **SMALL)
    monkeypatch.setattr(jc, "AgentSimConfig",
                        functools.partial(ja.AgentSimConfig, rng_stream="foldin"))
    monkeypatch.setattr(tc, "AgentSimConfig",
                        functools.partial(ta.AgentSimConfig, rng_stream="foldin"))
    a = jc.close_loop(jmodel(**FIG12), fp=want_fp, **SMALL)
    b = tc.close_loop(tmodel(**FIG12), fp=got_fp, device=CPU, **SMALL)
    _assert_same_loop(a, b)
    assert not np.array_equal(np.asarray(counter.aw_sim), np.asarray(b.aw_sim))


def test_close_loop_from_scratch_is_bitwise(social_fp, monkeypatch):
    monkeypatch.setenv("SBR_NATIVE", "0")
    want_fp, got_fp = social_fp
    a = jc.close_loop(jmodel(**FIG12), fp=want_fp, g0=None, **SMALL)
    b = tc.close_loop(tmodel(**FIG12), fp=got_fp, g0=None, device=CPU, **SMALL)
    _assert_same_loop(a, b)


def test_close_loop_generated_graph_is_bitwise(social_fp):
    want_fp, got_fp = social_fp
    a = jc.close_loop(jmodel(**FIG12), fp=want_fp, graph=jg.ErdosRenyiSpec(5000, 15.0),
                      n_reps=2, **SMALL)
    b = tc.close_loop(tmodel(**FIG12), fp=got_fp, graph=tg.ErdosRenyiSpec(5000, 15.0),
                      n_reps=2, device=CPU, **SMALL)
    _assert_same_loop(a, b)


def test_close_loop_seeds_axis_prepares_the_graph_once(social_fp, monkeypatch):
    want_fp, got_fp = social_fp
    calls = []
    prepare = tg.prepare_generated_graph

    def counted(*args, **kwargs):
        calls.append(kwargs.get("seed"))
        return prepare(*args, **kwargs)

    monkeypatch.setattr(tg, "prepare_generated_graph", counted)
    a = jc.close_loop(jmodel(**FIG12), fp=want_fp, graph=jg.ErdosRenyiSpec(5000, 15.0),
                      seeds=[3, 1, 4], seed=7, **SMALL)
    b = tc.close_loop(tmodel(**FIG12), fp=got_fp, graph=tg.ErdosRenyiSpec(5000, 15.0),
                      seeds=[3, 1, 4], seed=7, device=CPU, **SMALL)
    assert calls == [7]
    _assert_same_loop(a, b)
    assert b.aw_seeds.shape == (3, len(b.t))
    np.testing.assert_array_equal(a.aw_seeds, b.aw_seeds)


def test_close_loop_bayes_is_bitwise_with_carried_fields(bayes_fp, monkeypatch):
    """The port's field draw is patched to return the reference's fields,
    so the mid-start's threshold-ordered prefix and the belief kernel's
    thresholds are the reference's."""
    want_fp, _ = bayes_fp
    spec_j = JSpec(channel="bayes")

    def reference_fields(spec, n, seed, beta, dtype, device):
        return tuple(torch.from_numpy(np.array(f)).to(device)
                     for f in je._agent_fields(spec_j, n, seed, beta, dtype))

    monkeypatch.setattr(te, "_agent_fields", reference_fields)
    kw = dict(n_agents=4000, avg_degree=15.0, dt=0.05, g0=0.2, t_max=4.0, n_reps=2)
    a = jc.close_loop(jmodel(**FIG12), infomodel=spec_j, fp=want_fp, **kw)
    b = tc.close_loop(tmodel(**FIG12), infomodel=TSpec(channel="bayes"),
                      fp=tsol.fixed_point_from_numpy(as_numpy(want_fp), device=CPU),
                      device=CPU, **kw)
    _assert_same_loop(a, b)
    assert b.infomodel == TSpec(channel="bayes")
    assert b.err_g_rms < 0.06


def test_close_loop_bayes_closes_on_its_own(bayes_fp):
    """The port alone (its own fixed point and fields) meets
    test_infomodels' bound."""
    _, got_fp = bayes_fp
    comp = tc.close_loop(tmodel(**FIG12), infomodel=TSpec(channel="bayes"), fp=got_fp,
                         n_agents=4000, avg_degree=15.0, dt=0.05, g0=0.2, t_max=8.0,
                         n_reps=2, device=CPU)
    assert comp.err_aw_sup < 0.25 and comp.err_g_rms < 0.06


def test_close_loop_solves_its_own_fixed_point():
    comp = tc.close_loop(n_agents=3000, avg_degree=15.0, dt=0.1, t_max=12.0,
                         config=TConfig(n_grid=256), device=CPU)
    assert bool(comp.fp.converged) and bool(comp.fp.equilibrium.bankrun)
    assert comp.err_aw_rms < 0.1 and comp.err_g_rms < 0.1


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_close_loop_validation(social_fp):
    _, fp = social_fp
    m = tmodel(**FIG12)
    with pytest.raises(ValueError, match="outside the fixed point's G range"):
        tc.close_loop(m, fp=fp, g0=0.999, device=CPU, **SMALL)
    with pytest.raises(ValueError, match="outside the fixed point's G range"):
        tc.close_loop(m, fp=fp, g0=1e-5, device=CPU, **SMALL)
    with pytest.raises(ValueError, match="seeds must be non-empty"):
        tc.close_loop(m, fp=fp, seeds=[], device=CPU, **SMALL)
    with pytest.raises(ValueError, match="does not match n_agents"):
        tc.close_loop(m, fp=fp, graph=tg.ErdosRenyiSpec(4000, 15.0), device=CPU, **SMALL)
    # mesh= is ported (tests/test_torch_sharded_agents.py), but not with an
    # information model
    with pytest.raises(ValueError, match="mesh= is not supported"):
        tc.close_loop(m, fp=fp, mesh=object(), infomodel=TSpec(channel="bayes"),
                      device=CPU, **SMALL)
    # rewire closures run; their SBM base has no source marginal to tilt
    sbm = tg.StochasticBlockSpec(n=SMALL["n_agents"], avg_degree=SMALL["avg_degree"])
    with pytest.raises(ValueError, match="rewire"):
        tc.close_loop(m, infomodel=TSpec(dynamics="rewire"), graph=sbm, device=CPU, **SMALL)
    with pytest.raises(ValueError, match="rewire"):
        tc.close_loop(m, infomodel=TSpec(channel="bayes", dynamics="rewire"), graph=sbm,
                      device=CPU, **SMALL)
