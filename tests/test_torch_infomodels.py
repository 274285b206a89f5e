"""The port's information models (sbr_tpu_torch.infomodels and the belief
step of sbr_tpu_torch.social.fused) against sbr_tpu's, on the CPU.

Contracts:

- the spec: the same fields, validation errors, llr constants and wire
  form;
- the belief step: equal bit for bit to sbr_tpu's "lax" step as XLA
  compiles it (under ``jit``, as the simulation's scan runs it, with both
  multiply-adds fused); within the reference's own lowering tolerance of
  the "interpret" Pallas kernel and of the step dispatched op by op;
- the per-agent fields: β and awareness (so the groups) equal bit for bit;
  thresholds within 2 float32 ulp of the logistic noise, because
  PyTorch's and XLA's float32 ``log`` differ by one ulp on about a tenth of
  the lanes;
- the bayes simulation: equal bit for bit given the same fields, and
  within (differing decisions)/n given each package's own fields;
- the gossip channel: equal bit for bit, as it is the agent simulation.
"""

import os
import subprocess
import sys
import types
from fractions import Fraction
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sbr_tpu.infomodels import engine as je  # noqa: E402
from sbr_tpu.infomodels import spec as js  # noqa: E402
from sbr_tpu.social import agents as ja  # noqa: E402
from sbr_tpu.social import fused as jf  # noqa: E402
from sbr_tpu.social import graphgen as jg  # noqa: E402
from sbr_tpu_torch import infomodels as ti  # noqa: E402
from sbr_tpu_torch.infomodels import engine as te  # noqa: E402
from sbr_tpu_torch.infomodels import spec as ts  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402
from sbr_tpu_torch.social import fused as tf  # noqa: E402
from sbr_tpu_torch.social import graphgen as tg  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]
LLR = js.InfoModelSpec(channel="bayes").llr
HETERO = ((0.3, 2.0, 1.0), (0.5, 3.0, 3.0), (0.2, 4.5, 0.5))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(channel="telepathy"), dict(dynamics="wormhole"),
    dict(q_calm=0.5, q_run=0.1), dict(threshold_scale=0.0), dict(awareness=-1.0),
    dict(groups=((0.5, 3.0, 1.0), (0.6, 3.0, 1.0))), dict(groups=((1.0, 3.0, 1.0),)),
    dict(groups=((1.2, 3.0, 1.0), (-0.2, 3.0, 1.0))),
    dict(groups=((0.5, 3.0, 1.0), (0.5, 3.0, 0.0))),
    dict(epoch_steps=0), dict(rewire_bias=-1.0),
])
def test_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        js.InfoModelSpec(**kw)
    with pytest.raises(ValueError) as got:
        ts.InfoModelSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(channel="bayes"), dict(channel="bayes", q_run=0.2, q_calm=0.01),
    dict(channel="bayes", dynamics="rewire", epoch_steps=7, groups=HETERO),
])
def test_spec_constants_and_wire_form(kw):
    want, got = js.InfoModelSpec(**kw), ts.InfoModelSpec(**kw)
    assert got.llr == want.llr and got.llr[0] < 0 < got.llr[1]
    assert got.group_table() == want.group_table()
    assert got.to_doc() == want.to_doc()
    assert got.reduces_to_gossip() == want.reduces_to_gossip()
    assert ts.InfoModelSpec.from_doc(got.to_doc()) == got
    assert ts.InfoModelSpec.from_doc(want.to_doc()) == got
    assert ts.INFOMODEL_PROGRAM_VERSION == js.INFOMODEL_PROGRAM_VERSION
    assert (ts.CHANNELS, ts.DYNAMICS) == (js.CHANNELS, js.DYNAMICS)


def test_spec_doc_errors_and_hetero_bridge():
    with pytest.raises(ValueError, match="chanel"):
        ts.InfoModelSpec.from_doc({"chanel": "bayes"})
    with pytest.raises(ValueError, match="JSON object"):
        ts.InfoModelSpec.from_doc([1])
    # duck-typed: anything with .betas/.dist, or a .learning carrying them
    lrn = types.SimpleNamespace(betas=(0.5, 1.5), dist=(0.4, 0.6))
    for params in (lrn, types.SimpleNamespace(learning=lrn)):
        got = ts.InfoModelSpec.from_hetero_params(params, channel="bayes")
        want = js.InfoModelSpec.from_hetero_params(params, channel="bayes")
        assert got.to_doc() == want.to_doc()


def test_default_spec_env(monkeypatch):
    monkeypatch.setenv("SBR_INFOMODEL", "bayes")
    monkeypatch.setenv("SBR_INFOMODEL_DYNAMICS", "rewire")
    monkeypatch.setenv("SBR_INFOMODEL_EPOCH_STEPS", "9")
    assert ts.default_spec().to_doc() == js.default_spec().to_doc()
    assert ts.default_spec().epoch_steps == 9
    monkeypatch.setenv("SBR_INFOMODEL", "psychic")
    with pytest.raises(ValueError, match="SBR_INFOMODEL"):
        ts.default_spec()
    monkeypatch.delenv("SBR_INFOMODEL")
    monkeypatch.setenv("SBR_INFOMODEL_DYNAMICS", "wormhole")
    with pytest.raises(ValueError, match="SBR_INFOMODEL_DYNAMICS"):
        ts.default_spec()


# ---------------------------------------------------------------------------
# The belief step
# ---------------------------------------------------------------------------


def _belief_inputs(n, np_dtype, seed=0):
    """tests/test_infomodels.py's inputs, with varied degrees."""
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.1
    t_inf = np.zeros(n, np_dtype)
    belief = rng.normal(0, 1, n).astype(np_dtype)
    counts = rng.integers(0, 12, n).astype(np.int32)
    awareness = np.full(n, 2.0, np_dtype)
    deg = rng.integers(1, 15, n).astype(np_dtype)
    counts = np.minimum(counts, deg.astype(np.int32))
    thr = rng.normal(3.0, 1.5, n).astype(np_dtype)
    return informed, t_inf, belief, counts, awareness, deg, thr


T, DT = 0.3, 0.1


def _port_belief(arrays, np_dtype, mode="auto"):
    llr0, llr1 = (float(np_dtype(v)) for v in LLR)
    t_next = float(np_dtype(T + DT))  # the reference's `t + dt` on Python floats
    return tf.belief_update(*(torch.from_numpy(a) for a in arrays), t_next, DT, llr0, llr1,
                            mode)


def _jax_belief(arrays, np_dtype, mode, jit):
    def run(*xs):
        return jf.belief_update(*xs, T, DT, LLR[0], LLR[1], mode)

    out = (jax.jit(run) if jit else run)(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_belief_plain_equals_compiled_lax_bitwise(np_dtype, t_dtype):
    arrays = _belief_inputs(1500, np_dtype)
    want = _jax_belief(arrays, np_dtype, "lax", jit=True)
    got = [g.numpy() for g in _port_belief(arrays, np_dtype)]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)
    assert got[2].dtype == np_dtype
    newly = got[0] & ~arrays[0]
    assert newly.any() and (~got[0]).any()


@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
@pytest.mark.parametrize("jax_mode, jit", [("interpret", False), ("lax", False)])
def test_belief_plain_within_reference_lowering_tolerance(np_dtype, t_dtype, jax_mode, jit):
    """The Pallas interpreter and the op-by-op dispatch round the llr line
    without fused multiply-adds; the reference holds its lowerings to each
    other within 1e-4 (f32) / 1e-12 (f64) on beliefs, with equal decisions
    (tests/test_infomodels.py::TestBeliefKernel)."""
    arrays = _belief_inputs(1500, np_dtype)
    want = _jax_belief(arrays, np_dtype, jax_mode, jit)
    got = [g.numpy() for g in _port_belief(arrays, np_dtype)]
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    tol = 1e-4 if np_dtype == np.float32 else 1e-12
    np.testing.assert_allclose(want[2], got[2], rtol=tol, atol=tol)


def test_crossing_is_absorbing_and_stamps_t_next():
    informed = torch.zeros(4, dtype=torch.bool)
    t_inf = torch.zeros(4)
    belief = torch.tensor([0.0, 2.9, -5.0, 10.0])
    counts = torch.tensor([10, 10, 0, 0], dtype=torch.int32)
    awareness = torch.ones(4)
    deg = torch.full((4,), 10.0)
    thr = torch.tensor([100.0, 3.0, 0.0, 3.0])
    t_next = float(np.float32(1.1))
    inf2, t2, _ = tf.belief_update(informed, t_inf, belief, counts, awareness, deg, thr,
                                   t_next, 0.1, LLR[0], LLR[1], "auto")
    assert inf2.tolist() == [False, True, False, True]
    assert t2[1] == t2[3] == t_next and t2[0] == 0.0
    again, t3, _ = tf.belief_update(inf2, t2, torch.full((4,), -50.0), counts, awareness, deg,
                                    thr, 9.0, 0.1, LLR[0], LLR[1], "auto")
    assert torch.equal(again, inf2) and torch.equal(t3, t2)


def _exact_fma(a, b, c, np_dtype):
    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        v = Fraction(x) * Fraction(y) + Fraction(z)
        if np_dtype == np.float64:
            out.append(float(v))  # Fraction → float rounds to nearest, ties to even
            continue
        f = np.float32(float(v))
        near = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
        out.append(min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                            int(np.float32(q).view(np.int32)) & 1)))
    return np.array(out, np_dtype)


@pytest.mark.parametrize("n", [1, 2003])
@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_fma_rounds_once_exactly(np_dtype, t_dtype, n):
    """``_fma`` against exact rational arithmetic, on lengths that are no
    multiple of a vector width, with a third of the lanes cancelling."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np_dtype)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(np_dtype)
    c = (rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))).astype(np_dtype)
    k = n // 3
    c[:k] = (-(a[:k].astype(np.float64) * b[:k])).astype(np_dtype)
    got = tf._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_exact_fma(a, b, c, np_dtype)))


def test_belief_mode_resolution_contract(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("SBR_FUSED", raising=False)
    assert tf.resolve_belief_mode("auto", cuda) == "kernel"
    assert tf.resolve_belief_mode("pallas", cuda) == "kernel"
    for mode in ("auto", "lax", "unfused", "interpret"):
        assert tf.resolve_belief_mode(mode, cpu) == "plain"
    assert tf.resolve_belief_mode("lax", cuda) == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        tf.resolve_belief_mode("pallas", cpu)
    with pytest.raises(ValueError, match="belief mode"):
        tf.resolve_belief_mode("warp", cpu)
    monkeypatch.setenv("SBR_FUSED", "unfused")
    assert tf.resolve_belief_mode("auto", cuda) == "plain"
    monkeypatch.setenv("SBR_FUSED", "pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tf.resolve_belief_mode("auto", cpu)
    monkeypatch.setenv("SBR_FUSED", "bogus")
    with pytest.raises(ValueError, match="SBR_FUSED"):
        tf.resolve_belief_mode("auto", cpu)


def test_belief_kernel_wrapper_refuses_cpu_tensors_and_other_types():
    ts_ = [torch.from_numpy(a) for a in _belief_inputs(16, np.float32)]
    args = (1.0, 0.1, LLR[0], LLR[1])
    with pytest.raises(ValueError, match="CUDA"):
        tf._belief_cuda(*ts_, *args)
    half = [t.to(torch.float16) if t.is_floating_point() else t for t in ts_]
    with pytest.raises(NotImplementedError):
        tf._belief_cuda(*half, *args)


# ---------------------------------------------------------------------------
# Per-agent fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [(), HETERO])
@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_agent_fields(np_dtype, t_dtype, groups):
    """β and awareness bit for bit; thresholds within 2 float32 ulp of
    the noise, scaled by threshold_scale, plus one rounding of the sum in
    the sim dtype. XLA's and PyTorch's float32 log differ by one ulp on
    ~11% of lanes (measured); the rest of the line rounds alike."""
    n, seed, beta = 5000, 11, 0.7
    spec_j = js.InfoModelSpec(channel="bayes", groups=groups)
    spec_t = ts.InfoModelSpec(channel="bayes", groups=groups)
    want = [np.asarray(x) for x in je._agent_fields(spec_j, n, seed, beta, np_dtype)]
    got = [x.numpy() for x in te._agent_fields(spec_t, n, seed, beta, np_dtype, CPU)]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype == np_dtype
    np.testing.assert_array_equal(want[0], got[0])  # betas
    np.testing.assert_array_equal(want[2], got[2])  # awareness: the groups
    if groups:
        assert len(np.unique(got[2])) == 3
    _, thr_table, aware_table = spec_t.group_table()
    grp = np.argmax(got[2][:, None] == np.asarray(aware_table, np_dtype)[None, :], axis=1)
    noise = (got[1] - np.asarray(thr_table, np_dtype)[grp]) / spec_t.threshold_scale
    tol = (2 * spec_t.threshold_scale * np.spacing(np.abs(noise).astype(np.float32))
           + 2 * np.spacing(np.abs(got[1])))
    diff = np.abs(want[1].astype(np.float64) - got[1])
    assert (diff <= tol).all(), float((diff / tol).max())
    assert (diff > 0).mean() < 0.25


# ---------------------------------------------------------------------------
# The bayes simulation
# ---------------------------------------------------------------------------

GRAPH_N, STEPS = 800, 24


def _carried_fields(spec_kw, np_dtype, seed):
    spec = js.InfoModelSpec(channel="bayes", **spec_kw)
    return [np.array(x) for x in je._agent_fields(spec, GRAPH_N, seed, 1.0, np_dtype)]


@pytest.mark.parametrize("window", [(0.0, float("inf")), (0.2, 1.0)])
@pytest.mark.parametrize("with_belief0", [False, True])
@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_bayes_sim_with_carried_fields_bitwise(np_dtype, t_dtype, with_belief0, window):
    seed = 3
    kw = dict(n_steps=STEPS, dt=0.1, exit_delay=window[0], reentry_delay=window[1])
    cfg_j, cfg_t = ja.AgentSimConfig(**kw), ta.AgentSimConfig(**kw)
    betas, thr, aware = _carried_fields({}, np_dtype, seed)
    pg_j = jg.prepare_generated_graph(jg.ErdosRenyiSpec(GRAPH_N, 8.0), seed=seed,
                                      dtype=np_dtype, engine="gather")
    pg_t = tg.prepare_generated_graph(tg.ErdosRenyiSpec(GRAPH_N, 8.0), seed=seed,
                                      dtype=np_dtype, engine="gather", device=CPU)
    rng = np.random.default_rng(seed)
    informed0 = rng.random(GRAPH_N) < 0.03
    t_init = np.where(informed0, -rng.uniform(0, 0.5, GRAPH_N), 0).astype(np_dtype)
    belief0 = (rng.normal(0.5, 1.0, GRAPH_N) if with_belief0
               else np.zeros(GRAPH_N)).astype(np_dtype)
    llr01 = np.asarray(LLR, np_dtype)
    want = je._bayes_sim(je._normalize(cfg_j), "lax")(
        pg_j.src, pg_j.row_ptr, pg_j.indeg, jnp.asarray(aware), jnp.asarray(thr),
        jnp.asarray(llr01), jnp.asarray(informed0), jnp.asarray(t_init),
        jnp.asarray(belief0), jnp.int32(0),
    )
    aware_t, thr_t = (torch.from_numpy(a) for a in (aware, thr))
    got = te._bayes_sim(pg_t, aware_t, thr_t, llr01, torch.from_numpy(informed0),
                        torch.from_numpy(t_init), torch.from_numpy(belief0), 0, cfg_t)
    names = ("informed_frac", "withdrawn_frac", "informed", "t_inf", "belief")
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    g = got[0].numpy()
    assert g[-1] > g[0] and np.all(np.diff(g) >= 0)


@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_simulate_info_bayes_end_to_end(np_dtype, t_dtype):
    """With each package's own fields, a threshold one float32 ulp apart
    can flip a crossing. Decisions that differ are counted and each
    fraction differs by at most that count / n at every step."""
    spec_kw = dict(channel="bayes", groups=HETERO)
    cfg_kw = dict(n_steps=STEPS, dt=0.1, reentry_delay=1.5)
    graph = dict(n=GRAPH_N, avg_degree=8.0)
    want = je.simulate_info(js.InfoModelSpec(**spec_kw), jg.ErdosRenyiSpec(**graph),
                            x0=0.03, config=ja.AgentSimConfig(**cfg_kw), seed=4,
                            dtype=np_dtype)
    got = ti.simulate_info(ts.InfoModelSpec(**spec_kw), tg.ErdosRenyiSpec(**graph),
                           x0=0.03, config=ta.AgentSimConfig(**cfg_kw), seed=4,
                           dtype=np_dtype, device=CPU)
    differ = int((np.asarray(want.informed) != got.informed.numpy()).sum())
    assert differ <= 3
    for f in ("informed_frac", "withdrawn_frac"):
        gap = np.abs(np.asarray(getattr(want, f), np.float64) - getattr(got, f).numpy())
        assert gap.max() <= differ / GRAPH_N + 1e-6, f
    np.testing.assert_array_equal(np.asarray(want.t_grid), got.t_grid.numpy())
    assert got.belief_updates == want.belief_updates == GRAPH_N * STEPS
    assert got.epochs == 1 and got.belief.dtype == t_dtype
    # the same run with sbr_tpu's fields carried across is exact
    fields = ti.agent_fields_from_numpy(
        *(np.asarray(x) for x in je._agent_fields(js.InfoModelSpec(**spec_kw), GRAPH_N, 4,
                                                 0.9, np_dtype)), CPU)
    same = ti.simulate_info(ts.InfoModelSpec(**spec_kw), tg.ErdosRenyiSpec(**graph),
                            x0=0.03, config=ta.AgentSimConfig(**cfg_kw), seed=4,
                            dtype=np_dtype, device=CPU, fields=fields)
    for f in ("informed_frac", "withdrawn_frac", "informed", "t_inf", "belief"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(same, f).numpy(), err_msg=f)


def test_simulate_info_belief0_and_initial_state():
    spec_j, spec_t = js.InfoModelSpec(channel="bayes"), ts.InfoModelSpec(channel="bayes")
    graph = dict(n=GRAPH_N, avg_degree=6.0)
    rng = np.random.default_rng(8)
    kw = dict(x0=0.0, seed=2, dtype=np.float64, belief0=0.8,
              informed0=rng.random(GRAPH_N) < 0.05,
              t_inf0=-rng.uniform(0, 1, GRAPH_N))
    want = je.simulate_info(spec_j, jg.ErdosRenyiSpec(**graph),
                            config=ja.AgentSimConfig(n_steps=12, dt=0.1), **kw)
    fields = ti.agent_fields_from_numpy(
        *(np.asarray(x) for x in je._agent_fields(spec_j, GRAPH_N, 2, 0.9, np.float64)), CPU)
    got = ti.simulate_info(spec_t, tg.ErdosRenyiSpec(**graph),
                           config=ta.AgentSimConfig(n_steps=12, dt=0.1), device=CPU,
                           fields=fields, **kw)
    for f in ("informed_frac", "withdrawn_frac", "informed", "t_inf", "belief"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy())
    with pytest.raises(ValueError, match="belief0"):
        ti.simulate_info(ts.InfoModelSpec(), tg.ErdosRenyiSpec(**graph), belief0=0.5,
                         device=CPU)


# ---------------------------------------------------------------------------
# The gossip channel
# ---------------------------------------------------------------------------

GOSSIP_FIELDS = ("informed", "t_inf", "informed_frac", "withdrawn_frac", "t_grid")


@pytest.mark.parametrize("engine", ["gather", "incremental"])
@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
def test_gossip_static_bitwise(np_dtype, t_dtype, engine):
    graph = dict(n=400, avg_degree=8.0)
    kw = dict(beta=1.2, x0=0.02, seed=5, dtype=np_dtype, engine=engine)
    want = je.simulate_info(js.InfoModelSpec(), jg.ErdosRenyiSpec(**graph),
                            config=ja.AgentSimConfig(n_steps=20, dt=0.1), **kw)
    got = ti.simulate_info(ts.InfoModelSpec(), tg.ErdosRenyiSpec(**graph),
                           config=ta.AgentSimConfig(n_steps=20, dt=0.1), device=CPU, **kw)
    for f in GOSSIP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)),
                                      err_msg=f)
    assert got.belief is None and got.epochs == 1


def test_gossip_groups_bitwise():
    """K-group β comes from the fields, exactly equal, so the run is."""
    groups = ((0.5, 3.0, 0.2), (0.5, 3.0, 1.8))
    graph = dict(n=600, avg_degree=10.0)
    kw = dict(beta=1.0, x0=0.02, seed=2)
    want = je.simulate_info(js.InfoModelSpec(groups=groups), jg.ScaleFreeSpec(**graph),
                            config=ja.AgentSimConfig(n_steps=15, dt=0.1), **kw)
    got = ti.simulate_info(ts.InfoModelSpec(groups=groups), tg.ScaleFreeSpec(**graph),
                           config=ta.AgentSimConfig(n_steps=15, dt=0.1), device=CPU, **kw)
    for f in GOSSIP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# What is not ported, and the package rules
# ---------------------------------------------------------------------------


def test_unported_and_device_rules(monkeypatch):
    graph = tg.ErdosRenyiSpec(200, 4.0)
    for channel in ("gossip", "bayes"):
        # rewired runs are ported (tests/test_torch_rewire.py): 200 steps of
        # 25 make 8 epochs
        r = ti.simulate_info(ts.InfoModelSpec(channel=channel, dynamics="rewire"), graph,
                             device=CPU)
        assert r.epochs == 8 and r.informed.device.type == CPU
    with pytest.raises(NotImplementedError):
        tg.prepare_generated_graph(graph, mesh=object(), device=CPU)
    pg = tg.prepare_generated_graph(graph, device=CPU)
    with pytest.raises(ValueError, match="prepared"):
        ti.simulate_info(ts.InfoModelSpec(channel="bayes"), graph, prepared=pg, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ti.simulate_info(ts.InfoModelSpec(channel="bayes"), graph)


def test_infomodels_import_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sbr_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sbr_tpu_torch.infomodels\n"
        "import sbr_tpu_torch as st\n"
        "r = st.simulate_info(st.InfoModelSpec(channel='bayes'), st.ErdosRenyiSpec(300, 6.0),\n"
        "    x0=0.05, config=st.AgentSimConfig(n_steps=5), device='cpu')\n"
        "print('ok', float(r.informed_frac[-1]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
