"""The port's explicit-agent simulation (sbr_tpu_torch.social.agents) against
sbr_tpu's, on the same numpy graphs and seeds, on the CPU.

Contract: the prepared layout and the engine choice are equal; simulations
are exactly equal in informed, t_inf, informed_frac, withdrawn_frac and the
recount flags, in float64 and float32 alike. float32 is asserted exact
too: Threefry, the uniform, the division, the products and the fractions
round identically, and a one-ulp difference between XLA's and PyTorch's
expf flips a decision only when the draw falls inside that ulp (~6e-8 per
comparison), which these sizes do not meet."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

from sbr_tpu.social import agents as ja  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
N, DEG, STEPS = 2000, 8.0, 40
FIELDS = ("informed", "t_inf", "informed_frac", "withdrawn_frac", "full_recount_steps", "t_grid")


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16 of its own
            return x.cpu().view(torch.int16).numpy().view(bfloat16)
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(want, got, fields=FIELDS):
    for f in fields:
        w, g = _np(getattr(want, f)), _np(getattr(got, f))
        assert w.dtype == g.dtype, f
        # compared as bytes: bit for bit, and numpy compares no bfloat16
        np.testing.assert_array_equal(w.view(np.uint8), g.view(np.uint8), err_msg=f)


@pytest.fixture(scope="module")
def graph():
    return ta.erdos_renyi_edges(N, DEG, seed=1)


def _configs(window, **kw):
    kw = dict(n_steps=STEPS, dt=0.1, exit_delay=window[0], reentry_delay=window[1], **kw)
    return ja.AgentSimConfig(**kw), ta.AgentSimConfig(**kw)


def _betas(kind):
    if kind == "scalar":
        return 1.0
    return np.random.default_rng(9).lognormal(0.0, 0.5, N)


# ---------------------------------------------------------------------------
# Graph generation and layout
# ---------------------------------------------------------------------------


def test_erdos_renyi_and_scale_free_match_numpy_streams(monkeypatch):
    # the numpy streams (SBR_NATIVE=0); the default native pair stream is
    # held in tests/test_torch_native.py
    monkeypatch.setenv("SBR_NATIVE", "0")
    for want, got in (
        (ja.erdos_renyi_edges(3000, 6.0, seed=4), ta.erdos_renyi_edges(3000, 6.0, seed=4)),
        (ja.scale_free_edges(3000, 5.0, seed=4), ta.scale_free_edges(3000, 5.0, seed=4)),
    ):
        for w, g in zip(want, got):
            assert w.dtype == g.dtype == np.int32
            np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_prepared_layout_bitwise(graph, dtype):
    src, dst = graph
    betas = _betas("hetero")
    want = ja.prepare_agent_graph(betas, src, dst, N, dtype=dtype, engine="incremental")
    got = ta.prepare_agent_graph(betas, src, dst, N, dtype=dtype, engine="incremental", device=CPU)
    pairs = [("betas", want.betas, got.betas), ("src", want.src, got.src),
             ("row_ptr", want.row_ptr, got.row_ptr), ("indeg", want.indeg, got.indeg)]
    pairs += [(k, w, g) for k, w, g in zip(("dst2", "out_ptr", "outdeg"), want.inc, got.inc)]
    for name, w, g in pairs:
        w, g = _np(w), _np(g)
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert (want.budget, want.max_degree, want.n_edges) == (got.budget, got.max_degree, got.n_edges)


@pytest.mark.parametrize("engine", ["gather", "incremental"])
@pytest.mark.parametrize("stream", ["default", "numpy"])
def test_prepared_layout_bitwise_from_each_packages_graph(stream, engine, monkeypatch):
    """Each package draws its own graph from one seed and prepares it: the
    default stream (no ``SBR_NATIVE``: the native sampler and the counting
    sort in both) and the numpy one (``SBR_NATIVE=0``) give the reference's
    layout bit for bit."""
    monkeypatch.delenv("SBR_NATIVE", raising=False)
    if stream == "numpy":
        monkeypatch.setenv("SBR_NATIVE", "0")
    betas = _betas("hetero")
    jsrc, jdst = ja.erdos_renyi_edges(N, DEG, seed=3)
    tsrc, tdst = ta.erdos_renyi_edges(N, DEG, seed=3)
    want = ja.prepare_agent_graph(betas, jsrc, jdst, N, dtype=np.float32, engine=engine)
    got = ta.prepare_agent_graph(betas, tsrc, tdst, N, dtype=np.float32, engine=engine,
                                 device=CPU)
    pairs = [("src", want.src, got.src), ("row_ptr", want.row_ptr, got.row_ptr),
             ("indeg", want.indeg, got.indeg)]
    if engine == "incremental":
        pairs += [(k, w, g) for k, w, g in zip(("dst2", "out_ptr", "outdeg"), want.inc, got.inc)]
    for name, w, g in pairs:
        w, g = _np(w), _np(g)
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert (want.engine, want.n_edges) == (got.engine, got.n_edges) == (engine, len(tsrc))


def test_sort_edges_rejects_out_of_range():
    from sbr_tpu_torch.native import sort_edges_by_dst

    with pytest.raises(ValueError, match="out of range"):
        sort_edges_by_dst(np.array([0, 1]), np.array([1, 5]), 3)


# ---------------------------------------------------------------------------
# Engine census
# ---------------------------------------------------------------------------

_SF_OUTDEG = np.bincount(
    np.random.default_rng(0).choice(
        100_000, size=1_000_000,
        p=(w := np.arange(1, 100_001) ** (-1.0 / 1.5)) / w.sum(),
    ),
    minlength=100_000,
)
_STRETCH = np.zeros(1_000_000, np.int64)
_STRETCH[:12098] = 200
_LIGHT = np.full(10000, 10)
_LIGHT_HUBS = _LIGHT.copy()
_LIGHT_HUBS[:5] = 200

CENSUS_CASES = [
    ((_LIGHT, 64, 200, 10000, 1.0, 0.05, 4096), {}),
    ((_LIGHT_HUBS, 64, 200, 10000, 1.0, 0.05, 4096), {}),
    ((_SF_OUTDEG, 64, 200, 100_000, 1.0, 0.05, 4096), {}),
    ((np.full(2_000_000, 200), 64, 200, 2_000_000, 1.0, 0.05, 1 << 30), {}),
    ((np.full(1000, 10), 64, 80, 2_000_000, 5.0, 0.1, 4096), {}),
    ((np.full(1000, 10), 64, 6, 2_000_000, 10.0, 0.3, 4096), {}),
    ((np.full(1000, 10), 64, 80, 2_000_000, 5.0, 0.1, 300_000), {}),
    ((np.full(1000, 10), 64, 200, 1_000_000, 1.0, 0.05, 15625), {"waves": 1.0}),
    ((np.full(1000, 10), 64, 280, 1_000_000, 1.0, 0.05, 15625), {"waves": 2.0}),
    ((_STRETCH, 64, 200, 1_000_000, 1.1331, 0.05, 15625), {"waves": 1.0}),
]


@pytest.mark.parametrize("args, kw", CENSUS_CASES)
def test_census_equals_sbr_tpu(args, kw):
    assert ta._census_fallback_steps(*args, **kw) == ja._census_fallback_steps(*args, **kw)
    assert ta._auto_engine(*args, **kw) == ja._auto_engine(*args, **kw)


@pytest.mark.parametrize(
    "shape",
    [
        # ER with the window geometries of sbr_tpu's census tests
        dict(kind="er", beta=3.0, n_steps=120, exit_delay=0.0, reentry_delay=np.inf),
        dict(kind="er", beta=3.0, n_steps=120, exit_delay=0.0, reentry_delay=2.0),
        dict(kind="er", beta=3.0, n_steps=120, exit_delay=5.0, reentry_delay=2.0),
        # a scale-free hub tail, and a contagion that overflows a small
        # budget on every step (which picks gather)
        dict(kind="sf", beta=1.0, n_steps=100, exit_delay=0.0, reentry_delay=np.inf),
        dict(kind="er", beta=10.0, n_steps=6, dt=0.3, exit_delay=0.0, reentry_delay=1.0,
             budget=16, want="gather"),
    ],
)
def test_auto_engine_choice_equals_sbr_tpu(shape):
    n = 3000
    if shape["kind"] == "er":
        src, dst = ta.erdos_renyi_edges(n, 8.0, seed=2)
    else:
        src, dst = ta.scale_free_edges(n, 20.0, gamma=2.1, seed=2)
    kw = dict(n_steps=shape["n_steps"], dt=shape.get("dt", 0.1),
              exit_delay=shape["exit_delay"], reentry_delay=shape["reentry_delay"])
    jc, tc = ja.AgentSimConfig(**kw), ta.AgentSimConfig(**kw)
    budget = shape.get("budget")
    want = ja.prepare_agent_graph(shape["beta"], src, dst, n, config=jc, incremental_budget=budget)
    got = ta.prepare_agent_graph(shape["beta"], src, dst, n, config=tc, incremental_budget=budget,
                                 device=CPU)
    assert got.engine == want.engine == shape.get("want", "incremental")


# ---------------------------------------------------------------------------
# Simulation parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("engine", ["gather", "incremental"])
@pytest.mark.parametrize("window", [(0.0, np.inf), (0.5, 2.0)])
@pytest.mark.parametrize("betas", ["scalar", "hetero"])
def test_simulate_matches_sbr_tpu(graph, dtype, engine, window, betas):
    src, dst = graph
    jc, tc = _configs(window)
    b = _betas(betas)
    want = ja.simulate_agents(b, src, dst, N, x0=0.01, config=jc, seed=3, engine=engine, dtype=dtype)
    got = ta.simulate_agents(b, src, dst, N, x0=0.01, config=tc, seed=3, engine=engine,
                             dtype=dtype, device=CPU)
    assert_same(want, got)
    assert got.agent_steps == want.agent_steps == N * STEPS
    g = _np(got.informed_frac)
    assert g[-1] > g[0]  # the contagion actually spreads


@pytest.mark.parametrize("dtype", [np.float16, bfloat16, np.float32])
@pytest.mark.parametrize("engine", ["gather", "incremental"])
@pytest.mark.parametrize("stream", ["counter", "foldin"])
def test_half_types_and_foldin_match_sbr_tpu(graph, dtype, engine, stream):
    """float16 and bfloat16 (each rounded where XLA on the CPU rounds the
    reference's step) and the foldin stream: bit for bit, heterogeneous β
    and a withdrawal window."""
    src, dst = graph
    jc, tc = _configs((0.5, 2.0), rng_stream=stream)
    b = _betas("hetero")
    want = ja.simulate_agents(b, src, dst, N, x0=0.01, config=jc, seed=3, engine=engine,
                              dtype=dtype)
    got = ta.simulate_agents(b, src, dst, N, x0=0.01, config=tc, seed=3, engine=engine,
                             dtype=dtype, device=CPU)
    assert_same(want, got)
    g = _np(got.informed_frac).astype(np.float64)
    assert g[-1] > g[0]


def test_foldin_chunking_and_resume_match_sbr_tpu(graph):
    """foldin under max_steps_per_launch and across a resume equals the
    reference's unchunked run."""
    src, dst = graph
    jc, tc = _configs((0.5, 2.0), rng_stream="foldin")
    want = ja.simulate_agents(1.0, src, dst, N, x0=0.01, config=jc, seed=3, engine="incremental")
    pg = ta.prepare_agent_graph(1.0, src, dst, N, engine="incremental", device=CPU)
    chunked = ta.simulate_agents(
        prepared=pg, x0=0.01, config=dataclasses.replace(tc, max_steps_per_launch=9), seed=3)
    assert_same(want, chunked, FIELDS[:4] + ("t_grid",))
    half = dataclasses.replace(tc, n_steps=STEPS // 2)
    first = ta.simulate_agents(prepared=pg, x0=0.01, config=half, seed=3)
    second = ta.simulate_agents(prepared=pg, config=half, seed=3, informed0=first.informed,
                                t_inf0=first.t_inf, step_offset=STEPS // 2)
    for f in ("informed", "t_inf"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(second, f)))


@pytest.mark.parametrize("compact_impl", ["searchsorted", "searchsorted_blocked", "scatter"])
def test_overflow_fallback_and_compaction(graph, compact_impl):
    """A tiny change budget forces the overflow → full-recount fallback on
    some steps and not others; every compaction lowering gives sbr_tpu's
    result, recount flags included."""
    src, dst = graph
    jc, tc = _configs((0.5, 2.0), compact_impl=compact_impl)
    kw = dict(x0=0.01, seed=3, engine="incremental", incremental_budget=6, dtype=np.float64)
    want = ja.simulate_agents(1.0, src, dst, N, config=jc, **kw)
    got = ta.simulate_agents(1.0, src, dst, N, config=tc, device=CPU, **kw)
    assert_same(want, got)
    rec = _np(got.full_recount_steps)
    assert 0 < rec.sum() < STEPS
    gather = ta.simulate_agents(1.0, src, dst, N, config=tc, device=CPU,
                                **{**kw, "engine": "gather", "incremental_budget": None})
    assert_same(gather, got, FIELDS[:4])


@pytest.mark.parametrize("budget", [5, 64])
def test_compact_ids_equals_sbr_tpu(budget):
    import jax.numpy as jnp

    mask = np.random.default_rng(budget).random(1000) < 0.03
    for impl in ("searchsorted", "searchsorted_blocked", "scatter"):
        want = np.asarray(ja._compact_ids(jnp.asarray(mask), budget, 1000, impl))
        got = ta._compact_ids(torch.from_numpy(mask), budget, 1000, impl).numpy()
        np.testing.assert_array_equal(want, got, err_msg=impl)


def test_chunking_and_resume_bit_identical(graph):
    src, dst = graph
    _, tc = _configs((0.5, 2.0))
    pg = ta.prepare_agent_graph(1.0, src, dst, N, engine="incremental", device=CPU)
    full = ta.simulate_agents(prepared=pg, x0=0.01, config=tc, seed=3)
    chunked = ta.simulate_agents(
        prepared=pg, x0=0.01, config=dataclasses.replace(tc, max_steps_per_launch=7), seed=3
    )
    assert_same(full, chunked, FIELDS[:4] + ("t_grid",))
    half = dataclasses.replace(tc, n_steps=STEPS // 2)
    first = ta.simulate_agents(prepared=pg, x0=0.01, config=half, seed=3)
    second = ta.simulate_agents(prepared=pg, config=half, seed=3, informed0=first.informed,
                                t_inf0=first.t_inf, step_offset=STEPS // 2)
    for f in ("informed", "t_inf"):
        assert torch.equal(getattr(full, f), getattr(second, f))
    for f in ("informed_frac", "withdrawn_frac", "t_grid"):
        joined = torch.cat([getattr(first, f), getattr(second, f)])
        assert torch.equal(getattr(full, f), joined)


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_initial_state_override_matches_sbr_tpu(graph, engine):
    """informed0/t_inf0 replace the seeded state; negative informed times
    place agents inside the window at t = 0."""
    src, dst = graph
    rng = np.random.default_rng(4)
    informed0 = rng.random(N) < 0.02
    t_inf0 = rng.uniform(-3.0, 0.0, N)
    jc, tc = _configs((0.5, 2.0))
    kw = dict(informed0=informed0, t_inf0=t_inf0, seed=8, engine=engine, dtype=np.float64)
    want = ja.simulate_agents(1.0, src, dst, N, config=jc, **kw)
    got = ta.simulate_agents(1.0, src, dst, N, config=tc, device=CPU, **kw)
    assert_same(want, got)
    assert _np(got.withdrawn_frac)[0] > 0


def test_prepared_conflicts_and_shape_checks(graph):
    src, dst = graph
    pg = ta.prepare_agent_graph(1.0, src, dst, N, device=CPU)
    for bad in (dict(n=N), dict(engine="gather"), dict(device=CPU), dict(src=src),
                dict(incremental_budget=5)):
        with pytest.raises(ValueError, match="conflict with prepared"):
            ta.simulate_agents(prepared=pg, **bad)
    with pytest.raises(ValueError, match="length"):
        ta.simulate_agents(prepared=pg, informed0=np.zeros(N - 1, bool))
    with pytest.raises(ValueError, match="needs"):
        ta.simulate_agents(1.0, src, dst)


# ---------------------------------------------------------------------------
# State carried across from sbr_tpu
# ---------------------------------------------------------------------------


def test_resume_from_sbr_tpu_checkpoint(graph, tmp_path):
    """sbr_tpu runs 20 steps and saves; the port loads the npz and runs 20
    more: equal to sbr_tpu's uninterrupted 40 steps. The port's own save
    loads back in sbr_tpu."""
    src, dst = graph
    jc, tc = _configs((0.0, np.inf))
    j20 = dataclasses.replace(jc, n_steps=STEPS // 2)
    t20 = dataclasses.replace(tc, n_steps=STEPS // 2)
    kw = dict(x0=0.01, seed=6, engine="incremental")
    whole = ja.simulate_agents(1.0, src, dst, N, config=jc, **kw)
    part = ja.simulate_agents(1.0, src, dst, N, config=j20, **kw)
    ja.save_agent_state(tmp_path / "jax.npz", part, seed=6, dt=0.1)
    state = ta.load_agent_state(tmp_path / "jax.npz", dt=0.1)
    assert state["step_offset"] == STEPS // 2 and state["seed"] == 6
    rest = ta.simulate_agents(1.0, src, dst, N, config=t20, engine="incremental",
                              device=CPU, **state)
    np.testing.assert_array_equal(_np(whole.informed), _np(rest.informed))
    np.testing.assert_array_equal(_np(whole.t_inf), _np(rest.t_inf))
    np.testing.assert_array_equal(_np(whole.informed_frac)[STEPS // 2:], _np(rest.informed_frac))

    ta.save_agent_state(tmp_path / "port.npz", rest, seed=6, dt=0.1)
    back = ja.load_agent_state(tmp_path / "port.npz", dt=0.1)
    assert back["step_offset"] == STEPS and back["seed"] == 6
    np.testing.assert_array_equal(back["t_inf0"], _np(rest.t_inf))
    with pytest.raises(ValueError, match="dt="):
        ta.load_agent_state(tmp_path / "port.npz", dt=0.05)


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_prepared_from_numpy_of_sbr_tpu_graph(graph, engine):
    src, dst = graph
    jpg = ja.prepare_agent_graph(_betas("hetero"), src, dst, N, engine=engine)
    arrays = dict(betas=jpg.betas, src=jpg.src, row_ptr=jpg.row_ptr, indeg=jpg.indeg,
                  engine=jpg.engine, budget=jpg.budget, max_degree=jpg.max_degree)
    if jpg.inc is not None:
        arrays.update(zip(("dst2", "out_ptr", "outdeg"), jpg.inc))
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in arrays.items()}
    pg = ta.prepared_from_numpy(arrays, CPU)
    own = ta.prepare_agent_graph(_betas("hetero"), src, dst, N, engine=engine, device=CPU)
    _, tc = _configs((0.5, 2.0))
    a = ta.simulate_agents(prepared=pg, x0=0.01, config=tc, seed=2)
    b = ta.simulate_agents(prepared=own, x0=0.01, config=tc, seed=2)
    assert_same(a, b)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_and_no_sbr_tpu():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import sbr_tpu_torch as st\n"
        "for name in st.__all__:  # the package's exports load on first use\n"
        "    getattr(st, name)\n"
        "import sbr_tpu_torch.benchmarks.ablate_pallas_recount\n"
        "import sbr_tpu_torch.core.ode\n"
        "import sbr_tpu_torch.figures.master\n"
        "import sbr_tpu_torch.obs.mem\n"
        "import sbr_tpu_torch.obs.prof\n"
        "import sbr_tpu_torch.obs.runlog\n"
        "import sbr_tpu_torch.obs.report\n"
        "import sbr_tpu_torch.obs.history\n"
        "import sbr_tpu_torch.hetero\n"
        "import sbr_tpu_torch.interest\n"
        "import sbr_tpu_torch.social.recount\n"
        "import sbr_tpu_torch.sweeps.policy_sweeps\n"
        "src, dst = st.erdos_renyi_edges(300, 5.0, seed=0)\n"
        "r = st.simulate_agents(1.0, src, dst, 300, x0=0.05, device='cpu',\n"
        "    config=st.AgentSimConfig(n_steps=5))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sbr_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', float(r.informed_frac[-1]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_report_and_history_import_no_torch():
    """The run reader is a CLI over JSON files (chaos drills run it as a
    subprocess): importing it, or running it, loads no torch."""
    code = (
        "import sys\n"
        "import sbr_tpu_torch.obs.report, sbr_tpu_torch.obs.history\n"
        "from sbr_tpu_torch import obs\n"
        "obs.report.main(['trend', 'missing.jsonl'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'sbr_tpu', 'numpy'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _import_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_only_torch_numpy_and_the_port():
    # besides the port, chip_smoke.py loads the repo's numpy/scipy oracle
    # (tests/oracle.py) to hold the social fixed point to it; that module
    # must import no JAX either
    # (the standard library's os, pathlib, shutil and tempfile serve the
    # tiled phases' checkpoint directories and worker processes; contextlib
    # and io capture the replication run's printed manifest; types gives
    # the fleet phase loadgen's argument namespace)
    roots = _import_roots(REPO / "chip_smoke.py")
    assert roots <= {"__future__", "contextlib", "io", "json", "os", "pathlib", "shutil",
                     "subprocess", "sys", "tempfile", "time", "types", "numpy", "torch",
                     "sbr_tpu_torch", "oracle"}, roots
    assert _import_roots(REPO / "tests" / "oracle.py") <= {
        "__future__", "dataclasses", "numpy", "scipy"}


def test_entry_points_need_cuda_unless_told_cpu(graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = graph
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.prepare_agent_graph(1.0, src, dst, N)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.simulate_agents(1.0, src, dst, N)


def test_unported_options_raise(graph):
    src, dst = graph
    # engine="measure" is ported: it times both engines and keeps one, and
    # only prepare_agent_graph takes it
    cfg = ta.AgentSimConfig(n_steps=4)
    pg = ta.prepare_agent_graph(1.0, src, dst, N, config=cfg, engine="measure", device=CPU)
    assert [lbl for lbl, _ in pg.measured_steps_per_sec] == ["gather", "incremental"]
    with pytest.raises(ValueError, match="prepare_agent_graph feature"):
        ta.simulate_agents(1.0, src, dst, N, engine="measure", device=CPU)
    with pytest.raises(ValueError, match="measure_probe"):
        ta.prepare_agent_graph(1.0, src, dst, N, measure_probe={}, device=CPU)
    # mesh= is ported (tests/test_torch_sharded_agents.py); its comm is checked
    with pytest.raises(ValueError, match="comm"):
        ta.prepare_agent_graph(1.0, src, dst, N, comm="ring", device=CPU)
    # the foldin stream is ported: it runs, as the reference's does
    got = ta.simulate_agents(1.0, src, dst, N, device=CPU,
                             config=ta.AgentSimConfig(n_steps=2, rng_stream="foldin"))
    assert_same(ja.simulate_agents(1.0, src, dst, N,
                                   config=ja.AgentSimConfig(n_steps=2, rng_stream="foldin")),
                got)
    with pytest.raises(ValueError, match="rng_stream"):
        ta.AgentSimConfig(rng_stream="philox")
    with pytest.raises(ValueError):
        ta.AgentSimConfig(compact_impl="nonzero")
    with pytest.raises(ValueError):
        ta.AgentSimConfig(fused="triton")
