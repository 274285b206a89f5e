"""The port's sharded agent engines, sharded graph build and sharded closure
(``mesh=``), run as gloo process groups on the CPU (tests/torch_mesh.py),
against the port's single-device runs and sbr_tpu's sharded runs on the
same number of the suite's virtual devices.

Contract, bit for bit:

- every rank's result (informed, t_inf, the trajectories, the recount
  flags, t_grid) equals the port's single-device run, for both comms, both
  engines, a ragged N, with and without the incremental fallback, and
  under launch chunking;
- it equals sbr_tpu's sharded run on a mesh of 2 (and 4) virtual devices,
  recount flags included, and each rank's prepared shard equals the slice
  of sbr_tpu's sharded arrays that its device holds;
- the sharded graph build equals the host prepare under the same mesh
  byte for byte, and sbr_tpu's single-device layout; the self-check's
  sharded block passes;
- a sharded gossip closure's curves equal the single-device closure's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_mesh as tm  # noqa: E402
from sbr_tpu.social import agents as ja  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402

torch.set_num_threads(1)

N, DEG, STEPS = 2003, 8.0, 30  # N is ragged for every mesh size here
WINDOW = (0.1, 2.0)
SIM_FIELDS = ("informed", "t_inf", "informed_frac", "withdrawn_frac", "full_recount_steps",
              "t_grid")

# (id, kwargs of torch_mesh.case_agents): each runs on the 2-rank group
AGENT_CASES = [
    ("scatter-gather", dict(comm="scatter", engine="gather")),
    ("scatter-incremental", dict(comm="scatter", engine="incremental")),
    ("allgather-gather", dict(comm="allgather_psum", engine="gather")),
    ("allgather-incremental", dict(comm="allgather_psum", engine="incremental")),
    ("incremental-fallback", dict(comm="scatter", engine="incremental", budget=4)),
    ("incremental-hubs-f64", dict(comm="scatter", engine="incremental", graph="sf",
                                  betas="lognormal", dtype="float64")),
    ("gather-chunked", dict(comm="scatter", engine="gather", launch_cap=7)),
    ("auto", dict(comm="scatter", engine="auto")),
    # the foldin stream, keyed by global id like the counter one
    ("foldin-scatter-gather", dict(comm="scatter", engine="gather", rng_stream="foldin")),
    ("foldin-incremental-chunked", dict(comm="scatter", engine="incremental",
                                        rng_stream="foldin", launch_cap=11)),
]
WORLD4_CASES = [
    ("scatter-gather", dict(comm="scatter", engine="gather")),
    ("scatter-incremental", dict(comm="scatter", engine="incremental", budget=6)),
    ("allgather-gather", dict(comm="allgather_psum", engine="gather")),
]
GRAPH_CASES = [(s, e) for s in ("er", "sf", "sbm") for e in ("gather", "incremental")]
CLOSURE = dict(n_agents=3001, n_reps=2, graph="host")


def _full(kw):
    out = dict(n=N, deg=DEG, steps=STEPS, window=list(WINDOW), dtype="float32")
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [("agents", _full(kw)) for _, kw in AGENT_CASES]
    cases.append(("agents", _full(dict(comm="scatter", engine="gather", measure=True))))
    cases += [("graphgen", dict(spec=s, n=603, deg=6.0, seed=3, engine=e, chunk_edges=97))
              for s, e in GRAPH_CASES]
    cases.append(("selfcheck", dict()))
    cases.append(("closure", CLOSURE))
    return tm.run_group(2, cases, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [("agents", _full(kw)) for _, kw in WORLD4_CASES]
    return tm.run_group(4, cases, tmp_path_factory.mktemp("world4"))


def _graph(kw):
    if kw.get("graph", "er") == "er":
        return ta.erdos_renyi_edges(N, DEG, seed=1)
    return ta.scale_free_edges(N, DEG, gamma=2.2, seed=1)


def _config(pkg, kw):
    return pkg.AgentSimConfig(n_steps=STEPS, dt=0.1, exit_delay=WINDOW[0],
                              reentry_delay=WINDOW[1],
                              max_steps_per_launch=kw.get("launch_cap"),
                              rng_stream=kw.get("rng_stream", "counter"))


def _port_single(kw):
    kw = _full(kw)
    src, dst = _graph(kw)
    return ta.simulate_agents(
        tm._betas(kw.get("betas", "scalar"), N), src, dst, N, x0=0.01,
        config=_config(ta, kw), seed=5, dtype=np.dtype(kw["dtype"]),
        engine="gather" if kw["engine"] == "auto" else kw["engine"],
        incremental_budget=kw.get("budget"), device="cpu",
    )


_REF_CACHE = {}


def _ref_sharded(kw, n_dev):
    """sbr_tpu's sharded run on the first n_dev virtual devices, and its
    prepared graph."""
    key = (tuple(sorted((k, str(v)) for k, v in kw.items())), n_dev)
    if key not in _REF_CACHE:
        kw = _full(kw)
        src, dst = _graph(kw)
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("agents",))
        pg = ja.prepare_agent_graph(
            tm._betas(kw.get("betas", "scalar"), N), src, dst, N, config=_config(ja, kw),
            mesh=mesh, dtype=np.dtype(kw["dtype"]), comm=kw["comm"], engine=kw["engine"],
            incremental_budget=kw.get("budget"),
        )
        res = ja.simulate_agents(prepared=pg, x0=0.01, config=_config(ja, kw), seed=5)
        _REF_CACHE[key] = (pg, res)
    return _REF_CACHE[key]


def _assert_fields(want: dict, got: dict, fields=SIM_FIELDS):
    for f in fields:
        w, g = np.asarray(want[f]), np.asarray(got[f])
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(w, g, err_msg=f)


def _fields_of(res) -> dict:
    return {f: np.asarray(tm._np(getattr(res, f))) for f in SIM_FIELDS}


def _ref_fields(res) -> dict:
    return {f: np.asarray(getattr(res, f)) for f in SIM_FIELDS}


@pytest.mark.parametrize("i", range(len(AGENT_CASES)), ids=[c[0] for c in AGENT_CASES])
def test_sharded_equals_single_device(world2, i):
    """Every rank's result is the single-device run bit for bit (the
    recount flags only where the engine's telemetry agrees: every step for
    gather)."""
    kw = AGENT_CASES[i][1]
    want = _fields_of(_port_single(kw))
    fields = SIM_FIELDS if kw["engine"] == "gather" else SIM_FIELDS[:4] + ("t_grid",)
    for got in tm.case_result(world2, i):
        _assert_fields(want, got, fields)


@pytest.mark.parametrize("i", range(len(AGENT_CASES)), ids=[c[0] for c in AGENT_CASES])
def test_sharded_equals_reference_sharded(world2, i):
    """Every rank's result is sbr_tpu's sharded run on 2 virtual devices,
    recount flags included; the engine choices agree."""
    kw = AGENT_CASES[i][1]
    pg, res = _ref_sharded(kw, 2)
    for got in tm.case_result(world2, i):
        assert str(got["engine"]) == pg.engine
        assert int(got["budget"]) == pg.budget
        _assert_fields(_ref_fields(res), got)


@pytest.mark.parametrize("i", range(len(AGENT_CASES)), ids=[c[0] for c in AGENT_CASES])
def test_prepared_shards_equal_reference(world2, i):
    """Each rank holds exactly its device's slice of sbr_tpu's sharded
    arrays; no pad edge's source leaves [0, N) (the recount kernel's
    contract)."""
    kw = AGENT_CASES[i][1]
    pg, _ = _ref_sharded(kw, 2)
    for r, got in enumerate(tm.case_result(world2, i)):
        e_l = got["src"].shape[0]
        nb = got["betas"].shape[0]
        np.testing.assert_array_equal(got["src"], np.asarray(pg.src)[r * e_l:(r + 1) * e_l])
        np.testing.assert_array_equal(got["row_ptr"], np.asarray(pg.row_ptr)[r])
        np.testing.assert_array_equal(got["betas"], np.asarray(pg.betas)[r * nb:(r + 1) * nb])
        np.testing.assert_array_equal(got["indeg"], np.asarray(pg.indeg)[r * nb:(r + 1) * nb])
        assert got["src"].min() >= 0 and got["src"].max() < N
        if pg.engine == "incremental":
            ec = got["dst2"].shape[0]
            dst2, lstart, ldeg = (np.asarray(a) for a in pg.inc)
            np.testing.assert_array_equal(got["dst2"], dst2[r * ec:(r + 1) * ec])
            np.testing.assert_array_equal(got["lstart"], lstart[r])
            np.testing.assert_array_equal(got["ldeg"], ldeg[r])


def test_incremental_fallback_fires_only_where_asked(world2):
    """The small budget forces the bitpacked fallback; the default never
    does on this graph."""
    names = [c[0] for c in AGENT_CASES]
    fires = tm.case_result(world2, names.index("incremental-fallback"))[0]
    quiet = tm.case_result(world2, names.index("scatter-incremental"))[0]
    assert fires["full_recount_steps"].sum() > 0
    assert quiet["full_recount_steps"].sum() == 0


def test_measure_engine_matches_single_device(world2):
    """engine="measure" under a mesh: both ranks time both candidates, keep
    the same winner, and the run is the single-device run bit for bit."""
    ranks = tm.case_result(world2, len(AGENT_CASES))
    want = _fields_of(_port_single(dict(comm="scatter", engine="gather")))
    for got in ranks:
        assert list(got["measured"]) == ["gather", "incremental"]
        assert str(got["engine"]) == str(ranks[0]["engine"])
        _assert_fields(want, got, SIM_FIELDS[:4])


@pytest.mark.parametrize("i", range(len(WORLD4_CASES)), ids=[c[0] for c in WORLD4_CASES])
def test_world4_equals_single_and_reference(world4, i):
    """A mesh of four ranks: the single-device run and sbr_tpu's 4-device
    sharded run, bit for bit."""
    kw = WORLD4_CASES[i][1]
    want = _fields_of(_port_single(kw))
    _, res = _ref_sharded(kw, 4)
    for got in tm.case_result(world4, i):
        _assert_fields(want, got, SIM_FIELDS[:4])
        _assert_fields(_ref_fields(res), got)


def _graph_index(spec, engine):
    return len(AGENT_CASES) + 1 + GRAPH_CASES.index((spec, engine))


@pytest.mark.parametrize("spec,engine", GRAPH_CASES)
def test_sharded_build_equals_host_prepare(world2, spec, engine):
    """The sharded build's shards equal the host prepare's under the same
    mesh, byte for byte."""
    for got in tm.case_result(world2, _graph_index(spec, engine)):
        keys = [k[4:] for k in got if k.startswith("gen_")]
        assert {"src", "row_ptr", "indeg", "betas"} <= set(keys)
        if engine == "incremental":
            assert {"dst2", "lstart", "ldeg"} <= set(keys)
        for k in keys:
            np.testing.assert_array_equal(got["gen_" + k], got["host_" + k], err_msg=k)


@pytest.mark.parametrize("spec,engine", GRAPH_CASES)
def test_sharded_build_equals_reference_layout(world2, spec, engine):
    """Cut back into one array, the ranks' dst-sorted sources (pad edges
    dropped) are sbr_tpu's single-device layout; a simulation on the
    sharded build is the single-device one on the port's own build."""
    from sbr_tpu.social import graphgen as jg
    from sbr_tpu_torch.social import graphgen as tg

    sp = {"er": "ErdosRenyiSpec", "sf": "ScaleFreeSpec", "sbm": "StochasticBlockSpec"}[spec]
    kw = dict(n=603, avg_degree=6.0)
    extra = {"sf": dict(gamma=2.5), "sbm": dict(n_blocks=4, p_in=0.8)}.get(spec, {})
    ref = jg.prepare_generated_graph(getattr(jg, sp)(**kw, **extra), seed=3, engine="gather")
    ranks = tm.case_result(world2, _graph_index(spec, engine))
    e = int(np.asarray(ref.src).shape[0])
    src = np.concatenate([got["gen_src"] for got in ranks])[:e]
    np.testing.assert_array_equal(src, np.asarray(ref.src))
    pg = tg.prepare_generated_graph(getattr(tg, sp)(**kw, **extra), seed=3, engine=engine,
                                    device="cpu")
    cfg = ta.AgentSimConfig(n_steps=20, dt=0.1, exit_delay=0.1, reentry_delay=2.0)
    want = _fields_of(ta.simulate_agents(prepared=pg, x0=0.02, config=cfg, seed=1))
    for got in ranks:
        _assert_fields(want, {k[4:]: v for k, v in got.items() if k.startswith("sim_")},
                       SIM_FIELDS[:4])


def test_selfcheck_sharded_block(world2):
    """The self-check runs its sharded block under the 2-rank group and
    passes on every rank."""
    for got in tm.case_result(world2, len(AGENT_CASES) + 1 + len(GRAPH_CASES)):
        out = str(got["out"])
        assert int(got["rc"]) == 0, out
        assert "PASS  sharded gather: generated == host-prepared" in out
        assert "PASS  sharded incremental: generated == host-prepared" in out


def test_sharded_closure_equals_single_device(world2):
    """close_loop(mesh=) on a host graph a member: every rank's curves are
    the single-device closure's bit for bit."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.social.closure import close_loop

    want = close_loop(n_agents=CLOSURE["n_agents"], avg_degree=12.0, n_reps=CLOSURE["n_reps"],
                      seed=0, config=SolverConfig(n_grid=512, bisect_iters=60), t_max=6.0,
                      device="cpu")
    for got in tm.case_result(world2, len(AGENT_CASES) + 2 + len(GRAPH_CASES)):
        np.testing.assert_array_equal(got["aw_sim"], want.aw_sim)
        np.testing.assert_array_equal(got["g_sim"], want.g_sim)
        np.testing.assert_array_equal(got["t"], want.t)


def test_closure_refuses_infomodel_with_mesh():
    from sbr_tpu_torch.infomodels.spec import InfoModelSpec
    from sbr_tpu_torch.social.closure import close_loop

    with pytest.raises(ValueError, match="mesh"):
        close_loop(n_agents=100, mesh=object(), infomodel=InfoModelSpec(), device="cpu")


def test_prepared_graph_refuses_another_mesh_or_comm():
    src, dst = ta.erdos_renyi_edges(200, 4.0, seed=0)
    pg = ta.prepare_agent_graph(1.0, src, dst, 200, device="cpu")
    for kw in (dict(mesh=object()), dict(comm="allgather_psum")):
        with pytest.raises(ValueError, match="conflict with prepared"):
            ta.simulate_agents(prepared=pg, **kw)
    with pytest.raises(ValueError, match="comm"):
        ta.prepare_agent_graph(1.0, src, dst, 200, comm="ring", device="cpu")
