"""The port's population what-if queries (sbr_tpu_torch.infomodels.
population) and their serving route, on the CPU, against sbr_tpu's.

Contracts:

- `crossing_times`, `parse_population_doc` (its errors included) and
  `graph_spec_from_doc` are the reference's;
- `population_fingerprint` equals the reference's hex;
- `population_query` from a fixed point carried across
  (`fixed_point_from_numpy`), with the reference's per-agent fields
  patched in for bayes (the thresholds' float32 ``log`` rounds apart
  between the frameworks, tests/test_torch_infomodels.py): the record
  equals the reference's exactly, in both ``vary`` modes and both
  channels;
- a ``rewire`` information model is served at the function, the engine
  and the endpoint (200);
- the engine serves, caches (LRU, then the verified disk layer after a
  restart) and keys population records; the endpoint answers with the
  reference's codes.

Every wait carries a timeout and every server is closed in a ``finally``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.infomodels import engine as je  # noqa: E402
from sbr_tpu.infomodels import meanfield as jmf  # noqa: E402
from sbr_tpu.infomodels import population as jpop  # noqa: E402
from sbr_tpu.infomodels.spec import InfoModelSpec as JSpec  # noqa: E402
from sbr_tpu.models.params import SolverConfig as JConfig  # noqa: E402
from sbr_tpu.models.params import make_model_params as jmodel  # noqa: E402
from sbr_tpu.social import graphgen as jg  # noqa: E402
from sbr_tpu_torch.infomodels import engine as te  # noqa: E402
from sbr_tpu_torch.infomodels import population as tpop  # noqa: E402
from sbr_tpu_torch.infomodels.spec import InfoModelSpec as TSpec  # noqa: E402
from sbr_tpu_torch.models.params import SolverConfig as TConfig  # noqa: E402
from sbr_tpu_torch.models.params import make_model_params as tmodel  # noqa: E402
from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint  # noqa: E402
from sbr_tpu_torch.serve.loadgen import http_request  # noqa: E402
from sbr_tpu_torch.social import graphgen as tg  # noqa: E402
from sbr_tpu_torch.social.solver import fixed_point_from_numpy  # noqa: E402

CPU = "cpu"
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
PARAMS_DOC = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25}
POP = {"graph": {"model": "erdos_renyi", "n": 800, "avg_degree": 8},
       "infomodel": {"channel": "bayes"}, "seeds": 2, "vary": "sim", "g0": None}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on one machine, and torch's default pool in each of them
    oversubscribes the cores, where its small CPU ops wait on each other
    (a gossip population query took 337 s under six workers, 4.7 s with
    one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: as_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


@pytest.fixture(scope="module", params=["bayes", "gossip"])
def carried(request):
    """The reference's mean-field fixed point of one channel at n_grid 256
    (bench.py's population shape) and the port's carried copy of it."""
    channel = request.param
    want = jmf.solve_fixed_point_info(JSpec(channel=channel), jmodel(**FIG12),
                                      config=JConfig(n_grid=256), max_iter=500)
    return channel, want, fixed_point_from_numpy(as_numpy(want), device=CPU)


@pytest.fixture
def reference_fields(monkeypatch):
    """The port's field draw returns the reference's fields."""

    def fields(spec, n, seed, beta, dtype, device):
        jspec = JSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})
        return tuple(torch.from_numpy(np.array(f)).to(device)
                     for f in je._agent_fields(jspec, n, seed, beta, dtype))

    monkeypatch.setattr(te, "_agent_fields", fields)


def test_crossing_times_is_the_reference_s():
    t = np.asarray([0.0, 1.0, 2.0, 3.0])
    rows = np.asarray([[0.0, 0.1, 0.3, 0.5], [0.0, 0.05, 0.1, 0.2], [0.5, 0.6, 0.7, 0.8],
                       [0.0, 0.25, 0.25, 0.9], [0.1, 0.1, 0.4, 0.4]])
    got = tpop.crossing_times(rows, t, 0.25)
    np.testing.assert_array_equal(got, jpop.crossing_times(rows, t, 0.25))
    assert got[0] == pytest.approx(1.75) and np.isnan(got[1]) and got[2] == 0.0


@pytest.mark.parametrize("vary, seeds, n, g0", [
    ("sim", 3, 1000, 0.02),
    ("graph", 2, 800, 0.02),
    ("sim", 2, 600, None),
])
def test_population_query_record_equals_the_reference(carried, reference_fields, vary, seeds,
                                                      n, g0):
    channel, want_fp, got_fp = carried
    kw = dict(seeds=seeds, vary=vary, seed=5, g0=g0)
    want = jpop.population_query(JSpec(channel=channel), jg.ErdosRenyiSpec(n=n, avg_degree=10.0),
                                 jmodel(**FIG12), fp=want_fp, **kw)
    got = tpop.population_query(TSpec(channel=channel), tg.ErdosRenyiSpec(n=n, avg_degree=10.0),
                                tmodel(**FIG12), fp=got_fp, device=CPU, **kw)
    assert got == want
    assert got["kind"] == "population" and len(got["crossing_times"]) == seeds
    assert got["vary"] == vary and got["channel"] == channel
    if vary == "graph":
        assert got["err_aw_sup"] > 0


def test_population_query_validation_and_rewire():
    m = tmodel(**FIG12)
    graph = tg.ErdosRenyiSpec(n=200, avg_degree=5.0)
    with pytest.raises(ValueError, match="vary"):
        tpop.population_query(TSpec(), graph, m, vary="chaos", device=CPU)
    with pytest.raises(ValueError, match="seeds"):
        tpop.population_query(TSpec(), graph, m, seeds=0, device=CPU)
    # rewire models run (their records are held to the reference's in
    # tests/test_torch_rewire.py)
    cfg = TConfig(n_grid=256)
    for spec, vary in ((TSpec(dynamics="rewire"), "sim"),
                       (TSpec(channel="bayes", dynamics="rewire"), "graph")):
        rec = tpop.population_query(spec, graph, m, seeds=2, vary=vary, config=cfg,
                                    device=CPU)
        assert rec["dynamics"] == "rewire" and len(rec["crossing_times"]) == 2


@pytest.mark.parametrize("doc", [
    {},
    {"graph": {"n": 10, "avg_degree": 2}, "sedes": 3},
    {"graph": {"n": 10, "avg_degree": 2}, "seeds": 100000},
    {"graph": {"n": 10, "avg_degree": 2}, "seeds": 0},
    {"graph": {"n": 10, "avg_degree": 2}, "vary": "chaos"},
    {"graph": {"n": 10, "avg_degree": 2}, "dt": 0.0},
    {"graph": {"model": "nope"}},
    {"graph": {"n": 10, "avg_degree": 2, "gamma": 2.0}},
    {"graph": [1, 2]},
    {"graph": {"n": 10, "avg_degree": 2}, "infomodel": {"chanel": "bayes"}},
    {"graph": {"n": 10, "avg_degree": 2}, "infomodel": {"channel": "smoke"}},
    [1],
])
def test_parse_population_doc_errors_are_the_reference_s(doc):
    with pytest.raises(ValueError) as got:
        tpop.parse_population_doc(doc)
    with pytest.raises(ValueError) as want:
        jpop.parse_population_doc(doc)
    assert str(got.value) == str(want.value)


def test_parse_population_doc_and_fingerprint_equal_the_reference():
    cfg_t, cfg_j = TConfig(n_grid=128), JConfig(n_grid=128)
    docs = [
        {"graph": {"model": "scale_free", "n": 50, "avg_degree": 3, "gamma": 2.2},
         "infomodel": {"channel": "bayes"}, "seeds": 2},
        {"graph": {"n": 100, "avg_degree": 5.0}, "vary": "graph", "seed": 3, "dt": 0.05},
        {"graph": {"model": "stochastic_block", "n": 120, "avg_degree": 6.0,
                   "n_blocks": 3, "p_in": 0.7},
         "infomodel": {"groups": [[0.5, 2.0, 1.0], [0.5, 3.0, 2.0]]}, "g0": None},
        {"graph": {"n": 100, "avg_degree": 5.0}, "g0": 0.05},
    ]
    keys = set()
    for doc in docs:
        want = jpop.parse_population_doc(doc)
        got = tpop.parse_population_doc(doc)
        assert type(got["graph"]).__name__ == type(want["graph"]).__name__
        assert dataclasses.asdict(got["graph"]) == dataclasses.asdict(want["graph"])
        assert got["spec"].to_doc() == want["spec"].to_doc()
        assert {k: v for k, v in got.items() if k not in ("graph", "spec")} == \
            {k: v for k, v in want.items() if k not in ("graph", "spec")}
        for dt in ("float64", "float32"):
            f = tpop.population_fingerprint(got, tmodel(**FIG12), cfg_t, dt)
            assert f == jpop.population_fingerprint(want, jmodel(**FIG12), cfg_j, dt)
            keys.add(f)
    assert len(keys) == 2 * len(docs)
    base = tpop.parse_population_doc({"graph": {"n": 100, "avg_degree": 5.0}})
    f = tpop.population_fingerprint(base, tmodel(**FIG12), cfg_t, torch.float64)
    assert f == tpop.population_fingerprint(dict(base), tmodel(**FIG12), cfg_t, "float64")
    assert f != tpop.population_fingerprint({**base, "vary": "graph"}, tmodel(**FIG12), cfg_t,
                                            "float64")
    assert f != tpop.population_fingerprint(
        {**base, "graph": tg.ErdosRenyiSpec(n=101, avg_degree=5.0)}, tmodel(**FIG12), cfg_t,
        "float64")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _engine(cache_dir):
    return Engine(config=TConfig(n_grid=256), serve=ServeConfig(buckets=(1,),
                                                                cache_dir=str(cache_dir)),
                  device=CPU)


def test_engine_caches_population_records(tmp_path):
    engine = _engine(tmp_path)
    try:
        first = engine.query_population(tmodel(**FIG12), POP)
        again = engine.query_population(tmodel(**FIG12), POP)
        with pytest.raises(ValueError, match="graph"):
            engine.query_population(tmodel(**FIG12), {"seeds": 2})
    finally:
        engine.close()
    assert (first["source"], again["source"]) == ("computed", "lru")
    assert first["population_fingerprint"] == again["population_fingerprint"]
    direct = tpop.population_query(TSpec(channel="bayes"), tg.ErdosRenyiSpec(800, 8.0),
                                   tmodel(**FIG12), seeds=2, g0=None,
                                   config=TConfig(n_grid=256), device=CPU)
    strip = ("source", "latency_ms", "population_fingerprint")
    assert {k: v for k, v in first.items() if k not in strip} == direct
    engine = _engine(tmp_path)
    try:
        restored = engine.query_population(tmodel(**FIG12), POP)
    finally:
        engine.close()
    assert restored["source"] == "disk"
    assert restored["crossing_times"] == first["crossing_times"]


def test_endpoint_population_route_and_codes(tmp_path):
    engine = _engine(tmp_path).start()
    endpoint = None
    try:
        endpoint = ServeEndpoint(engine).start()
        port = endpoint.port

        def post(doc):
            code, body, _ = http_request(port, "/query", doc)
            return code, json.loads(body)

        code, doc = post({**PARAMS_DOC, "population": POP})
        assert code == 200 and doc["kind"] == "population" and "run_probability" in doc
        code, again = post({**PARAMS_DOC, "population": POP})
        assert code == 200 and again["source"] == "lru"
        assert again["crossing_times"] == doc["crossing_times"]
        for bad, reason in (
            ({**PARAMS_DOC, "population": {"graph": {"model": "nope"}}}, "bad population"),
            ({**PARAMS_DOC, "population": {"seeds": 2}}, "bad population"),
            ({**PARAMS_DOC, "population": POP, "scenario": {"learning": "baseline"}},
             "mutually exclusive"),
            ({**PARAMS_DOC, "population": POP, "grads": True}, "grads"),
        ):
            code, body = post(bad)
            assert code == 400 and reason in body["error"], (bad, body)
        rewire = {**POP, "infomodel": {"dynamics": "rewire"}}
        code, body = post({**PARAMS_DOC, "population": rewire})
        assert code == 200 and body["dynamics"] == "rewire" and body["source"] == "computed"
        code, metrics, _ = http_request(port, "/metrics")
        assert code == 200 and "sbr_serve_queries_total 3" in metrics
    finally:
        if endpoint is not None:
            endpoint.close()
        engine.close()
