"""The port's graph generation (sbr_tpu_torch.social.graphgen) against
sbr_tpu's, on the CPU.

Contract: for the same (spec, seed) the raw edge stream and every array of
the prepared layout (src, row_ptr, indeg and the incremental engine's
dst2, out_ptr, outdeg) are equal bit for bit, under any chunking, and the
resolved engine is the same. The draws are integer Threefry and integer
range maps, so nothing is rounded."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sbr_tpu.social import graphgen as jg  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402
from sbr_tpu_torch.social import graphgen as tg  # noqa: E402

CPU = "cpu"
N, DEG = 500, 6.0


def _specs(mod):
    return {
        "er": mod.ErdosRenyiSpec(n=N, avg_degree=DEG),
        "sf": mod.ScaleFreeSpec(n=N, avg_degree=DEG, gamma=2.5),
        "sbm": mod.StochasticBlockSpec(n=N, avg_degree=DEG, n_blocks=4, p_in=0.8),
    }


KINDS = ["er", "sf", "sbm"]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("chunk", [None, 97])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_generate_edges_bitwise(kind, seed, chunk):
    want = jg.generate_edges(_specs(jg)[kind], seed=seed, chunk_edges=chunk)
    got = tg.generate_edges(_specs(tg)[kind], seed=seed, chunk_edges=chunk, device=CPU)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_prepared_gather_layout_bitwise(kind, dtype):
    want = jg.prepare_generated_graph(_specs(jg)[kind], seed=3, dtype=dtype, engine="gather")
    got = tg.prepare_generated_graph(_specs(tg)[kind], seed=3, dtype=dtype, engine="gather",
                                     device=CPU)
    assert got.engine == want.engine == "gather" and got.n_edges == want.n_edges
    for f in ("src", "row_ptr", "indeg", "betas"):
        w, g = np.asarray(getattr(want, f)), _np(getattr(got, f))
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(w, g, err_msg=f)
    assert got.inc is None


@pytest.mark.parametrize("chunk", [None, 97])
@pytest.mark.parametrize("engine", ["incremental", "auto"])
@pytest.mark.parametrize("kind", KINDS)
def test_prepared_incremental_layout_bitwise(kind, engine, chunk):
    kw = dict(seed=1, betas=1.5, engine=engine, chunk_edges=chunk)
    want = jg.prepare_generated_graph(_specs(jg)[kind], **kw)
    got = tg.prepare_generated_graph(_specs(tg)[kind], device=CPU, **kw)
    assert got.engine == want.engine and got.budget == want.budget
    for f in ("src", "row_ptr", "indeg"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), _np(getattr(got, f)))
    if want.engine == "incremental":
        for w, g in zip(want.inc, got.inc):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(w), _np(g))


def test_auto_engine_picks_both_ways_like_sbr_tpu():
    """A short horizon keeps the census on gather, a long one on
    incremental: the port resolves both as the reference does."""
    from sbr_tpu.social.agents import AgentSimConfig as JCfg

    for steps, dt in ((3, 0.01), (200, 0.1)):
        want = jg.prepare_generated_graph(_specs(jg)["er"], seed=2, engine="auto",
                                          config=JCfg(n_steps=steps, dt=dt))
        got = tg.prepare_generated_graph(_specs(tg)["er"], seed=2, engine="auto", device=CPU,
                                         config=ta.AgentSimConfig(n_steps=steps, dt=dt))
        assert got.engine == want.engine


@pytest.mark.parametrize("kind", KINDS)
def test_generated_layout_equals_host_prepare_of_raw_stream(kind):
    spec = _specs(tg)[kind]
    src, dst = tg.generate_edges(spec, seed=4, device=CPU)
    host = ta.prepare_agent_graph(1.0, src, dst, N, engine="incremental", device=CPU)
    gen = tg.prepare_generated_graph(spec, seed=4, engine="incremental", device=CPU)
    for a, b in zip((host.src, host.row_ptr, host.indeg, *host.inc),
                    (gen.src, gen.row_ptr, gen.indeg, *gen.inc)):
        assert torch.equal(a, b)


def test_mulhi32_equals_reference():
    rng = np.random.default_rng(0)
    edge_a = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                      np.uint32)
    edge_m = np.array([1, 2, 3, 2**16 - 1, 2**16, 10**8, 2**31 - 2, 2**31 - 1], np.uint32)
    a = np.concatenate([np.repeat(edge_a, len(edge_m)), rng.integers(0, 2**32, 4000,
                                                                      dtype=np.uint32)])
    m = np.concatenate([np.tile(edge_m, len(edge_a)), rng.integers(1, 2**31, 4000,
                                                                    dtype=np.uint32)])
    want = np.asarray(jg._mulhi32(jnp.asarray(a), jnp.asarray(m)))
    got = tg._mulhi32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(m.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    exact = (a.astype(object) * m.astype(object)) // 2**32
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int64))


@pytest.mark.parametrize("c0, chunk", [(0, 3), (4, 6), (6, 4), (7, 2)])
def test_dst_chunk_pads_past_the_last_edge_as_the_reference(c0, chunk):
    row_ptr = np.array([0, 2, 2, 5, 7, 7], np.int32)
    want = np.asarray(jg._dst_chunk(jnp.asarray(row_ptr), 5, c0, chunk))
    got = tg._dst_chunk(torch.from_numpy(row_ptr), 5, c0, chunk)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("name, kw", [
    ("ErdosRenyiSpec", dict(n=1, avg_degree=3.0)),
    ("ErdosRenyiSpec", dict(n=10, avg_degree=0.0)),
    ("ErdosRenyiSpec", dict(n=2**31, avg_degree=1.0)),
    ("ScaleFreeSpec", dict(n=10, avg_degree=2.0, gamma=1.0)),
    ("StochasticBlockSpec", dict(n=10, avg_degree=2.0, n_blocks=1)),
    ("StochasticBlockSpec", dict(n=6, avg_degree=2.0, n_blocks=4)),
    ("StochasticBlockSpec", dict(n=10, avg_degree=2.0, p_in=1.5)),
])
def test_specs_reject_what_the_reference_rejects(name, kw):
    with pytest.raises(ValueError) as want:
        getattr(jg, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tg, name)(**kw)
    assert str(got.value) == str(want.value)


def test_edge_counts_and_plan_follow_the_reference(monkeypatch):
    for kind in KINDS:
        for seed in (0, 5):
            assert _specs(tg)[kind].edge_count(seed) == _specs(jg)[kind].edge_count(seed)
    monkeypatch.setenv("SBR_GRAPHGEN_BUDGET_BYTES", str(1 << 24))
    chunk = tg.plan_chunk_edges(10**6, 10**5)
    assert chunk & (chunk - 1) == 0 and 2**14 <= chunk <= 2**26
    assert tg.plan_chunk_edges(100, 10) == 100
    with pytest.raises(ValueError):
        tg._check_edges(tg._MAX_EDGES)


def test_unported_and_device_rules(monkeypatch):
    spec = _specs(tg)["er"]
    with pytest.raises(NotImplementedError):
        tg.prepare_generated_graph(spec, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="engine"):
        tg.prepare_generated_graph(spec, engine="measure", device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.prepare_generated_graph(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.generate_edges(spec)
