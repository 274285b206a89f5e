"""The port's host library (sbr_tpu_torch.native, ``native/graphgen.cpp``)
against sbr_tpu.native, on the CPU.

Contracts:

- `er_edges_native` equals the reference's splitmix64 pairs bit for bit,
  and `_er_edges_plain` (numpy) equals both, self-loop redraws included;
- `sort_edges_by_dst` gives the reference's four outputs (sorted src and
  dst, in-degrees, row pointers) bit for bit, native and plain alike,
  with duplicate destinations, agents without edges and no edges at all,
  and raises ``ValueError`` on a destination out of range;
- `agents.erdos_renyi_edges` is the reference's graph with ``SBR_NATIVE``
  unset (the native stream) and with ``"0"`` (numpy's stream);
- the prepared layouts (gather, incremental, the multi-bank exposure
  table) are the same on both routes, so the counting sort changes no
  layout;
- ``SBR_NATIVE`` is read on every call; a failed build raises, with no
  fallback to numpy; builds of one library at once leave one whole
  library.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu import native as jn  # noqa: E402
from sbr_tpu.social import agents as ja  # noqa: E402
from sbr_tpu_torch import _build  # noqa: E402
from sbr_tpu_torch import native as tn  # noqa: E402
from sbr_tpu_torch.social import agents as ta  # noqa: E402

CPU = "cpu"
SEEDS = [0, 1, 2**63 + 5]
# (agents, edges): the smallest graphs, where self-loops are common, up to
# the size of a small closure
SHAPES = [(2, 400), (3, 600), (1000, 10_000), (100_000, 1_000_000), (1000, 0)]


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("SBR_NATIVE", raising=False)
    assert jn.native_available()  # the reference's own test: g++ is here


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n, e", SHAPES)
def test_er_edges_native_equals_the_reference(n, e, seed):
    got = tn.er_edges_native(n, e, seed)
    _same(jn.er_edges_native(n, e, seed), got)
    src, dst = got
    assert src.dtype == np.int32 and src.shape == (e,)
    if e:
        assert not (src == dst).any() and 0 <= min(src.min(), dst.min())
        assert max(src.max(), dst.max()) < n


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n, e", SHAPES)
def test_er_edges_plain_equals_the_native_stream(n, e, seed):
    _same(tn.er_edges_native(n, e, seed), tn._er_edges_plain(n, e, seed))


def test_er_edges_plain_single_agent_keeps_its_loops():
    """One agent: the native loop redraws nothing (``n > 1``), every pair
    is (0, 0)."""
    _same(tn.er_edges_native(1, 7, 3), tn._er_edges_plain(1, 7, 3))
    assert not tn._er_edges_plain(1, 7, 3)[0].any()


def _sort_cases():
    rng = np.random.default_rng(0)
    n, e = 500, 20_000  # ~40 edges a destination: many duplicates
    yield "duplicates", rng.integers(0, n, e), rng.integers(0, n, e), n
    # destinations only among the first tenth: most agents have no in-edge
    yield "sparse", rng.integers(0, n, 3000), rng.integers(0, n // 10, 3000), n
    yield "stable", np.arange(6)[::-1], np.asarray([1, 0, 1, 0, 1, 0]), 2
    yield "no_edges", np.zeros(0), np.zeros(0), 5
    yield "no_agents", np.zeros(0), np.zeros(0), 0


@pytest.mark.parametrize("case", list(_sort_cases()), ids=lambda c: c[0])
def test_sort_equals_the_reference_and_the_plain_sort(case):
    _, src, dst, n = case
    got = tn.sort_edges_by_dst(src, dst, n)
    _same(jn.sort_edges_by_dst(np.asarray(src, np.int32), np.asarray(dst, np.int32), n), got)
    _same(tn._sort_edges_by_dst_plain(src, dst, n), got)
    src_s, dst_s, indeg, row_ptr = got
    assert (src_s.dtype, dst_s.dtype, indeg.dtype, row_ptr.dtype) == (
        np.int32, np.int32, np.int32, np.int64)
    assert indeg.shape == (n,) and row_ptr.shape == (n + 1,) and row_ptr[-1] == len(src)


@pytest.mark.parametrize("bad", [-1, 4, 7])
@pytest.mark.parametrize("route", ["native", "plain"])
def test_sort_rejects_destinations_out_of_range(route, bad):
    sort = tn.sort_edges_by_dst if route == "native" else tn._sort_edges_by_dst_plain
    with pytest.raises(ValueError, match="out of range"):
        sort(np.asarray([0, 1]), np.asarray([1, bad]), 4)
    with pytest.raises(ValueError, match="out of range"):
        jn.sort_edges_by_dst(np.asarray([0, 1]), np.asarray([1, bad]), 4)


def test_sort_rejects_mismatched_arrays():
    with pytest.raises(ValueError, match="one length"):
        tn.sort_edges_by_dst(np.asarray([0, 1, 2]), np.asarray([1, 0]), 4)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n, deg", [(2, 0.9), (3000, 6.0), (20_000, 15.0)])
@pytest.mark.parametrize("stream", ["default", "numpy"])
def test_erdos_renyi_edges_equal_the_reference(stream, n, deg, seed, monkeypatch):
    if stream == "numpy":
        monkeypatch.setenv("SBR_NATIVE", "0")
    got = ta.erdos_renyi_edges(n, deg, seed=seed)
    _same(ja.erdos_renyi_edges(n, deg, seed=seed), got)


def test_the_two_streams_are_different_graphs(monkeypatch):
    native = ta.erdos_renyi_edges(3000, 6.0, seed=4)
    monkeypatch.setenv("SBR_NATIVE", "0")
    numpy_stream = ta.erdos_renyi_edges(3000, 6.0, seed=4)
    assert len(native[0]) == len(numpy_stream[0])  # one binomial edge count
    assert not np.array_equal(native[0], numpy_stream[0])


@pytest.mark.parametrize("engine", ["gather", "incremental"])
def test_prepared_layout_is_the_same_on_both_routes(engine, monkeypatch):
    n = 4000
    src, dst = ta.erdos_renyi_edges(n, 8.0, seed=2)
    betas = np.random.default_rng(9).lognormal(0.0, 0.5, n)
    native = ta.prepare_agent_graph(betas, src, dst, n, dtype=np.float64, engine=engine,
                                    device=CPU)
    monkeypatch.setenv("SBR_NATIVE", "0")
    plain = ta.prepare_agent_graph(betas, src, dst, n, dtype=np.float64, engine=engine,
                                   device=CPU)
    names = ["betas", "src", "row_ptr", "indeg"]
    for name in names:
        assert torch.equal(getattr(native, name), getattr(plain, name)), name
    if engine == "incremental":
        for w, g in zip(native.inc, plain.inc):
            assert torch.equal(w, g)
    assert (native.engine, native.budget) == (plain.engine, plain.budget)


def test_multibank_exposure_layout_is_the_same_on_both_routes(monkeypatch):
    from sbr_tpu_torch.scenario import ScenarioSpec
    from sbr_tpu_torch.scenario.multibank import _exposure_layout

    rng = np.random.default_rng(5)
    banks = 64
    edges = {(int(s), int(d)) for s, d in rng.integers(0, banks, (400, 2)) if s != d}
    spec = ScenarioSpec(banks=banks, exposure=tuple(
        (s, d, float(w)) for (s, d), w in zip(sorted(edges), rng.uniform(0.0, 1.0, len(edges)))))
    native = _exposure_layout(spec)
    monkeypatch.setenv("SBR_NATIVE", "0")
    _same(_exposure_layout(spec), native)


def test_sbr_native_is_read_on_every_call(monkeypatch):
    lib = tn.get_lib()
    assert lib is not None and tn.native_available()
    monkeypatch.setenv("SBR_NATIVE", "0")
    assert tn.get_lib() is None and not tn.native_available()
    assert tn.er_edges_native(10, 5, 0) is None
    monkeypatch.delenv("SBR_NATIVE")
    assert tn.get_lib() is lib


def _fresh_build(monkeypatch, tmp_path, cxx):
    """A build into an empty directory with compiler ``cxx``, nothing
    loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "HOST_CXX", cxx)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tn, "_lib", None)


@pytest.mark.parametrize("cxx", ["sbr-no-such-compiler", "false"])
def test_a_failed_build_raises_and_does_not_fall_back(cxx, monkeypatch, tmp_path):
    """A compiler that is missing, or that fails, raises from every entry
    point that needs the library, and names ``SBR_NATIVE=0``; nothing is
    left in the build directory. ``SBR_NATIVE=0`` still draws numpy's
    stream."""
    _fresh_build(monkeypatch, tmp_path, cxx)
    for call in (tn.get_lib, lambda: tn.er_edges_native(100, 10, 0),
                 lambda: tn.sort_edges_by_dst([0], [1], 2),
                 lambda: ta.erdos_renyi_edges(1000, 5.0, seed=0)):
        with pytest.raises(RuntimeError, match="SBR_NATIVE=0"):
            call()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    monkeypatch.setenv("SBR_NATIVE", "0")
    _same(ja.erdos_renyi_edges(1000, 5.0, seed=0), ta.erdos_renyi_edges(1000, 5.0, seed=0))


def test_concurrent_builds_leave_one_whole_library(monkeypatch, tmp_path):
    """Four builds of the library at once (as test workers starting
    together do) each end in an atomic rename: one library, no temporary
    file, and it loads and sorts."""
    _fresh_build(monkeypatch, tmp_path, _build.HOST_CXX)
    paths, errors = [], []

    def build():
        try:
            paths.append(_build.build_host("graphgen"))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and list(tmp_path.glob("*.so")) == paths[:1]
    assert not list(tmp_path.glob("*.tmp"))
    _same(tn._sort_edges_by_dst_plain([3, 1, 2], [1, 0, 1], 2),
          tn.sort_edges_by_dst([3, 1, 2], [1, 0, 1], 2))
