"""The port's meshes, collectives and sharded sweeps (sbr_tpu_torch.parallel,
``mesh=`` of the sweeps, tiles and policy sweep, the K-sharded hetero
solve), against the port's unsharded results and sbr_tpu's mesh results on
the suite's virtual devices, on the CPU.

Contract:

- the mesh helpers behave as tests/test_utils_parallel.py::TestMesh holds
  sbr_tpu's (balanced factorization, axis names, the bad-shape error);
- `exclusive_psum` equals sbr_tpu's in ``shard_map`` on the same number
  of devices bit for bit, integers and floats;
- a sharded u-sweep, β×u grid, tiled grid and policy sweep equal the
  port's unsharded ones bit for bit (cells are independent, and a cell's
  bits depend on its own row alone), and sbr_tpu's mesh results within the
  standing contract (1e-12 in float64, 2e-5 in float32, statuses and flags
  equal);
- the K-sharded hetero solve equals the single-device solve bit for bit
  at one rank, and within 1e-9 across two (its psums regroup the float
  sums; measured ≤ 2.3e-16 on these cases under the suite's fixed
  numerics), statuses and flags equal;
- two processes form one mesh and run the sharded agent sim (bit for bit
  the one-process run) and the K-sharded hetero solve (sbr_tpu's
  TestTwoProcessSharedMesh).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import torch_mesh as tm  # noqa: E402
from sbr_tpu.parallel import balanced_2d as ref_balanced_2d  # noqa: E402
from sbr_tpu_torch import parallel  # noqa: E402

torch.set_num_threads(1)

GRID = dict(n_b=8, n_u=6, n_grid=512)
TWO_PROC = dict(n=4003, deg=8.0, steps=30, comm="scatter", engine="auto", window=[0.1, 2.0],
                dtype="float32")
HETERO_K, HETERO_GRID = 64, 256
RK4_BETA_HI = 1.0  # the RK4 route psums ω every stage of every micro-step

WORLD2 = [
    ("exclusive_psum", dict(n_dev=2, length=37, dtype="int32")),
    ("exclusive_psum", dict(n_dev=2, length=37, dtype="float64")),
    ("exclusive_psum", dict(n_dev=2, length=37, dtype="float32")),
    ("u_sweep", dict(n_u=64, n_grid=512)),
    ("grid", dict(shape=[1, 2], dtype="float64", **GRID)),
    ("grid", dict(shape=[2, 1], dtype="float32", **GRID)),
    ("tiled", dict(shape=[1, 2], n_b=8, n_u=8, tile=[4, 4], n_grid=256, ckpt=None)),
    ("policy", dict(shape=[1, 2], n_b=4, n_u=8, n_r=3, n_grid=256)),
    ("hetero", dict(k=HETERO_K, n_grid=HETERO_GRID, dtype="float64")),
    ("hetero", dict(k=HETERO_K, n_grid=HETERO_GRID, dtype="float64", grid_warp=0.0,
                    beta_hi=RK4_BETA_HI)),
    ("agents", TWO_PROC),
    ("hetero", dict(k=16, n_grid=128, dtype="float32")),
]
WORLD4 = [
    ("exclusive_psum", dict(n_dev=4, length=37, dtype="float64")),
    ("exclusive_psum", dict(n_dev=4, length=37, dtype="int64")),
    ("grid", dict(shape=[2, 2], dtype="float64", **GRID)),
]


def _index(cases, name, **kw):
    return next(i for i, (n, k) in enumerate(cases)
                if n == name and all(k.get(a) == b for a, b in kw.items()))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    cases = [(n, dict(k, ckpt=str(tmp / "ckpt")) if n == "tiled" else k) for n, k in WORLD2]
    return tm.run_group(2, cases, tmp)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return tm.run_group(4, WORLD4, tmp_path_factory.mktemp("world4"))


@pytest.fixture
def world1():
    """A world-size-1 group in this process, as a caller that brought none
    up gets from the mesh helpers; torn down after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, err_msg
    np.testing.assert_array_equal(a, b, err_msg=err_msg)


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 6, 7, 8, 12, 16, 24])
def test_balanced_2d_equals_reference(n):
    assert parallel.balanced_2d(n) == ref_balanced_2d(n)


def test_mesh_helpers_at_world_one(world1):
    """No group up: the helpers bring up a world-size-1 gloo group from an
    in-memory store, and build the reference's axis names."""
    import torch.distributed as dist

    mesh = parallel.make_grid_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("b", "u") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="does not use 1 devices"):
        parallel.make_grid_mesh(shape=(3, 5), device="cpu")
    agents = parallel.make_agent_mesh(device="cpu")
    assert agents.mesh_dim_names == ("agents",)
    v = torch.arange(6.0)
    (blk,) = parallel.shard_axis_values(agents, ("agents",), v)
    _same(_np(blk), _np(v))


def test_shard_axis_values_refuses_indivisible():
    two = tm.AxisStub(b=(1, 0), u=(2, 1))  # rank 1 of a "u" axis of two
    a, b = parallel.shard_axis_values(two, ("b", "u"), torch.arange(3), torch.arange(6))
    _same(_np(a), np.arange(3))
    _same(_np(b), np.arange(3, 6))
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_axis_values(two, ("u",), torch.arange(5))


def test_initialize_distributed_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed() is False


# ---------------------------------------------------------------------------
# exclusive_psum
# ---------------------------------------------------------------------------


def _ref_exclusive(xs, n_dev):
    from sbr_tpu.parallel import shard_map
    from sbr_tpu.parallel.collectives import exclusive_psum

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("agents",))
    fn = jax.jit(shard_map(lambda x: exclusive_psum(x, "agents", n_dev), mesh=mesh,
                           in_specs=P("agents"), out_specs=P("agents")))
    return np.asarray(fn(jnp.asarray(np.concatenate(xs))))


@pytest.mark.parametrize("dtype", ["int32", "float64", "float32"])
def test_exclusive_psum_equals_reference_world2(world2, dtype):
    ranks = tm.case_result(world2, _index(WORLD2, "exclusive_psum", dtype=dtype))
    want = _ref_exclusive([r["x"] for r in ranks], 2)
    _same(np.concatenate([r["excl"] for r in ranks]), want.astype(dtype))
    assert not ranks[0]["excl"].any()


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_exclusive_psum_equals_reference_world4(world4, dtype):
    ranks = tm.case_result(world4, _index(WORLD4, "exclusive_psum", dtype=dtype))
    want = _ref_exclusive([r["x"] for r in ranks], 4)
    _same(np.concatenate([r["excl"] for r in ranks]), want.astype(dtype))


# ---------------------------------------------------------------------------
# Sharded sweeps
# ---------------------------------------------------------------------------

TOL = {"float64": 1e-12, "float32": 2e-5}


def _close(ref, got, tol, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               atol=tol, rtol=0, equal_nan=True, err_msg=err_msg)


def test_u_sweep_sharded(world2):
    from sbr_tpu.baseline.learning import solve_learning as ref_learning
    from sbr_tpu.models.params import SolverConfig as RefCfg
    from sbr_tpu.models.params import make_model_params as ref_params
    from sbr_tpu.sweeps.baseline_sweeps import u_sweep as ref_u_sweep
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import u_sweep

    us = np.linspace(0.001, 0.9, 64)
    cfg = SolverConfig(n_grid=512, bisect_iters=60)
    m = make_model_params()
    want = u_sweep(solve_learning(m.learning, cfg, device="cpu"), us, m.economic, cfg)
    rm = ref_params()
    rcfg = RefCfg(n_grid=512, bisect_iters=60)
    ref = ref_u_sweep(ref_learning(rm.learning, rcfg), us, rm.economic, rcfg,
                      mesh=Mesh(np.asarray(jax.devices()[:2]), ("u",)))
    for got in tm.case_result(world2, _index(WORLD2, "u_sweep")):
        for f in ("collapse_times", "max_withdrawals", "return_times", "status"):
            _same(got[f], _np(getattr(want, f)), f)
        _same(got["health_flags"], _np(want.health.flags))
        _same(got["status"], np.asarray(ref.status))
        _close(ref.collapse_times, got["collapse_times"], 1e-12)
        _close(ref.max_withdrawals, got["max_withdrawals"], 1e-12)


def _grid_ref(shape, dtype, n_b, n_u, n_grid):
    from sbr_tpu.models.params import SolverConfig as RefCfg
    from sbr_tpu.models.params import make_model_params as ref_params
    from sbr_tpu.sweeps.baseline_sweeps import beta_u_grid as ref_grid

    devs = np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    return ref_grid(np.linspace(0.5, 4.0, n_b), np.linspace(0.01, 0.3, n_u), ref_params(),
                    RefCfg(n_grid=n_grid), mesh=Mesh(devs, ("b", "u")),
                    dtype=getattr(jnp, dtype))


def _grid_port(dtype, n_b, n_u, n_grid):
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    return beta_u_grid(np.linspace(0.5, 4.0, n_b), np.linspace(0.01, 0.3, n_u),
                       make_model_params(), SolverConfig(n_grid=n_grid),
                       dtype=getattr(torch, dtype), device="cpu")


def _check_grid(ranks, shape, dtype):
    want = _grid_port(dtype, **GRID)
    ref = _grid_ref(shape, dtype, **GRID)
    for got in ranks:
        for f in ("xi", "max_aw", "status"):
            _same(got[f], _np(getattr(want, f)), f)
        for f in ("residual", "bracket_width", "iterations", "flags"):
            _same(got[f"health_{f}"], _np(getattr(want.health, f)), f)
        _same(got["status"], np.asarray(ref.status))
        _same(got["health_flags"], np.asarray(ref.health.flags))
        _close(ref.xi, got["xi"], TOL[dtype])
        _close(ref.max_aw, got["max_aw"], TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [([1, 2], "float64"), ([2, 1], "float32")])
def test_beta_u_grid_sharded_world2(world2, shape, dtype):
    _check_grid(tm.case_result(world2, _index(WORLD2, "grid", shape=shape)), shape, dtype)


def test_beta_u_grid_sharded_world4(world4):
    _check_grid(tm.case_result(world4, _index(WORLD4, "grid")), [2, 2], "float64")


def test_tiled_grid_sharded(world2):
    """Sharded tiles equal one unsharded grid bit for bit; a rerun over the
    same directory computes nothing; a tile shape the mesh does not divide
    is refused before anything is written."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    want = beta_u_grid(np.linspace(0.5, 4.0, 8), np.linspace(0.01, 0.3, 8), make_model_params(),
                       SolverConfig(n_grid=256, bisect_iters=60), device="cpu")
    for got in tm.case_result(world2, _index(WORLD2, "tiled")):
        for f in ("xi", "max_aw", "status"):
            _same(got[f], _np(getattr(want, f)), f)
            _same(got[f"again_{f}"], got[f], f)
        assert list(got["computed"]) == [4, 0]
        assert "divisible by the mesh axes 1×2" in str(got["err"])


def test_policy_sweep_sharded(world2):
    from sbr_tpu.models.params import SolverConfig as RefCfg
    from sbr_tpu.models.params import make_interest_params as ref_interest
    from sbr_tpu.sweeps.policy_sweeps import policy_sweep_interest as ref_policy
    from sbr_tpu_torch.models.params import SolverConfig, make_interest_params
    from sbr_tpu_torch.sweeps.policy_sweeps import policy_sweep_interest

    axes = (np.linspace(0.5, 3.0, 4), np.linspace(0.0, 0.4, 8), np.linspace(0.0, 0.09, 3))
    want = policy_sweep_interest(*axes, make_interest_params(u=0.0, delta=0.1),
                                 SolverConfig(n_grid=256, bisect_iters=60), device="cpu")
    ref = ref_policy(*axes, ref_interest(u=0.0, delta=0.1), RefCfg(n_grid=256, bisect_iters=60),
                     mesh=Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("b", "u")))
    for got in tm.case_result(world2, _index(WORLD2, "policy")):
        for f in ("xi", "aw_max", "status"):
            _same(got[f], _np(getattr(want, f)), f)
        _same(got["health_flags"], _np(want.health.flags))
        _same(got["status"], np.asarray(ref.status))
        _close(ref.xi, got["xi"], 1e-12)
        _close(ref.aw_max, got["aw_max"], 1e-12)


# ---------------------------------------------------------------------------
# The K-sharded hetero solve
# ---------------------------------------------------------------------------


def _hetero_single(k, n_grid, dtype, grid_warp=0.5, beta_hi=5.0):
    from sbr_tpu_torch.hetero import get_aw_hetero, solve_equilibrium_hetero
    from sbr_tpu_torch.hetero import solve_learning_hetero
    from sbr_tpu_torch.models.params import SolverConfig

    m = tm.hetero_params(k, beta_hi=beta_hi)
    cfg = SolverConfig(n_grid=n_grid, bisect_iters=60, grid_warp=grid_warp)
    lsh = solve_learning_hetero(m.learning, cfg, dtype=dtype, device="cpu")
    res = solve_equilibrium_hetero(lsh, m.economic, cfg)
    return lsh, res, get_aw_hetero(res, lsh)


@pytest.mark.parametrize("grid_warp", [0.5, 0.0])
def test_hetero_sharded_world2(world2, grid_warp):
    """Two ranks: within 1e-9 of the single-device solve (the psums regroup
    float sums), statuses and flags equal; per-group rows of the exact path
    are local and so bitwise; and sbr_tpu's 2-device sharded solve within
    1e-9 too."""
    from sbr_tpu.hetero import solve_hetero_sharded as ref_sharded
    from sbr_tpu.models.params import SolverConfig as RefCfg

    beta_hi = 5.0 if grid_warp > 0 else RK4_BETA_HI
    lsh, res, aw = _hetero_single(HETERO_K, HETERO_GRID, torch.float64, grid_warp, beta_hi)
    _, rres, raw = ref_sharded(tm.hetero_params(HETERO_K, "sbr_tpu", beta_hi),
                               Mesh(np.asarray(jax.devices()[:2]), ("k",)),
                               RefCfg(n_grid=HETERO_GRID, bisect_iters=60, grid_warp=grid_warp))
    i = _index(WORLD2, "hetero", k=HETERO_K, grid_warp=grid_warp if grid_warp == 0.0 else None)
    for got in tm.case_result(world2, i):
        if grid_warp > 0:
            _same(got["cdfs"], _np(lsh.cdfs))
        for f, want in (("cdfs", lsh.cdfs), ("hrs", res.hrs), ("tau_in", res.tau_bar_in_uncs),
                        ("tau_out", res.tau_bar_out_uncs), ("xi", res.xi),
                        ("aw_cum", aw.aw_cum), ("aw_max", aw.aw_max),
                        ("aw_groups", aw.aw_groups)):
            _close(_np(want), got[f], 1e-9, f)
        _same(got["status"], _np(res.status))
        _same(got["flags"], _np(res.health.flags))
        _same(got["status"], np.asarray(rres.status))
        _close(rres.xi, got["xi"], 1e-9)
        _close(raw.aw_cum, got["aw_cum"], 1e-9)


def test_hetero_sharded_world_one_is_bitwise(world1):
    """At one rank the sharded solve is the single-device solve bit for bit."""
    from sbr_tpu_torch.hetero import solve_hetero_sharded
    from sbr_tpu_torch.models.params import SolverConfig

    lsh, res, aw = _hetero_single(HETERO_K, HETERO_GRID, torch.float64)
    mesh = parallel.make_agent_mesh(axis_name="k", device="cpu")
    lsh1, res1, aw1 = solve_hetero_sharded(tm.hetero_params(HETERO_K), mesh,
                                           SolverConfig(n_grid=HETERO_GRID, bisect_iters=60))
    for a, b in ((lsh1.cdfs, lsh.cdfs), (res1.hrs, res.hrs), (res1.xi, res.xi),
                 (res1.status, res.status), (res1.health.flags, res.health.flags),
                 (aw1.aw_cum, aw.aw_cum), (aw1.aw_groups, aw.aw_groups)):
        _same(_np(a), _np(b))


def test_hetero_sharded_refuses_indivisible_k():
    from sbr_tpu_torch.hetero import solve_hetero_sharded
    from sbr_tpu_torch.models.params import SolverConfig, make_hetero_params

    m = make_hetero_params(betas=[0.5, 1.0, 2.0], dist=[0.3, 0.3, 0.4], eta_bar=15.0)
    with pytest.raises(ValueError, match="divide evenly"):
        solve_hetero_sharded(m, tm.AxisStub(k=(8, 0)), SolverConfig(n_grid=256))


# ---------------------------------------------------------------------------
# Two processes, one mesh (sbr_tpu's TestTwoProcessSharedMesh)
# ---------------------------------------------------------------------------


def test_two_process_shared_mesh(world2, world1):
    """Two processes brought up by `initialize_distributed` form one
    2-rank mesh: the sharded agent sim is this process's one-rank run bit
    for bit, and the K-sharded hetero solve's ξ is the one-rank solve's
    (float32) within the reference test's 1e-5."""
    from sbr_tpu_torch.hetero import solve_hetero_sharded
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.social import agents as A

    kw = TWO_PROC
    src, dst = A.erdos_renyi_edges(kw["n"], kw["deg"], seed=1)
    cfg = A.AgentSimConfig(n_steps=kw["steps"], dt=0.1, exit_delay=0.1, reentry_delay=2.0)
    mesh = parallel.make_agent_mesh(device="cpu")
    one = A.simulate_agents(1.0, src, dst, kw["n"], x0=0.01, config=cfg, seed=5, mesh=mesh)
    _, res1, _ = solve_hetero_sharded(tm.hetero_params(16),
                                      parallel.make_agent_mesh(axis_name="k", device="cpu"),
                                      SolverConfig(n_grid=128, bisect_iters=60),
                                      dtype=torch.float32)
    for got in tm.case_result(world2, _index(WORLD2, "agents")):
        for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"):
            _same(got[f], _np(getattr(one, f)), f)
    for got in tm.case_result(world2, _index(WORLD2, "hetero", k=16)):
        assert float(got["xi"]) == pytest.approx(float(res1.xi), abs=1e-5)
        _same(got["status"], _np(res1.status))
