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


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float16, torch.int32, torch.float16, torch.float16)]
    with pytest.raises(NotImplementedError):
        fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)
    ts = [torch.zeros(8, dtype=d, device=cuda_device) for d in (
        torch.bool, torch.float32, torch.int64, torch.float32, torch.float32)]
    with pytest.raises(ValueError, match="counts"):
        fused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)
