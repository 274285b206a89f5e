"""The port's fused infection step (sbr_tpu_torch.social.fused) against
sbr_tpu's: the Pallas kernel in interpret mode and its lax form, on the same
numpy inputs. On the CPU the port runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ml_dtypes import bfloat16  # noqa: E402

from sbr_tpu.social import fused as jfused  # noqa: E402
from sbr_tpu_torch.social import fused as tfused  # noqa: E402
from sbr_tpu_torch.social import rng as trng  # noqa: E402
from sbr_tpu_torch.social.agents import _tensor  # noqa: E402

N = 3001  # a ragged tail against the Pallas kernel's 1024-agent block
DT = 0.1
T = 1.7
SEED, STEP = 5, 17

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _inputs(np_dtype, seed=0, n=N):
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.3
    t_inf = np.where(informed, rng.uniform(-1.0, 1.6, n), np.inf).astype(np_dtype)
    deg = rng.integers(0, 9, n)  # some 0: safe_deg = 1 there
    counts = np.minimum(rng.integers(0, 9, n), deg).astype(np.int32)
    safe_deg = np.maximum(deg, 1).astype(np_dtype)
    betas = rng.lognormal(0.5, 0.5, n).astype(np_dtype)
    return informed, t_inf, counts, betas, safe_deg


def _port(np_dtype, t_dtype, arrays, mode="auto"):
    t_next = float(np_dtype(T) + np_dtype(DT))  # JAX's eager `t + dt`
    ts = [torch.from_numpy(a) for a in arrays]
    return tfused.infection_update(
        *ts, trng.prng_key(SEED), STEP, 0, t_next, DT, "counter", mode
    )


def _boundary_lanes(np_dtype, t_dtype, arrays):
    """Lanes whose draw lies within 4 ulp of p: the only lanes an exp that
    differs by one ulp between XLA and PyTorch could flip."""
    informed, t_inf, counts, betas, safe_deg = arrays
    ids = torch.arange(N, dtype=torch.int64)
    u = trng._agent_uniforms(trng.prng_key(SEED), STEP, ids, t_dtype).numpy()
    p = 1 - np.exp((-betas) * (counts.astype(np_dtype) / safe_deg) * np_dtype(DT))
    ulp = np.spacing(p.astype(np_dtype))
    return np.abs(u - p) <= 4 * ulp


@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES)
@pytest.mark.parametrize("jax_mode", ["interpret", "lax"])
def test_plain_matches_sbr_tpu(np_dtype, t_dtype, jax_mode):
    """Outputs are exactly equal: Threefry, the uniform, the division and
    the products round alike; only exp is each framework's own, and a
    one-ulp exp difference flips a decision only for a draw inside that
    ulp (~6e-8 per lane in float32). Should such a flip ever appear, it
    must lie on a boundary lane — asserted below with the exact check."""
    arrays = _inputs(np_dtype)
    informed, t_inf, counts, betas, safe_deg = arrays
    want_i, want_t = jfused.infection_update(
        jnp.asarray(informed), jnp.asarray(t_inf), jnp.asarray(counts),
        jnp.asarray(betas), jnp.asarray(safe_deg), jax.random.PRNGKey(SEED), STEP,
        jnp.arange(N, dtype=jnp.uint32), jnp.asarray(T, np_dtype), DT,
        "counter", jax_mode,
    )
    got_i, got_t = _port(np_dtype, t_dtype, arrays)
    want_i, want_t = np.asarray(want_i), np.asarray(want_t)
    differ = (got_i.numpy() != want_i) | (got_t.numpy() != want_t)
    assert not (differ & ~_boundary_lanes(np_dtype, t_dtype, arrays)).any()
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert got_t.dtype == t_dtype and got_i.dtype == torch.bool
    # the inputs exercise both outcomes
    newly = want_i & ~informed
    assert newly.any() and (~want_i).any()


@pytest.mark.parametrize("mode", ["auto", "lax", "unfused", "interpret"])
def test_cpu_modes_run_the_plain_version(mode):
    arrays = _inputs(np.float32, seed=1)
    want = _port(np.float32, torch.float32, arrays, "lax")
    got = _port(np.float32, torch.float32, arrays, mode)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert tfused.resolve_mode(mode, torch.device("cpu"), "counter") == "plain"


def test_mode_resolution_contract(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("SBR_FUSED", raising=False)
    assert tfused.resolve_mode("auto", cuda, "counter") == "kernel"
    assert tfused.resolve_mode("pallas", cuda, "counter") == "kernel"
    assert tfused.resolve_mode("lax", cuda, "counter") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        tfused.resolve_mode("pallas", cpu, "counter")
    with pytest.raises(ValueError, match="fused must be one of"):
        tfused.resolve_mode("triton", cpu, "counter")
    # the foldin stream runs unfused in every mode, as the reference's rule says
    for mode in ("auto", "pallas", "lax", "unfused", "interpret"):
        for dev in (cpu, cuda):
            assert tfused.resolve_mode(mode, dev, "foldin") == "plain"
    with pytest.raises(ValueError, match="fused must be one of"):
        tfused.resolve_mode("triton", cpu, "foldin")
    # SBR_FUSED overrides "auto" only
    monkeypatch.setenv("SBR_FUSED", "lax")
    assert tfused.resolve_mode("auto", cuda, "counter") == "plain"
    monkeypatch.setenv("SBR_FUSED", "pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.resolve_mode("auto", cpu, "counter")
    assert tfused.resolve_mode("lax", cpu, "counter") == "plain"
    monkeypatch.setenv("SBR_FUSED", "bogus")
    with pytest.raises(ValueError, match="SBR_FUSED"):
        tfused.resolve_mode("auto", cpu, "counter")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    ts = [torch.from_numpy(a) for a in _inputs(np.float32, n=16)]
    with pytest.raises(ValueError, match="CUDA"):
        tfused._update_cuda(*ts, 0, 1, 2, 0.1, 0.1)
    for half_type in (torch.float16, torch.bfloat16):  # kernels of their own now
        half = [t.to(half_type) if t.is_floating_point() else t for t in ts]
        with pytest.raises(ValueError, match="CUDA"):
            tfused._update_cuda(*half, 0, 1, 2, 0.1, 0.1)
    ints = [t.to(torch.int16) if t.is_floating_point() else t for t in ts]
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfused._update_cuda(*ints, 0, 1, 2, 0.1, 0.1)


HALF_DTYPES = [(np.float16, torch.float16), (bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("np_dtype, t_dtype", HALF_DTYPES)
@pytest.mark.parametrize("stream", ["counter", "foldin"])
def test_half_types_match_sbr_tpu_under_jit(np_dtype, t_dtype, stream):
    """float16 and bfloat16: the step as the reference's simulation runs it
    (jitted, so XLA decides where it rounds) equals the plain version bit
    for bit, hazard included, on both streams."""
    arrays = _inputs(np_dtype, seed=2, n=20_000)
    informed, t_inf, counts, betas, safe_deg = arrays
    n = informed.shape[0]
    t = np_dtype(T)

    @jax.jit
    def ref(informed, t_inf, counts, betas, safe_deg):
        out = jfused.infection_update(
            informed, t_inf, counts, betas, safe_deg, jax.random.PRNGKey(SEED), STEP,
            jnp.arange(n, dtype=jnp.uint32), jnp.asarray(t, np_dtype), DT, stream, "lax")
        frac = counts.astype(np_dtype) / safe_deg
        return out + (1.0 - jnp.exp(-betas * frac * DT),)

    want_i, want_t, want_p = ref(*(jnp.asarray(a) for a in arrays))
    ts = [_tensor(a, "cpu") for a in arrays]
    t_next = float(np_dtype(t + np_dtype(DT)))
    got_i, got_t = tfused.infection_update(*ts, trng.prng_key(SEED), STEP, 0, t_next, DT,
                                           stream, "auto")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert torch.equal(got_t.view(torch.int16), _tensor(np.asarray(want_t), "cpu").view(torch.int16))
    dt_ = tfused.host_round(DT, t_dtype)
    p = 1.0 - torch.exp((-ts[3]) * (ts[2].to(t_dtype) / ts[4]) * dt_)
    assert torch.equal(p.view(torch.int16), _tensor(np.asarray(want_p), "cpu").view(torch.int16))
    newly = np.asarray(want_i) & ~informed
    assert newly.any() and (~np.asarray(want_i)).any()


@pytest.mark.parametrize("np_dtype, t_dtype", DTYPES + HALF_DTYPES)
def test_foldin_stream_matches_sbr_tpu_unfused(np_dtype, t_dtype):
    """rng_stream="foldin" in every mode is the reference's unfused step."""
    arrays = _inputs(np_dtype, seed=3)
    ja = [jnp.asarray(a) for a in arrays]
    want_i, want_t = jfused.infection_update(
        *ja, jax.random.PRNGKey(SEED), STEP, jnp.arange(N, dtype=jnp.uint32),
        jnp.asarray(T, np_dtype), DT, "foldin", "pallas")
    t_next = float(np_dtype(np_dtype(T) + np_dtype(DT)))
    for mode in ("auto", "lax", "interpret"):
        got_i, got_t = tfused.infection_update(
            *(_tensor(a, "cpu") for a in arrays), trng.prng_key(SEED), STEP, 0, t_next, DT,
            "foldin", mode)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        w = _tensor(np.asarray(want_t), "cpu")
        assert torch.equal(got_t.view(torch.uint8), w.view(torch.uint8)), mode
