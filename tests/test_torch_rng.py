"""The port's counter RNG (sbr_tpu_torch.social.rng) against sbr_tpu's:
Threefry words, uniforms, the host emulation of PRNGKey/fold_in and both
streams of `_agent_uniforms` ("counter" and "foldin", in float16,
bfloat16, float32 and float64) are bitwise equal."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ml_dtypes import bfloat16  # noqa: E402

from sbr_tpu.social import rng as jrng  # noqa: E402
from sbr_tpu_torch.social import rng as trng  # noqa: E402
from sbr_tpu_torch.social.agents import _tensor  # noqa: E402

FOUR_DTYPES = [(np.float16, torch.float16), (bfloat16, torch.bfloat16),
               (np.float32, torch.float32), (np.float64, torch.float64)]
# ids on both sides of 2^31 and of 2^32, where the uint32 cast wraps
WIDE_IDS = np.concatenate([np.arange(2500), 2**31 - 3 + np.arange(7),
                           2**32 - 2 + np.arange(4)]).astype(np.int64)


def _same_bits(want, got):
    want = _tensor(np.asarray(want), "cpu")
    assert want.dtype == got.dtype
    assert torch.equal(want.view(torch.uint8), got.view(torch.uint8))

IDS = np.array([0, 1, 1023, 1024, 2**24 + 3, 2**32 - 1], dtype=np.uint64)
KEYS = [(0, 0), (0, 7), (0x12345678, 0x9ABCDEF0), (2**32 - 1, 2**32 - 1)]


@pytest.mark.parametrize("key", KEYS)
def test_threefry_words_bitwise(key):
    c1 = np.array([0, 5, 2**31, 1, 2**32 - 1, 77], dtype=np.uint64)
    want = jrng._threefry2x32(
        jnp.uint32(key[0]), jnp.uint32(key[1]),
        jnp.asarray(IDS, jnp.uint32), jnp.asarray(c1, jnp.uint32),
    )
    got = trng._threefry2x32(
        key[0], key[1], torch.from_numpy(IDS.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())
    # the host (Python int) form gives the same words
    for i in range(len(IDS)):
        h = trng._threefry2x32(key[0], key[1], int(IDS[i]), int(c1[i]))
        assert h == (int(want[0][i]), int(want[1][i]))


@pytest.mark.parametrize(
    "np_dtype, t_dtype",
    [(np.float32, torch.float32), (np.float64, torch.float64), (np.float16, torch.float16),
     (bfloat16, torch.bfloat16)],
)
def test_uniform_from_bits_bitwise(np_dtype, t_dtype):
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    x1 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    # words whose uniform rounds to 1.0 in half precision hit the clamp
    x0[:4] = [2**32 - 1, 2**32 - 512, 0, 2**31]
    want = np.asarray(
        jrng._uniform_from_bits(
            jnp.asarray(x0, jnp.uint32), jnp.asarray(x1, jnp.uint32), np_dtype
        )
    )
    got = trng._uniform_from_bits(
        torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64)),
        t_dtype,
    )
    _same_bits(want, got)
    assert float(got.max()) < 1.0


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("k", [0, 1, 199, 10**6])
def test_prng_key_and_fold_in_emulation(seed, k):
    key = jax.random.PRNGKey(seed)
    assert trng.prng_key(seed) == tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    want = np.asarray(jax.random.key_data(jax.random.fold_in(key, k)))
    assert trng.fold_in(trng.prng_key(seed), k) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize(
    "np_dtype, t_dtype", [(np.float32, torch.float32), (np.float64, torch.float64)]
)
@pytest.mark.parametrize("step", [0, 3, 1000])
def test_agent_uniforms_counter_stream(np_dtype, t_dtype, step):
    ids = np.arange(3001, dtype=np.int64)
    want = np.asarray(
        jrng._agent_uniforms(
            jax.random.PRNGKey(11), step, jnp.asarray(ids, jnp.uint32), np_dtype, "counter"
        )
    )
    got = trng._agent_uniforms(trng.prng_key(11), step, torch.from_numpy(ids), t_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_foldin_stream_raises():
    """The foldin stream runs (it raised before it was ported); an unknown
    stream name raises."""
    ids = torch.arange(4)
    want = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(
        jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jax.random.fold_in(jax.random.PRNGKey(0), 0), jnp.arange(4)))
    _same_bits(want, trng._agent_uniforms(trng.prng_key(0), 0, ids, torch.float32, "foldin"))
    with pytest.raises(ValueError, match="rng_stream"):
        trng._agent_uniforms(trng.prng_key(0), 0, ids, torch.float32, "philox")


@pytest.mark.parametrize("np_dtype, t_dtype", FOUR_DTYPES)
@pytest.mark.parametrize("step", [0, 3, 10**6])
@pytest.mark.parametrize("stream", ["foldin", "counter"])
def test_agent_uniforms_both_streams_four_dtypes(np_dtype, t_dtype, step, stream):
    """`jax.random.uniform` of a scalar key draws 8 bits for bfloat16, 16
    for float16, b0 ^ b1 for float32 and both words for float64."""
    want = jrng._agent_uniforms(jax.random.PRNGKey(11), step,
                                jnp.asarray(WIDE_IDS.astype(np.uint32)), np_dtype, stream)
    got = trng._agent_uniforms(trng.prng_key(11), step, torch.from_numpy(WIDE_IDS), t_dtype,
                               stream)
    _same_bits(want, got)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0
