"""Counter-RNG primitives of the agent simulation, in PyTorch.

The per-(agent, step) random stream is a pure function of (key words,
agent id) built on one Threefry-2x32 block, so any chunking or fusion of
the consuming computation draws the same bits. This module reproduces
``sbr_tpu.social.rng`` bit for bit:

- ``_threefry2x32`` runs on Python ints and on int64 tensors holding
  32-bit words. CPU PyTorch implements neither ``+`` nor the shifts on
  ``uint32``, so every word is kept in int64 and masked back to 32 bits
  after each operation that can carry past them.
- ``prng_key`` and ``fold_in`` emulate ``jax.random.PRNGKey`` and
  ``jax.random.fold_in`` for the default threefry key layout on the host,
  in Python ints: a step's key words cost no device work and no sync.
- ``_uniform_from_bits`` builds the [0, 1) draw from the block's words
  exactly as the JAX package does (mantissa-or trick, both words for
  float64, the half-precision clamp below 1.0).
- ``_agent_uniforms`` draws either stream of ``AgentSimConfig.rng_stream``:
  "counter" (one block an agent, the id as its counter) and "foldin"
  (``uniform(fold_in(fold_in(key, step), id))``: one more block an agent,
  and the bits ``jax.random.uniform`` takes from a scalar key,
  `_scalar_uniform`).
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _threefry2x32(k0, k1, c0, c1):
    """One Threefry-2x32 block (Salmon et al. 2011) on 32-bit words.

    Arguments are Python ints or int64 tensors with values in [0, 2^32);
    the result words are of the same kind. Identical to
    ``sbr_tpu.social.rng._threefry2x32`` (tested bitwise)."""
    m = _MASK32

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (c0 + ks[0]) & m
    x1 = (c1 + ks[1]) & m
    for i in range(5):
        for r in _ROT_A if i % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & m
            x1 = rotl(x1, r)
            x1 = x1 ^ x0
        j = i + 1
        x0 = (x0 + ks[j % 3]) & m
        x1 = (x1 + ks[(j + 1) % 3] + j) & m
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """Key words of ``jax.random.PRNGKey(seed)`` (threefry layout, 64-bit
    seeds): the high and low 32 bits of the seed's two's complement."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32) & _MASK32, s & _MASK32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """Key words of ``jax.random.fold_in(key, data)``: one Threefry block of
    ``key`` on the counter (data >> 32, data & 0xFFFFFFFF)."""
    d = int(data) & 0xFFFFFFFFFFFFFFFF
    return _threefry2x32(key[0], key[1], (d >> 32) & _MASK32, d & _MASK32)


def _one_minus_epsneg(dtype: torch.dtype) -> float:
    # numpy's finfo(dtype).epsneg (the gap below 1.0) is half of eps for
    # every binary float format; torch.finfo has no epsneg field.
    return 1.0 - torch.finfo(dtype).eps / 2


def _uniform_from_bits(x0, x1, dtype: torch.dtype) -> torch.Tensor:
    """[0, 1) uniform from one Threefry block's words (int64 tensors).

    float64 takes the 52-bit mantissa from both words; narrower types take
    x0's high 23 bits through a float32 and, below 32 bits, clamp the
    rounded cast under 1.0 — the ``sbr_tpu.social.rng._uniform_from_bits``
    definition."""
    if dtype == torch.float64:
        # ((x0 << 32 | x1) >> 12) without a 64-bit unsigned type
        mant = (x0 << 20) | (x1 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    mant = ((x0 >> 9) | 0x3F800000).to(torch.int32)
    u = (mant.view(torch.float32) - 1.0).to(dtype)
    if torch.finfo(dtype).bits < 32:
        u = torch.clamp(u, max=_one_minus_epsneg(dtype))
    return u


def _scalar_uniform(a0, a1, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.uniform(key, (), dtype)`` for a batch of threefry keys
    with words (a0, a1) (int64 tensors), as jax 0.9 computes it under its
    default ``jax_threefry_partitionable``: one block of the key on the
    counter (0, 0) gives words (b0, b1); a 64-bit draw takes b0 as its
    high word and b1 as its low one, narrower draws take b0 ^ b1, cut to
    the dtype's width, or to 8 bits for bfloat16, whose 7-bit mantissa is
    narrower than 8. The mantissa-or trick then gives [1, 2), minus 1; the
    scaling to [0, 1) and the ``max`` with 0 change no value."""
    zero = torch.zeros_like(a0)
    b0, b1 = _threefry2x32(a0, a1, zero, zero)
    if dtype == torch.float64:
        return _uniform_from_bits(b0, b1, dtype)
    bits = b0 ^ b1
    if dtype == torch.float32:
        one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float16:
        one = (((bits & 0xFFFF) >> 6) | 0x3C00).to(torch.int16).view(torch.float16)
    elif dtype == torch.bfloat16:
        one = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    else:
        raise TypeError(f"no uniform draw of {dtype}")
    return one - 1.0


def _agent_uniforms(key, step_k: int, ids: torch.Tensor, dtype: torch.dtype,
                    impl: str = "counter") -> torch.Tensor:
    """Per-agent uniform draw as a pure function of (key, step, GLOBAL id),
    so every engine and sharding draws the same bits.

    - "counter": the step's key words hash the id directly as the block
      counter (one block an agent).
    - "foldin": ``uniform(fold_in(fold_in(key, step), id))``: the agent's
      key is the block of the step's key on the counter (0, id), and its
      draw `_scalar_uniform` (two blocks an agent). The two streams are
      different realizations.

    ``key`` is a ``prng_key`` pair; ``ids`` any integer tensor of ids."""
    if impl not in ("counter", "foldin"):
        raise ValueError(f"rng_stream must be 'foldin' or 'counter', got {impl!r}")
    k0, k1 = fold_in(key, step_k)
    c0 = ids.to(torch.int64) & _MASK32
    if impl == "foldin":
        a0, a1 = _threefry2x32(k0, k1, torch.zeros_like(c0), c0)
        return _scalar_uniform(a0, a1, dtype)
    x0, x1 = _threefry2x32(k0, k1, c0, torch.zeros_like(c0))
    return _uniform_from_bits(x0, x1, dtype)
