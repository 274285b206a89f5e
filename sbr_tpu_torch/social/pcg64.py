"""numpy's PCG64 streams drawn on the card (``csrc/pcg64_draws.cu``).

Two draws of a simulation are numpy's on one host thread, in the JAX
package as here: an epoch's in-degrees (`graphgen.epoch_indegrees`, the
bincount of ``Generator.integers(0, n)``) and the initial informed mask
(`agents._draw_seeds`, ``Generator.random(n) < x0``). At 10^7 agents they
are most of a rewired epoch and a simulation's start, with the card idle.
The kernels draw the same streams from the generator's state, entry for
entry (the kernel file sets out numpy's definitions), and the caller's
generator is left where it was. Each wrapper counts its launches in
``_build.LAUNCHES[KERNEL]``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from sbr_tpu_torch import _build

KERNEL = "pcg64_draws"
_M64 = (1 << 64) - 1
_U64 = ctypes.c_uint64


def _head(rng: np.random.Generator):
    """(state hi, lo, inc hi, lo) of a fresh PCG64 generator's stream."""
    state = rng.bit_generator.state
    if state["bit_generator"] != "PCG64" or state["has_uint32"]:
        raise ValueError("the card draws from a PCG64 stream with no 32-bit half kept")
    s, inc = state["state"]["state"], state["state"]["inc"]
    return s >> 64, s & _M64, inc >> 64, inc & _M64


def uniform_indegrees(rng: np.random.Generator, n: int, e: int, device) -> torch.Tensor:
    """The histogram (int64, ``n`` entries) of the first ``e`` ids of
    ``rng.integers(0, n)``, chunked or not: what ``np.bincount`` gives of
    the host draw. A word is rejected with probability ((2^32 - n) mod n)
    / 2^32 < 1/2, and the kernel's stream holds ``e`` accepted words with
    20 standard deviations to spare; a device-side assert stops the run if
    it did not. Two launches."""
    threshold = ((1 << 32) - n) % n
    need = e / (1.0 - threshold / 2.0**32)
    words = int(need + 20.0 * math.sqrt(need)) + 4096
    lib = _build.load(KERNEL)
    lib.pcg64_indegree_threads.argtypes = [ctypes.c_int64]
    lib.pcg64_indegree_threads.restype = ctypes.c_int64
    fn = _build.entry(KERNEL, "pcg64_indegree_pass", [
        ctypes.c_int, _U64, _U64, _U64, _U64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ])
    accepted = torch.empty(lib.pcg64_indegree_threads(words), dtype=torch.int32, device=device)
    hist = torch.zeros(n, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    head = (*_head(rng), n, threshold, words)
    rc = fn(1, *head, accepted.data_ptr(), None, e, None, stream)
    ends = torch.cumsum(accepted, 0)
    torch._assert_async(ends[-1] >= e)
    first = ends - accepted
    if rc == 0:
        rc = fn(0, *head, None, first.data_ptr(), e, hist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pcg64 in-degree kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES[KERNEL] += 2
    return hist.to(torch.int64)


def bernoulli(rng: np.random.Generator, n: int, p: float, device) -> torch.Tensor:
    """``rng.random(n) < p`` as a bool tensor on ``device``. One launch."""
    fn = _build.entry(KERNEL, "pcg64_bernoulli", [
        _U64, _U64, _U64, _U64, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
        ctypes.c_void_p,
    ])
    out = torch.empty(n, dtype=torch.bool, device=device)
    rc = fn(*_head(rng), n, float(p), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pcg64 Bernoulli kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES[KERNEL] += 1
    return out


def advanced(rng: np.random.Generator, outputs: int) -> np.random.Generator:
    """A generator at ``rng``'s stream ``outputs`` 64-bit draws on, as
    ``rng`` is after ``rng.random(outputs)``; ``rng`` is left where it
    was."""
    bg = np.random.PCG64()
    bg.state = rng.bit_generator.state
    bg.advance(outputs)
    return np.random.Generator(bg)
