"""Host-side graph preprocessing for the agent simulation, bound with ctypes.

The port's copy of the JAX package's native layer: ``graphgen.cpp`` holds
a counting sort of edges by destination (O(E + N), where numpy's stable
argsort is O(E log E)) and the Erdős–Rényi pair sampler on a splitmix64
stream. ``_build.build_host`` compiles it with ``g++`` at first use into
``_build/`` (no CUDA toolkit needed), so it runs on any host.

The rules are the JAX package's: ``SBR_NATIVE=0`` turns the library off,
read on every call, so one process can time both routes; with it off,
`sort_edges_by_dst` takes the numpy sort (the same layout) and
`er_edges_native` returns None (`agents.erdos_renyi_edges` then draws
numpy's stream). One departure: where the JAX package falls back to numpy
when the build fails, and so silently changes the graph a seed gives, a
failed build here raises.

`_sort_edges_by_dst_plain` and `_er_edges_plain` are the plain versions
(numpy) that the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from sbr_tpu_torch import _build

_I32_MAX = np.iinfo(np.int32).max

_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sort_edges_by_dst.restype = ctypes.c_int
    lib.sort_edges_by_dst.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, i64p, i32p,
    ]
    lib.er_edges.restype = None
    lib.er_edges.argtypes = [ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64, i32p, i32p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The host library, built at first use; None under ``SBR_NATIVE=0``.
    A failed build raises ``RuntimeError``."""
    global _lib
    if os.environ.get("SBR_NATIVE", "").strip() == "0":
        return None
    if _lib is None:
        try:
            lib = _build.load_host("graphgen")  # one load a process, under its lock
        except (RuntimeError, OSError) as exc:
            raise RuntimeError(
                "the native host library (sbr_tpu_torch/native/graphgen.cpp) did not "
                "build; SBR_NATIVE=0 selects the numpy routes (numpy's edge stream, "
                f"another graph for a seed): {exc}"
            ) from exc
        _lib = _bind(lib)
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _check_n(n: int) -> None:
    if not 0 <= n <= _I32_MAX:
        raise ValueError(f"n = {n} outside [0, {_I32_MAX}]")


def _edge_arrays(src, dst) -> Tuple[np.ndarray, np.ndarray]:
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src and dst must be 1-D of one length, got {src.shape}, {dst.shape}")
    return src, dst


def _sort_edges_by_dst_plain(
    src, dst, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The numpy version of `sort_edges_by_dst`: a stable argsort."""
    src, dst = _edge_arrays(src, dst)
    if dst.size and (dst.min() < 0 or dst.max() >= n):
        raise ValueError(f"dst ids out of range [0, {n})")
    order = np.argsort(dst, kind="stable")
    src_out, dst_out = src[order], dst[order]
    indeg = np.bincount(dst, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(indeg, out=row_ptr[1:])
    return src_out, dst_out, indeg, row_ptr


def sort_edges_by_dst(
    src, dst, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by destination; return (src, dst, indeg, row_ptr).

    Stable in source order, matching ``np.argsort(dst, kind="stable")``.
    ``row_ptr`` is int64 of length n+1 with edges of dst i in
    [row_ptr[i], row_ptr[i+1]). The native counting sort, or under
    ``SBR_NATIVE=0`` the numpy one (the same outputs). Raises
    ``ValueError`` on a destination outside [0, n).
    """
    _check_n(n)
    src, dst = _edge_arrays(src, dst)
    lib = get_lib()
    if lib is None:
        return _sort_edges_by_dst_plain(src, dst, n)
    e = src.shape[0]
    src_out = np.empty(e, np.int32)
    dst_out = np.empty(e, np.int32)
    row_ptr = np.empty(n + 1, np.int64)
    indeg = np.empty(n, np.int32)
    if lib.sort_edges_by_dst(src, dst, e, n, src_out, dst_out, row_ptr, indeg) != 0:
        raise ValueError(f"dst ids out of range [0, {n})")
    return src_out, dst_out, indeg, row_ptr


def er_edges_native(n: int, e: int, seed: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``e`` uniform directed (src, dst) pairs on ``n`` agents from the
    splitmix64 stream seeded with ``seed`` (self-loops redrawn); None under
    ``SBR_NATIVE=0``. Deterministic in seed, independent of numpy's
    generator, and the JAX package's native stream."""
    lib = get_lib()
    if lib is None:
        return None
    _check_n(n)
    if e < 0 or (e and n < 1):
        raise ValueError(f"cannot draw {e} edges on {n} agents")
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    lib.er_edges(n, e, seed, src, dst)
    return src, dst


_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix_draws(seed: int, count: int, n: int) -> np.ndarray:
    """The first ``count`` outputs of the splitmix64 stream seeded with
    ``seed``, each modulo ``n`` (int64). The state after k draws is
    seed + k·golden modulo 2^64; numpy's uint64 arrays wrap the same way."""
    state = np.arange(1, count + 1, dtype=np.uint64)
    state *= _GOLDEN
    state += np.array([seed], dtype=np.uint64)
    z = state
    z ^= z >> np.uint64(30)
    z *= _MIX1
    z ^= z >> np.uint64(27)
    z *= _MIX2
    z ^= z >> np.uint64(31)
    return (z % np.uint64(n)).astype(np.int64)


def _er_edges_plain(n: int, e: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy version of `er_edges_native`: the same pairs.

    Edge i takes the next two draws as (src, dst) and, while dst == src,
    draws dst again, so a self-loop shifts every later edge's draws. The
    stream is drawn in bulk; the self-loops are found by comparing each
    draw with the next, at both parities, and taken in stream order."""
    _check_n(n)
    if e < 0 or (e and n < 1):
        raise ValueError(f"cannot draw {e} edges on {n} agents")
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    if e == 0:
        return src, dst
    extra = 64 + 4 * (e // n)
    while True:
        w = _splitmix_draws(seed, 2 * e + extra, n)
        if n == 1:  # every pair is (0, 0): no redraw
            src[:], dst[:] = w[0:2 * e:2], w[1:2 * e:2]
            return src, dst
        same = w[:-1] == w[1:]
        # stream positions q whose pair (q, q + 1) is a self-loop, by parity
        loops = [np.flatnonzero(same[p::2]) * 2 + p for p in (0, 1)]
        pos = i = 0
        while i < e:
            # edge i + j reads the pair at pos + 2j until the next self-loop
            cand = loops[pos % 2]
            k = np.searchsorted(cand, pos)
            end = pos + 2 * (e - i)
            q = int(cand[k]) if k < len(cand) else end
            if q >= end:
                if end > len(w):
                    break
                src[i:] = w[pos:end:2]
                dst[i:] = w[pos + 1:end:2]
                return src, dst
            j = (q - pos) // 2
            src[i:i + j] = w[pos:q:2]
            dst[i:i + j] = w[pos + 1:q:2]
            r = q + 2
            while r < len(w) and w[r] == w[q]:
                r += 1
            if r >= len(w):
                break
            src[i + j], dst[i + j] = w[q], w[r]
            i, pos = i + j + 1, r + 1
        else:
            return src, dst  # the last edge was a redrawn self-loop
        extra *= 4  # the redraws ran past the drawn stream: draw a longer one
