"""Host-side graph preprocessing for the agent simulation.

The JAX package binds a native counting sort here (``graphgen.cpp``); the
port keeps only its numpy path, which returns the same layout: a stable
argsort by destination, so equal destinations keep their source order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sort_edges_by_dst(
    src, dst, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by destination; return (src, dst, indeg, row_ptr).

    Stable in source order, matching ``np.argsort(dst, kind="stable")``.
    ``row_ptr`` is int64 of length n+1 with edges of dst i in
    [row_ptr[i], row_ptr[i+1]). Raises ``ValueError`` on a destination
    outside [0, n).
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if dst.size and (dst.min() < 0 or dst.max() >= n):
        raise ValueError(f"dst ids out of range [0, {n})")
    order = np.argsort(dst, kind="stable")
    src_out, dst_out = src[order], dst[order]
    indeg = np.bincount(dst, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(indeg, out=row_ptr[1:])
    return src_out, dst_out, indeg, row_ptr
