"""The recount's source-activity gather: ``active[e]`` = bit ``src[e]`` of
the withdrawn mask.

The neighbour recount of the agent simulation counts, per agent, the
in-edges whose source has withdrawn; its wall is this per-edge gather
(``sbr_tpu/social/agents.py:19-21``). The JAX package tried a Pallas
kernel that keeps the mask resident in fast memory
(``benchmarks/ablate_pallas_recount.py::_build_pallas_gather``); it never
lowered on the TPU, so its semantics are those of its interpret mode and
of the script's XLA variants. Here it is the CUDA kernel
``csrc/recount_gather.cu``, and ``benchmarks/ablate_pallas_recount.py`` of
this package measures it beside the library gather.

Two mask layouts:

- packed: ``uint8`` of ⌈N/8⌉ bytes, eight agents a byte, little-endian
  (`pack_mask`, equal to ``np.packbits(wd, bitorder="little")``);
  ``active[e] = (mask[s >> 3] >> (s & 7)) & 1``;
- unpacked: ``uint8`` of N bytes, one agent a byte (0 or 1);
  ``active[e] = mask[s]``.

The ids are ``int32`` of any shape (the ablation's 2-D form is a
(E/128, 128) view); the result is ``int32`` of the same shape.

Contract: every id lies in [0, N). The JAX variants disagree outside it
(``jnp.take``'s fill inside the Pallas kernel, clamping in ``w[s]``), and
the port copies neither: the plain versions raise an index error, the
kernel reads 0 for an id outside the mask's bits, and no caller may rely
on either.

`bit_gather` and `bool_gather` launch the kernel for CUDA tensors and run
the plain versions (`bit_gather_plain`, `bool_gather_plain`) for CPU
tensors; on the card nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from sbr_tpu_torch import _build

KERNEL = "recount_gather"

_KERNEL_FN = {True: "sbr_recount_gather_packed", False: "sbr_recount_gather_bool"}

# Which way the last launch read the mask, by layout: "shared" (staged in
# each block's shared memory) or "global" (through the read-only path).
LAST_BRANCH: dict = {}

_BRANCHES = {0: "shared", 1: "global"}


def pack_mask(wd: torch.Tensor) -> torch.Tensor:
    """Pack a boolean (or 0/1) mask of N agents into ⌈N/8⌉ ``uint8`` bytes,
    eight agents a byte, little-endian: ``np.packbits(wd,
    bitorder="little")``. Computed in ``int32``, which every device
    shifts and sums."""
    n = wd.shape[0]
    bits = torch.zeros(-(-n // 8) * 8, dtype=torch.int32, device=wd.device)
    bits[:n] = wd.to(torch.int32)
    weights = torch.ones(8, dtype=torch.int32, device=wd.device) << torch.arange(
        8, dtype=torch.int32, device=wd.device
    )
    return (bits.view(-1, 8) * weights).sum(-1).to(torch.uint8)


def bit_gather_plain(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``(packed[src >> 3] >> (src & 7)) & 1`` as ``int32``, the shape of
    ``src``: the kernel's plain version on the packed mask."""
    flat = src.reshape(-1)
    byte = torch.index_select(packed, 0, flat >> 3).to(torch.int32)
    return ((byte >> (flat & 7)) & 1).reshape(src.shape)


def bool_gather_plain(mask_u8: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``mask_u8[src]`` as ``int32``, the shape of ``src``: the kernel's
    plain version on the unpacked mask."""
    return torch.index_select(mask_u8, 0, src.reshape(-1)).to(torch.int32).reshape(src.shape)


def _check(mask: torch.Tensor, src: torch.Tensor) -> None:
    if mask.dtype != torch.uint8:
        raise ValueError(f"the mask must be uint8, got {mask.dtype}")
    if src.dtype != torch.int32:
        raise ValueError(f"the ids must be int32, got {src.dtype}")
    if mask.dim() != 1:
        raise ValueError(f"the mask must be 1-D, got shape {tuple(mask.shape)}")
    if mask.device != src.device:
        raise ValueError(f"the mask ({mask.device}) and the ids ({src.device}) must share a device")


def _gather_cuda(mask: torch.Tensor, src: torch.Tensor, packed: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; counts one launch in
    ``_build.LAUNCHES``."""
    if not mask.is_contiguous() or not src.is_contiguous():
        raise ValueError("the mask and the ids must be contiguous")
    fn = getattr(_build.load(KERNEL), _KERNEL_FN[packed])
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = ctypes.c_int
    out = torch.empty(src.shape, dtype=torch.int32, device=src.device)
    branch = ctypes.c_int(-1)
    rc = fn(
        mask.data_ptr(), mask.numel(), src.data_ptr(), out.data_ptr(), src.numel(),
        torch.cuda.current_stream(src.device).cuda_stream, ctypes.byref(branch),
    )
    if rc != 0:
        raise RuntimeError(f"recount_gather kernel launch failed: CUDA error {rc}")
    if branch.value >= 0:
        _build.LAUNCHES[KERNEL] += 1
        LAST_BRANCH["packed" if packed else "unpacked"] = _BRANCHES[branch.value]
    return out


def _gather(mask: torch.Tensor, src: torch.Tensor, packed: bool) -> torch.Tensor:
    _check(mask, src)
    if src.device.type == "cuda":
        return _gather_cuda(mask, src, packed)
    if src.device.type != "cpu":
        raise ValueError(f"recount gather runs on CUDA or the CPU, not {src.device}")
    return (bit_gather_plain if packed else bool_gather_plain)(mask, src)


def bit_gather(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``active[e]`` = bit ``src[e]`` of the packed mask (module docstring),
    ``int32`` of the shape of ``src``: the CUDA kernel on the card, the
    plain version on the CPU."""
    return _gather(packed, src, packed=True)


def bool_gather(mask_u8: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``active[e]`` = ``mask_u8[src[e]]``, ``int32`` of the shape of
    ``src``: the CUDA kernel on the card, the plain version on the CPU."""
    return _gather(mask_u8, src, packed=False)
