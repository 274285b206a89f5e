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

The kernel's launch plan is made here, once for each shape: `plan_launch`
chooses where the mask sits (the branch: a bit table in each block's
shared memory, whole or its first part, or the read-only path from L2),
the cluster of blocks that stages the table, the shared-memory size and
the grid, from the card's numbers, which are read once a device.
`bit_gather` and `bool_gather` launch the plan's choice; `launch` takes a
plan explicitly, which is how the size rule's two sides are timed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sbr_tpu_torch import _build

KERNEL = "recount_gather"

BRANCHES = ("shared", "global")
# 1,024 threads a block, each with 4 loads of 16 bytes in flight.
THREADS = 1024
# An SM's threads, for a plan made without the occupancy API's count.
MAX_THREADS_PER_SM = 2048
# Dynamic shared memory: two mbarriers and a flag, then the bit table
# (kTableOffset of the source).
TABLE_OFFSET = 128
# Shared memory the runtime keeps back from each resident block.
SMEM_RESERVED = 1024

# The size rule, the plan's own choice (measured on an H100: PERF.md §6).
# The branch is "shared" (the bit table in each block: whole, or its first
# part, "split") while the whole bit table is at most SHARED_MAX_BYTES,
# else "global". A packed mask is staged by each block alone; an unpacked
# one by the smallest cluster of STAGE_CLUSTERS of which no block reads
# more than STAGE_BYTES of it, else the largest.
SHARED_MAX_BYTES = 1 << 19
STAGE_BYTES = 1 << 18
STAGE_CLUSTERS = (1, 2, 4)

# The last launch by layout ("packed", "unpacked"): the branch's name
# (`Plan.name`: "shared", "split" or "global") and its whole plan.
LAST_BRANCH: dict = {}
LAST_PLAN: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel: what `plan_launch` chose. ``held`` is the
    bytes of the bit table (packed mask bytes, or unpacked agents eight a
    byte) a block holds in the shared branch, ``whole`` whether that is all
    of it; ``cluster`` the blocks that stage it together; ``smem`` bytes of
    dynamic shared memory."""

    branch: str
    cluster: int
    threads: int
    grid: int
    smem: int
    held: int
    whole: bool

    @property
    def name(self) -> str:
        if self.branch == "shared":
            return "shared" if self.whole else "split"
        return self.branch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_launch(mask_bytes: int, n_edges: int, *, packed: bool, sms: int, smem_optin: int,
                smem_per_sm: int, resident=None, shared_max: int = SHARED_MAX_BYTES) -> Plan:
    """The launch plan of the kernel for a mask of ``mask_bytes`` (packed or
    not) and ``n_edges`` ids on a card with ``sms`` streaming
    multiprocessors, ``smem_optin`` bytes of shared memory a block may take
    and ``smem_per_sm`` an SM, by the size rule (module constants), whose
    threshold is ``shared_max``. ``resident`` is the number of blocks the
    card holds at once for this plan's kernel (the occupancy API's, on the
    card); without it, it is reckoned from threads and shared memory. The
    grid never exceeds it."""
    room = smem_optin - TABLE_OFFSET
    # the bit table: a packed mask's bytes, up to 15 bytes after its start
    # (which aligns its body); an unpacked mask's agents, eight a byte
    bits = mask_bytes if packed else -(-mask_bytes // 8)
    pad = 15 if packed else 0
    branch = "shared" if bits <= shared_max else "global"
    held, cluster, table = 0, 1, 0
    if branch == "shared":
        held = min(bits, room // 16 * 16 - pad)
        if not packed:
            fewest = (c for c in STAGE_CLUSTERS if 8 * held <= c * STAGE_BYTES)
            cluster = next(fewest, STAGE_CLUSTERS[-1])
        table = _round_up(pad + held, 16)
    smem = TABLE_OFFSET + table
    if resident is None:
        per_sm = min(MAX_THREADS_PER_SM // THREADS, smem_per_sm // (smem + SMEM_RESERVED))
        resident = per_sm * sms // cluster * cluster
    if resident < cluster:
        raise ValueError(f"no block of the {branch} branch fits on the card ({smem} bytes)")
    # blocks with work: a quad of ids a thread
    work = -(-n_edges // (4 * THREADS))
    grid = _round_up(max(1, min(work, resident)), cluster)
    return Plan(branch=branch, cluster=cluster, threads=THREADS, grid=grid, smem=smem,
                held=held, whole=branch == "shared" and held == bits)


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


def _kernel_id(plan: Plan, packed: bool) -> int:
    """The C side's index of the kernel instantiation the plan launches."""
    return 2 * packed + BRANCHES.index(plan.branch)


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.sbr_recount_launch.argtypes is None:
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        out = ctypes.POINTER(ctypes.c_int)
        lib.sbr_recount_limits.argtypes = [i32, out, out, out]
        lib.sbr_recount_allow_smem.argtypes = [i32, i32, i32]
        lib.sbr_recount_resident.argtypes = [i32, i32, i32, i32, i32, out]
        lib.sbr_recount_launch.argtypes = [
            i32, i32, ptr, i64, ptr, ptr, i64, i32, i32, i32, i32, i32, ptr,
        ]
        for fn in (lib.sbr_recount_limits, lib.sbr_recount_allow_smem,
                   lib.sbr_recount_resident, lib.sbr_recount_launch):
            fn.restype = ctypes.c_int
    return lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"recount_gather {what} failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> dict:
    """The card's numbers that `plan_launch` takes, read once a device:
    ``sms``, ``smem_optin`` and ``smem_per_sm``."""
    vals = [ctypes.c_int() for _ in range(3)]
    _check_rc(_lib().sbr_recount_limits(index, *map(ctypes.byref, vals)), "device query")
    return dict(zip(("sms", "smem_optin", "smem_per_sm"), (v.value for v in vals)))


@functools.lru_cache(maxsize=None)
def _allow_smem(index: int, kernel_id: int) -> None:
    """Raise kernel ``kernel_id``'s shared-memory limit on device ``index``,
    once."""
    _check_rc(_lib().sbr_recount_allow_smem(index, kernel_id,
                                            device_limits(index)["smem_optin"]),
              "shared-memory set-up")


@functools.lru_cache(maxsize=None)
def _resident(index: int, kernel_id: int, threads: int, smem: int, cluster: int) -> int:
    """Blocks of the kernel device ``index`` holds at once, from the
    occupancy API."""
    _allow_smem(index, kernel_id)
    count = ctypes.c_int()
    _check_rc(_lib().sbr_recount_resident(index, kernel_id, threads, smem, cluster,
                                          ctypes.byref(count)), "occupancy query")
    return count.value


@functools.lru_cache(maxsize=1024)
def _plan_on(index: int, mask_bytes: int, n_edges: int, packed: bool, shared_max: int) -> Plan:
    kw = dict(packed=packed, shared_max=shared_max, **device_limits(index))
    plan = plan_launch(mask_bytes, n_edges, **kw)
    resident = _resident(index, _kernel_id(plan, packed), plan.threads, plan.smem, plan.cluster)
    return plan_launch(mask_bytes, n_edges, resident=resident, **kw)


def plan_for(mask: torch.Tensor, src: torch.Tensor, *, packed: bool,
             shared_max: int = SHARED_MAX_BYTES) -> Plan:
    """The plan a launch on these CUDA tensors takes (`plan_launch` with
    the card's numbers and its occupancy), made once a shape."""
    return _plan_on(src.device.index, mask.numel(), src.numel(), packed, shared_max)


def _output_like(src: torch.Tensor) -> torch.Tensor:
    """An int32 tensor of the shape of ``src`` whose address has the ids'
    alignment modulo 16, so that one edge offset aligns both for 16-byte
    accesses: a view into a buffer three elements longer."""
    n = src.numel()
    buf = torch.empty(n + 3, dtype=torch.int32, device=src.device)
    skip = (src.data_ptr() - buf.data_ptr()) // 4 % 4
    return buf[skip:skip + n].view(src.shape)


def launch(mask: torch.Tensor, src: torch.Tensor, plan: Plan, *, packed: bool) -> torch.Tensor:
    """Launch the CUDA kernel with ``plan`` (from `plan_for`) on the current
    stream of the tensors' device; counts one launch in
    ``_build.LAUNCHES``."""
    _check(mask, src)
    if src.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not on {src.device}")
    if not mask.is_contiguous() or not src.is_contiguous():
        raise ValueError("the mask and the ids must be contiguous")
    if src.numel() == 0:
        return torch.empty(src.shape, dtype=torch.int32, device=src.device)
    index = src.device.index
    kernel_id = _kernel_id(plan, packed)
    _allow_smem(index, kernel_id)
    out = _output_like(src)
    rc = _lib().sbr_recount_launch(
        index, kernel_id, mask.data_ptr(), mask.numel(), src.data_ptr(), out.data_ptr(),
        src.numel(), plan.grid, plan.threads, plan.smem, plan.cluster, plan.held,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _check_rc(rc, "kernel launch")
    _build.LAUNCHES[KERNEL] += 1
    layout = "packed" if packed else "unpacked"
    LAST_BRANCH[layout] = plan.name
    LAST_PLAN[layout] = plan
    return out


def _gather(mask: torch.Tensor, src: torch.Tensor, packed: bool) -> torch.Tensor:
    """The kernel with the plan's own choice for CUDA tensors; the plain
    version for CPU tensors."""
    _check(mask, src)
    if src.device.type == "cuda":
        return launch(mask, src, plan_for(mask, src, packed=packed), packed=packed)
    if src.device.type != "cpu":
        raise ValueError(f"recount gather runs on CUDA or the CPU, not {src.device}")
    return (bit_gather_plain if packed else bool_gather_plain)(mask, src)


def bit_gather(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``active[e]`` = bit ``src[e]`` of the packed mask (module docstring),
    ``int32`` of the shape of ``src``: the CUDA kernel on the card, the
    plain version on the CPU."""
    return _gather(packed, src, True)


def bool_gather(mask_u8: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``active[e]`` = ``mask_u8[src[e]]``, ``int32`` of the shape of
    ``src``: the CUDA kernel on the card, the plain version on the CPU."""
    return _gather(mask_u8, src, False)
