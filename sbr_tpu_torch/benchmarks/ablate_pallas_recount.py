"""Ablation: can a mask held in fast memory beat the ``wd[src]`` gather?

The port's counterpart of ``benchmarks/ablate_pallas_recount.py``. The
agent recount's wall is the per-edge gather of the withdrawn mask at each
edge's source. The JAX script asked whether a kernel that keeps the
(packed) mask resident while the edge ids stream past beats the XLA
gather; its Pallas kernels never lowered on the TPU. This script asks the
same question on the card with the CUDA kernel of
``sbr_tpu_torch/csrc/recount_gather.cu``, on the same inputs, under five
variant names:

  torch_bool_gather    one ``torch.index_select`` on the mask as int32:
                       the library call (the JAX script's xla_bool_gather)
  torch_bit_gather     the packed gather in PyTorch ops, shift and mask
                       (xla_bit_gather; the kernel's plain version)
  cuda_bit_gather      the kernel on the packed mask (pallas_bit_gather)
  cuda_bit_gather_2d   the same kernel on a (E/128, 128) view of the ids,
                       no copy (pallas_bit_gather_2d)
  cuda_bool_gather     the kernel on the unpacked one-byte mask
                       (pallas_bool_gather)

Every variant's output is held equal to the library variant's before any
timing. Times come from CUDA events around `REPS` calls after a warm-up.

Run:

    python -m sbr_tpu_torch.benchmarks.ablate_pallas_recount [n_agents] [n_edges] \\
        [--device cuda|cpu] [--json PATH]

On the card by default. ``--device cpu`` checks the outputs only (the
kernels' wrappers run their plain versions on CPU tensors) and times
nothing. The JSON goes to ``--json PATH`` only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sbr_tpu_torch.social import recount

# The JAX script's edge block: its edge count is padded to a multiple of
# it, and the same padding keeps the two scripts' shapes equal.
EDGE_BLOCK = 1 << 17
# timed calls of each variant
REPS = 20

VARIANTS = (
    "torch_bool_gather", "torch_bit_gather", "cuda_bit_gather",
    "cuda_bit_gather_2d", "cuda_bool_gather",
)


def make_inputs(n: int, e: int, device):
    """The JAX script's inputs: ``np.random.default_rng(0)``, the agent
    count rounded up to whole bytes with the padding agents never
    withdrawn, the edge count padded to a multiple of `EDGE_BLOCK`.
    Returns (wd numpy bool (n8,), src numpy int32 (E_pad,), tensors dict)."""
    rng = np.random.default_rng(0)
    n8 = -(-n // 8) * 8
    e_pad = -(-e // EDGE_BLOCK) * EDGE_BLOCK
    wd = rng.random(n8) < 0.3
    wd[n:] = False
    src = rng.integers(0, n, size=e_pad, dtype=np.int32)
    dev = torch.device(device)
    wd_u8 = torch.from_numpy(wd.astype(np.uint8)).to(dev)
    tensors = {
        "wd_i32": wd_u8.to(torch.int32),
        "wd_u8": wd_u8,
        "packed": torch.from_numpy(np.packbits(wd, bitorder="little")).to(dev),
        "src": torch.from_numpy(src).to(dev),
    }
    tensors["src_2d"] = tensors["src"].view(-1, 128)
    return wd, src, tensors


def variant_fns(t: dict) -> dict:
    """The five variants as calls on the inputs of `make_inputs`."""
    return {
        "torch_bool_gather": lambda: torch.index_select(t["wd_i32"], 0, t["src"]),
        "torch_bit_gather": lambda: recount.bit_gather_plain(t["packed"], t["src"]),
        "cuda_bit_gather": lambda: recount.bit_gather(t["packed"], t["src"]),
        "cuda_bit_gather_2d": lambda: recount.bit_gather(t["packed"], t["src_2d"]),
        "cuda_bool_gather": lambda: recount.bool_gather(t["wd_u8"], t["src"]),
    }


def event_ms(fn) -> float:
    """Mean device milliseconds of one call of ``fn`` over `REPS` calls
    between two CUDA events, after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def run(n: int = 1_000_000, e: int = 10_000_000, device="cuda") -> dict:
    """Check every variant against the library variant, then time each on
    the card. Returns the JSON-ready record; raises on a mismatch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a check without timings")
    wd, src, t = make_inputs(n, e, dev)
    fns = variant_fns(t)
    ref = fns["torch_bool_gather"]()
    if not np.array_equal(ref.cpu().numpy(), wd[src].astype(np.int32)):
        raise AssertionError("torch_bool_gather differs from wd[src]")
    results = {}
    for name in VARIANTS:
        out = fns[name]()
        mism = int((out.reshape(-1) != ref).sum())
        if mism:
            raise AssertionError(f"{name} differs from torch_bool_gather on {mism} edges")
        row = {"mismatches": 0}
        if dev.type == "cuda":
            ms = event_ms(fns[name])
            row.update(ms=ms, elem_per_sec=ref.numel() / (ms * 1e-3))
        else:
            row.update(ms=None, elem_per_sec=None)
        results[name] = row
    record = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_agents": n,
        "n_edges": int(ref.numel()),
        "packed_mask_bytes": int(t["packed"].numel()),
        "mask_branch": dict(recount.LAST_BRANCH) if dev.type == "cuda" else None,
        "results": results,
    }
    if dev.type == "cuda":
        lib = results["torch_bool_gather"]["ms"]
        best = min(("cuda_bit_gather", "cuda_bit_gather_2d", "cuda_bool_gather"),
                   key=lambda k: results[k]["ms"])
        record["best_kernel"] = best
        record["speedup_vs_library"] = lib / results[best]["ms"]
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_agents", nargs="?", type=int, default=1_000_000)
    ap.add_argument("n_edges", nargs="?", type=int, default=10_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="", help="write the record to this path")
    args = ap.parse_args(argv)
    record = run(args.n_agents, args.n_edges, args.device)
    for name, row in record["results"].items():
        ms = "not measured" if row["ms"] is None else f"{row['ms']:.4f} ms"
        print(f"{name:>20}: {ms}  mismatches {row['mismatches']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
