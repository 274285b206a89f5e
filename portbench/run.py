"""The benchmark of `sbr_tpu_torch`: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It reads ``BENCHMARK.json`` and the cell's
files under ``portbench/`` (`harness.cell`), builds the cell's inputs from
the seed, sets up, measures for ``--seconds``, compares what the window
produced with the plain reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), the device, and the numbers compared,
each beside its limit (also the last lines on standard error).

It exits 3 without a result when no CUDA card (or fewer than the cell asks
for) is there, and 4 when a forbidden module (JAX or the JAX package) was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _caches() -> None:
    """Build and kernel caches live at fixed paths inside the checkout."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness.cell import load_cell
    from harness.core import ForbiddenImport, execute, guard_imports

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
        guard_imports()
    except ForbiddenImport as exc:
        print(str(exc), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
