"""Readings for the limits of a cell's comparison, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--seconds 2] [--out FILE]

For each seed it sets the cell up, runs a short window of its traffic and
prints the numbers its comparison reads for the program; for each control
seed it also prints them for the control: the plain reference computed in
the type below the configuration's (bfloat16 for float32) put in the
program's place. The limits in ``workloads/<cell>.json`` lie between the
largest program reading and the smallest control reading (`PERF.md`). The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CONTROL = {"float32": "bfloat16", "float64": "float32"}


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    """One seed's numbers for the program (and the control), with the
    seconds each comparison took."""
    import torch

    driver = cell.driver().Driver(cell, seed, device)
    driver.setup()
    driver.window(seconds, False)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    row = {"cell": cell.name, "seed": seed, "units": len(driver.units)}
    row["program"], _ = driver.compare()
    row["compare_s"] = time.perf_counter() - t
    if control:
        row["control_dtype"] = CONTROL[cell.config["dtype"]]
        row["control"], _ = driver.compare(control=getattr(torch, row["control_dtype"]))
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness.cell import load_cell

    cell = load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            row = readings(cell, seed, args.seconds, device, seed in args.control_seeds)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
