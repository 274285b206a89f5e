"""Count a built kernel's instructions per agent from its SASS, by pipe.

The infection kernel's operations bound (``chip_smoke.py``) is the
instructions it issues for one frontier agent on its busiest pipe, over
that pipe's rate. This script reads those instructions from the machine
code of the built library: ``cuobjdump -sass`` (from the CUDA toolkit, or
the copy in Triton's package), one listing per kernel function. In each
function the per-agent body is the innermost loop that holds a MUFU
instruction (the reciprocal of the division, and the float32
exponential): the smallest range between a backward branch and its target
that contains one. Its instructions are counted once each,
as they stand in the listing (a slow path the common case branches over
counts too), and sorted into the pipes they issue to on Hopper:

  alu    integer add, logic, shifts, compares, selects (IADD3, LOP3, SHF,
         ISETP, FSETP, SEL, FSEL, FMNMX, PRMT, LEA, I2FP, F2FP...): 64 lanes
         a clock on one SM
  fma    FFMA, FADD, FMUL and the half-type arithmetic: 128
  imad   IMAD in all its forms (also the compiler's moves): 64
  fp64   DFMA, DADD, DMUL, DSETP: 64
  xu     MUFU, the conversions F2F, F2I, I2F, and POPC, FLO: 16
  lsu    loads and stores (LDG, STG, LDS, STS...): 32
  other  branches, moves and the rest, which only take an issue slot

and ``issue``, every instruction, at one a clock on each of the SM's four
schedulers (128 lanes a clock).

Run (on a machine with the CUDA toolkit; the kernel is built first):

    python -m sbr_tpu_torch.benchmarks.sass_count [kernel] [--dump PATH]

prints one JSON object: for each function of ``csrc/<kernel>.cu`` (default
``infection_update``) the loop's address range and its counts by pipe and
by opcode. ``--dump`` writes the whole listing to PATH.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# lanes a clock on one SM of a Hopper card, by pipe
PIPE_LANES = {"alu": 64, "fma": 128, "imad": 64, "fp64": 64, "xu": 16, "lsu": 32,
              "issue": 128}

_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "FSETP", "HSETP2",
        "SEL", "FSEL", "FMNMX", "IMNMX", "VIMNMX", "PRMT", "LEA", "IABS", "I2FP", "F2FP",
        "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "FCHK", "BFE", "BFI", "ISCADD", "IMNMX3"}
_FMA = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "HADD2", "HFMA2", "HMUL2",
        "HMNMX2", "FSWZADD"}
_FP64 = {"DFMA", "DADD", "DMUL", "DSETP", "DMNMX"}
_XU = {"MUFU", "F2F", "F2I", "I2F", "POPC", "FLO", "BREV", "FRND"}
_LSU = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "LDC", "ATOMS", "ATOMG", "RED",
        "LDSM", "SHFL"}

# one instruction line of cuobjdump: /*addr*/  [@pred] OPCODE operands ;
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def pipe_of(opcode: str) -> str:
    """The pipe an instruction issues to (its opcode's base, before the
    first dot)."""
    base = opcode.split(".")[0]
    if base.startswith("IMAD"):
        return "imad"
    for pipe, names in (("alu", _ALU), ("fma", _FMA), ("fp64", _FP64), ("xu", _XU),
                        ("lsu", _LSU)):
        if base in names:
            return pipe
    return "other"


def parse(listing: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """{function name: [(address, opcode, operands), ...]} of a
    ``cuobjdump -sass`` listing."""
    funcs: Dict[str, List[Tuple[int, str, str]]] = {}
    current: Optional[List[Tuple[int, str, str]]] = None
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return funcs


def agent_loop(instrs: List[Tuple[int, str, str]], marker: str = "MUFU"
               ) -> Optional[Tuple[int, int]]:
    """(first, last) address of the innermost loop holding ``marker``: the
    smallest range [target, branch] of a backward branch that contains an
    instruction whose opcode starts with it. None when there is none."""
    marks = [a for a, op, _ in instrs if op.startswith(marker)]
    best = None
    for addr, op, operands in instrs:
        if not op.startswith("BRA"):
            continue
        t = _TARGET.search(operands)
        if not t:
            continue
        target = int(t.group(1), 16)
        if target > addr or not any(target <= m <= addr for m in marks):
            continue
        if best is None or addr - target < best[1] - best[0]:
            best = (target, addr)
    return best


def count(instrs: List[Tuple[int, str, str]], span: Tuple[int, int]) -> dict:
    """Counts by pipe (``issue``: all of them) and by opcode of the
    instructions whose address lies in ``span``."""
    ops = collections.Counter(op for a, op, _ in instrs if span[0] <= a <= span[1])
    pipes = collections.Counter()
    for op, k in ops.items():
        pipes[pipe_of(op)] += k
    pipes["issue"] = sum(ops.values())
    return {"pipes": dict(sorted(pipes.items())), "opcodes": dict(sorted(ops.items()))}


def busiest(pipes: Dict[str, int]) -> Tuple[str, float]:
    """(pipe, clocks an agent on one SM) of the pipe that takes longest."""
    return max(((p, pipes.get(p, 0) / lanes) for p, lanes in PIPE_LANES.items()),
               key=lambda kv: kv[1])


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "cuobjdump")
    try:
        import triton

        candidates.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
                          / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("no cuobjdump found (CUDA toolkit or Triton's package)")


def kernel_counts(kernel: str = "infection_update", dump: Optional[str] = None) -> dict:
    """Build ``csrc/<kernel>.cu`` if needed, read its SASS, and return for
    each function the agent loop's span and counts (None where a function
    has no such loop)."""
    from sbr_tpu_torch import _build

    lib = _build.build_all([kernel])[kernel]
    listing = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True,
                             text=True, check=True, timeout=120).stdout
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(listing)
    out = {}
    for name, instrs in parse(listing).items():
        span = agent_loop(instrs)
        if span is None:
            out[name] = None
            continue
        c = count(instrs, span)
        pipe, clocks = busiest(c["pipes"])
        out[name] = {"span": [hex(span[0]), hex(span[1])], "instructions": len(instrs),
                     "busiest": pipe, "clocks_per_agent_sm": clocks, **c}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", nargs="?", default="infection_update")
    ap.add_argument("--dump", default=None, help="write the whole SASS listing here")
    args = ap.parse_args(argv)
    print(json.dumps(kernel_counts(args.kernel, args.dump)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
