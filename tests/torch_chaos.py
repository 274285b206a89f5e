"""Shared helpers of the chaos-drill tests (tests/test_torch_chaos*.py):
run one drill of ``python -m sbr_tpu_torch.resilience.chaos`` on the CPU,
and read the reference's drills (``sbr_tpu/resilience/chaos.py``) with
``ast``, without importing the JAX package.

A drill runs as a subprocess with ``--device cpu --json``, one intra-op
thread for it and every process it starts, bounded by ``TIMEOUT_S``; the
drill itself bounds and kills its children. It runs at a raised priority
(``nice`` -10, where the system allows it), which its children inherit:
the audit drill holds its audited run's p99 to the audit-off run's, and
the suite's other workers, each with a thread a core, would otherwise
starve one run more than the other."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "sbr_tpu" / "resilience" / "chaos.py"
PORT = REPO / "sbr_tpu_torch" / "resilience" / "chaos.py"
TIMEOUT_S = 900

# each drill's function in the two modules (the reference's base drill is
# its `main`)
DRILLS = {
    "base": ("main", "main_base", None),
    "churn": ("main_churn", "main_churn", "--churn"),
    "fleet": ("main_fleet", "main_fleet", "--fleet"),
    "audit": ("main_audit", "main_audit", "--audit"),
    "prewarm": ("main_prewarm", "main_prewarm", "--prewarm"),
}


def run_drill(name: str, out: Path) -> tuple:
    """(exit code, verdict document, seconds) of one drill on the CPU."""
    import time

    flag = DRILLS[name][2]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "sbr_tpu_torch.resilience.chaos", "--device", "cpu",
            "--json", "--out", str(out), *([flag] if flag else [])]
    t0 = time.monotonic()
    proc = subprocess.Popen(argv, env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        try:  # before the drill starts a child, which inherits it
            os.setpriority(os.PRIO_PROCESS, proc.pid, -10)
        except OSError:
            pass  # the system refuses: the inherited priority
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    seconds = time.monotonic() - t0
    try:
        doc = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        doc = {}
    if not doc.get("ok"):
        sys.stderr.write(err[-6000:])
    return proc.returncode, doc, seconds


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def check_keys(path: Path, function: str) -> list:
    """The keys a drill function assigns in its ``checks`` dict, in order."""
    keys = []
    for node in ast.walk(_function(_tree(path), function)):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                        and target.value.id == "checks"
                        and isinstance(target.slice, ast.Constant)):
                    keys.append((node.lineno, target.slice.value))
    # a key assigned on two branches counts once
    return list(dict.fromkeys(key for _, key in sorted(keys)))


def constant(path: Path, name: str):
    """A module-level literal (``NAME = {...}`` or ``NAME = dict(...)``)."""
    for node in _tree(path).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id == name):
            value = node.value
            if isinstance(value, ast.Call) and getattr(value.func, "id", "") == "dict":
                return {kw.arg: ast.literal_eval(kw.value) for kw in value.keywords}
            return ast.literal_eval(value)
    raise KeyError(name)


def reference_function(name: str):
    """A standard-library-only function of the reference module, compiled
    on its own."""
    namespace: dict = {}
    exec(compile(ast.Module(body=[_function(_tree(REFERENCE), name)], type_ignores=[]),
                 str(REFERENCE), "exec"), namespace)
    return namespace[name]
