"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, and is loaded with ``ctypes``. Nothing builds at
import time: the first launch of a kernel builds it, or a caller builds
them all up front with ``build_all`` (one ``nvcc`` per source, all started
together). A failed build raises; nothing falls back to the plain versions.

``LAUNCHES`` counts kernel launches by name. Each kernel wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process per source, run in parallel. Returns
    each library's path; the compiler's output (with ``-Xptxas -v``'s
    register counts) is kept beside it as ``.log``. Raises on a failure."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    todo = [name for name, path in paths.items() if not path.exists()]
    procs: List[tuple] = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate(timeout=600)
            paths[name].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
