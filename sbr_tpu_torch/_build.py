"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``_build/<name>-<hash>.so``, keyed by a hash of the
source and the flags, and is loaded with ``ctypes``. Nothing builds at
import time: the first launch of a kernel builds it, or a caller builds
them all up front with ``build_all`` (one ``nvcc`` per source, all started
together). A failed build raises; nothing falls back to the plain versions.

The host route builds ``native/<name>.cpp`` (the graph preprocessing) the
same way with ``g++`` (``build_host``, ``load_host``): it needs no CUDA
toolkit, so it builds on any machine with a C++ compiler.

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
NATIVE = Path(__file__).parent / "native"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# the host library's compiler and flags: the JAX package's native build
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-shared", "-fPIC")

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


def _lib_path(name: str, source: Path, flags) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(jobs: Dict[str, tuple], what: str) -> None:
    """Run each job's compiler, ``name: (argv up to -o, source, library
    path)``, all started together. Each writes a temporary file in
    ``BUILD_DIR`` that replaces the library path only once it is complete,
    so processes that build the same library at once stay safe; the
    compiler's output is kept beside the library as ``.log``. Raises on a
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    try:
        failed = []
        for name, (argv, source, path) in jobs.items():
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            try:
                proc = subprocess.Popen([*argv, "-o", tmp, str(source)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except OSError as exc:  # no such compiler
                os.remove(tmp)
                failed.append(f"{name}: {argv[0]} did not start: {exc}")
                continue
            procs.append((name, tmp, proc, path))
        for name, tmp, proc, path in procs:
            out, _ = proc.communicate(timeout=600)
            path.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name}: {proc.args[0]} exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))
    finally:
        for _, tmp, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process per source, run in parallel. Returns
    each library's path; the compiler's output (with ``-Xptxas -v``'s
    register counts) is kept beside it as ``.log``. Raises on a failure."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    sources = {name: CSRC / f"{name}.cu" for name in names}
    paths = {name: _lib_path(name, sources[name], NVCC_FLAGS) for name in names}
    todo = [name for name, path in paths.items() if not path.exists()]
    if todo:
        nvcc = _nvcc()
        _compile({name: ([nvcc, *NVCC_FLAGS], sources[name], paths[name]) for name in todo},
                 "kernel")
    return paths


def build_host(name: str = "graphgen") -> Path:
    """Compile the host library ``native/<name>.cpp`` with ``HOST_CXX`` and
    ``HOST_FLAGS`` if it is not built yet; returns its path. The key hashes
    the compiler's name with the flags. Raises on a failure."""
    source = NATIVE / f"{name}.cpp"
    flags = (HOST_CXX, *HOST_FLAGS)
    path = _lib_path(name, source, flags)
    if not path.exists():
        _compile({name: (list(flags), source, path)}, "host library")
    return path


def load_host(name: str = "graphgen") -> ctypes.CDLL:
    """The loaded host library ``name``, built first if needed."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            _libs[key] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel ``name``'s library, built and
    loaded on first use, with its argument types set and an int result
    (the launch's CUDA error)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
