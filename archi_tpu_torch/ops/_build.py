"""Build the CUDA kernels in ``archi_tpu_torch/csrc`` at first CUDA use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/lib<name>.so``, which the
ops modules load with ``ctypes``.  Nothing is built when the package is
imported: the first kernel launch on a CUDA tensor builds (or ``build()``
does, for every source at once, with all ``nvcc`` processes started
together).  A library is rebuilt when a source in ``csrc/`` is newer than it.
A failed build raises; there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: compiler output of the last build of each source (register and
#: shared-memory use from ``-Xptxas -v``)
BUILD_LOGS: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(p) for p in
                 glob.glob(os.path.join(CSRC, "*.cu*")))
    return newest > os.path.getmtime(lib)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _build_locked(names) -> None:
    stale = [n for n in names if _stale(n)]
    if not stale:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in stale:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:  # wait for every process before raising
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names=None) -> float:
    """Compile the given sources (default: all) that are stale, in
    parallel; returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        _build_locked(sources() if names is None else list(names))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
        return lib
