"""Build and load the port's CUDA libraries (nvcc by hand, ctypes).

Each library is one ``csrc/*.cu`` file compiled with ``nvcc`` for
``sm_90a`` into ``csrc/build/`` at first use.  The file may include the
shared headers ``csrc/*.cuh``, so a library counts as stale when it is
older than its source or than any of those headers.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_library", "load_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit to build")
    return found


def _inputs(source: Path) -> list:
    """Every file the library is built from: the source and the shared
    headers beside it."""
    return [source, *sorted(source.parent.glob("*.cuh"))]


def build_library(source: Path, lib: Path, flags=()) -> str:
    """Compile ``source`` into ``lib`` unless ``lib`` is newer than the
    source and every shared header; ``flags`` are extra nvcc arguments
    (e.g. ``-D`` settings of a trial build).  Returns the compiler's
    output (ptxas register and shared-memory report), or an empty string
    when nothing was built.

    The library is compiled to a per-process temporary name and moved
    into place, so concurrent processes never load a partial file."""
    if (lib.exists() and lib.stat().st_mtime
            >= max(f.stat().st_mtime for f in _inputs(source))):
        return ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(source.parent), "-o",
           str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return proc.stdout + proc.stderr


def load_library(source: Path, lib: Path, signatures: dict):
    """Build if stale, load with ctypes and set each function's
    ``argtypes`` from ``signatures`` (name -> list of ctypes types); every
    function returns a CUDA error code as ``int``."""
    build_library(source, lib)
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle
