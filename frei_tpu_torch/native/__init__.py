"""Native (C++) host kernels, loaded through ctypes.

A copy of ``frei_tpu.native``: the grouped trapezoid rebin of
``csrc/rebin_host.cc``, compiled on first use with g++ (plain
``extern "C"`` + ctypes, no pybind11) into ``csrc/build/`` and threaded
over table rows.  It is the ETL's ``"native"`` engine
(``opacity/etl.py``): ingest and rebin stream through CPU threads while
the card runs columns.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

__all__ = ["native_available", "grouped_trapezoid_native", "build_native"]

_SOURCE = CSRC / "rebin_host.cc"
_LIB_PATH = BUILD_DIR / "libfrei_rebin_host.so"
_lib = None
_lib_lock = threading.Lock()


def build_native(force: bool = False):
    """Compile the native library unless it is newer than its source.
    Returns the library's path."""
    if _LIB_PATH.exists() and not force and \
            _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return _LIB_PATH
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a per-process temp name and os.replace into place:
    # concurrent processes (pytest-xdist workers) may both build, and a
    # partially-written library with a fresh mtime would make every
    # later build skip recompiling while CDLL fails.
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
        "-shared", "-pthread", str(_SOURCE), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if tmp.exists():
            tmp.unlink()
    return _LIB_PATH


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build_native()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.bin_codes.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bin_codes.restype = None
            lib.grouped_trapz.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.grouped_trapz.restype = None
            _lib = lib
    return _lib


def native_available() -> bool:
    """True when the host library builds (g++ present) and loads."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def grouped_trapezoid_native(values, x, edges, n_threads=None):
    """(R, N) float32 samples on grid ``x`` -> (R, B) per-bin trapezoid
    integrals, accumulated in float64; the same-bin-pair semantics of
    :func:`frei_tpu_torch.ops.rebin.resort_rebin`."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    x = np.ascontiguousarray(x, dtype=np.float64)
    edges = np.ascontiguousarray(edges, dtype=np.float64)
    R, N = values.shape
    if x.shape != (N,):
        raise ValueError(f"x has shape {x.shape}, expected ({N},)")
    B = edges.shape[0] - 1
    codes = np.empty(N, dtype=np.int32)
    lib.bin_codes(_ptr(x, ctypes.c_double), N,
                  _ptr(edges, ctypes.c_double), B + 1,
                  _ptr(codes, ctypes.c_int32))
    out = np.zeros((R, B), dtype=np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.grouped_trapz(_ptr(values, ctypes.c_float),
                      _ptr(x, ctypes.c_double),
                      _ptr(codes, ctypes.c_int32),
                      _ptr(out, ctypes.c_float),
                      R, N, B, int(n_threads))
    return out
