"""Grouped trapezoid rebin kernel (CUDA) and its plain twin.

Counterpart of ``frei_tpu.ops.rebin_pallas``.  The rebin maps an (R, N)
slab of high-resolution samples on an ascending wavelength grid to
(R, B) per-bin trapezoid integrals (``ops.rebin.resort_rebin``
semantics).  It has

* a per-store :class:`RebinPlan`: the float64 host bin codes, panel
  widths and each bin's contiguous sample range, computed once by
  :func:`make_rebin_plan` and reused for every row chunk;
* a kernel written by hand for Hopper, ``csrc/rebin.cu``, built with
  ``nvcc`` at first use into ``csrc/build/`` and loaded with ctypes;
* a wrapper, :func:`rebin_kernel`, that launches the kernel for CUDA
  tensors, raises if it cannot, uses the plain twin for CPU tensors, and
  counts its launches in ``.launches``;
* the plain twin :func:`rebin_plain`, ``ops.rebin.resort_rebin`` on the
  plan's codes and widths.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import BUILD_DIR, CSRC, build_library, load_library
from .rebin import bin_codes_np, resort_rebin

__all__ = ["RebinPlan", "make_rebin_plan", "rebin_plain", "rebin_kernel",
           "build"]

_SOURCE = CSRC / "rebin.cu"
_LIB_PATH = BUILD_DIR / "libfrei_rebin.so"


class RebinPlan(NamedTuple):
    """What a rebin needs of the wavelength grid, computed on the float64
    host coordinates and placed on one device."""

    codes: torch.Tensor   # (N,) int64 right-closed bin codes, -1 outside
    dx: torch.Tensor      # (N-1,) float64 panel widths diff(x)
    start: torch.Tensor   # (B,) int64 first sample of each bin
    stop: torch.Tensor    # (B,) int64 one past each bin's last sample
    edges: torch.Tensor   # (B+1,) float64 bin edges

    @property
    def n_samples(self) -> int:
        return self.codes.shape[0]

    @property
    def n_bins(self) -> int:
        return self.start.shape[0]


def make_rebin_plan(x, edges, device="cpu") -> RebinPlan:
    """Plan the rebin of samples at ``x`` (N,) into the right-closed bins
    of ``edges`` (B + 1,), both ascending.  Bin ``b`` holds the samples
    ``start[b] <= i < stop[b]`` (those with ``edges[b] < x <=
    edges[b + 1]``), the same set :func:`ops.rebin.bin_codes_np` assigns
    to it."""
    x = np.asarray(x, np.float64)
    edges = np.asarray(edges, np.float64)
    if x.ndim != 1 or edges.ndim != 1 or edges.shape[0] < 2:
        raise ValueError("x must be 1-D and edges 1-D with >= 2 entries")
    if np.any(np.diff(x) < 0) or np.any(np.diff(edges) <= 0):
        raise ValueError("the rebin needs ascending samples and strictly "
                         "ascending bin edges")
    start = np.searchsorted(x, edges[:-1], side="right")
    stop = np.searchsorted(x, edges[1:], side="right")

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return RebinPlan(codes=dev(bin_codes_np(x, edges), torch.int64),
                     dx=dev(np.diff(x), torch.float64),
                     start=dev(start, torch.int64),
                     stop=dev(stop, torch.int64),
                     edges=dev(edges, torch.float64))


def rebin_plain(values, plan: RebinPlan):
    """Plain twin of the kernel: ``resort_rebin`` of ``values`` (R, N) on
    the plan's codes and widths, summed in the dtype of ``values``."""
    return resort_rebin(values, None, plan.edges, codes=plan.codes,
                        dx=plan.dx)


# --------------------------------------------------------------------------
# Kernel build, load and launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/rebin.cu`` into ``csrc/build/libfrei_rebin.so``
    unless the library is newer than its inputs.  Returns the compiler's
    output, or an empty string when nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


#: the library's launchers and their ctypes argument types: five
#: pointers, R, N, B, the stream
SIGNATURES = {name: ([ctypes.c_void_p] * 5
                     + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_void_p])
              for name in ("frei_rebin_f32", "frei_rebin_f64")}


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(_SOURCE, _LIB_PATH, SIGNATURES)
    return _lib


def _check(values, plan: RebinPlan):
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the rebin takes float32 or float64 rows, got "
                        f"{values.dtype}")
    if values.ndim != 2 or values.shape[1] != plan.n_samples:
        raise ValueError(f"values have shape {tuple(values.shape)}, "
                         f"expected (R, {plan.n_samples})")
    for name, t, dtype in (("codes", plan.codes, torch.int64),
                           ("dx", plan.dx, torch.float64),
                           ("start", plan.start, torch.int64),
                           ("stop", plan.stop, torch.int64)):
        if t.device != values.device or t.dtype != dtype:
            raise TypeError(f"plan {name} is {t.dtype} on {t.device}; "
                            f"expected {dtype} on {values.device}")


def rebin_kernel(values, plan: RebinPlan):
    """Per-bin trapezoid integrals (R, B) of ``values`` (R, N): the CUDA
    kernel for CUDA tensors (float32 or float64 rows, summed in float64,
    returned in the rows' dtype), :func:`rebin_plain` for CPU tensors."""
    _check(values, plan)
    if values.device.type == "cpu":
        return rebin_plain(values, plan)
    if not values.is_cuda:
        raise RuntimeError(f"no rebin kernel for device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    R, N = values.shape
    B = plan.n_bins
    out = values.new_empty((R, B))
    if R == 0 or B == 0:
        return out
    fn = getattr(_library(), "frei_rebin_f32" if values.dtype ==
                 torch.float32 else "frei_rebin_f64")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), plan.dx.data_ptr(),
                 plan.start.data_ptr(), plan.stop.data_ptr(),
                 out.data_ptr(), R, N, B, stream)
    if err != 0:
        raise RuntimeError(f"rebin kernel launch failed: CUDA error {err}")
    rebin_kernel.launches += 1
    return out


rebin_kernel.launches = 0
