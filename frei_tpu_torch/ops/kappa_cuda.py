"""Batched bilinear kappa lookup kernel (CUDA) and its plain twin.

Counterpart of ``frei_tpu.ops.kappa_pallas``: the total opacity of
``opacity.tables.kappa_from_stack`` for a batch of (T, P) lookup points
— every species' bilinear (T, P) interpolation, zero outside the hull,
weighted by the mass mixing ratios and summed, plus the Rayleigh term.
It has

* a kernel written by hand for Hopper, ``csrc/kappa.cu``, built with
  ``nvcc`` at first use into ``csrc/build/`` and loaded with ctypes;
* a wrapper, :func:`kappa_kernel`, that computes the lower corner, the
  fractions and the hull mask in torch (``opacity.tables._axis_weights``,
  as the JAX wrapper does around its kernel), launches the kernel for
  CUDA tensors, raises if it cannot, uses the plain twin for CPU
  tensors, and counts its launches in ``.launches``;
* the plain twin :func:`kappa_plain`, the 4-point gather lookup.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..opacity.tables import OpacityStack, _axis_weights, _kappa_gather
from .cuda_build import BUILD_DIR, CSRC, build_library, load_library

__all__ = ["kappa_plain", "kappa_kernel", "build"]

_SOURCE = CSRC / "kappa.cu"
_LIB_PATH = BUILD_DIR / "libfrei_kappa.so"


def kappa_plain(stack: OpacityStack, mmr, temperature, pressure_cgs,
                sigma_scat):
    """Plain twin: the MMR-weighted species sum of the gather
    ``interp_tp`` plus sigma.  ``mmr`` is (S,) + B for lookup points of
    shape B; returns ``(k_total (B + (W,)), sigma_scat)``."""
    return _kappa_gather(stack, mmr, temperature, pressure_cgs, sigma_scat)


# --------------------------------------------------------------------------
# Kernel build, load and launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/kappa.cu`` into ``csrc/build/libfrei_kappa.so``
    unless the library is newer than its inputs.  Returns the compiler's
    output, or an empty string when nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            sig = ([ctypes.c_void_p] * 7
                   + [ctypes.c_int64] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
            _lib = load_library(_SOURCE, _LIB_PATH, {
                "frei_kappa_f32": sig, "frei_kappa_f64": sig})
    return _lib


def _check(stack: OpacityStack, sigma_scat):
    values = stack.values
    dtype, device = values.dtype, values.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kappa kernel takes float32 or float64 tables, "
                        f"got {dtype}")
    S, nT, nP, W = values.shape
    if nT < 2:
        raise ValueError("the kappa kernel interpolates in temperature: the "
                         f"stack needs nT >= 2, got {nT}")
    for name, t, shape in (("temps", stack.temps, (nT,)),
                           ("press_cgs", stack.press_cgs, (nP,)),
                           ("sigma_scat", sigma_scat, (W,))):
        if t.device != device or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the "
                            f"lookup runs in {dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not (values.is_contiguous() and sigma_scat.is_contiguous()):
        raise ValueError("the stack's values and sigma_scat must be "
                         "contiguous")


def kappa_kernel(stack: OpacityStack, mmr, temperature, pressure_cgs,
                 sigma_scat):
    """Total opacity at lookup points of shape B: the CUDA kernel for a
    stack on a CUDA device, :func:`kappa_plain` for one on the CPU.
    ``mmr`` is (S,) + B (broadcast to it), ``sigma_scat`` (W,).  Returns
    ``(k_total (B + (W,)), sigma_scat)``."""
    values = stack.values
    if values.device.type == "cpu":
        return kappa_plain(stack, mmr, temperature, pressure_cgs,
                           sigma_scat)
    if not values.is_cuda:
        raise RuntimeError(f"no kappa kernel for device {values.device}")
    _check(stack, sigma_scat)
    dtype, device = values.dtype, values.device
    S, nT, nP, W = values.shape
    temperature, pressure_cgs = torch.broadcast_tensors(
        torch.as_tensor(temperature, dtype=dtype, device=device),
        torch.as_tensor(pressure_cgs, dtype=dtype, device=device))
    shape = tuple(temperature.shape)
    N = temperature.numel()
    mmr = torch.as_tensor(mmr, dtype=dtype, device=device)
    if mmr.shape[0] != S:
        raise ValueError(f"mmr has {mmr.shape[0]} species, the stack {S}")
    ti, tf, t_ok = _axis_weights(stack.temps, temperature)
    pj, pf, p_ok = _axis_weights(stack.press_cgs, pressure_cgs)
    idx = (ti * nP + pj).reshape(N).to(torch.int32)
    frac = torch.stack([tf.reshape(N), pf.reshape(N)], dim=1).contiguous()
    mask = (t_ok & p_ok).reshape(N).contiguous()
    mmr_pts = mmr.broadcast_to((S,) + shape).reshape(S, N).t().contiguous()
    out = values.new_empty((N, W))
    fn = getattr(_library(), "frei_kappa_f32" if dtype == torch.float32
                 else "frei_kappa_f64")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(idx.data_ptr(), frac.data_ptr(), mask.data_ptr(),
                 mmr_pts.data_ptr(), values.data_ptr(),
                 sigma_scat.data_ptr(), out.data_ptr(), N, S, nT, nP, W,
                 stream)
    if err != 0:
        raise RuntimeError(f"kappa kernel launch failed: CUDA error {err}")
    kappa_kernel.launches += 1
    return out.reshape(shape + (W,)), sigma_scat


kappa_kernel.launches = 0
