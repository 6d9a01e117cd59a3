"""Batched bilinear kappa lookup kernel (CUDA), its plan and their twins.

Counterpart of ``frei_tpu.ops.kappa_pallas``: the total opacity of
``opacity.tables.kappa_from_stack`` for a batch of (T, P) lookup points
— every species' bilinear (T, P) interpolation, zero outside the hull,
weighted by the mass mixing ratios and summed, plus the Rayleigh term.
It has

* a kernel written by hand for Hopper, ``csrc/kappa.cu``, built with
  ``nvcc`` at first use into ``csrc/build/`` and loaded with ctypes: a
  plan on the device (each point's axis weights and its (T, P) cell, the
  points counted and sorted by cell into work items of up to
  :data:`ITEM_POINTS` points), then one block per work item that reads
  its cell's corner rows once into shared memory for all its points;
* a wrapper, :func:`kappa_kernel`, that launches the plan and the kernel
  for CUDA tensors, raises if it cannot, uses the plain twin for CPU
  tensors, and counts its calls in ``.launches``;
* the plain twin :func:`kappa_plain`, the 4-point gather lookup, and the
  plan's plain twin :func:`kappa_plan_plain`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ..opacity.tables import OpacityStack, _axis_weights, _kappa_gather
from .cuda_build import BUILD_DIR, CSRC, build_library, load_library

__all__ = ["ITEM_POINTS", "KappaPlan", "kappa_plain", "kappa_plan_plain",
           "kappa_kernel", "build"]

_SOURCE = CSRC / "kappa.cu"
_LIB_PATH = BUILD_DIR / "libfrei_kappa.so"

#: lookup points of one cell that one block of the kernel takes at most
ITEM_POINTS = 32


class KappaPlan(NamedTuple):
    """How the kernel groups N lookup points on an (nT, nP) table, with
    M = nT nP cells and bucket M for the points outside the hull."""

    key: torch.Tensor           # (N,) int32: cell i nP + j, or M outside
    frac: torch.Tensor          # (N, 2): (tf, pf) of ``_axis_weights``
    offsets: torch.Tensor       # (M + 2,) int32: bucket b: order[o[b]:o[b+1]]
    item_offsets: torch.Tensor  # (M + 2,) int32: bucket b's first item; total
    order: torch.Tensor         # (N,) int32: point ids, bucket by bucket


def kappa_plain(stack: OpacityStack, mmr, temperature, pressure_cgs,
                sigma_scat):
    """Plain twin: the MMR-weighted species sum of the gather
    ``interp_tp`` plus sigma.  ``mmr`` is (S,) + B for lookup points of
    shape B; returns ``(k_total (B + (W,)), sigma_scat)``."""
    return _kappa_gather(stack, mmr, temperature, pressure_cgs, sigma_scat)


def _points(stack: OpacityStack, temperature, pressure_cgs):
    """The lookup points as two flat tensors of the stack's type and
    device, and their broadcast shape."""
    dtype, device = stack.values.dtype, stack.values.device
    temperature, pressure_cgs = torch.broadcast_tensors(
        torch.as_tensor(temperature, dtype=dtype, device=device),
        torch.as_tensor(pressure_cgs, dtype=dtype, device=device))
    shape = tuple(temperature.shape)
    return (temperature.reshape(-1).contiguous(),
            pressure_cgs.reshape(-1).contiguous(), shape)


def kappa_plan_plain(stack: OpacityStack, temperature, pressure_cgs,
                     item_points: int = ITEM_POINTS) -> KappaPlan:
    """Plain twin of the kernel's plan: ``_axis_weights`` on both axes,
    the bucket keys, their counts scanned into bucket and work-item
    offsets, and a stable sort of the keys (the kernel's counting sort
    leaves the order inside a bucket open)."""
    _, nT, nP, _ = stack.values.shape
    M = nT * nP
    t, p, _ = _points(stack, temperature, pressure_cgs)
    ti, tf, t_ok = _axis_weights(stack.temps, t)
    pj, pf, p_ok = _axis_weights(stack.press_cgs, p)
    key = torch.where(t_ok & p_ok, ti * nP + pj, M)
    counts = torch.bincount(key, minlength=M + 1)
    zero = counts.new_zeros(1)
    items = (counts + item_points - 1) // item_points
    return KappaPlan(
        key=key.to(torch.int32), frac=torch.stack([tf, pf], dim=1),
        offsets=torch.cat([zero, counts.cumsum(0)]).to(torch.int32),
        item_offsets=torch.cat([zero, items.cumsum(0)]).to(torch.int32),
        order=torch.sort(key, stable=True).indices.to(torch.int32))


# --------------------------------------------------------------------------
# Kernel build, load and launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()

#: the launchers' ctypes signatures: ten pointers, N, five ints, the
#: stream
SIGNATURES = {name: ([ctypes.c_void_p] * 10
                     + [ctypes.c_int64] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
              for name in ("frei_kappa_f32", "frei_kappa_f64")}


def build() -> str:
    """Compile ``csrc/kappa.cu`` into ``csrc/build/libfrei_kappa.so``
    unless the library is newer than its inputs.  Returns the compiler's
    output, or an empty string when nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(_SOURCE, _LIB_PATH, SIGNATURES)
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
    if not (values.is_contiguous() and sigma_scat.is_contiguous()
            and stack.temps.is_contiguous()
            and stack.press_cgs.is_contiguous()):
        raise ValueError("the stack's values, axes and sigma_scat must be "
                         "contiguous")


def _launch(stack: OpacityStack, mmr, temperature, pressure_cgs,
            sigma_scat):
    """Run the plan and the lookup on a CUDA stack, with work items of up
    to :data:`ITEM_POINTS` points; returns the (N, W) output, the plan as
    the device left it and the points' broadcast shape."""
    values = stack.values
    _check(stack, sigma_scat)
    dtype, device = values.dtype, values.device
    S, nT, nP, W = values.shape
    M = nT * nP
    t, p, shape = _points(stack, temperature, pressure_cgs)
    N = t.numel()
    mmr = torch.as_tensor(mmr, dtype=dtype, device=device)
    if mmr.shape[0] != S:
        raise ValueError(f"mmr has {mmr.shape[0]} species, the stack {S}")
    mmr = mmr.broadcast_to((S,) + shape).reshape(S, N).contiguous()
    out = values.new_empty((N, W))
    frac = values.new_empty((N, 2))
    scratch = torch.empty(2 * N + 3 * M + 5, dtype=torch.int32,
                          device=device)
    fn = getattr(_library(), "frei_kappa_f32" if dtype == torch.float32
                 else "frei_kappa_f64")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(t.data_ptr(), p.data_ptr(), mmr.data_ptr(),
                 stack.temps.data_ptr(), stack.press_cgs.data_ptr(),
                 values.data_ptr(), sigma_scat.data_ptr(), frac.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), N, S, nT, nP, W,
                 ITEM_POINTS, stream)
    if err != 0:
        raise RuntimeError(f"kappa kernel launch failed: CUDA error {err}")
    key, order, rest = scratch.split([N, N, 3 * M + 5])
    plan = KappaPlan(key=key, frac=frac, offsets=rest[M + 1:2 * M + 3],
                     item_offsets=rest[2 * M + 3:], order=order)
    return out, plan, shape


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
    out, _, shape = _launch(stack, mmr, temperature, pressure_cgs,
                            sigma_scat)
    kappa_kernel.launches += 1
    return out.reshape(shape + (values.shape[-1],)), sigma_scat


kappa_kernel.launches = 0

