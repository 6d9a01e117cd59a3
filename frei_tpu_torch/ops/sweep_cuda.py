"""Batched emit/absorb sweep kernels (CUDA) and their plain twins.

Counterpart of ``frei_tpu.ops.sweep_pallas``.  One sweep reads the
stale flux state, runs the layer recurrence and writes both updated
flux slabs plus a (B, 4, L-1) block of bolometric quadratures; the
temperature epilogue (flux divergence -> adaptive timestep -> dT) runs
in plain PyTorch on those quadratures, reusing ``rt.physics``.

Each sweep direction has

* a kernel written by hand for Hopper, ``csrc/sweep.cu``, built with
  ``nvcc`` at first use into ``csrc/build/`` and loaded with ctypes;
* a wrapper (:func:`emit_kernel`, :func:`absorb_kernel`) that launches
  the kernel for CUDA tensors, raises if it cannot, uses the plain twin
  for CPU tensors, and counts its launches in ``.launches``;
* a plain PyTorch twin (:func:`emit_plain`, :func:`absorb_plain`) with
  the same signature and outputs, which the CPU tests hold against the
  JAX package and the card's smoke run holds the kernel against.

The opacity argument ``kappa`` is either the materialized (B, L, W)
total-opacity slab or a pair ``(ohs, tab)`` of (B, L, K) T-interpolation
weight rows and (L, K, W) layer tables (``opacity.tables``), in which
case the kernel contracts them itself and adds sigma.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from .. import constants as const
from ..rt import physics
from ..rt.sweeps import top_pressure
from .twostream import two_stream_couplers_g0

__all__ = ["SweepConsts", "make_sweep_consts", "emit_kernel",
           "absorb_kernel", "emit_plain", "absorb_plain",
           "emit_epilogue", "absorb_epilogue", "emit_sweep_cuda",
           "absorb_sweep_cuda", "build"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "sweep.cu"
_BUILD_DIR = _CSRC / "build"
_LIB_PATH = _BUILD_DIR / "libfrei_sweep.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class SweepConsts(NamedTuple):
    """Per-configuration constants of the sweep kernels, all 1-D and
    contiguous on the solve's device, for one shared planet."""

    dtf_emit: torch.Tensor    # (L-1,) (p1 - p2) / g per emit-swept layer
    dtf_absorb: torch.Tensor  # (L-1,) the same for the absorb ordering
    c1: torch.Tensor          # (W,) Planck prefactor 2 h c^2 / lam^5
    xrow: torch.Tensor        # (W,) Planck exponent scale h c / (k lam)
    sigma: torch.Tensor       # (W,) Rayleigh scattering opacity
    f_toa: torch.Tensor       # (W,) top-of-atmosphere flux
    tw: torch.Tensor          # (W,) trapezoid quadrature weights


def make_sweep_consts(consts, params: physics.PhysicsParams) -> SweepConsts:
    """Kernel constants from the solver's ``RTConstants``.  Per-column
    gravity or F_toa (population mode) is not ported yet."""
    if torch.as_tensor(params.g).ndim or consts.F_toa.ndim != 1:
        raise NotImplementedError(
            "per-column g / F_toa in the sweep kernels (population "
            "mode) is ROADMAP queue 1 item 9")
    p = consts.pressures
    lam = consts.lam_cm
    g = params.g
    return SweepConsts(
        dtf_emit=((p[1:] - top_pressure(p)) / g).contiguous(),
        dtf_absorb=((p[:-1] - p[1:]) / g).contiguous(),
        c1=(2.0 * const.h * const.c ** 2 / lam ** 5).contiguous(),
        xrow=(const.hc_over_k / lam).contiguous(),
        sigma=consts.sigma_scat.contiguous(),
        f_toa=consts.F_toa.contiguous(),
        tw=consts.trapz_w.contiguous(),
    )


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def _planck_row(sc: SweepConsts, T_col):
    """B_lambda of one layer for a (B, 1) column of temperatures."""
    return sc.c1 / torch.expm1(sc.xrow * (1.0 / T_col))


def _kappa_slab(kappa, sc: SweepConsts):
    if isinstance(kappa, tuple):
        ohs, tab = kappa
        return torch.einsum("blk,lkw->blw", ohs, tab) + sc.sigma
    return kappa


def _frozen(done, F):
    if done is None:
        return torch.zeros((F.shape[0], 1), dtype=torch.bool,
                           device=F.device)
    return done.reshape(-1, 1)


def emit_plain(temps, F_up, F_down, kappa, sc: SweepConsts, done=None,
               with_dtaus=False):
    """Plain twin of the emit kernel: one bottom-to-top sweep.

    Returns ``(F_up_new, F_down_new, sums)``; ``sums[:, q, i]`` holds
    the quadratures of swept layer ``i + 1``: outgoing F_up, incoming
    F_down, incoming F_up, outgoing F_down.  ``with_dtaus`` appends the
    (B, L, W) dtaus diagnostic (``rt.sweeps.emit_dtaus``)."""
    B, L, W = F_up.shape
    k_all = _kappa_slab(kappa, sc)
    frozen = _frozen(done, F_up)
    fu = F_up.clone()           # rows 0-1 are copied through
    fd = F_down.clone()         # row 0 is copied through
    sums = F_up.new_empty((B, 4, L - 1))
    dtaus = torch.ones_like(F_up) if with_dtaus else None
    tw = sc.tw
    z = F_up[:, 1]
    B1 = _planck_row(sc, temps[:, 1:2])
    sz = None
    for i in range(L - 1):
        l = i + 1
        kk = k_all[:, l]
        dtau = kk * sc.dtf_emit[i]
        if with_dtaus:
            dtaus[:, l] = dtau
        om = sc.sigma / (sc.sigma + kk)
        if i < L - 2:
            B2 = _planck_row(sc, temps[:, l + 1:l + 2])
            F2d = F_down[:, l + 1]
        else:                   # T2 = T[-1] at the top; incoming F_TOA
            B2 = B1
            F2d = sc.f_toa.expand(B, W)
        cp = two_stream_couplers_g0(dtau, om, B1, B2)
        u = z
        z = cp.a * u + (-cp.b * F2d + cp.s_up)
        F1d = cp.a * F2d - cp.b * u + cp.s_down
        if i < L - 2:           # the top layer's outgoing flux is not stored
            fu[:, l + 1] = torch.where(frozen, F_up[:, l + 1], z)
        fd[:, l] = torch.where(frozen, F_down[:, l], F1d)
        su = (u * tw).sum(1) if sz is None else sz
        sz = (z * tw).sum(1)
        sums[:, 0, i] = sz
        sums[:, 1, i] = (F2d * tw).sum(1)
        sums[:, 2, i] = su
        sums[:, 3, i] = (F1d * tw).sum(1)
        B1 = B2
    return (fu, fd, sums) + ((dtaus,) if with_dtaus else ())


def absorb_plain(temps, F_up, F_down, kappa, sc: SweepConsts, done=None):
    """Plain twin of the absorb kernel: one top-to-bottom sweep over
    layers L-2 .. 0.  Returns ``(F_up_new, F_down_new, sums)`` with
    ``sums[:, q, i]``: outgoing F_up, incoming F_down, incoming F_up,
    outgoing F_down of swept layer ``i``."""
    B, L, W = F_up.shape
    k_all = _kappa_slab(kappa, sc)
    frozen = _frozen(done, F_up)
    fu = F_up.clone()           # row 0 is copied through
    fd = F_down.clone()         # row L-1 is copied through
    sums = F_up.new_empty((B, 4, L - 1))
    tw = sc.tw
    d = F_down[:, L - 1]
    B2 = _planck_row(sc, temps[:, L - 1:L])
    sd = None
    for i in range(L - 2, -1, -1):
        kk = k_all[:, i]
        dtau = kk * sc.dtf_absorb[i]
        om = sc.sigma / (sc.sigma + kk)
        B1 = _planck_row(sc, temps[:, i:i + 1])
        cp = two_stream_couplers_g0(dtau, om, B1, B2)
        F1u = F_up[:, i]
        d_next = d
        d = cp.a * d_next + (-cp.b * F1u + cp.s_down)
        F2u = cp.a * F1u - cp.b * d_next + cp.s_up
        fd[:, i] = torch.where(frozen, F_down[:, i], d)
        fu[:, i + 1] = torch.where(frozen, F_up[:, i + 1], F2u)
        s_dn = (d_next * tw).sum(1) if sd is None else sd
        sd = (d * tw).sum(1)
        sums[:, 0, i] = (F2u * tw).sum(1)
        sums[:, 1, i] = s_dn
        sums[:, 2, i] = (F1u * tw).sum(1)
        sums[:, 3, i] = sd
        B2 = B1
    return fu, fd, sums


# --------------------------------------------------------------------------
# Kernel build, load and launch
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the sweep kernels need the "
                           "CUDA toolkit to build")
    return found


def build() -> str:
    """Compile ``csrc/sweep.cu`` into ``csrc/build/libfrei_sweep.so``
    unless a library newer than the source is there.  Returns the
    compiler's output (ptxas register and shared-memory report), or an
    empty string when nothing was built.

    The library is compiled to a per-process temporary name and moved
    into place, so concurrent processes never load a partial file."""
    if (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime):
        return ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, _LIB_PATH)
    finally:
        if tmp.exists():
            tmp.unlink()
    return proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            for name in ("frei_emit_sweep_f32", "frei_emit_sweep_f64",
                         "frei_absorb_sweep_f32", "frei_absorb_sweep_f64"):
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 17
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(direction: str, temps, F_up, F_down, kappa, sc: SweepConsts,
            done, with_dtaus=False):
    """Check the arguments, allocate the outputs and launch one sweep
    on the current stream (no synchronization)."""
    B, L, W = F_up.shape
    dtype, device = F_up.dtype, F_up.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep kernels take float32 or float64, got {dtype}")
    fused = isinstance(kappa, tuple)
    if fused:
        ohs, tab = kappa
        K = ohs.shape[-1]
        kap = None
        shapes = {"ohs": (ohs, (B, L, K)), "tab": (tab, (L, K, W))}
        if L * K * (F_up.element_size() + 4) + 4 * L > 200 * 1024:
            raise ValueError(f"weight rows of {L} x {K} exceed the "
                             "kernel's shared memory")
    else:
        ohs = tab = None
        K = 0
        kap = kappa
        shapes = {"kappa": (kappa, (B, L, W))}
    dtf = sc.dtf_emit if direction == "emit" else sc.dtf_absorb
    shapes.update({
        "temps": (temps, (B, L)), "F_up": (F_up, (B, L, W)),
        "F_down": (F_down, (B, L, W)), "dtf": (dtf, (L - 1,)),
        "c1": (sc.c1, (W,)), "xrow": (sc.xrow, (W,)),
        "sigma": (sc.sigma, (W,)), "f_toa": (sc.f_toa, (W,)),
        "tw": (sc.tw, (W,))})
    for name, (t, shape) in shapes.items():
        if t.device != device or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the "
                            f"sweep runs in {dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if done is not None:
        if (done.dtype != torch.bool or done.device != device
                or tuple(done.shape) != (B,) or not done.is_contiguous()):
            raise ValueError("done must be a contiguous (B,) bool tensor "
                             "on the sweep's device")
    if L < 3 or W > 8 * 256:
        raise ValueError(f"sweep kernels need L >= 3 and W <= 2048, got "
                         f"L={L}, W={W}")

    F_up_out = torch.empty_like(F_up)
    F_down_out = torch.empty_like(F_down)
    sums = F_up.new_empty((B, 4, L - 1))
    dtaus = torch.empty_like(F_up) if with_dtaus else None
    lib = _library()
    fn = getattr(lib, f"frei_{direction}_sweep_"
                      f"{'f32' if dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(dtf.data_ptr(), _ptr(done), temps.data_ptr(), _ptr(ohs),
                 _ptr(tab), _ptr(kap), F_up.data_ptr(), F_down.data_ptr(),
                 sc.c1.data_ptr(), sc.xrow.data_ptr(), sc.sigma.data_ptr(),
                 sc.f_toa.data_ptr(), sc.tw.data_ptr(),
                 F_up_out.data_ptr(), F_down_out.data_ptr(),
                 sums.data_ptr(), _ptr(dtaus), B, L, W, K, stream)
    if err != 0:
        raise RuntimeError(f"{direction} sweep kernel launch failed: "
                           f"CUDA error {err}")
    return (F_up_out, F_down_out, sums) + ((dtaus,) if with_dtaus else ())


def _dispatch(direction, plain, temps, F_up, F_down, kappa, sc, done,
              **kw):
    if F_up.is_cuda:
        out = _launch(direction, temps, F_up, F_down, kappa, sc, done, **kw)
        wrapper = emit_kernel if direction == "emit" else absorb_kernel
        wrapper.launches += 1
        return out
    if F_up.device.type == "cpu":
        return plain(temps, F_up, F_down, kappa, sc, done, **kw)
    raise RuntimeError(f"no sweep kernel for device {F_up.device}")


def emit_kernel(temps, F_up, F_down, kappa, sc: SweepConsts, done=None,
                with_dtaus=False):
    """Emit sweep: the CUDA kernel for CUDA tensors, :func:`emit_plain`
    for CPU tensors.  Returns ``(F_up_new, F_down_new, sums)``, plus the
    dtaus diagnostic when ``with_dtaus``."""
    return _dispatch("emit", emit_plain, temps, F_up, F_down, kappa, sc,
                     done, with_dtaus=with_dtaus)


def absorb_kernel(temps, F_up, F_down, kappa, sc: SweepConsts, done=None):
    """Absorb sweep: the CUDA kernel for CUDA tensors,
    :func:`absorb_plain` for CPU tensors."""
    return _dispatch("absorb", absorb_plain, temps, F_up, F_down, kappa,
                     sc, done)


emit_kernel.launches = 0
absorb_kernel.launches = 0


# --------------------------------------------------------------------------
# Sweeps with the temperature epilogue
# --------------------------------------------------------------------------

def _dT(sums, T1, T2, p1, p2, params):
    bu2, bd2, bu1, bd1 = sums.unbind(1)
    div, dz = physics.div_bol_net_flux(bu2, bd2, bu1, bd1,
                                       T1, T2, p1, p2, params)
    dt = physics.radiative_timestep(T1, T2, p1, p2, div, dz, params)
    return physics.delta_temperature(div, dt, T1, p1, p2, params)


def emit_epilogue(temps, sums, pressures, params):
    """Temperature update of an emit sweep from its quadratures
    (`frei_tpu/ops/sweep_pallas.py:669-680`).  Returns
    ``(temps - dT, dT)`` with ``dT[:, 0] == 0``."""
    p = pressures
    T2 = torch.cat([temps[:, 2:], temps[:, -1:]], dim=1)
    dT_swept = _dT(sums, temps[:, 1:], T2, p[1:], top_pressure(p), params)
    dT = torch.cat([torch.zeros_like(temps[:, :1]), dT_swept], dim=1)
    return temps - dT, dT


def absorb_epilogue(temps, sums, pressures, params):
    """Temperature update of an absorb sweep from its quadratures
    (`frei_tpu/ops/sweep_pallas.py:693-704`), ``dT[:, -1] == 0``."""
    p = pressures
    dT_swept = _dT(sums, temps[:, :-1], temps[:, 1:], p[:-1], p[1:],
                   params)
    dT = torch.cat([dT_swept, torch.zeros_like(temps[:, :1])], dim=1)
    return temps - dT, dT


def emit_sweep_cuda(temps, F_up, F_down, k_all, sc: SweepConsts,
                    pressures, params, done=None, with_dtaus=False):
    """Batched emit sweep through :func:`emit_kernel` plus the
    temperature epilogue.  Returns ``(F_up, F_down, temps - dT, dT)``,
    plus the dtaus diagnostic when ``with_dtaus``; ``done`` (B,) bool
    freezes those columns' flux rows."""
    F_up_new, F_down_new, sums, *dtaus = emit_kernel(
        temps, F_up, F_down, k_all, sc, done, with_dtaus=with_dtaus)
    return (F_up_new, F_down_new,
            *emit_epilogue(temps, sums, pressures, params), *dtaus)


def absorb_sweep_cuda(temps, F_up, F_down, k_all, sc: SweepConsts,
                      pressures, params, done=None):
    """Batched absorb sweep (mirror of :func:`emit_sweep_cuda`)."""
    F_up_new, F_down_new, sums = absorb_kernel(temps, F_up, F_down, k_all,
                                               sc, done)
    return (F_up_new, F_down_new,
            *absorb_epilogue(temps, sums, pressures, params))
