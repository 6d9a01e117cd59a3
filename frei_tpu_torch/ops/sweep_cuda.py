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
  JAX package and the card's smoke run holds the kernel against;
* a launch plan (:func:`plan_sweep`): threads, wavelengths per thread,
  the depth of the kernel's shared-memory ring (0 or 1) and the rows it
  stages, and the shared-memory bytes, which the kernel checks against
  its own layout.

The opacity argument ``kappa`` is either the materialized (B, L, W)
total-opacity slab or a pair ``(ohs, tab)`` of (B, L, K) T-interpolation
weight rows and (L, K, W) layer tables (``opacity.tables``), in which
case the kernel contracts them itself and adds sigma.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from .. import constants as const
from ..diag import telemetry
from ..rt import physics
from ..rt.sweeps import bins_sum, top_pressure
from .cuda_build import BUILD_DIR, CSRC, build_library, load_library
from .twostream import two_stream_couplers_g0

__all__ = ["SweepConsts", "make_sweep_consts", "emit_kernel",
           "absorb_kernel", "emit_plain", "absorb_plain",
           "emit_epilogue", "absorb_epilogue", "emit_sweep_cuda",
           "absorb_sweep_cuda", "build", "SweepPlan", "plan_sweep",
           "sweep_smem_bytes"]

_SOURCE = CSRC / "sweep.cu"
_LIB_PATH = BUILD_DIR / "libfrei_sweep.so"

#: kappa rows per ring slot that a plan starts from: two compacted table
#: rows, one species of a linear T interpolation (PERF.md §5)
STAGED_KAPPA_ROWS = 2
#: a plan shrinks its ring to stay under this many bytes of shared memory
#: per block, so that the blocks the registers allow fit on an SM (six of
#: 128 threads for the float32 headline)
SMEM_TARGET = 36 * 1024
SMEM_LIMIT = 227 * 1024


class SweepConsts(NamedTuple):
    """Per-configuration constants of the sweep kernels, contiguous on the
    solve's device.  A shared planet has 1-D rows; a population (one
    planet per column) has per-column dtau factors (B, L-1) where gravity
    is per column, and a (B, W) F_toa where the irradiation is."""

    dtf_emit: torch.Tensor    # (L-1,) or (B, L-1): (p1 - p2) / g per
    #                           emit-swept layer
    dtf_absorb: torch.Tensor  # the same for the absorb ordering
    c1: torch.Tensor          # (W,) Planck prefactor 2 h c^2 / lam^5
    xrow: torch.Tensor        # (W,) Planck exponent scale h c / (k lam)
    sigma: torch.Tensor       # (W,) Rayleigh scattering opacity
    f_toa: torch.Tensor       # (W,) or (B, W) top-of-atmosphere flux
    tw: torch.Tensor          # (W,) trapezoid quadrature weights


def make_sweep_consts(consts, params: physics.PhysicsParams) -> SweepConsts:
    """Kernel constants from the solver's ``RTConstants``.  ``params.g``
    is a scalar, or per column (B, 1) as the solver normalizes it; then
    each column's dtau factors are ``(p1 - p2) / g_b``, the expression of
    the shared rows, so that column b of a population equals a
    shared-planet sweep of planet b bit for bit (the JAX package's
    kernels multiply by a per-column 1/g instead, for want of a per-layer
    lane extraction on the TPU).  ``consts.F_toa`` is (W,) or (B, W)."""
    p = consts.pressures
    lam = consts.lam_cm
    g = params.g
    if torch.as_tensor(g).ndim:
        g = g.reshape(-1, 1)
        p1e, p2e = p[None, 1:], top_pressure(p)[None]
        p1a, p2a = p[None, :-1], p[None, 1:]
    else:
        p1e, p2e, p1a, p2a = p[1:], top_pressure(p), p[:-1], p[1:]
    return SweepConsts(
        dtf_emit=((p1e - p2e) / g).contiguous(),
        dtf_absorb=((p1a - p2a) / g).contiguous(),
        c1=(2.0 * const.h * const.c ** 2 / lam ** 5).contiguous(),
        xrow=(const.hc_over_k / lam).contiguous(),
        sigma=consts.sigma_scat.contiguous(),
        f_toa=consts.F_toa.contiguous(),
        tw=consts.trapz_w.contiguous(),
    )


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def _dtf(dtf, i):
    """Layer i's dtau factor: a scalar, or a (B, 1) column."""
    return dtf[i] if dtf.ndim == 1 else dtf[:, i:i + 1]


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
        dtau = kk * _dtf(sc.dtf_emit, i)
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
        dtau = kk * _dtf(sc.dtf_absorb, i)
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


def build() -> str:
    """Compile ``csrc/sweep.cu`` (with the shared ``csrc/*.cuh``) into
    ``csrc/build/libfrei_sweep.so`` unless the library is newer than all
    of them.  Returns the compiler's output, or an empty string when
    nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


#: the library's launchers and their ctypes argument types: seventeen
#: pointers, eleven ints, the stream
SIGNATURES = {name: ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 11
                     + [ctypes.c_void_p])
              for name in ("frei_emit_sweep_f32", "frei_emit_sweep_f64",
                           "frei_absorb_sweep_f32", "frei_absorb_sweep_f64")}


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(_SOURCE, _LIB_PATH, SIGNATURES)
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


class SweepPlan(NamedTuple):
    """How one sweep launches: one block of ``threads`` per column, each
    thread owning ``npt`` wavelengths; a shared-memory ring ``depth`` (0
    or 1) layers ahead of the layer being computed, each slot holding ``rows``
    rows (the stale flux row, then kappa rows); ``smem`` bytes of dynamic
    shared memory in all."""

    threads: int
    npt: int
    depth: int
    rows: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def sweep_smem_bytes(fused: bool, L: int, K: int, elem: int, threads: int,
                     npt: int, depth: int, rows: int) -> int:
    """Dynamic shared memory of one sweep block, the layout of
    ``csrc/sweep.cu`` (``layout``): the compacted weights (fused form),
    1/T and dtf of the column, the per-warp quadrature partials and the
    ring of ``depth + 1`` slots of ``rows`` rows of ``threads * npt``."""
    lk = L * K if fused else 0
    return (_align16(lk * elem) + _align16(lk * 4)
            + _align16(L * 4 if fused else 0)
            + _align16(L * elem) + _align16((L - 1) * elem)
            + _align16((3 * (L - 1) + 1) * (threads // 32) * elem)
            + _align16((depth + 1) * rows * threads * npt * elem))


def _block_shape(W: int, most: int = 128):
    """Wavelengths per thread and threads per block (a whole number of
    warps).  Wavelengths per thread are the smallest power of two up to 8
    that leaves at most ``most`` threads: for the sweeps 128, four
    independent layer chains per thread in small blocks hide latency best
    (PERF.md §6).  The kernels take at most ``most`` threads up to 4
    wavelengths per thread and 256 at 8, so W <= 2048."""
    npt = 1
    while -(-W // npt) > most and npt < 8:
        npt *= 2
    per = -(-W // npt)
    if per > (most if npt <= 4 else 256):
        raise ValueError(f"no block shape for W={W}: more than 2048 "
                         "wavelengths")
    return npt, (per + 31) // 32 * 32


def plan_sweep(W: int, L: int, K: int, elem: int, fused: bool) -> SweepPlan:
    """The launch plan of one sweep over (B, L, W) slabs of ``elem``-byte
    values, fused (K weight rows) or materialized opacity.

    The ring stages the stale flux row and the layer's kappa rows (the
    materialized row, or ``STAGED_KAPPA_ROWS`` compacted table rows) one
    layer ahead (``depth`` 1, two slots).  Where that exceeds
    ``SMEM_TARGET`` it stages fewer kappa rows, and failing that each
    layer stages only its own flux row (depth 0, one slot)."""
    npt, threads = _block_shape(W)
    kappa_rows = min(K, STAGED_KAPPA_ROWS) if fused else 1

    def size(d, rows):
        return sweep_smem_bytes(fused, L, K, elem, threads, npt, d, rows)

    if size(0, 1) > SMEM_LIMIT:
        raise ValueError(f"weight rows of {L} x {K} exceed the kernel's "
                         "shared memory")
    for nk in range(kappa_rows, -1, -1):
        if size(1, 1 + nk) <= SMEM_TARGET:
            return SweepPlan(threads, npt, 1, 1 + nk, size(1, 1 + nk))
    return SweepPlan(threads, npt, 0, 1, size(0, 1))


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
    else:
        ohs = tab = None
        K = 0
        kap = kappa
        shapes = {"kappa": (kappa, (B, L, W))}
    dtf = sc.dtf_emit if direction == "emit" else sc.dtf_absorb
    # a population's rows: one per column, read at a stride of one row
    dtf_rows = (B, L - 1) if dtf.ndim == 2 else (L - 1,)
    ftoa_rows = (B, W) if sc.f_toa.ndim == 2 else (W,)
    shapes.update({
        "temps": (temps, (B, L)), "F_up": (F_up, (B, L, W)),
        "F_down": (F_down, (B, L, W)), "dtf": (dtf, dtf_rows),
        "c1": (sc.c1, (W,)), "xrow": (sc.xrow, (W,)),
        "sigma": (sc.sigma, (W,)), "f_toa": (sc.f_toa, ftoa_rows),
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
    plan = plan_sweep(W, L, K, F_up.element_size(), fused)

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
                 sums.data_ptr(), _ptr(dtaus), B, L, W, K,
                 (L - 1) * (dtf.ndim == 2), W * (sc.f_toa.ndim == 2),
                 *plan, stream)
    if err != 0:
        raise RuntimeError(f"{direction} sweep kernel launch failed: "
                           f"CUDA error {err}")
    return (F_up_out, F_down_out, sums) + ((dtaus,) if with_dtaus else ())


def _dispatch(direction, plain, temps, F_up, F_down, kappa, sc, done,
              **kw):
    if F_up.is_cuda:
        with telemetry.span(f"frei.kernel.{direction}"):
            out = _launch(direction, temps, F_up, F_down, kappa, sc, done,
                          **kw)
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
                    pressures, params, done=None, with_dtaus=False,
                    bins_group=None):
    """Batched emit sweep through :func:`emit_kernel` plus the
    temperature epilogue.  Returns ``(F_up, F_down, temps - dT, dT)``,
    plus the dtaus diagnostic when ``with_dtaus``; ``done`` (B,) bool
    freezes those columns' flux rows.  ``bins_group``: the process group
    of a bins-sharded solve, over which the kernel's (B, 4, L-1)
    quadratures are summed before the epilogue
    (`frei_tpu/ops/sweep_pallas.py:664-668`)."""
    F_up_new, F_down_new, sums, *dtaus = emit_kernel(
        temps, F_up, F_down, k_all, sc, done, with_dtaus=with_dtaus)
    sums = bins_sum(sums, bins_group)
    return (F_up_new, F_down_new,
            *emit_epilogue(temps, sums, pressures, params), *dtaus)


def absorb_sweep_cuda(temps, F_up, F_down, k_all, sc: SweepConsts,
                      pressures, params, done=None, bins_group=None):
    """Batched absorb sweep (mirror of :func:`emit_sweep_cuda`)."""
    F_up_new, F_down_new, sums = absorb_kernel(temps, F_up, F_down, k_all,
                                               sc, done)
    sums = bins_sum(sums, bins_group)
    return (F_up_new, F_down_new,
            *absorb_epilogue(temps, sums, pressures, params))
