"""Whole-RC-iteration and whole-loop kernels (CUDA) and their plain twins.

Counterpart of ``frei_tpu.ops.iteration_pallas``.  One RC step is the
chemistry (a clipped log10 T interpolation of layer ln-MMR tables), the
opacity (T-interpolation weights against layer tables), an emit sweep,
its temperature update, an absorb sweep at the updated temperatures and
its update, with the per-column ``done`` freeze applied to the flux
slabs.  The loop form runs the whole fixed-horizon RC loop: history
rows, the incremental zero-crossing counters, max|dT| per iteration,
per-column iteration counts and per-layer converged flags.  Both forms
solve one shared planet or a population, one planet per column, with
per-column F_toa rows, dtau factors and g, m_bar and alpha.

Each form has

* a kernel written by hand for Hopper, ``csrc/iteration.cu``, built
  with ``nvcc`` at first use into ``csrc/build/`` and loaded with ctypes;
* a wrapper (:func:`rc_iteration_kernel`, :func:`rc_loop_kernel`) that
  launches the kernel for CUDA tensors, raises if it cannot, uses the
  plain twin for CPU tensors, and counts its launches in ``.launches``,
  those with per-column rows in ``.per_column`` and the species its plan
  leaves to L2 reads in ``.l2_species``;
* a plain PyTorch twin (:func:`rc_iteration_plain`,
  :func:`rc_loop_plain`) with the same signature and outputs;
* a launch plan per kernel (:func:`plan_iteration`): threads,
  wavelengths per thread, the depth of the kernels' shared-memory ring
  (0 or 1) and the rows it stages, and the shared-memory bytes, which
  the kernels check against their own layout; the ring is sized by the
  blocks per SM the card holds (:func:`card_blocks_per_sm`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from .. import constants as const
from ..diag import telemetry
from ..rt.physics import PhysicsParams
from ..rt.sweeps import top_pressure
from .cuda_build import BUILD_DIR, CSRC, build_library, load_library
from .sweep_cuda import (SMEM_LIMIT, SMEM_TARGET, SweepConsts, _align16,
                         _block_shape, absorb_epilogue, absorb_plain,
                         emit_epilogue, emit_plain, make_sweep_consts)

__all__ = ["IterationPack", "make_iteration_pack", "rc_iteration_plain",
           "rc_loop_plain", "rc_iteration_kernel", "rc_loop_kernel",
           "build", "IterationPlan", "plan_iteration",
           "iteration_smem_bytes", "card_blocks_per_sm"]

_SOURCE = CSRC / "iteration.cu"
_LIB_PATH = BUILD_DIR / "libfrei_iteration.so"
_LN10 = 2.302585092994046  # ln(10)
#: per-layer vectors of the kernels' working type in shared memory
_LAYER_VECS = 9


class IterationPack(NamedTuple):
    """Per-configuration constants of the iteration kernels, contiguous
    on the solve's device: for one shared planet, or for a population
    with the per-column F_toa and dtau-factor rows of ``sc``."""

    sc: SweepConsts          # spectral rows + dtau factors
    k_tgrid: torch.Tensor    # (nT,) kappa table temperature grid [K]
    k_tab: torch.Tensor      # (L, S, nT, W) layer opacity tables
    c_tgrid: torch.Tensor    # (nTc,) chemistry log10 T grid
    c_tab: torch.Tensor      # (L, S, nTc) layer ln-MMR tables
    p1e: torch.Tensor        # (L-1,) emit p1 row [barye]
    p2e: torch.Tensor        # (L-1,) emit p2 row (extrapolated top)
    p1a: torch.Tensor        # (L-1,) absorb p1 row
    p2a: torch.Tensor        # (L-1,) absorb p2 row


def make_iteration_pack(consts, params: PhysicsParams, k_tgrid, k_tab,
                        chem) -> IterationPack:
    """Pack from the solver's ``RTConstants`` and a κ model's
    ``iteration_hook = (k_tgrid, k_tab, chem)``; ``k_tab`` is the
    (L, S*nT, W) layer table of ``opacity.tables.make_layer_tables``.
    A population's per-column ``consts.F_toa`` (B, W) and ``params.g``
    (B, 1) give the pack (B, W) and (B, L-1) rows
    (``sweep_cuda.make_sweep_consts``).  Spanned ``frei.iteration.pack``."""
    with telemetry.span("frei.iteration.pack"):
        p = consts.pressures
        dtype, device = k_tab.dtype, k_tab.device
        c_tgrid, c_tab = chem.layer_ln_mmr_tables(p)
        L, _, W = k_tab.shape
        nT = k_tgrid.shape[0]
        S = k_tab.shape[1] // nT

        def dev(x):
            return torch.as_tensor(x, dtype=dtype, device=device).contiguous()
        return IterationPack(
            sc=make_sweep_consts(consts, params),
            k_tgrid=dev(k_tgrid),
            k_tab=dev(k_tab.reshape(L, S, nT, W)),
            c_tgrid=dev(c_tgrid),
            c_tab=dev(torch.movedim(torch.as_tensor(c_tab), 1, 2)),
            p1e=dev(p[1:]), p2e=dev(top_pressure(p)),
            p1a=dev(p[:-1]), p2a=dev(p[1:]),
        )


def _pressures(pack: IterationPack):
    """The layer pressures (L,) from the pack's absorb rows."""
    return torch.cat([pack.p1a, pack.p2a[-1:]])


def _pinned(params: PhysicsParams, like) -> PhysicsParams:
    """Physics parameters as tensors in the solve's dtype and device, as
    the kernels see them: scalars 0-d, per-column values as given."""
    def t(x):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return PhysicsParams(g=t(params.g), m_bar=t(params.m_bar),
                         alpha=t(params.alpha), n_dof=params.n_dof)


# --------------------------------------------------------------------------
# Plain PyTorch twins
# --------------------------------------------------------------------------

def _interp_weights(coord, x, clip: bool):
    """Twin of ``iteration_pallas._interp_weights_nd``: one-hot linear
    interpolation weights (..., n) of ``x`` (...) on the ascending grid
    ``coord`` (n,); clipped into the grid (``clip``), or zero-filled
    outside it with the 8-ULP hull tolerance."""
    n = coord.shape[0]
    x = x[..., None]
    if clip:
        x = torch.clamp(x, coord[0], coord[n - 1])
    i = torch.clamp((x >= coord).sum(-1, keepdim=True) - 1, 0, n - 2)
    c_lo, c_hi = coord[i], coord[i + 1]
    f = (x - c_lo) / (c_hi - c_lo)
    if clip:
        ok = 1.0
    else:
        eps = 8.0 * torch.finfo(x.dtype).eps
        lo = coord[0] - eps * torch.abs(coord[0])
        hi = coord[n - 1] + eps * torch.abs(coord[n - 1])
        ok = ((x >= lo) & (x <= hi)).to(x.dtype)
    w_lo = (1.0 - f) * ok
    w_hi = f * ok
    col = torch.arange(n, device=x.device)
    return (torch.where(col == i, w_lo, 0.0)
            + torch.where(col == i + 1, w_hi, 0.0))


def _sweep_kappa(temps, pack: IterationPack):
    """Total opacity (B, L, W) of every layer at (B, L) temperatures:
    chemistry and the species-weighted table contraction of
    ``iteration_pallas`` (`:178-200`, `:368-390`), plus sigma."""
    oh_T = _interp_weights(pack.k_tgrid, temps, clip=False)   # (B, L, nT)
    logT = torch.log(temps) * (1.0 / _LN10)
    oh_c = _interp_weights(pack.c_tgrid, logT, clip=True)     # (B, L, nTc)
    kk = None
    for s in range(pack.k_tab.shape[1]):
        mmr = torch.exp((oh_c * pack.c_tab[:, s]).sum(-1))[..., None]
        part = torch.einsum("blt,ltw->blw", oh_T, pack.k_tab[:, s])
        kk = part * mmr if kk is None else kk + part * mmr
    return kk + pack.sc.sigma


def rc_iteration_plain(temps, F_up, F_down, done, pack: IterationPack,
                       params: PhysicsParams, with_sums=False):
    """Plain twin of the iteration kernel (`_kernel`,
    `iteration_pallas.py:163-294`): emit at ``temps``, T1 = temps - dT1
    (no freeze on T1), absorb at T1 on the emit's output, T2 = T1 - dT2.
    Flux rows of columns flagged in ``done`` (B,) bool come back
    unchanged.  Returns ``(T1, F_up, F_down, T2, dT2)``, plus with
    ``with_sums`` the (B, 2, 4, L-1) quadratures of the emit and the
    absorb sweep (as ``sweep_cuda.emit_plain`` / ``absorb_plain``
    return them)."""
    params = _pinned(params, temps)
    p = _pressures(pack)
    Fu1, Fd1, s_e = emit_plain(temps, F_up, F_down,
                               _sweep_kappa(temps, pack), pack.sc, done)
    T1, _ = emit_epilogue(temps, s_e, p, params)
    Fu2, Fd2, s_a = absorb_plain(T1, Fu1, Fd1, _sweep_kappa(T1, pack),
                                 pack.sc, done)
    T2, dT2 = absorb_epilogue(T1, s_a, p, params)
    return (T1, Fu2, Fd2, T2, dT2) + (
        (torch.stack([s_e, s_a], 1),) if with_sums else ())


def rc_loop_plain(temps, F_up, F_down, pack: IterationPack,
                  params: PhysicsParams, n_timesteps: int,
                  n_zero_crossings: int, convergence_dT: float,
                  with_sums=False):
    """Plain twin of the loop kernel (`_loop_kernel`,
    `iteration_pallas.py:297-530`, and its wrapper's return `:621-627`):
    ``n_timesteps`` RC steps over the whole batch, converged columns
    frozen by selects.  Returns ``(temps, F_up, F_down, hist (B, 2T, L),
    max_dT (B, T), n_iters (B,) int32, converged (B, L) bool)``, plus
    with ``with_sums`` the quadratures of each column's last live step,
    as :func:`rc_iteration_plain` returns them."""
    params = _pinned(params, temps)
    p = _pressures(pack)
    B, L = temps.shape
    dtype, device = temps.dtype, temps.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    fu, fd, tfin = F_up.clone(), F_down.clone(), temps.clone()
    hist, maxdt = zeros(B, 2 * n_timesteps, L), zeros(B, n_timesteps)
    niter, conv = zeros(B, L), zeros(B, L)
    sums = zeros(B, 2, 4, L - 1)
    prev_T, prev_S, flips, n_cols, done_s = (temps.clone(), zeros(B, L),
                                             zeros(B, L), zeros(B, L),
                                             zeros(B, L))

    def push(T_new, prev_T, prev_sign, flips, n_cols):
        s = torch.sign(T_new - prev_T)
        flips = flips + torch.where((n_cols >= 2.0) & (s != prev_sign),
                                    1.0, 0.0)
        prev_sign = torch.where(n_cols >= 1.0, s, prev_sign)
        return T_new, prev_sign, flips, n_cols + 1.0

    for it in range(n_timesteps):
        T = tfin
        done = done_s[:, 0] > 0.0                          # (B,)
        keep = done[:, None]
        # one RC step; the emit/absorb twins write frozen rows back
        fu, fd, s_e = emit_plain(T, fu, fd, _sweep_kappa(T, pack),
                                 pack.sc, done)
        _, dT1 = emit_epilogue(T, s_e, p, params)
        T1 = torch.where(keep, T, T - dT1)
        fu, fd, s_a = absorb_plain(T1, fu, fd, _sweep_kappa(T1, pack),
                                   pack.sc, done)
        _, dT2 = absorb_epilogue(T1, s_a, p, params)
        T2 = torch.where(keep, T, T1 - dT2)

        live = ~keep
        hist[:, 2 * it] = torch.where(live, T1, hist[:, 2 * it])
        st1 = push(T1, prev_T, prev_S, flips, n_cols)
        hist[:, 2 * it + 1] = torch.where(live, T2, hist[:, 2 * it + 1])
        st2 = push(T2, *st1)
        conv_layers = (st2[2] > n_zero_crossings) | (
            torch.abs(dT2) < convergence_dT)
        new_done = conv_layers.all(1, keepdim=True)
        maxdt[:, it] = torch.where(done, maxdt[:, it],
                                   torch.abs(dT2).amax(1))

        def sel(new, old):
            return torch.where(keep, old, new)
        tfin = sel(T2, T)
        prev_T, prev_S, flips, n_cols = (
            sel(n, o) for n, o in zip(st2, (prev_T, prev_S, flips, n_cols)))
        conv = sel(conv_layers.to(dtype), conv)
        done_s = torch.maximum(done_s, new_done.to(dtype).expand(B, L))
        niter = sel(torch.full_like(niter, it + 1), niter)
        sums = torch.where(keep[..., None, None],
                           sums, torch.stack([s_e, s_a], 1))
    return (tfin, fu, fd, hist, maxdt, niter[:, 0].to(torch.int32),
            conv > 0.5) + ((sums,) if with_sums else ())


# --------------------------------------------------------------------------
# Kernel build, load and launch
# --------------------------------------------------------------------------

class _IterArgs(ctypes.Structure):
    """Mirror of ``struct IterArgs`` in ``csrc/iteration.cu``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "temps", "F_up", "F_down", "done", "k_tgrid", "k_tab", "c_tgrid",
        "c_tab", "c1", "xrow", "sigma", "f_toa", "tw", "dtf_emit",
        "dtf_absorb", "p1e", "p2e", "p1a", "p2a", "F_up_out", "F_down_out",
        "T1", "T2", "dT2", "temps_out", "hist", "max_dT", "n_iters",
        "conv", "sums", "phys")]
        + [(name, ctypes.c_int) for name in (
            "ftoa_stride", "dtf_stride", "phys_stride")]
        + [(name, ctypes.c_double) for name in (
            "n_dof", "k_B", "sigma_sb", "convergence_dT")]
        + [(name, ctypes.c_int) for name in (
            "B", "L", "W", "S", "nT", "nTc", "n_timesteps",
            "n_zero_crossings", "threads", "npt", "depth", "rows", "smem",
            "reserved", "wpad", "whole")])


_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/iteration.cu`` (with the shared ``csrc/*.cuh``)
    into ``csrc/build/libfrei_iteration.so`` unless the library is newer
    than all of them.  Returns the compiler's output, or an empty string
    when nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


#: the library's launchers and their ctypes argument types
SIGNATURES = {name: [ctypes.POINTER(_IterArgs), ctypes.c_void_p]
              for name in ("frei_rc_iteration_f32", "frei_rc_iteration_f64",
                           "frei_rc_loop_f32", "frei_rc_loop_f64")}
SIGNATURES["frei_rc_blocks_per_sm"] = [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_int)]


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(_SOURCE, _LIB_PATH, SIGNATURES)
    return _lib


class IterationPlan(NamedTuple):
    """How the iteration kernels launch: one block of ``threads`` per
    column, each thread owning ``npt`` contiguous wavelengths; a
    shared-memory ring ``depth`` (0 or 1) layers ahead of the layer being
    computed, each slot holding ``rows`` rows (the stale flux row, then the
    two table rows of each staged species); ``smem`` bytes of dynamic
    shared memory in all."""

    threads: int
    npt: int
    depth: int
    rows: int
    smem: int


def iteration_smem_bytes(L: int, S: int, elem: int, threads: int, npt: int,
                         depth: int, rows: int) -> int:
    """Dynamic shared memory of one iteration-kernel block, the layout of
    ``csrc/iteration.cu`` (``layout``): the per-warp quadrature partials,
    the block quadratures, the per-layer vectors, both dtf orderings, the
    (L, S) mixing ratios, three int vectors and the ring of ``depth + 1``
    slots of ``rows`` rows of ``threads * npt``."""
    n = L - 1
    return (_align16((3 * n + 1) * (threads // 32) * elem)
            + _align16(4 * n * elem) + _align16(_LAYER_VECS * L * elem)
            + _align16(2 * n * elem) + _align16(L * S * elem)
            + _align16(3 * L * 4)
            + _align16((depth + 1) * rows * threads * npt * elem))


def plan_iteration(W: int, L: int, S: int, elem: int, loop: bool = False,
                   blocks_per_sm=None) -> IterationPlan:
    """The launch plan of the iteration kernel (or with ``loop`` the loop
    kernel) over (B, L, W) slabs of ``elem``-byte values with ``S``
    species.

    The iteration kernel's block shape is the sweeps'
    (``sweep_cuda._block_shape``); the loop kernel's allows 256 threads
    (2 wavelengths per thread at W = 500: at 4 its step spilled under the
    register cap and ran slower, PERF.md §5).  The ring stages the stale
    flux row and both table rows of every species one layer ahead
    (``depth`` 1, two slots).  ``blocks_per_sm(threads, npt, smem)`` gives
    the blocks of this kernel an SM holds at ``smem`` dynamic bytes (the
    card's answer, :func:`card_blocks_per_sm`, or a model of it): the ring
    stages the most species that still leave as many blocks as the flux
    row alone at depth 1 (the rest come from L2); where no depth-1 ring
    fits the card, each layer stages only its own flux row (depth 0, one
    slot).  Without ``blocks_per_sm`` (no card answers) the ring keeps
    to ``SMEM_TARGET`` bytes, in the same order of fallbacks."""
    npt, threads = _block_shape(W, 256 if loop else 128)

    def size(d, rows):
        return iteration_smem_bytes(L, S, elem, threads, npt, d, rows)

    if size(0, 1) > SMEM_LIMIT:
        raise ValueError(f"{L} layers x {S} species exceed the iteration "
                         "kernels' shared memory")
    if blocks_per_sm is None:
        def fits(n):
            return n <= SMEM_TARGET
    else:
        def blocks(n):
            return blocks_per_sm(threads, npt, n) if n <= SMEM_LIMIT else 0
        want = max(blocks(size(1, 1)), 1)

        def fits(n):
            return blocks(n) >= want
    for ss in range(S, -1, -1):
        if fits(size(1, 1 + 2 * ss)):
            return IterationPlan(threads, npt, 1, 1 + 2 * ss,
                                 size(1, 1 + 2 * ss))
    return IterationPlan(threads, npt, 0, 1, size(0, 1))


_occupancy = {}


def card_blocks_per_sm(device, elem: int, loop: bool, threads: int,
                       npt: int, smem: int) -> int:
    """Blocks per SM of the iteration (or with ``loop`` the loop) kernel
    for ``elem``-byte values at ``npt`` wavelengths per thread,
    ``threads`` per block and ``smem`` dynamic bytes, on the card of
    ``device``: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for
    the exact instantiation, asked once per key."""
    device = torch.device(device)
    key = (device.index, elem, bool(loop), threads, npt, smem)
    if key not in _occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _library().frei_rc_blocks_per_sm(
                int(elem == 8), int(bool(loop)), npt, threads, smem,
                ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {err}")
        _occupancy[key] = out.value
    return _occupancy[key]


def _card_plan(F_up, dims, loop: bool) -> IterationPlan:
    """The plan of a launch over ``F_up``, sized by its card."""
    _, L, W, S = dims[:4]
    elem = F_up.element_size()

    def blocks(threads, npt, smem):
        return card_blocks_per_sm(F_up.device, elem, loop, threads, npt,
                                  smem)
    return plan_iteration(W, L, S, elem, loop, blocks)


def _phys_rows(params: PhysicsParams, pack: IterationPack, B: int,
               like) -> torch.Tensor:
    """(g, m_bar, alpha) as the kernels read them: a (1, 3) row for one
    shared planet, or (B, 3) where any of them is per column (a scalar,
    a (B,) or a (B, 1) tensor each), in the solve's dtype and device.  A
    per-column g needs the pack's per-column dtau factors, which it
    divides."""
    cols = [torch.as_tensor(x, dtype=like.dtype, device=like.device)
            .reshape(-1, 1) for x in (params.g, params.m_bar, params.alpha)]
    n = max(c.shape[0] for c in cols)
    if n not in (1, B) or any(c.shape[0] not in (1, n) for c in cols):
        raise ValueError(f"per-column physics parameters need {B} values "
                         f"(one per column) or one, got "
                         f"{[c.shape[0] for c in cols]}")
    if cols[0].shape[0] > 1 and pack.sc.dtf_emit.ndim == 1:
        raise ValueError("a per-column g needs the pack's per-column dtau "
                         "factors: build the pack with the same params")
    return torch.cat([c.expand(n, 1) for c in cols], 1).contiguous()


def _check(temps, F_up, F_down, pack: IterationPack):
    """Check device, dtype, shape and contiguity of every argument;
    returns (B, L, W, S, nT, nTc).  The F_toa and dtau-factor rows are
    shared (1-D) or one per column."""
    B, L, W = F_up.shape
    dtype, device = F_up.dtype, F_up.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"iteration kernels take float32 or float64, "
                        f"got {dtype}")
    _, S, nT, _ = pack.k_tab.shape
    nTc = pack.c_tgrid.shape[0]
    sc = pack.sc

    def rows(x, n):
        return (B, n) if x.ndim == 2 else (n,)
    shapes = {
        "temps": (temps, (B, L)), "F_up": (F_up, (B, L, W)),
        "F_down": (F_down, (B, L, W)), "k_tgrid": (pack.k_tgrid, (nT,)),
        "k_tab": (pack.k_tab, (L, S, nT, W)),
        "c_tgrid": (pack.c_tgrid, (nTc,)), "c_tab": (pack.c_tab, (L, S, nTc)),
        "c1": (sc.c1, (W,)), "xrow": (sc.xrow, (W,)),
        "sigma": (sc.sigma, (W,)), "f_toa": (sc.f_toa, rows(sc.f_toa, W)),
        "tw": (sc.tw, (W,)),
        "dtf_emit": (sc.dtf_emit, rows(sc.dtf_emit, L - 1)),
        "dtf_absorb": (sc.dtf_absorb, rows(sc.dtf_emit, L - 1))}
    for name in ("p1e", "p2e", "p1a", "p2a"):
        shapes[name] = (getattr(pack, name), (L - 1,))
    for name, (t, shape) in shapes.items():
        if t.device != device or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the "
                            f"iteration runs in {dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if L < 3 or W > 8 * 256 or nT < 2 or nTc < 2:
        raise ValueError(f"iteration kernels need L >= 3, W <= 2048 and "
                         f"grids of >= 2 points, got L={L}, W={W}, "
                         f"nT={nT}, nTc={nTc}")
    return B, L, W, S, nT, nTc


def _args(temps, F_up, F_down, pack, phys, params, dims, plan, sums,
          **extra):
    B, L, W, S, nT, nTc = dims
    sc = pack.sc
    return _IterArgs(
        **plan._asdict(),
        sums=None if sums is None else sums.data_ptr(),
        temps=temps.data_ptr(), F_up=F_up.data_ptr(),
        F_down=F_down.data_ptr(), k_tgrid=pack.k_tgrid.data_ptr(),
        k_tab=pack.k_tab.data_ptr(), c_tgrid=pack.c_tgrid.data_ptr(),
        c_tab=pack.c_tab.data_ptr(), c1=sc.c1.data_ptr(),
        xrow=sc.xrow.data_ptr(), sigma=sc.sigma.data_ptr(),
        f_toa=sc.f_toa.data_ptr(), tw=sc.tw.data_ptr(),
        dtf_emit=sc.dtf_emit.data_ptr(),
        dtf_absorb=sc.dtf_absorb.data_ptr(), p1e=pack.p1e.data_ptr(),
        p2e=pack.p2e.data_ptr(), p1a=pack.p1a.data_ptr(),
        p2a=pack.p2a.data_ptr(), phys=phys.data_ptr(),
        ftoa_stride=W if sc.f_toa.ndim == 2 else 0,
        dtf_stride=L - 1 if sc.dtf_emit.ndim == 2 else 0,
        phys_stride=3 if phys.shape[0] > 1 else 0,
        n_dof=float(params.n_dof), k_B=const.k_B, sigma_sb=const.sigma_sb,
        B=B, L=L, W=W, S=S, nT=nT, nTc=nTc, **extra)


def _launch(name, device, dtype, args):
    fn = getattr(_library(), f"frei_rc_{name}_"
                             f"{'f32' if dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _count(wrapper, S: int, plan: IterationPlan, args: _IterArgs):
    """Count a launch, whether it read per-column rows, and the species
    its plan reads from L2."""
    wrapper.launches += 1
    wrapper.per_column += int(bool(args.ftoa_stride or args.dtf_stride
                                   or args.phys_stride))
    wrapper.l2_species += S - (plan.rows - 1) // 2


def _iteration(temps, F_up, F_down, done, pack, params, with_sums):
    """Check the arguments, allocate the outputs and launch the iteration
    kernel on the current stream (no synchronization)."""
    dims = _check(temps, F_up, F_down, pack)
    B, L = dims[:2]
    if (done.dtype != torch.bool or done.device != F_up.device
            or tuple(done.shape) != (B,) or not done.is_contiguous()):
        raise ValueError("done must be a contiguous (B,) bool tensor on "
                         "the iteration's device")
    Fu, Fd = torch.empty_like(F_up), torch.empty_like(F_down)
    T1, T2, dT2 = (torch.empty_like(temps) for _ in range(3))
    sums = temps.new_empty((B, 2, 4, L - 1)) if with_sums else None
    plan = _card_plan(F_up, dims, loop=False)
    phys = _phys_rows(params, pack, B, temps)
    args = _args(temps, F_up, F_down, pack, phys, params, dims, plan, sums,
                 done=done.data_ptr(), F_up_out=Fu.data_ptr(),
                 F_down_out=Fd.data_ptr(), T1=T1.data_ptr(),
                 T2=T2.data_ptr(), dT2=dT2.data_ptr())
    _launch("iteration", F_up.device, F_up.dtype, args)
    _count(rc_iteration_kernel, dims[3], plan, args)
    return (T1, Fu, Fd, T2, dT2) + ((sums,) if with_sums else ())


def rc_iteration_kernel(temps, F_up, F_down, done, pack: IterationPack,
                        params: PhysicsParams, with_sums=False):
    """One RC step: the CUDA kernel for CUDA tensors,
    :func:`rc_iteration_plain` for CPU tensors.  ``done`` is a (B,) bool
    freeze mask.  Returns ``(T1, F_up, F_down, T2, dT2)``, plus the
    quadratures diagnostic with ``with_sums``.  ``params``' g, m_bar and
    alpha are scalars or per column (B,) or (B, 1), as the pack's rows
    are shared or per column; pass tensors on the solve's device, as the
    solver does: a Python float is uploaded at every launch."""
    if F_up.device.type == "cpu":
        return rc_iteration_plain(temps, F_up, F_down, done, pack, params,
                                  with_sums)
    if not F_up.is_cuda:
        raise RuntimeError(f"no iteration kernel for device {F_up.device}")
    with telemetry.span("frei.kernel.iteration"):
        return _iteration(temps, F_up, F_down, done, pack, params, with_sums)


def rc_loop_kernel(temps, F_up, F_down, pack: IterationPack,
                   params: PhysicsParams, n_timesteps: int,
                   n_zero_crossings: int, convergence_dT: float,
                   with_sums=False):
    """The whole fixed-horizon RC loop: the CUDA kernel for CUDA tensors,
    :func:`rc_loop_plain` for CPU tensors.  Returns ``(temps, F_up,
    F_down, hist, max_dT, n_iters, converged)``, plus the last live
    step's quadratures with ``with_sums``.  ``params`` as for
    :func:`rc_iteration_kernel`."""
    if F_up.device.type == "cpu":
        return rc_loop_plain(temps, F_up, F_down, pack, params, n_timesteps,
                             n_zero_crossings, convergence_dT, with_sums)
    if not F_up.is_cuda:
        raise RuntimeError(f"no loop kernel for device {F_up.device}")
    with telemetry.span("frei.kernel.loop"):
        dims = _check(temps, F_up, F_down, pack)
        B, L = dims[:2]
        if n_timesteps < 0:
            raise ValueError(f"n_timesteps must be >= 0, got {n_timesteps}")
        Fu, Fd = torch.empty_like(F_up), torch.empty_like(F_down)
        tout = torch.empty_like(temps)
        hist = temps.new_empty((B, 2 * n_timesteps, L))
        maxdt = temps.new_empty((B, n_timesteps))
        n_iters = torch.empty((B,), dtype=torch.int32, device=temps.device)
        conv = torch.empty((B, L), dtype=torch.bool, device=temps.device)
        sums = temps.new_empty((B, 2, 4, L - 1)) if with_sums else None
        plan = _card_plan(F_up, dims, loop=True)
        phys = _phys_rows(params, pack, B, temps)
        args = _args(temps, F_up, F_down, pack, phys, params, dims, plan,
                     sums,
                     F_up_out=Fu.data_ptr(), F_down_out=Fd.data_ptr(),
                     temps_out=tout.data_ptr(), hist=hist.data_ptr(),
                     max_dT=maxdt.data_ptr(), n_iters=n_iters.data_ptr(),
                     conv=conv.data_ptr(),
                     convergence_dT=float(convergence_dT),
                     n_timesteps=int(n_timesteps),
                     n_zero_crossings=min(int(n_zero_crossings), 2 ** 31 - 1))
        _launch("loop", F_up.device, F_up.dtype, args)
        _count(rc_loop_kernel, dims[3], plan, args)
    return (tout, Fu, Fd, hist, maxdt, n_iters, conv) + (
        (sums,) if with_sums else ())


for _w in (rc_iteration_kernel, rc_loop_kernel):
    _w.launches = _w.per_column = _w.l2_species = 0
