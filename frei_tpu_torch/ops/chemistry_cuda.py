"""Equilibrium chemistry table build kernel (CUDA) and its wrapper.

The kernel, ``csrc/chemistry.cu``, runs the whole table build of
``chemistry.fastchem.FastChemTorch`` on the card in one launch: one
thread-block cluster, one warp per (T, P) point, the rows walked from the
hottest down with the build's refinish and settle decisions taken at
cluster barriers.  It
replaces no TPU kernel (the JAX package's build is XLA); its plain
version is the build's own Gauss-Seidel sweep, ``fastchem._GaussSeidel``,
which the host build runs.  This module has

* :func:`sweep_lists`, the plain sweep's stoichiometry in the layout the
  kernel reads (CSR lists of each species' elements, of each element's
  species in the sweep's order, and of the ions), on the device;
* :func:`table_plan`, the launch's blocks and warps;
* :func:`table_kernel`, the wrapper: it checks its tensors (CUDA,
  float64, shapes), launches the kernel and counts its launches in
  ``.launches``.  It has no host path: the host build is the plain
  version's.

The library is built with ``nvcc`` and loaded at the first launch only,
so nothing that never builds a table on the card loads it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import BUILD_DIR, CSRC, build_library, load_library

__all__ = ["MAX_ELEMENT_TERMS", "SweepLists", "TableBuild", "TablePlan",
           "sweep_lists", "table_plan", "table_kernel", "build"]

_SOURCE = CSRC / "chemistry.cu"
_LIB_PATH = BUILD_DIR / "libfrei_chemistry.so"

#: terms (species plus its own) an element's Newton solve may have: six a
#: lane of a warp (``kMaxItems`` in ``csrc/chemistry.cu``)
MAX_ELEMENT_TERMS = 6 * 32

#: warps of a row in all (``kMaxWarps`` in ``csrc/chemistry.cu``), and
#: of one block: a row of 32 points is a cluster of 8 blocks
_MAX_WARPS, _WARPS_PER_BLOCK = 32, 4


class SweepLists(NamedTuple):
    """The stoichiometry of a ``fastchem._prepare_static`` as the kernel
    reads it, on one device (int32 indices, float64 values)."""

    ln_eps: torch.Tensor    # (E,) ln abundance, -1e30 where it is zero
    sp_off: torch.Tensor    # (S + 1,) species i's pairs sp_*[off[i]:off[i+1]]
    sp_el: torch.Tensor     # its elements
    sp_nu: torch.Tensor     # its signed counts
    el_j: torch.Tensor      # (n,) the elements in sweep order
    el_off: torch.Tensor    # (n + 1,) element e's terms aug_*[off[e]:off[e+1]]
    aug_sp: torch.Tensor    # the species, -1 first: the element's own term
    aug_nu: torch.Tensor    # their counts, 1 for the own term
    aug_lnnu: torch.Tensor  # ln of the counts
    cat_sp: torch.Tensor    # species with a negative electron count
    cat_nu: torch.Tensor
    an_sp: torch.Tensor     # species with a positive electron count
    an_nu: torch.Tensor
    ln_eps_sum: float       # ln sum(eps), the atomic start's ln M offset
    eps_H: float
    ie: int
    iH: int
    iH2: int                # -1 without H2


def sweep_lists(static, gs, device) -> SweepLists:
    """The kernel's lists from the plain sweep's constants ``gs`` (a
    float64 ``fastchem._GaussSeidel`` on the host: its elements' species,
    ions and targets, which both solves then share) and the atomic
    start's constants of ``static`` (``fastchem._prepare_static``).
    Raises ``ValueError`` where the kernel cannot take the table: a real
    element with a negative count, or with more than
    :data:`MAX_ELEMENT_TERMS` terms."""
    nu = gs.nuT.T                                # (S, E)
    aug_sp, aug_nu, aug_lnnu, el_off = [], [], [], [0]
    for j, sub in gs.subsets:
        if sub.nz.shape[0] != sub.pos.shape[0]:
            raise ValueError(f"element {j} has a negative count: the "
                             "kernel takes signed counts for the electron "
                             "only")
        if sub.nu_aug.shape[0] > MAX_ELEMENT_TERMS:
            raise ValueError(f"element {j} has {sub.nu_aug.shape[0]} "
                             f"terms; the kernel takes {MAX_ELEMENT_TERMS}")
        aug_sp += [[-1], sub.pos]
        aug_nu.append(sub.nu_aug)
        aug_lnnu += [[0.0], sub.ln_nu]
        el_off.append(el_off[-1] + sub.nu_aug.shape[0])
    pairs = torch.nonzero(nu)                    # row-major: species, element

    def cat(dtype, *parts):
        return torch.cat([torch.as_tensor(x, dtype=dtype).reshape(-1)
                          for x in parts]).to(device)

    def i32(*parts):
        return cat(torch.int32, *parts)

    def f64(*parts):
        return cat(torch.float64, *parts)

    eps = torch.as_tensor(static["eps"], dtype=torch.float64)
    return SweepLists(
        ln_eps=f64(gs.ln_eps),
        sp_off=i32([0], torch.cumsum((nu != 0).sum(1), 0)),
        sp_el=i32(pairs[:, 1]), sp_nu=f64(nu[pairs[:, 0], pairs[:, 1]]),
        el_j=i32([j for j, _ in gs.subsets]), el_off=i32(el_off),
        aug_sp=i32(*aug_sp), aug_nu=f64(*aug_nu), aug_lnnu=f64(*aug_lnnu),
        cat_sp=i32(gs.cat), cat_nu=f64(gs.nu_cat),
        an_sp=i32(gs.an), an_nu=f64(gs.nu_an),
        ln_eps_sum=float(torch.log(torch.sum(eps))),
        eps_H=float(eps[static["iH"]]), ie=int(gs.ie), iH=int(static["iH"]),
        iH2=-1 if static["iH2"] is None else int(static["iH2"]))


class TableBuild(NamedTuple):
    """What the kernel returns, on the host except ``ln_p``."""

    ln_p: torch.Tensor       # (nT, nP, n_idx) float64 on the device
    residual: np.ndarray     # (nT,) each row's final closure residual
    sweeps: np.ndarray       # (nT,) sweeps each row ran
    refinished: np.ndarray   # (nT,) bool: the row ran the cold sweeps again
    failed_row: int          # the row that did not settle, or -1
    moved: float             # that row's last move


class TablePlan(NamedTuple):
    """How the kernel launches: one cluster of ``blocks`` blocks of
    ``warps`` warps, one warp a point of the row."""

    warps: int
    blocks: int


def table_plan(nP: int) -> TablePlan:
    """A warp for each of the row's ``nP`` points up to 32 (wider rows
    give a warp several points in turn), four a block (one a scheduler
    of an SM: the sweep is a chain of dependent steps, so a warp runs
    fastest alone on its scheduler), as many blocks as that takes."""
    total = min(nP, _MAX_WARPS)
    warps = min(_WARPS_PER_BLOCK, total)
    return TablePlan(warps=warps, blocks=-(-total // warps))


class _ChemArgs(ctypes.Structure):
    """Mirror of ``struct ChemArgs`` in ``csrc/chemistry.cu``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "lnK", "ln_P", "ln_eps", "sp_off", "sp_el", "sp_nu", "el_j",
        "el_off", "aug_sp", "aug_nu", "aug_lnnu", "cat_sp", "cat_nu",
        "an_sp", "an_nu", "out_idx", "state", "out", "row_res",
        "row_sweeps", "row_refin", "fail")]
        + [(name, ctypes.c_double) for name in (
            "ln_eps_sum", "eps_H", "refinish_tol", "settle_tol")]
        + [(name, ctypes.c_int) for name in (
            "nT", "nP", "S", "E", "n_order", "n_cat", "n_an", "n_idx", "ie",
            "iH", "iH2", "n_cold", "n_warm", "n_inner", "settle",
            "settle_sweeps", "settle_blocks", "warps", "blocks")])


#: the library's launcher and its ctypes argument types
SIGNATURES = {"frei_chem_table": [ctypes.POINTER(_ChemArgs),
                                  ctypes.c_void_p]}

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/chemistry.cu`` into
    ``csrc/build/libfrei_chemistry.so`` unless the library is newer than
    its inputs.  Returns the compiler's output, or an empty string when
    nothing was built."""
    return build_library(_SOURCE, _LIB_PATH)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(_SOURCE, _LIB_PATH, SIGNATURES)
    return _lib


def _check(name, t, dtype):
    if not torch.is_tensor(t) or not t.is_cuda:
        where = t.device if torch.is_tensor(t) else type(t).__name__
        raise RuntimeError(f"the chemistry table kernel runs on a CUDA "
                           f"device: {name} is on {where}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def table_kernel(lists: SweepLists, lnK: torch.Tensor, ln_P: torch.Tensor,
                 out_idx: torch.Tensor, *, n_cold: int, n_warm: int,
                 n_inner: int, refinish_tol: float, settle: bool,
                 settle_sweeps: int, settle_tol: float,
                 settle_blocks: int) -> TableBuild:
    """Build the (nT, nP) table on the card: ``lnK`` (nT, S) is ln K at
    each row's temperature (rows in ascending T; the build walks them
    from the last), ``ln_P`` (nP,) ln of each column's pressure in bar,
    ``out_idx`` (n_idx,) int32 indices into [elements..., species...] of
    the log pressures to return.  The stopping rule's parameters are
    the build's (``fastchem._build_vmr_table``).  Synchronizes once to
    read the row counters back."""
    _check("lnK", lnK, torch.float64)
    _check("ln_P", ln_P, torch.float64)
    _check("out_idx", out_idx, torch.int32)
    if lnK.dim() != 2 or ln_P.dim() != 1 or out_idx.dim() != 1:
        raise ValueError(f"lnK (nT, S), ln_P (nP,) and out_idx (n_idx,): "
                         f"got {tuple(lnK.shape)}, {tuple(ln_P.shape)} and "
                         f"{tuple(out_idx.shape)}")
    (nT, S), nP, device = lnK.shape, ln_P.shape[0], lnK.device
    for name in SweepLists._fields:
        t = getattr(lists, name)
        if torch.is_tensor(t):
            _check(name, t, torch.float64 if t.is_floating_point()
                   else torch.int32)
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, lnK on {device}")
    if out_idx.device != ln_P.device or ln_P.device != device:
        raise ValueError("lnK, ln_P and out_idx must be on one device")
    E = lists.ln_eps.shape[0]
    if nT < 1 or nP < 1 or lists.sp_off.shape[0] != S + 1:
        raise ValueError(f"a table of {nT} x {nP} points on {S} species: "
                         f"the lists hold {lists.sp_off.shape[0] - 1}")
    if min(n_cold, n_warm) < 1 or (settle and min(settle_sweeps,
                                                  settle_blocks) < 1):
        raise ValueError("every group of sweeps needs at least one sweep")
    n_idx = out_idx.shape[0]
    plan = table_plan(nP)
    state = torch.empty((nP, E + 1), dtype=torch.float64, device=device)
    out = torch.empty((nT, nP, n_idx), dtype=torch.float64, device=device)
    row_res = torch.empty(nT, dtype=torch.float64, device=device)
    counts = torch.zeros((2, nT), dtype=torch.int32, device=device)
    fail = torch.tensor([-1.0, 0.0], dtype=torch.float64, device=device)
    ptrs = {"lnK": lnK, "ln_P": ln_P, "out_idx": out_idx, "state": state,
            "out": out, "row_res": row_res, "row_sweeps": counts[0],
            "row_refin": counts[1], "fail": fail}
    ptrs.update((n, getattr(lists, n)) for n in SweepLists._fields
                if torch.is_tensor(getattr(lists, n)))
    args = _ChemArgs(
        **{n: t.data_ptr() for n, t in ptrs.items()},
        ln_eps_sum=lists.ln_eps_sum, eps_H=lists.eps_H,
        refinish_tol=refinish_tol, settle_tol=settle_tol, nT=nT, nP=nP, S=S,
        E=E, n_order=lists.el_j.shape[0], n_cat=lists.cat_sp.shape[0],
        n_an=lists.an_sp.shape[0], n_idx=n_idx, ie=lists.ie, iH=lists.iH,
        iH2=lists.iH2, n_cold=n_cold, n_warm=n_warm, n_inner=n_inner,
        settle=int(settle), settle_sweeps=settle_sweeps,
        settle_blocks=settle_blocks, warps=plan.warps, blocks=plan.blocks)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.frei_chem_table(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"chemistry table kernel launch failed: CUDA "
                           f"error {err} ({nT} x {nP} points, {plan})")
    table_kernel.launches += 1
    row_res, counts, fail = row_res.cpu().numpy(), counts.cpu().numpy(), \
        fail.cpu().numpy()
    return TableBuild(ln_p=out, residual=row_res, sweeps=counts[0],
                      refinished=counts[1].astype(bool),
                      failed_row=int(fail[0]), moved=float(fail[1]))


table_kernel.launches = 0
