"""Batched equilibrium chemistry: a FastChem-equivalent solver in PyTorch.

Counterpart of ``frei_tpu.chemistry.fastchem``.  The reference reaches
equilibrium abundances through the external C++ FastChem solver
(`frei/chemistry.py:143-173`); this module solves the law of mass action
itself over the same shipped thermochemical data (JANAF log K fits and
Asplund 2009 solar abundances in ``data/chem_tables.npz``, this package's
own copy of the JAX package's file), batched over (columns x layers)
points.

Formulation (p0 = 1 bar):

* unknowns per point: ``lam_j = ln(p_j / p0)`` for each element j
  (including the free electron) plus ``m = ln M``, the log of the
  total-nuclei normalization;
* gas species i has ``ln p_i = ln K_i(T) + sum_j nu_ij lam_j`` with
  ``ln K = a1/T + a2 ln T + a3 + a4 T + a5 T^2``;
* element conservation ``p_j + sum_i nu_ij p_i = eps_j M``, charge
  balance for the electron, and total pressure ``sum p = P``.

Algorithm: nested Gauss-Seidel with exact scalar solves (Stock et al.
2018).  Each sweep visits the elements in descending-abundance order and
solves each one's conservation equation in 1-D by safeguarded Newton (the
log-space residual is an increasing convex logsumexp in ``lam_j``), then
eliminates the electron analytically (charges are +-1: a quadratic in
``p_e``) and closes the total pressure with a secant step on ``m``.
Every sum is a max-subtracted logsumexp, so nothing overflows where
ln K ~ 800 (T = 500 K).

The JAX package sums each element's conservation over all 495 species
with a mask; here each element's Newton solve runs on the species that
contain it (1,091 (species, element) pairs with a positive count, against
28 x 495), gathered once per solve.  It is the same sum, so the two agree
to rounding, not bit for bit.  Run eagerly, a sweep is a few thousand
small tensor operations whatever the batch size, so the table build
(``FastChemTorch(mode="table")``) is bound by issuing them: on the card
it replays one sweep captured in a CUDA graph, on the host it runs them
on one thread (``build_device``).
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import constants as const
from .names import (iso_to_mass_g, iso_to_species,
                    species_name_to_fastchem_name)

__all__ = ["ChemTable", "load_chem_table", "equilibrium_log_pressures",
           "FastChemTorch", "UNKNOWN_SPECIES", "hot_loop_mmr_fn"]

_DATA = Path(__file__).parent / "data" / "chem_tables.npz"

#: sentinel index for species absent from the tables (mirrors
#: FASTCHEM_UNKNOWN_SPECIES, `chemistry.py:153`)
UNKNOWN_SPECIES = -1

_NEG = -1e30  # stand-in for -inf that survives arithmetic


class ChemTable(NamedTuple):
    """Thermochemical tables (host metadata and arrays)."""

    elements: tuple          # (E,) symbols, 'e-' last
    abundances: np.ndarray   # (E,) eps_j relative to H, e- = 0
    species: tuple           # (S,) Hill-notation gas species
    stoich: np.ndarray       # (S, E) signed element counts
    coeffs: np.ndarray       # (S, 5) ln K fit coefficients
    species_mass_amu: np.ndarray  # (S,)

    @property
    def n_elements(self) -> int:
        return len(self.elements)

    @property
    def n_species(self) -> int:
        return len(self.species)

    def species_index(self, hill_name: str) -> int:
        """Index into the combined [elements..., gas species...] output
        vector, or UNKNOWN_SPECIES (the reference's
        ``fastchem.getSpeciesIndex``, `chemistry.py:186`)."""
        if hill_name in self.elements:
            return self.elements.index(hill_name)
        if hill_name in self.species:
            return self.n_elements + self.species.index(hill_name)
        return UNKNOWN_SPECIES


def load_chem_table(path=_DATA) -> ChemTable:
    d = np.load(path, allow_pickle=False)
    return ChemTable(
        elements=tuple(str(e) for e in d["elements"]),
        abundances=d["abundances"],
        species=tuple(str(s) for s in d["species"]),
        stoich=d["stoich"].astype(np.float64),
        coeffs=d["logk_coeffs"],
        species_mass_amu=d["species_mass"],
    )


def _ln_k(coeffs, T):
    """ln K(T) from the 5-term fit; coeffs (S, 5), T (..., 1) -> (..., S)."""
    a1, a2, a3, a4, a5 = (coeffs[:, i] for i in range(5))
    return a1 / T + a2 * torch.log(T) + a3 + a4 * T + a5 * T * T


def _lse(terms):
    """Max-subtracted logsumexp over the last axis (the JAX package's
    ``_masked_lse`` with every term kept: each element's solve here runs
    on its own species, so nothing is masked)."""
    m = torch.clamp(torch.amax(terms, dim=-1), min=_NEG)
    s = torch.exp(terms - m[..., None]).sum(-1)
    return m + torch.log(torch.clamp(s, min=1e-300))


@contextmanager
def _one_host_thread(device):
    """Run a host solve on one thread: its operations are too small for
    the thread pool to pay off (PERF.md §5)."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tensor(x, dtype=None, device=None):
    if torch.is_tensor(x):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def equilibrium_log_pressures(table: ChemTable, T, P_bar, x0=None,
                              n_sweeps: int = 60, n_inner: int = 16,
                              return_residuals: bool = False):
    """Solve equilibrium for a batch of (T, P) points.

    Parameters
    ----------
    T, P_bar : tensors or arrays (broadcast together)
        Temperature [K] and total pressure [bar].  The solve runs in their
        promoted dtype on T's device.
    x0 : optional warm start, shape (..., E+1): element log pressures
        plus ``m`` from a previous solve.
    n_sweeps : Gauss-Seidel sweeps.
    n_inner : scalar-Newton iterations per 1-D element solve.
    return_residuals : also return the per-sweep convergence history.

    Returns
    -------
    ln_p : (..., E + S) log partial pressures (elements then species).
    z : (..., E + 1) warm-start state for subsequent calls.
    r_hist : (n_sweeps,) max-over-batch |log pressure-closure residual|
        per sweep (only with ``return_residuals``); ``r_hist[-1]`` is the
        solve's convergence metric.
    """
    T = _tensor(T)
    P_bar = _tensor(P_bar, device=T.device)
    dtype = torch.promote_types(T.dtype, P_bar.dtype)
    shape = torch.broadcast_shapes(T.shape, P_bar.shape)
    Tf = T.to(dtype).broadcast_to(shape).reshape(-1)
    Pf = P_bar.to(dtype).broadcast_to(shape).reshape(-1)
    E, S = table.n_elements, table.n_species
    if x0 is not None:
        x0 = _tensor(x0, dtype, T.device).reshape(-1, E + 1)
    static = _prepare_static(table)
    ln_p, z, r_hist = _solve_batch(static, Tf, Pf, x0,
                                   n_sweeps=n_sweeps, n_inner=n_inner)
    out = (ln_p.reshape(shape + (E + S,)), z.reshape(shape + (E + 1,)))
    return out + (r_hist,) if return_residuals else out


def _clip_interp_axis(coord, x):
    """Clamped 1-D linear-interpolation weights on ascending ``coord``:
    clip ``x`` into the axis range, lower index ``i``, fraction ``f``.

    One definition on purpose: :meth:`FastChemTorch.layer_mmr_interp`
    equals :meth:`FastChemTorch._vmr_from_table` (the bilinear
    interpolation factored axis by axis) only while every table lookup
    uses the same clip, search and fraction."""
    n = coord.shape[0]
    x = torch.minimum(torch.maximum(x, coord[0]), coord[-1])
    i = torch.clamp(torch.searchsorted(coord, x.contiguous(), right=True) - 1,
                    0, n - 2)
    f = (x - coord[i]) / (coord[i + 1] - coord[i])
    return i, f


def _prepare_static(table: ChemTable):
    """Host-side preprocessing shared by every solve (cheap numpy work,
    recomputed per call): the stoichiometry, the element order, and for
    each element the species that contain it."""
    nu = np.asarray(table.stoich)
    eps = np.asarray(table.abundances)
    E = table.n_elements
    ie = E - 1 if table.elements[-1] == "e-" else None
    order = np.argsort(-eps[: ie if ie is not None else E])
    return dict(
        nu=nu, eps=eps, order=order, ie=ie,
        coeffs=np.asarray(table.coeffs),
        iH=table.elements.index("H"),
        iH2=table.species.index("H2") if "H2" in table.species else None,
    )


class _Subsets(NamedTuple):
    """One element's species, on the solve's device."""

    pos: torch.Tensor       # (n,) species with a positive count
    nu_aug: torch.Tensor    # (n + 1,) [1, their counts]
    ln_nu: torch.Tensor     # (n,) log of their counts
    nz: torch.Tensor        # species with a non-zero count
    nu_nz: torch.Tensor     # their counts


class _GaussSeidel:
    """The constants of a solve in one dtype on one device, and its
    sweep (:meth:`sweep`).  Each element's 1-D solve runs on the species
    that contain it, gathered here once."""

    def __init__(self, static, dtype, device, n_inner: int):
        nu_np, ie = static["nu"], static["ie"]

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)

        nu = t(nu_np)
        eps = t(static["eps"])
        self.nuT = nu.T.contiguous()
        self.coeffs = t(static["coeffs"])
        self.ln_eps = torch.where(
            eps > 0, torch.log(torch.clamp(eps, min=1e-300)), _NEG)
        self.subsets = []
        for j in static["order"]:
            pos = np.nonzero(nu_np[:, j] > 0)[0]
            nz = np.nonzero(nu_np[:, j] != 0)[0]
            self.subsets.append((int(j), _Subsets(
                pos=t(pos, torch.long),
                nu_aug=t(np.concatenate([[1.0], nu_np[pos, j]])),
                ln_nu=t(np.log(nu_np[pos, j])),
                nz=t(nz, torch.long), nu_nz=t(nu_np[nz, j]))))
        self.cat = t(np.nonzero(nu_np[:, ie] < 0)[0], torch.long)
        self.an = t(np.nonzero(nu_np[:, ie] > 0)[0], torch.long)
        self.nu_cat, self.nu_an = nu[self.cat, ie], nu[self.an, ie]
        self.ie, self.n_inner = ie, n_inner

    def sweep(self, lnK, ln_P, lam, m):
        """One Gauss-Seidel sweep, in place on the state ``lam`` (B, E)
        and ``m`` (B,), at ``lnK`` (B, S) and ``ln_P`` (B,).  Returns the
        largest |log pressure-closure residual| (0-d), with no host
        synchronization (so that a CUDA graph can hold the sweep)."""
        ie, nuT = self.ie, self.nuT
        zero = lam.new_zeros((lam.shape[0], 1))
        y = lnK + lam @ nuT                                   # (B, S)
        for j, sub in self.subsets:
            lam_j = lam[:, j]
            # column 0 is the element's own term: 0 + 1 * xj
            base = torch.cat([zero, y[:, sub.pos]
                              - sub.nu_aug[1:] * lam_j[:, None]
                              + sub.ln_nu], dim=1)
            target = self.ln_eps[j] + m                       # (B,)
            xj = lam_j
            for _ in range(self.n_inner):
                # t = logsumexp(terms), and the slope sum_i nu_i
                # exp(terms_i - t) from the same exponentials
                terms = torch.addcmul(base, sub.nu_aug, xj[:, None])
                mx = torch.amax(terms, dim=1, keepdim=True)
                ea = torch.exp(terms - mx)
                s = ea.sum(1)
                tj = mx[:, 0] + torch.log(s)
                slope = (ea @ sub.nu_aug) / s
                xj = xj - (tj - target) / torch.clamp(slope, min=0.5)
            y[:, sub.nz] += (xj - lam_j)[:, None] * sub.nu_nz
            lam[:, j] = xj
        # the electron: exact charge balance for +-1 gas charges
        y = lnK + lam @ nuT
        lam_e = lam[:, ie:ie + 1]
        lse_cat = _lse(y[:, self.cat] - lam_e * self.nu_cat)
        lse_an = _lse(torch.cat([zero, y[:, self.an] - lam_e * self.nu_an],
                                dim=1))
        lam[:, ie] = 0.5 * (lse_cat - lse_an)
        y = lnK + lam @ nuT
        # total-pressure residual and secant update on m
        r_p = _lse(torch.cat([lam, y], dim=1)) - ln_P
        m.sub_(r_p)
        return torch.amax(torch.abs(r_p))

    def finish(self, lnK, lam, m):
        """``(ln_p, z)`` of the state ``lam``, ``m``."""
        ln_p = torch.cat([lam, lnK + lam @ self.nuT], dim=1)
        return ln_p, torch.cat([lam, m[:, None]], dim=1)


class _GraphedSweep:
    """One sweep of :class:`_GaussSeidel` at a fixed batch of B points,
    captured in a CUDA graph on static buffers: each replay launches the
    sweep's few thousand small kernels without the host issuing them.
    Replays give the eager sweep's bits on the same device."""

    def __init__(self, gs: _GaussSeidel, B: int, dtype, device):
        E, S = gs.nuT.shape
        z = torch.zeros
        self.lnK = z((B, S), dtype=dtype, device=device)
        self.ln_P = z((B,), dtype=dtype, device=device)
        self.lam = z((B, E), dtype=dtype, device=device)
        self.m = z((B,), dtype=dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):        # warm up off the state
            gs.sweep(self.lnK, self.ln_P, self.lam.clone(), self.m.clone())
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.r = gs.sweep(self.lnK, self.ln_P, self.lam, self.m)

    def run(self, lnK, ln_P, lam, m, n_sweeps):
        """``n_sweeps`` replays from the state ``lam``, ``m``; returns
        copies of the final state and the residual history."""
        for dst, src in ((self.lnK, lnK), (self.ln_P, ln_P),
                         (self.lam, lam), (self.m, m)):
            dst.copy_(src)
        r_hist = self.r.new_empty((n_sweeps,))
        for i in range(n_sweeps):
            self.graph.replay()
            r_hist[i].copy_(self.r)
        return self.lam.clone(), self.m.clone(), r_hist


def _gs_solve(static, T, P_bar, z0, n_sweeps: int, n_inner: int,
              graphed: Optional[_GraphedSweep] = None, gs=None):
    """Gauss-Seidel equilibrium solve of (B,) points from the state
    ``z0`` (B, E + 1), in T's dtype on T's device, eagerly or by replays
    of ``graphed``.  Returns ``(ln_p, z, r_hist)`` as
    :func:`equilibrium_log_pressures` does."""
    E = static["nu"].shape[1]
    if gs is None:
        gs = _GaussSeidel(static, T.dtype, T.device, n_inner)
    lnK = _ln_k(gs.coeffs, T[:, None])                    # (B, S)
    ln_P = torch.log(P_bar)                               # (B,)
    lam = z0[:, :E].clone()
    m = z0[:, E].clone()
    if graphed is not None:
        lam, m, r = graphed.run(lnK, ln_P, lam, m, n_sweeps)
    else:
        r = torch.stack([gs.sweep(lnK, ln_P, lam, m)
                         for _ in range(n_sweeps)]) if n_sweeps else \
            T.new_zeros((0,))
    return gs.finish(lnK, lam, m) + (r,)


def _solve_batch(static, T, P_bar, x0, n_sweeps, n_inner, **solver):
    dtype, dev = T.dtype, T.device
    eps = static["eps"]
    ie = static["ie"]
    if ie is None:
        raise NotImplementedError("tables without an electron row")
    ln_P = torch.log(P_bar)
    if x0 is None:
        # atomic start with the H/H2 quadratic solved analytically
        eps_d = torch.as_tensor(eps, dtype=dtype, device=dev)
        ln_eps = torch.where(eps_d > 0,
                             torch.log(torch.clamp(eps_d, min=1e-300)), _NEG)
        m0 = ln_P - torch.log(torch.sum(eps_d))
        lam0 = ln_eps[None, :] + m0[:, None]
        lam0[:, ie] = ln_P - 40.0
        if static["iH2"] is not None:
            coeffs = torch.as_tensor(static["coeffs"], dtype=dtype,
                                     device=dev)
            lnK2 = _ln_k(coeffs, T[:, None])[:, static["iH2"]]
            K2 = torch.exp(torch.clamp(lnK2, max=600.0))
            epsH = eps_d[static["iH"]]
            pH = ((-1.0 + torch.sqrt(1.0 + 8.0 * K2 * epsH * torch.exp(m0)))
                  / (4.0 * K2))
            lam0[:, static["iH"]] = torch.log(torch.clamp(pH, min=1e-300))
        z0 = torch.cat([lam0, m0[:, None]], dim=1)
    else:
        z0 = x0
    return _gs_solve(static, T, P_bar, z0, n_sweeps, n_inner, **solver)


class FastChemTorch:
    """Chemistry model: equilibrium mass mixing ratios for the opacity
    species, batched over layers (and columns).  Counterpart of
    ``frei_tpu.chemistry.fastchem.FastChemJAX``.

    Pipeline as the reference ``chemistry()`` (`chemistry.py:114-205`):
    isotopologue -> species name -> Hill name -> solver index; VMR = p_i /
    P; MMR = VMR * m_species / m_bar.  Unknown species raise at
    construction instead of printing (`chemistry.py:200-201`).

    Parameters
    ----------
    opacity_species : sequence of isotopologue names (opacity keys).
    m_bar_g : mean molecular weight [g].
    mode : ``"table"`` (default) solves log-VMRs on a (log T, log P) grid
        in float64 at construction and interpolates them bilinearly per
        call, accurate to ~1e-3 relative at the default 64 x 32 grid;
        ``"exact"`` runs the Gauss-Seidel solve per call (use float64).
    T_range, P_range_bar : the table's coverage (500-6000 K, 1e-8-1e3
        bar: the opacity data's range, with T headroom so that an RC
        iteration's overshoots above 5000 K stay on the table).
    build_device : where the table is solved: the card unless the
        caller names another device (without CUDA, ``"cuda"`` raises and
        names ``build_device="cpu"``).  A row is 32 points, so a sweep is
        a few thousand small operations: on an H100 a sweep replayed from
        a CUDA graph takes 10.2 ms, on its host 20.4 ms on one thread
        (the host build's setting) and 55.7 ms on the default pool, and
        74.8 ms issued eagerly to the card; the default table takes 42.4
        s on the card and 104.9 s on the host (PERF.md §5).  So on the
        card the build replays one sweep captured in a CUDA graph (the
        eager sweep's bits).  The table itself is kept on the host and
        copied, once per device, to where it is read.
    """

    def __init__(self, opacity_species: Sequence[str], m_bar_g: float,
                 table: Optional[ChemTable] = None, mode: str = "table",
                 n_sweeps: int = 60, grid_shape=(64, 32),
                 T_range=(500.0, 6000.0), P_range_bar=(1e-8, 1e3),
                 build_device="cuda"):
        self.table = table if table is not None else load_chem_table()
        self.m_bar_g = float(m_bar_g)
        self.mode = mode
        self.n_sweeps = int(n_sweeps)
        self.isotopologues = tuple(opacity_species)
        idx, mass = [], []
        for iso in self.isotopologues:
            hill = species_name_to_fastchem_name(iso_to_species(iso))
            i = self.table.species_index(hill)
            if i == UNKNOWN_SPECIES:
                raise ValueError(
                    f"species {iso!r} ({hill!r}) not in chemistry tables")
            idx.append(i)
            mass.append(iso_to_mass_g(iso))
        self._indices = np.array(idx)
        self._masses_g = np.array(mass)
        self._on_device = {}
        if mode == "table":
            device = torch.device(build_device)
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "FastChemTorch: the table builds on the card by default "
                    "but no CUDA device is available here; pass "
                    "build_device=\"cpu\"")
            self._build_vmr_table(grid_shape, T_range, P_range_bar, device)
        elif mode != "exact":
            raise ValueError(f"unknown chemistry mode {mode!r}")

    def _build_vmr_table(self, grid_shape, T_range, P_range_bar, device):
        nT, nP = grid_shape
        logT = np.linspace(np.log10(T_range[0]), np.log10(T_range[1]), nT)
        logP = np.linspace(np.log10(P_range_bar[0]),
                           np.log10(P_range_bar[1]), nP)
        P_row = 10.0 ** logP
        P_t = torch.as_tensor(P_row, dtype=torch.float64, device=device)
        ln_vmr = np.empty((nT, nP, len(self._indices)))
        worst = 0.0
        static = _prepare_static(self.table)
        with _one_host_thread(device), torch.inference_mode():
            solver = dict(gs=_GaussSeidel(static, torch.float64, device, 16))
            if device.type == "cuda":
                solver["graphed"] = _GraphedSweep(solver["gs"], nP,
                                                  torch.float64, device)
            # Continuation: solve the hottest row cold (the chemistry is
            # mildest there), then walk down in T warm-starting each row
            # from the previous one, ~4x fewer sweeps overall.
            z = None
            for k in range(nT - 1, -1, -1):
                T_row = torch.full((nP,), 10.0 ** logT[k],
                                   dtype=torch.float64, device=device)
                ln_p, z, r = _solve_batch(
                    static, T_row, P_t, z,
                    self.n_sweeps if z is None else 16, 16, **solver)
                if float(r[-1]) > 1e-8:
                    # the warm start from the neighbouring row was not
                    # close enough (coarse grids, stiff cold rows):
                    # finish the row with a full-sweep continuation
                    ln_p, z, r = _solve_batch(static, T_row, P_t, z,
                                              self.n_sweeps, 16, **solver)
                worst = max(worst, float(r[-1]))
                ln_vmr[k] = (ln_p.cpu().numpy()[:, self._indices]
                             - np.log(P_row)[:, None])
        #: worst final pressure-closure residual over the table build:
        #: convergence telemetry, and a loud failure for (T, P) coverage
        #: the solver cannot reach
        self.table_residual = worst
        if worst > 1e-6:
            raise RuntimeError(
                f"chemistry table build did not converge: final "
                f"pressure-closure residual {worst:.2e} (> 1e-6); "
                f"raise n_sweeps or shrink T_range/P_range_bar")
        self._tab_logT = torch.as_tensor(logT, dtype=torch.float32)
        self._tab_logP = torch.as_tensor(logP, dtype=torch.float32)
        self._tab_lnvmr = torch.as_tensor(ln_vmr, dtype=torch.float32)

    def _tables(self, device):
        """The float32 table's (log T, log P, ln VMR) on ``device``."""
        key = torch.device(device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                x.to(key) for x in (self._tab_logT, self._tab_logP,
                                    self._tab_lnvmr))
        return self._on_device[key]

    def _vmr_from_table(self, temperatures, pressures_cgs):
        temperatures = _tensor(temperatures)
        dtype, dev = temperatures.dtype, temperatures.device
        tab_logT, tab_logP, v = self._tables(dev)
        logT = torch.log10(temperatures.to(torch.float32))
        logP = torch.log10(_tensor(pressures_cgs, torch.float32, dev)
                           / const.BAR_TO_CGS)
        ti, tf = _clip_interp_axis(tab_logT, logT)
        pj, pf = _clip_interp_axis(tab_logP, logP)
        out = ((1 - tf)[..., None] * ((1 - pf)[..., None] * v[ti, pj]
                                      + pf[..., None] * v[ti, pj + 1])
               + tf[..., None] * ((1 - pf)[..., None] * v[ti + 1, pj]
                                  + pf[..., None] * v[ti + 1, pj + 1]))
        return torch.movedim(torch.exp(out), -1, 0).to(dtype)

    def vmr(self, temperatures, pressures_cgs):
        """(S,) + batch volume mixing ratios."""
        if self.mode == "table":
            return self._vmr_from_table(temperatures, pressures_cgs)
        return self.vmr_with_state(temperatures, pressures_cgs)[0]

    def vmr_with_state(self, temperatures, pressures_cgs, z0=None,
                       n_sweeps: Optional[int] = None):
        """Exact-mode VMRs plus the warm-start state ``z`` for the next
        call (thread ``z`` through an iteration loop to re-solve with far
        fewer sweeps as temperatures drift), and the per-sweep residual
        history as the third element (``r_hist[-1]`` is the convergence
        metric)."""
        if self.mode == "table":
            raise AttributeError("warm-start state is exact-mode only")
        temperatures = _tensor(temperatures)
        P_bar = (_tensor(pressures_cgs, device=temperatures.device)
                 / const.BAR_TO_CGS)
        ln_p, z, r_hist = equilibrium_log_pressures(
            self.table, temperatures, P_bar, x0=z0,
            n_sweeps=self.n_sweeps if n_sweeps is None else n_sweeps,
            return_residuals=True)
        idx = torch.as_tensor(self._indices, device=ln_p.device)
        ln_vmr = ln_p[..., idx] - torch.log(P_bar)[..., None]
        return torch.movedim(torch.exp(ln_vmr), -1, 0), z, r_hist

    def mmr(self, temperatures, pressures_cgs):
        """(S,) + batch mass mixing ratios (`chemistry.py:197-199`)."""
        v = self.vmr(temperatures, pressures_cgs)
        scale = torch.as_tensor(self._masses_g / self.m_bar_g,
                                dtype=v.dtype, device=v.device)
        return v * scale.reshape(scale.shape + (1,) * (v.ndim - 1))

    def layer_ln_mmr_tables(self, pressures_cgs):
        """Layer-factored form for the whole-iteration kernels (table mode
        only): the (log T, log P) ln-VMR table interpolated onto the fixed
        layer pressures, the mass / m_bar scale folded in.  Returns (log10
        T grid (nTc,), ln-MMR table (L, nTc, S)), float32 on the
        pressures' device; the kernels' clipped 1-D log T interpolation
        then reproduces :meth:`_vmr_from_table`, since bilinear
        interpolation factors axis by axis."""
        if self.mode != "table":
            raise AttributeError(
                "layer-factored chemistry requires table mode")
        dev = _tensor(pressures_cgs).device
        tab_logT, tab_logP, v = self._tables(dev)      # v (nTc, nPc, S)
        logP = torch.log10(_tensor(pressures_cgs, torch.float32, dev)
                           / const.BAR_TO_CGS)
        pj, pf = _clip_interp_axis(tab_logP, logP)
        tab = ((1 - pf)[None, :, None] * v[:, pj, :]
               + pf[None, :, None] * v[:, pj + 1, :])    # (nTc, L, S)
        tab = tab + torch.log(torch.as_tensor(
            self._masses_g / self.m_bar_g, dtype=tab.dtype, device=dev))
        return tab_logT, torch.movedim(tab, 0, 1).contiguous()

    def supports_layer_factoring(self):
        """True when :meth:`layer_mmr_interp` is available (table mode):
        the hot loop can hoist the P interpolation."""
        return self.mode == "table"

    def layer_mmr_interp(self, pressures_cgs):
        """Hot-loop MMR evaluator on the fixed layer grid (table mode
        only): returns ``mmr_fn(temps)`` with ``temps`` (..., L) ->
        (S, ..., L) mass mixing ratios, equal to ``self.mmr(temps,
        pressures_cgs)`` to float32 rounding.

        The P axis is interpolated once onto the layer pressures
        (:meth:`layer_ln_mmr_tables`), which leaves a per-call clipped 1-D
        log T interpolation, in float32 as the JAX package's one-hot
        contraction computes it: the two weighted table rows of each
        layer, added.  Temperatures are clamped to the table's range (as
        ``_vmr_from_table`` does, unlike the opacity tables' zero-fill)."""
        if self.mode != "table":
            raise AttributeError(
                "layer-factored chemistry requires table mode")
        logT_grid, tab = self.layer_ln_mmr_tables(pressures_cgs)
        L = tab.shape[0]
        layers = torch.arange(L, device=tab.device)

        def mmr_fn(temps):
            dtype = temps.dtype
            x = torch.log10(temps.to(torch.float32))
            i, f = _clip_interp_axis(logT_grid, x)
            ln = ((1.0 - f)[..., None] * tab[layers, i]
                  + f[..., None] * tab[layers, i + 1])    # (..., L, S)
            return torch.movedim(torch.exp(ln), -1, 0).to(dtype)

        return mmr_fn


def hot_loop_mmr_fn(chem, pressures_cgs):
    """Best MMR evaluator for a solver hot loop on the fixed layer
    pressure grid: the model's layer-factored ``layer_mmr_interp`` when it
    advertises one (``supports_layer_factoring()``, where defined, must
    say yes), else ``chem.mmr(temps, pressures_cgs)``.

    The dispatch is an explicit capability check, not exception-driven,
    so an ``AttributeError`` inside a custom model propagates."""
    supports = getattr(chem, "supports_layer_factoring", None)
    fast = getattr(chem, "layer_mmr_interp", None)
    if fast is not None and (supports is None or supports()):
        return fast(pressures_cgs)

    def mmr_fn(temps):
        return chem.mmr(temps, pressures_cgs)

    return mmr_fn
