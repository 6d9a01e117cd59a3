"""The plain reference solve on equilibrium chemistry: ``rt``'s batched
radiative-convective iterations with every species' mass mixing ratio
read, at each layer's temperature and pressure, from an equilibrium
table the reference solves itself (``equilibrium.py``).

A configuration's ``chemistry`` block ``{"kind": "equilibrium",
"grid_shape": [nT, nP], "T_range_K": [lo, hi], "P_range_bar": [lo,
hi]}`` names the table: ln VMR of the opacity species at nT log-spaced
temperatures by nP log-spaced pressures (the port's
``FastChemTorch(mode="table")`` documents the same nodes).  A layer's
mass mixing ratio is the clamped bilinear interpolation of ln VMR in
(log10 T, log10 P), exponentiated, times m_species / m_bar
(`frei/chemistry.py:197-199`); the opacity is ``rt``'s bilinear lookup
of each species weighted by it, plus Rayleigh scattering.

Departures from frei, which calls FastChem at every layer of every
opacity call (`frei/opacity.py:246-248`): the table interpolation
stands in for the per-call solve (the table is accurate to ~1e-3
relative at 64 x 32, the port's ``fastchem.py`` says); and the
reference interpolates each layer in (T, P) where the program
interpolates P onto the layers once and T at each call, which agree in
real arithmetic.

In ``dtype`` (float64 for the reference, float32 for the control); the
control's table is the float64 table rounded to its dtype.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import case, equilibrium, inputs, rt
from . import constants as const


class Chem(NamedTuple):
    """A configuration's equilibrium table on the reference's device
    and dtype."""

    logT: torch.Tensor      # (nT,) log10 T [K], ascending
    logP: torch.Tensor      # (nP,) log10 P [bar], ascending
    ln_vmr: torch.Tensor    # (nT, nP, S)
    ln_scale: torch.Tensor  # (S,) ln(m_species / m_bar)


def fastchem_name(isotopologue: str) -> str:
    """The thermochemical data's name of an opacity species: "1H2-16O"
    -> "H2O1", "48Ti-16O" -> "O1Ti1" (elements in alphabetical order,
    each with its count), "23Na" -> "Na" (an atom)."""
    counts = {}
    for part in isotopologue.split("-"):
        m = re.fullmatch(r"\d*([A-Z][a-z]?)(\d*)", part)
        if m is None:
            raise ValueError(f"cannot read the isotopologue "
                             f"{isotopologue!r}")
        counts[m.group(1)] = counts.get(m.group(1), 0) + int(m.group(2) or 1)
    if len(counts) == 1 and sum(counts.values()) == 1:
        return next(iter(counts))
    return "".join(f"{e}{counts[e]}" for e in sorted(counts))


def axes(block: dict):
    """The table's (log10 T (nT,), log10 P (nP,)) nodes."""
    nT, nP = block["grid_shape"]
    return (np.linspace(*np.log10(block["T_range_K"]), int(nT)),
            np.linspace(*np.log10(block["P_range_bar"]), int(nP)))


@lru_cache(maxsize=4)
def _table(species: tuple, grid_shape: tuple, T_range: tuple,
           P_range: tuple) -> np.ndarray:
    th = equilibrium.load()
    logT, logP = axes({"grid_shape": grid_shape, "T_range_K": T_range,
                       "P_range_bar": P_range})
    E = len(th.elements)
    idx = []
    for iso in species:
        name = fastchem_name(iso)
        if name in th.elements:
            idx.append(th.elements.index(name))
        elif name in th.species:
            idx.append(E + th.species.index(name))
        else:
            raise ValueError(f"{iso!r} ({name!r}) is not in the "
                             f"thermochemical data")
    P = 10.0 ** logP
    sy = equilibrium._System(th)
    out = np.empty((logT.shape[0], P.shape[0], len(species)))
    x, T_prev = None, np.full(P.shape, equilibrium.T_HOT)
    for k in range(logT.shape[0] - 1, -1, -1):
        T = np.full(P.shape, 10.0 ** logT[k])
        ln_p, x = equilibrium.walk(th, T_prev, T, P, x, sy)
        out[k] = ln_p[:, idx] - logP[:, None] * np.log(10.0)
        T_prev = T
    out.setflags(write=False)
    return out


def ln_vmr_table(cfg: dict, species) -> np.ndarray:
    """ln VMR (nT, nP, S) of ``species`` at the nodes of ``cfg``'s
    chemistry block, float64, solved once per process."""
    ch = cfg["chemistry"]
    if ch["kind"] != "equilibrium":
        raise ValueError(f"not an equilibrium configuration: {ch['kind']!r}")
    return _table(tuple(species), tuple(ch["grid_shape"]),
                  tuple(ch["T_range_K"]), tuple(ch["P_range_bar"]))


def chem(cfg: dict, species, dtype, device) -> Chem:
    logT, logP = axes(cfg["chemistry"])
    scale = np.log([inputs.iso_mass_amu(n) * const.u_amu / case.m_bar_g(cfg)
                    for n in species])

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return Chem(t(logT), t(logP), t(ln_vmr_table(cfg, species)), t(scale))


def _clamped(coord, x):
    """Lower index and fraction of ``x`` clipped onto the ascending
    ``coord``."""
    x = torch.clamp(x, coord[0], coord[-1])
    i = torch.clamp(torch.searchsorted(coord, x.contiguous(), right=True)
                    - 1, 0, coord.shape[0] - 2)
    return i, (x - coord[i]) / (coord[i + 1] - coord[i])


def ln_mmr(c: Chem, T, P_bar):
    """ln MMR (..., S) at temperatures ``T`` [K] and pressures ``P_bar``
    [bar] of one shape: the clamped bilinear interpolation of ln VMR in
    (log10 T, log10 P), plus ln(m_species / m_bar)."""
    ti, tf = _clamped(c.logT, torch.log10(T))
    pj, pf = _clamped(c.logP, torch.log10(P_bar))
    tf, pf, v = tf[..., None], pf[..., None], c.ln_vmr
    return ((1 - tf) * ((1 - pf) * v[ti, pj] + pf * v[ti, pj + 1])
            + tf * ((1 - pf) * v[ti + 1, pj] + pf * v[ti + 1, pj + 1])
            + c.ln_scale)


def layer_table(c: Chem, pressures):
    """ln MMR (L, nT, S) at each table temperature and each layer's
    pressure ``pressures`` [barye] (``ln_mmr`` at the temperature nodes,
    where the interpolation in T is the node's row): the form of the
    port's ``layer_ln_mmr_tables``."""
    pj, pf = _clamped(c.logP, torch.log10(pressures / const.BAR_TO_CGS))
    pf = pf[None, :, None]
    t = (1 - pf) * c.ln_vmr[:, pj] + pf * c.ln_vmr[:, pj + 1] + c.ln_scale
    return torch.movedim(t, 0, 1)


def kappa(s: rt.Setup, c: Chem, T):
    """Total opacity (B, L, W) at the layers' temperatures ``T`` (B, L):
    ``rt.kappa``'s lookup of each species, zero outside the opacity
    table's hull, weighted by the species' equilibrium MMR at the
    layer's (T, P), plus Rayleigh scattering."""
    p = s.pressures.expand_as(T)
    ti, tf, t_ok = rt._axis(s.table_T, T)
    pj, pf, p_ok = rt._axis(s.table_P, p)
    v = s.table
    tf, pf = tf[..., None], pf[..., None]
    k = ((1 - tf) * ((1 - pf) * v[:, ti, pj] + pf * v[:, ti, pj + 1])
         + tf * ((1 - pf) * v[:, ti + 1, pj] + pf * v[:, ti + 1, pj + 1]))
    k = torch.where((t_ok & p_ok)[..., None], k, 0.0)
    mmr = torch.exp(ln_mmr(c, T, p / const.BAR_TO_CGS))       # (B, L, S)
    return (torch.movedim(mmr, -1, 0)[..., None] * k).sum(0) + s.sigma


def emit(s, c, ph, T, F_up, F_down):
    """``rt.emit`` with the equilibrium opacity."""
    B, L = T.shape
    p = s.pressures
    Bp = rt.planck(T[..., None], s.lam_cm)
    k_all = kappa(s, c, T)
    F_up = list(F_up.unbind(1))
    F_down = list(F_down.unbind(1))
    dT = [torch.zeros_like(T[:, 0])]
    F_toa = s.F_toa.expand(B, -1)
    for l in range(1, L):
        top = l == L - 1
        p1, p2 = p[l], (p[-1] * p[-2] / p[-3] if top else p[l + 1])
        T1, T2 = T[:, l], T[:, l if top else l + 1]
        F1_up, F2_down = F_up[l], (F_toa if top else F_down[l + 1])
        F2_up, F1_down = rt._layer(s, ph, F1_up, F2_down, p1, p2, Bp[:, l],
                                   Bp[:, l if top else l + 1], k_all[:, l])
        bol = [f @ s.trapz_w for f in (F2_up, F2_down, F1_up, F1_down)]
        dT.append(rt.delta_T(*bol, T1, T2, p1, p2, rt._ph_col(ph)))
        if not top:
            F_up[l + 1] = F2_up
        F_down[l] = F1_down
    dT = torch.stack(dT, 1)
    return torch.stack(F_up, 1), torch.stack(F_down, 1), T - dT


def absorb(s, c, ph, T, F_up, F_down):
    """``rt.absorb`` with the equilibrium opacity."""
    B, L = T.shape
    p = s.pressures
    Bp = rt.planck(T[..., None], s.lam_cm)
    k_all = kappa(s, c, T)
    F_up = list(F_up.unbind(1))
    F_down = list(F_down.unbind(1))
    dT = [torch.zeros_like(T[:, 0])] * L
    for l in range(L - 2, -1, -1):
        T1, T2 = T[:, l], T[:, l + 1]
        F1_up, F2_down = F_up[l], F_down[l + 1]
        F2_up, F1_down = rt._layer(s, ph, F1_up, F2_down, p[l], p[l + 1],
                                   Bp[:, l], Bp[:, l + 1], k_all[:, l])
        bol = [f @ s.trapz_w for f in (F2_up, F2_down, F1_up, F1_down)]
        dT[l] = rt.delta_T(*bol, T1, T2, p[l], p[l + 1],
                             rt._ph_col(ph))
        F_up[l + 1] = F2_up
        F_down[l] = F1_down
    return (torch.stack(F_up, 1), torch.stack(F_down, 1),
            T - torch.stack(dT, 1))


def solve(s, c, ph, T0, n_iterations: int) -> rt.Solution:
    """``rt.solve`` with the equilibrium opacity: ``n_iterations``
    emit/absorb pairs from zero flux, then one final emit."""
    B, L = T0.shape
    W = s.lam_cm.shape[0]
    F_up = T0.new_zeros((B, L, W))
    F_down = T0.new_zeros((B, L, W))
    T = T0
    for _ in range(n_iterations):
        F_up, F_down, T = emit(s, c, ph, T, F_up, F_down)
        F_up, F_down, T = absorb(s, c, ph, T, F_up, F_down)
    F_up, _, T = emit(s, c, ph, T, F_up, F_down)
    return rt.Solution(flux=F_up[:, -1], final_temps=T)


def forward(cfg, tables, T0, n_iters, dtype, device, block):
    """Flux (C, W), final temperatures (C, L) and the layer table
    ``ln_mmr`` (L, nT, S) of the fixed-horizon solve of the (C, L)
    profiles ``T0`` (float64 numpy), as float64 host tensors; the solve
    ``block`` columns at a time."""
    s, ph = case.build(_as_mock(cfg), tables, dtype, device)
    c = chem(cfg, list(tables), dtype, device)
    flux, temps = [], []
    with torch.no_grad():
        for i in range(0, T0.shape[0], block):
            r = solve(s, c, ph, torch.as_tensor(T0[i:i + block], dtype=dtype,
                                                 device=device), n_iters)
            flux.append(r.flux.double().cpu())
            temps.append(r.final_temps.double().cpu())
        ln = layer_table(c, s.pressures).double().cpu()
    return {"flux": torch.cat(flux), "final_temps": torch.cat(temps),
            "ln_mmr": ln}


def _as_mock(cfg: dict) -> dict:
    """``cfg`` as ``case.build`` takes it: its constant-ratio ``mmr`` is
    never read here."""
    return {**cfg, "chemistry": {"kind": "mock", "vmr": float("nan")}}
