"""The plain reference solve: batched radiative-convective iterations in
plain PyTorch, with no kernel, cache or program state.

A frozen restatement of frei_tpu_torch's ``"eager"`` engine
(rt/solver.py, rt/sweeps.py, rt/physics.py, ops/twostream.py
``two_stream_couplers``, ops/planck.py), which restates the reference
frei (`twostream.py:16-550`, `core.py:233-338`; Malik et al. 2017,
Deitrick et al. 2020).  Departures: the opacity is the bilinear (T, P)
interpolation of the raw table at each layer (the program hoists the P
axis; the two agree in real arithmetic), and the layer recurrence is
always the serial Gauss-Seidel loop.  Differentiable end to end, so
``torch.autograd`` gives the reference gradient.

Every input is a tensor in the dtype the caller chose: float64 for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import constants as const


class Physics(NamedTuple):
    g: torch.Tensor        # scalar or (B, 1) [cm / s^2]
    m_bar: torch.Tensor    # scalar [g]
    alpha: torch.Tensor    # scalar or (B, 1)
    n_dof: int = 5


class Setup(NamedTuple):
    """A configuration's constants on the reference's device and dtype."""

    lam_cm: torch.Tensor      # (W,)
    trapz_w: torch.Tensor     # (W,)
    pressures: torch.Tensor   # (L,) BOA first [barye]
    sigma: torch.Tensor       # (W,) Rayleigh opacity [cm^2 / g]
    F_toa: torch.Tensor       # (W,) or (B, W)
    table: torch.Tensor       # (S, nT, nP, W) [cm^2 / g]
    table_T: torch.Tensor     # (nT,) ascending [K]
    table_P: torch.Tensor     # (nP,) ascending [barye]
    mmr: torch.Tensor         # (S,) constant mass mixing ratios


def planck(T, lam):
    return 2.0 * const.h * const.c ** 2 / lam ** 5 / torch.expm1(
        const.hc_over_k / (lam * T))


def _axis(coord, x):
    """Lower index, fraction and in-hull mask of ``x`` on an ascending
    axis, the hull widened by 8 ulp of the axis dtype."""
    n = coord.shape[0]
    idx = torch.clamp(torch.searchsorted(coord, x.contiguous(), right=True)
                      - 1, 0, n - 2)
    x0, x1 = coord[idx], coord[idx + 1]
    eps = 8.0 * torch.finfo(coord.dtype).eps
    ok = ((x >= coord[0] - eps * coord[0].abs())
          & (x <= coord[-1] + eps * coord[-1].abs()))
    return idx, (x - x0) / (x1 - x0), ok


def kappa(s: Setup, T):
    """Total opacity (B, L, W) at the layers' temperatures ``T`` (B, L):
    the MMR-weighted bilinear lookup of every species, zero outside the
    table's hull, plus Rayleigh scattering."""
    p = s.pressures.expand_as(T)
    ti, tf, t_ok = _axis(s.table_T, T)
    pj, pf, p_ok = _axis(s.table_P, p)
    v = s.table
    tf, pf = tf[..., None], pf[..., None]
    k = ((1 - tf) * ((1 - pf) * v[:, ti, pj] + pf * v[:, ti, pj + 1])
         + tf * ((1 - pf) * v[:, ti + 1, pj] + pf * v[:, ti + 1, pj + 1]))
    k = torch.where((t_ok & p_ok)[..., None], k, 0.0)
    return (s.mmr[:, None, None, None] * k).sum(0) + s.sigma


def couplers(dtau, om, B1, B2):
    """Improved two-stream couplers at g0 = 0 (Malik Eq. 12-15, the E
    correction of Deitrick Eq. 19), in the expm1 form."""
    E = torch.where(om > 0.1, 1.225 - 0.1777 * om - 0.05582 * om ** 2, 1.0)
    k_hat = torch.sqrt(E * (E - om))
    ratio = torch.sqrt((E - om) / E)
    zp, zm = 0.5 * (1.0 + ratio), 0.5 * (1.0 - ratio)
    em = torch.expm1(-2.0 * k_hat * dtau)
    tr = 1.0 + em
    zmT_zp = zm * tr + zp
    chi = (zm * tr - zp) * zmT_zp
    psi = (zm - zp) * tr
    chi_p_xi = (zm - zp) * (zm * tr ** 2 + zp)
    pi_term = math.pi * (1.0 - om) / (E - om)
    grad = (B1 - B2) * (em / dtau) * zmT_zp / (2.0 * E)
    inv_chi = 1.0 / chi
    return (psi * inv_chi, (chi_p_xi - chi) * inv_chi,
            pi_term * (B2 * chi_p_xi - psi * B1 + grad) * inv_chi,
            pi_term * (B1 * chi_p_xi - psi * B2 - grad) * inv_chi)


def _cp(ph):
    return (2.0 + ph.n_dof) / (2.0 * ph.m_bar) * const.k_B


def delta_T(bu2, bd2, bu1, bd1, T1, T2, p1, p2, ph: Physics):
    """The temperature change of a swept layer from its four bolometric
    fluxes (Malik Eq. 18-28): radiative plus mixing-length convective
    flux divergence over the adaptive timestep."""
    cp = _cp(ph)
    dz = (const.k_B * T1 / ph.m_bar) / ph.g * torch.log(p1 / p2)
    rho = ((p1 - p2) / ph.g) / dz
    dg = (T1 - T2) / dz - ph.g / cp
    dg_safe = torch.where(dg > 0, dg, 1.0)
    mix = ph.alpha * (const.k_B * T1 / ph.m_bar) / ph.g
    conv = torch.where(dg > 0, rho * cp * mix ** 2 * torch.sqrt(ph.g / T1)
                       * dg_safe ** 1.5, 0.0)
    div = ((bu2 - bd2) - (bu1 - bd1) + conv) / dz
    x = div * dz
    x_safe = torch.where(x != 0.0, x, 1.0)
    f_pre = torch.where(x != 0.0, 1e5 / torch.abs(x_safe) ** 0.9, 1.0)
    dt_rad = cp * p1 / (const.sigma_sb * ph.g * T1 ** 3)
    dt_conv = torch.sqrt(T1 / (ph.g * dg_safe))
    dt = f_pre * torch.where(dg > 0, torch.minimum(dt_rad, dt_conv), dt_rad)
    return div * dt / (rho * cp)


def _layer(s, ph, F1_up, F2_down, p1, p2, B1, B2, k):
    """One layer's outgoing (F2_up, F1_down)."""
    dtau = (p1 - p2) / _col(ph.g) * k
    om = s.sigma / (s.sigma + k)
    a, b, su, sd = couplers(dtau, om, B1, B2)
    return a * F1_up - b * F2_down + su, a * F2_down - b * F1_up + sd


def _col(x):
    return x if x.ndim == 0 else x.reshape(-1, 1)


def emit(s: Setup, ph: Physics, T, F_up, F_down):
    """One bottom-to-top emission sweep over layers 1 .. L-1.  Returns
    the new (F_up, F_down) and temperatures."""
    B, L = T.shape
    p = s.pressures
    Bp = planck(T[..., None], s.lam_cm)
    k_all = kappa(s, T)
    F_up = list(F_up.unbind(1))
    F_down = list(F_down.unbind(1))
    dT = [torch.zeros_like(T[:, 0])]
    F_toa = s.F_toa.expand(B, -1)
    for l in range(1, L):
        top = l == L - 1
        p1, p2 = p[l], (p[-1] * p[-2] / p[-3] if top else p[l + 1])
        T1, T2 = T[:, l], T[:, l if top else l + 1]
        F1_up, F2_down = F_up[l], (F_toa if top else F_down[l + 1])
        F2_up, F1_down = _layer(s, ph, F1_up, F2_down, p1, p2, Bp[:, l],
                                Bp[:, l if top else l + 1], k_all[:, l])
        bol = [f @ s.trapz_w for f in (F2_up, F2_down, F1_up, F1_down)]
        dT.append(delta_T(*bol, T1, T2, p1, p2, _ph_col(ph)))
        if not top:
            F_up[l + 1] = F2_up
        F_down[l] = F1_down
    dT = torch.stack(dT, 1)
    return torch.stack(F_up, 1), torch.stack(F_down, 1), T - dT


def absorb(s: Setup, ph: Physics, T, F_up, F_down):
    """One top-to-bottom absorption sweep over layers L-2 .. 0,
    propagating F_down with the stale F_up."""
    B, L = T.shape
    p = s.pressures
    Bp = planck(T[..., None], s.lam_cm)
    k_all = kappa(s, T)
    F_up = list(F_up.unbind(1))
    F_down = list(F_down.unbind(1))
    dT = [torch.zeros_like(T[:, 0])] * L
    for l in range(L - 2, -1, -1):
        T1, T2 = T[:, l], T[:, l + 1]
        F1_up, F2_down = F_up[l], F_down[l + 1]
        F2_up, F1_down = _layer(s, ph, F1_up, F2_down, p[l], p[l + 1],
                                Bp[:, l], Bp[:, l + 1], k_all[:, l])
        bol = [f @ s.trapz_w for f in (F2_up, F2_down, F1_up, F1_down)]
        dT[l] = delta_T(*bol, T1, T2, p[l], p[l + 1], _ph_col(ph))
        F_up[l + 1] = F2_up
        F_down[l] = F1_down
    return (torch.stack(F_up, 1), torch.stack(F_down, 1),
            T - torch.stack(dT, 1))


def _ph_col(ph: Physics) -> Physics:
    """Per-column physics against a (B,) layer row."""
    return ph._replace(g=_row(ph.g), alpha=_row(ph.alpha))


def _row(x):
    return x if x.ndim == 0 else x.reshape(-1)


class Solution(NamedTuple):
    flux: torch.Tensor         # (B, W) emergent spectrum
    final_temps: torch.Tensor  # (B, L) after the final emit


def solve(s: Setup, ph: Physics, T0, n_iterations: int) -> Solution:
    """The fixed-horizon solve: ``n_iterations`` emit/absorb pairs from
    zero flux, then one final emit (no convergence exit: the benchmark's
    traffic turns both exits off)."""
    B, L = T0.shape
    W = s.lam_cm.shape[0]
    F_up = T0.new_zeros((B, L, W))
    F_down = T0.new_zeros((B, L, W))
    T = T0
    for _ in range(n_iterations):
        F_up, F_down, T = emit(s, ph, T, F_up, F_down)
        F_up, F_down, T = absorb(s, ph, T, F_up, F_down)
    F_up, _, T = emit(s, ph, T, F_up, F_down)
    return Solution(flux=F_up[:, -1], final_temps=T)
