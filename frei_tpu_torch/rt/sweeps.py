"""Batched emit / absorb layer sweeps in plain PyTorch.

Counterpart of ``frei_tpu.rt.sweeps`` with the column axis written
out: every tensor carries a leading batch axis of B columns, where the
JAX package vmaps a single-column sweep.  Within a sweep the propagated
flux is a first-order affine recurrence over layers
(`frei/twostream.py:383-394,511-522`); it runs here as a Python loop
over layers on (B, W) tensors, in the reference's Gauss-Seidel order,
or with ``associative=True`` as a log-depth prefix scan of the affine
maps (``frei_tpu``'s ``lax.associative_scan``, for deep grids).
Everything else (couplers, Planck sources, quadratures and the
temperature tendencies) is vectorized over all layers.

Boundary quirks kept from the reference: the top-layer pressure
extrapolation ``p2 = p[-1] p[-2] / p[-3]``, dtau output seeded with a
row of ones, emit leaving layer 0 untouched and never storing the top
layer's outgoing flux, absorb leaving the top F_down and bottom F_up
rows untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.planck import planck_lambda
from ..ops.twostream import two_stream_couplers
from . import physics
from .physics import PhysicsParams

__all__ = ["SweepResult", "emit_sweep", "absorb_sweep", "bolometric_flux",
           "emit_dtaus", "top_pressure"]


def top_pressure(p):
    """Pressures above each emit-swept layer: ``p[2:]`` followed by the
    extrapolated ``p[-1] p[-2] / p[-3]`` (`twostream.py:358-359`)."""
    return torch.cat([p[2:], (p[-1] * p[-2] / p[-3])[None]])


def _slab_g(g):
    """Gravity against (B, L-1, W) slabs: a scalar, or per column (B, 1)
    as (B, 1, 1)."""
    return g if torch.as_tensor(g).ndim == 0 else g[..., None]


def emit_dtaus(k_all, pressures, params):
    """The dtaus diagnostic of an emit sweep (`twostream.py:352,371`):
    a row of ones followed by the per-swept-layer optical depths, over
    any leading batch axes of ``k_all``."""
    p = pressures
    dtau = physics.delta_tau(k_all[..., 1:, :], p[1:, None],
                             top_pressure(p)[:, None], _slab_g(params.g))
    ones = torch.ones_like(k_all[..., :1, :])
    return torch.cat([ones, dtau], dim=-2)


class SweepResult(NamedTuple):
    F_up: torch.Tensor      # (B, L, W) updated upward fluxes
    F_down: torch.Tensor    # (B, L, W) updated downward fluxes
    temps: torch.Tensor     # (B, L) updated temperatures
    dT: torch.Tensor        # (B, L) temperature change (T_new = T - dT)
    dtaus: torch.Tensor     # (B, L, W) [ones, dtau per swept layer]


def bolometric_flux(flux, trapz_w):
    """``np.trapz(flux, lam)`` as a quadrature dot product
    (`twostream.py:16-20`)."""
    return flux @ trapz_w


def _affine_prefix_seq(A, c, init):
    """z_j = A_j z_{j-1} + c_j along axis 1, seeded with ``init``."""
    out = []
    z = init
    for j in range(A.shape[1]):
        z = A[:, j] * z + c[:, j]
        out.append(z)
    return torch.stack(out, dim=1)


def _affine_prefix_assoc(A, c, init):
    """The same prefix map in ceil(log2 n) doubling steps over the n
    layers of axis 1: step d composes each map with the one d layers
    below it, ``(a_r a_l, a_r c_l + c_r)``, built out of place, then
    ``z = A_pref init + c_pref`` (`frei_tpu/rt/sweeps.py:89-97`)."""
    n = A.shape[1]
    d = 1
    while d < n:
        A, c = (torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], dim=1),
                torch.cat([c[:, :d], A[:, d:] * c[:, :-d] + c[:, d:]],
                          dim=1))
        d *= 2
    return A * init[:, None] + c


def _affine_prefix(A, c, init, associative):
    if associative:
        return _affine_prefix_assoc(A, c, init)
    return _affine_prefix_seq(A, c, init)


def emit_sweep(temps, F_up, F_down, k_all, sigma_scat, F_toa,
               lam_cm, trapz_w, pressures, params: PhysicsParams,
               associative: bool = False) -> SweepResult:
    """One bottom-to-top emission sweep (`twostream.py:290-421`).

    ``temps`` (B, L); ``F_up``, ``F_down``, ``k_all`` (B, L, W);
    ``sigma_scat``, ``lam_cm``, ``trapz_w`` (W,); ``F_toa`` (W,), or
    (B, W) per column; ``pressures`` (L,), bottom of the atmosphere
    first.  ``params`` fields are scalars or (B, 1) per-column values.
    ``associative`` runs the layer recurrence as a log-depth scan.
    """
    B = temps.shape[0]
    p = pressures
    T1 = temps[:, 1:]
    p1 = p[1:]
    p2 = top_pressure(p)
    T2 = torch.cat([temps[:, 2:], temps[:, -1:]], dim=1)

    k = k_all[:, 1:]
    dtau = physics.delta_tau(k, p1[:, None], p2[:, None], _slab_g(params.g))
    omega_0 = sigma_scat / (sigma_scat + k)

    # one Planck evaluation per layer; B1/B2 are shifted views
    B_all = planck_lambda(temps[..., None], lam_cm)
    B1 = B_all[:, 1:]
    B2 = torch.cat([B_all[:, 2:], B_all[:, -1:]], dim=1)
    cp = two_stream_couplers(dtau, omega_0, B1, B2, g_0=0.0)

    W = F_toa.shape[-1]
    F2_down = torch.cat(
        [F_down[:, 2:], F_toa.reshape(-1, 1, W).expand(B, 1, W)], dim=1)
    c = -cp.b * F2_down + cp.s_up
    z = _affine_prefix(cp.a, c, F_up[:, 1], associative)  # F_2_up per layer
    u = torch.cat([F_up[:, 1:2], z[:, :-1]], dim=1)     # F_1_up per layer

    F1_down = cp.a * F2_down - cp.b * u + cp.s_down

    F_up_new = torch.cat([F_up[:, :2], z[:, :-1]], dim=1)
    F_down_new = torch.cat([F_down[:, :1], F1_down], dim=1)

    bu2 = bolometric_flux(z, trapz_w)
    bd2 = bolometric_flux(F2_down, trapz_w)
    bu1 = bolometric_flux(u, trapz_w)
    bd1 = bolometric_flux(F1_down, trapz_w)
    div, dz = physics.div_bol_net_flux(bu2, bd2, bu1, bd1,
                                       T1, T2, p1, p2, params)
    dt = physics.radiative_timestep(T1, T2, p1, p2, div, dz, params)
    dT_swept = physics.delta_temperature(div, dt, T1, p1, p2, params)
    dT = torch.cat([torch.zeros_like(temps[:, :1]), dT_swept], dim=1)

    dtaus = torch.cat([torch.ones_like(dtau[:, :1]), dtau], dim=1)
    return SweepResult(F_up_new, F_down_new, temps - dT, dT, dtaus)


def absorb_sweep(temps, F_up, F_down, k_all, sigma_scat, F_toa,
                 lam_cm, trapz_w, pressures, params: PhysicsParams,
                 associative: bool = False) -> SweepResult:
    """One top-to-bottom absorption sweep (`twostream.py:424-550`):
    layers L-2 .. 0, propagating F_down with the stale F_up."""
    del F_toa  # enters only through the caller-maintained F_down state
    p = pressures
    T1 = temps[:, :-1]
    T2 = temps[:, 1:]
    p1 = p[:-1]
    p2 = p[1:]

    k = k_all[:, :-1]
    dtau = physics.delta_tau(k, p1[:, None], p2[:, None], _slab_g(params.g))
    omega_0 = sigma_scat / (sigma_scat + k)

    B_all = planck_lambda(temps[..., None], lam_cm)
    B1 = B_all[:, :-1]
    B2 = B_all[:, 1:]
    cp = two_stream_couplers(dtau, omega_0, B1, B2, g_0=0.0)

    F1_up_stale = F_up[:, :-1]
    c = -cp.b * F1_up_stale + cp.s_down
    d = torch.flip(_affine_prefix(torch.flip(cp.a, [1]), torch.flip(c, [1]),
                                  F_down[:, -1], associative),
                   [1])                                  # F_1_down per layer
    d_next = torch.cat([d[:, 1:], F_down[:, -1:]], dim=1)  # F_2_down

    F2_up = cp.a * F1_up_stale - cp.b * d_next + cp.s_up

    F_down_new = torch.cat([d, F_down[:, -1:]], dim=1)
    F_up_new = torch.cat([F_up[:, :1], F2_up], dim=1)

    bu2 = bolometric_flux(F2_up, trapz_w)
    bd2 = bolometric_flux(d_next, trapz_w)
    bu1 = bolometric_flux(F1_up_stale, trapz_w)
    bd1 = bolometric_flux(d, trapz_w)
    div, dz = physics.div_bol_net_flux(bu2, bd2, bu1, bd1,
                                       T1, T2, p1, p2, params)
    dt = physics.radiative_timestep(T1, T2, p1, p2, div, dz, params)
    dT_swept = physics.delta_temperature(div, dt, T1, p1, p2, params)
    dT = torch.cat([dT_swept, torch.zeros_like(temps[:, :1])], dim=1)

    dtaus = torch.cat([torch.ones_like(dtau[:, :1]), torch.flip(dtau, [1])],
                      dim=1)
    return SweepResult(F_up_new, F_down_new, temps - dT, dT, dtaus)
