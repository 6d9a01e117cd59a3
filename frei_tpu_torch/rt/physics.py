"""Radiative-convective time-step physics, branch-free and batched.

PyTorch counterpart of ``frei_tpu.rt.physics`` (Malik et al. 2017
Eqs. 18-28, `frei/twostream.py:16-287`): every function is elementwise
over (layers,) or (columns, layers) tensors, with the reference's
Python branches as ``torch.where`` selects.  Formulas, association
order and the NaN-safe double selects are those of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const

__all__ = ["PhysicsParams", "c_p", "delta_z", "delta_tau", "rho_p",
           "gamma_lapse", "gamma_adiabatic", "delta_gamma",
           "mixing_length", "convective_flux", "div_bol_net_flux",
           "radiative_timestep", "delta_temperature"]


class PhysicsParams(NamedTuple):
    """Physical parameters of one column (CGS floats or 0-d tensors).

    Defaults are the reference's: ``m_bar = 2.4 m_p``, ``n_dof = 5``,
    ``alpha = 1`` (`frei/twostream.py:23,98,291-293`).
    """

    g: float = const.g_jup            # surface gravity [cm / s^2]
    m_bar: float = 2.4 * const.m_p    # mean molecular weight [g]
    alpha: float = 1.0                # mixing-length scale heights
    n_dof: int = 5                    # molecular degrees of freedom


def c_p(params: PhysicsParams):
    """Specific heat capacity (Malik Eq. 25, `twostream.py:220-224`)."""
    return (2.0 + params.n_dof) / (2.0 * params.m_bar) * const.k_B


def delta_z(T_1, p_1, p_2, params: PhysicsParams):
    """Layer geometric thickness (Malik Eq. 18, `twostream.py:180-187`).

    Sequential divisions on purpose: ``m_bar * g`` is a ~1e-20 CGS
    product whose reciprocal overflows float32 under differentiation."""
    return (const.k_B * T_1 / params.m_bar) / params.g \
        * torch.log(p_1 / p_2)


def delta_tau(kappa, p_1, p_2, g):
    """Layer optical depth (Malik Eq. 19, `twostream.py:227-231`)."""
    return (p_1 - p_2) / g * kappa


def rho_p(T_1, p_1, p_2, params: PhysicsParams):
    """Local mass density (`twostream.py:234-238`)."""
    return ((p_1 - p_2) / params.g) / delta_z(T_1, p_1, p_2, params)


def gamma_lapse(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Temperature lapse rate dT/dz (`twostream.py:241-250`)."""
    return (T_1 - T_2) / delta_z(T_1, p_1, p_2, params)


def gamma_adiabatic(params: PhysicsParams):
    """Adiabatic lapse rate g / c_p (`twostream.py:253-254`)."""
    return params.g / c_p(params)


def delta_gamma(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Super-adiabaticity gamma - gamma_ad (`twostream.py:257-266`)."""
    return gamma_lapse(T_1, T_2, p_1, p_2, params) - gamma_adiabatic(params)


def mixing_length(T_1, params: PhysicsParams):
    """Mixing length alpha * k_B T / (m_bar g) (`twostream.py:269-270`),
    with the same sequential divisions as :func:`delta_z`."""
    return params.alpha * (const.k_B * T_1 / params.m_bar) / params.g


def convective_flux(T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Mixing-length convective flux, gated on super-adiabaticity
    (`twostream.py:273-287`).  The 1.5-power is taken of a clamped
    argument so the untaken branch never produces NaN."""
    dg = delta_gamma(T_1, T_2, p_1, p_2, params)
    dg_safe = torch.where(dg > 0, dg, 1.0)
    flux = (rho_p(T_1, p_1, p_2, params) * c_p(params)
            * mixing_length(T_1, params) ** 2
            * torch.sqrt(params.g / T_1) * dg_safe ** 1.5)
    return torch.where(dg > 0, flux, 0.0)


def div_bol_net_flux(F_2_up_bol, F_2_down_bol, F_1_up_bol, F_1_down_bol,
                     T_1, T_2, p_1, p_2, params: PhysicsParams):
    """Divergence of the bolometric net flux (Malik Eq. 23,
    `twostream.py:190-205`).  Returns (div, dz)."""
    delta_F_rad = (F_2_up_bol - F_2_down_bol) - (F_1_up_bol - F_1_down_bol)
    delta_F_conv = convective_flux(T_1, T_2, p_1, p_2, params)
    dz = delta_z(T_1, p_1, p_2, params)
    return (delta_F_rad + delta_F_conv) / dz, dz


def radiative_timestep(T_1, T_2, p_1, p_2, div, dz, params: PhysicsParams):
    """Adaptive timestep (Malik Eqs. 27-28, `twostream.py:23-43`).

    The prefactor ``1e5 / |div dz|^0.9`` is guarded by a double select:
    at ``div dz == 0`` the untaken branch would be ``1e5 / 0``."""
    dF_dz = div * dz
    dF_safe = torch.where(dF_dz != 0.0, dF_dz, 1.0)
    f_pre = torch.where(dF_dz != 0.0,
                        1e5 / torch.abs(dF_safe) ** 0.9,
                        1.0)
    dt_rad = c_p(params) * p_1 / (const.sigma_sb * params.g * T_1 ** 3)
    dg = delta_gamma(T_1, T_2, p_1, p_2, params)
    dg_safe = torch.where(dg > 0, dg, 1.0)
    dt_conv = torch.sqrt(T_1 / (params.g * dg_safe))
    dt = torch.where(dg > 0, torch.minimum(dt_rad, dt_conv), dt_rad)
    return f_pre * dt


def delta_temperature(div, dt, T_1, p_1, p_2, params: PhysicsParams):
    """Temperature update (Malik Eq. 24, `twostream.py:208-217`):
    ``div * dt / (rho c_p)``, with the configured ``params.m_bar``."""
    return div * dt / (rho_p(T_1, p_1, p_2, params) * c_p(params))
