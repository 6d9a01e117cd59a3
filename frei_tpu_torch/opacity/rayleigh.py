"""Rayleigh scattering cross sections for H2 and He.

Equivalent of `frei/opacity.py:173-200` (Malik 2017
Eq. 16/17, Deitrick 2020 Eq. C3).  Computed on the HOST in float64:
the scattering opacity depends only on the static wavelength grid and
the mean molecular weight, so it is a per-configuration constant — and
the naive expression contains intermediates like ``1 / n_ref**2``
(~1.4e-39) that underflow float32 and would be flushed to zero on the device.
The host-precomputed (W,) vector is shipped to device once.
"""

from __future__ import annotations

import numpy as np

from .. import constants as const

__all__ = ["rayleigh_h2", "rayleigh_he", "rayleigh_total"]

# Reference number densities at standard conditions (`opacity.py:23-25`)
N_REF_H2 = 2.68678e19   # [cm^-3]
N_REF_HE = 2.546899e19  # [cm^-3]
K_LAMBDA = 1.0


def n_lambda_h2(lam_cm):
    """Refractive index of H2 (Malik 2017 Eq. 17, `opacity.py:173-177`)."""
    lam_cm = np.asarray(lam_cm, dtype=np.float64)
    return 13.58e-5 * (1.0 + 7.52e-11 / lam_cm ** 2) + 1.0


def n_lambda_he(lam_cm):
    """Refractive index of He (Deitrick 2020 Eq. C3, `opacity.py:180-184`)."""
    lam_um = np.asarray(lam_cm, dtype=np.float64) / const.MICRON_TO_CM
    return 1e-8 * (2283.0 + 1.8102e13 / (1.5342e10 - lam_um ** -2)) + 1.0


def _rayleigh(lam_cm, n_lam, n_ref, m_bar_g):
    lorentz = ((n_lam ** 2 - 1.0) / (n_lam ** 2 + 2.0)) ** 2
    sigma = (24.0 * np.pi ** 3 / n_ref ** 2 / np.asarray(lam_cm) ** 4
             * lorentz * K_LAMBDA)
    return sigma / m_bar_g  # [cm^2 / g]


def rayleigh_h2(lam_cm, m_bar_g=2.4 * const.m_p):
    """H2 Rayleigh scattering opacity [cm^2/g] (`opacity.py:187-192`)."""
    return _rayleigh(lam_cm, n_lambda_h2(lam_cm), N_REF_H2, m_bar_g)


def rayleigh_he(lam_cm, m_bar_g=2.4 * const.m_p):
    """He Rayleigh scattering opacity [cm^2/g] (`opacity.py:195-200`)."""
    return _rayleigh(lam_cm, n_lambda_he(lam_cm), N_REF_HE, m_bar_g)


def rayleigh_total(lam_cm, m_bar_g=2.4 * const.m_p):
    """sigma_scattering = rayleigh_H2 + rayleigh_He (`opacity.py:233`)."""
    return rayleigh_h2(lam_cm, m_bar_g) + rayleigh_he(lam_cm, m_bar_g)
