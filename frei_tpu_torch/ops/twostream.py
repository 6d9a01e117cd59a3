"""Improved two-stream radiative transfer couplers.

PyTorch counterpart of ``frei_tpu.ops.twostream``: the closed-form
improved two-stream flux propagation of Malik et al. (2017) Eq. 12-15
with the E-correction of Deitrick et al. (2020) Eq. 19, in the
float32-stable factored form derived in ``frei_tpu.ops.twostream``
(``chi - psi - xi = expm1(-2 k dtau) * (zm T + zp)``), so the
Planck-gradient source term tends smoothly to ``-2k (B1 - B2)`` in the
optically thin limit.  ``torch.expm1`` is used throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["e_correction", "TwoStreamCouplers", "two_stream_couplers",
           "two_stream_couplers_g0", "propagate_fluxes"]


def e_correction(omega_0, g_0):
    """Improved two-stream correction term E(omega_0, g_0) (Deitrick
    et al. 2020 Eq. 19, `frei/twostream.py:70-94`): a fitted polynomial
    for omega_0 > 0.1 and exactly 1 otherwise."""
    poly = (1.225 - 0.1582 * g_0 - 0.1777 * omega_0 - 0.07465 * g_0 ** 2
            + 0.2351 * omega_0 * g_0 - 0.05582 * omega_0 ** 2)
    return torch.where(omega_0 > 0.1, poly, 1.0)


class TwoStreamCouplers(NamedTuple):
    """Per-(layer, wavelength) couplers of the affine flux maps

        F_2_up   = a * F_1_up   - b * F_2_down + s_up
        F_1_down = a * F_2_down - b * F_1_up   + s_down
    """

    a: torch.Tensor        # psi / chi: transmission-like coupling
    b: torch.Tensor        # xi / chi: reflection-like coupling
    s_up: torch.Tensor     # upward thermal source term [flux]
    s_down: torch.Tensor   # downward thermal source term [flux]


def two_stream_couplers(delta_tau, omega_0, B1, B2, g_0=0.0):
    """Affine two-stream couplers for a set of layers
    (`frei/twostream.py:139-176`), in the factored expm1 form."""
    E = e_correction(omega_0, g_0)
    one_m_wg = 1.0 - omega_0 * g_0
    k_hat = torch.sqrt(E * (E - omega_0) * one_m_wg)
    ratio = torch.sqrt((E - omega_0) / (E * one_m_wg))
    zp = 0.5 * (1.0 + ratio)
    zm = 0.5 * (1.0 - ratio)

    em = torch.expm1(-2.0 * k_hat * delta_tau)     # = T - 1, in (-1, 0]
    T = 1.0 + em                                   # transmission

    zmT_zp = zm * T + zp
    chi = (zm * T - zp) * zmT_zp                   # < 0 always
    psi = (zm - zp) * T
    chi_p_xi = (zm - zp) * (zm * T ** 2 + zp)      # chi + xi
    pi_term = math.pi * (1.0 - omega_0) / (E - omega_0)

    grad = (B1 - B2) * (em / delta_tau) * zmT_zp / (2.0 * E * one_m_wg)
    s_up_raw = pi_term * (B2 * chi_p_xi - psi * B1 + grad)
    s_down_raw = pi_term * (B1 * chi_p_xi - psi * B2 - grad)

    inv_chi = 1.0 / chi
    xi = chi_p_xi - chi
    return TwoStreamCouplers(
        a=psi * inv_chi,
        b=xi * inv_chi,
        s_up=s_up_raw * inv_chi,
        s_down=s_down_raw * inv_chi,
    )


def two_stream_couplers_g0(delta_tau, omega_0, B1, B2):
    """``two_stream_couplers`` at ``g_0 = 0`` (the only value the
    reference uses, `frei/twostream.py:389,518`) with one rsqrt and
    three divides per element: the form the sweep kernels
    (``csrc/sweep.cu``) and their plain twins evaluate, equal to the
    general form in real arithmetic."""
    E = e_correction(omega_0, 0.0)
    d = E - omega_0
    s = torch.rsqrt(E * d)
    k_hat = E * d * s
    ratio = d * s
    zp = 0.5 * (1.0 + ratio)
    zm = 0.5 * (1.0 - ratio)

    em = torch.expm1(-2.0 * k_hat * delta_tau)     # = T - 1, in (-1, 0]
    T = 1.0 + em

    zmT_zp = zm * T + zp
    chi = (zm * T - zp) * zmT_zp                   # < 0 always
    psi = (zm - zp) * T
    chi_p_xi = (zm - zp) * (zm * T ** 2 + zp)      # chi + xi

    # grad = (B1-B2) * (em/dtau) * zmT_zp / (2 E); 1/(2E) = s^2 d / 2
    grad = (B1 - B2) * (em / delta_tau) * zmT_zp * (0.5 * s * s * d)
    s_up_raw = B2 * chi_p_xi - psi * B1 + grad
    s_down_raw = B1 * chi_p_xi - psi * B2 - grad

    inv_dchi = 1.0 / (d * chi)
    inv_chi = d * inv_dchi
    pi_scale = (math.pi * (1.0 - omega_0)) * inv_dchi
    xi = chi_p_xi - chi
    return TwoStreamCouplers(
        a=psi * inv_chi,
        b=xi * inv_chi,
        s_up=s_up_raw * pi_scale,
        s_down=s_down_raw * pi_scale,
    )


def propagate_fluxes(F_1_up, F_2_down, B1, B2, delta_tau,
                     omega_0=0.0, g_0=0.0):
    """Propagate fluxes across one layer (`frei/twostream.py:97-177`),
    parameterized on the interface Planck radiances.

    Returns ``(F_2_up, F_1_down)``."""
    omega_0 = torch.as_tensor(omega_0, dtype=delta_tau.dtype,
                              device=delta_tau.device)
    cp = two_stream_couplers(delta_tau, omega_0, B1, B2, g_0)
    F_2_up = cp.a * F_1_up - cp.b * F_2_down + cp.s_up
    F_1_down = cp.a * F_2_down - cp.b * F_1_up + cp.s_down
    return F_2_up, F_1_down
