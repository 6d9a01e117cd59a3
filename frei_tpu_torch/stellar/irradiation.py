"""Stellar irradiation boundary condition.

Counterpart of ``frei_tpu.stellar.irradiation`` (reference
`frei/core.py:48-62`): the flux at the top of the atmosphere is the
stellar blackbody diluted by the orbital distance and a
heat-redistribution factor f (default 2/3).
"""

from __future__ import annotations

import numpy as np

from ..ops.planck import planck_lambda, planck_lambda_np

__all__ = ["b_star", "f_toa", "f_toa_np"]


def b_star(T_star, lam_cm):
    """Stellar blackbody spectral radiance (`core.py:58-62`)."""
    return planck_lambda(T_star, lam_cm)


def f_toa(lam_cm, T_star, a_rstar, f=2.0 / 3.0):
    """Top-of-atmosphere incident flux [erg / s / cm^3] on tensors:
    ``f * a_rstar^-2 * (1 / 2pi) * (pi * B(T_star, lam))``
    (`core.py:48-55`)."""
    return f / (2.0 * a_rstar ** 2) * b_star(T_star, lam_cm)


def f_toa_np(lam_cm, T_star, a_rstar, f=2.0 / 3.0):
    """Host float64 twin of :func:`f_toa`."""
    return (f / (2.0 * a_rstar ** 2)
            * planck_lambda_np(T_star, np.asarray(lam_cm)))
