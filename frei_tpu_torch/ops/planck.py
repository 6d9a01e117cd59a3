"""Planck blackbody spectral radiance, unitless CGS.

PyTorch counterpart of ``frei_tpu.ops.planck``: ``planck_lambda`` works
on tensors, ``planck_lambda_np`` is the host float64 copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const

__all__ = ["planck_lambda", "planck_lambda_np", "bb_flux"]


def planck_lambda(temperature, lam_cm):
    """Planck spectral radiance B_lambda(T) in erg s^-1 cm^-3 (per sr).

    ``B = 2 h c^2 / lam^5 / expm1(h c / (lam k_B T))``
    (`frei/twostream.py:64-67`).  Broadcasts over both arguments; for
    very cold layers the exponent overflows to +inf and the result
    underflows cleanly to 0.
    """
    lam_cm = torch.as_tensor(lam_cm)
    x = const.hc_over_k / (lam_cm * temperature)
    return 2.0 * const.h * const.c ** 2 / lam_cm ** 5 / torch.expm1(x)


def planck_lambda_np(temperature, lam_cm):
    """Host (numpy, float64) twin of :func:`planck_lambda`, for
    per-configuration constants such as the TOA irradiation."""
    lam_cm = np.asarray(lam_cm, dtype=np.float64)
    x = const.hc_over_k / (lam_cm * temperature)
    return 2.0 * const.h * const.c ** 2 / lam_cm ** 5 / np.expm1(x)


def bb_flux(temperature, lam_cm):
    """Hemispheric blackbody flux ``pi * B_lambda`` [erg s^-1 cm^-3]."""
    return math.pi * planck_lambda(temperature, lam_cm)
