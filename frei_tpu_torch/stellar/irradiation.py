"""Stellar irradiation boundary condition.

Counterpart of ``frei_tpu.stellar.irradiation`` (reference
`frei/core.py:48-62`): the flux at the top of the atmosphere is the
stellar blackbody diluted by the orbital distance and a
heat-redistribution factor f (default 2/3).  :func:`f_toa_rows` builds
a population's rows, one a planet, in one batched evaluation on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.planck import planck_lambda, planck_lambda_np

__all__ = ["b_star", "f_toa", "f_toa_np", "f_toa_rows"]


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


def f_toa_rows(lam_cm, T_star, a_rstar, dtype):
    """(C, W) top-of-atmosphere rows, one a planet, from (C,) ``T_star``
    [K] and ``a_rstar`` tensors: :func:`f_toa` over the columns
    ``T_star[:, None]`` and ``a_rstar[:, None]``, evaluated in float64 on
    ``T_star``'s device and cast to ``dtype`` afterwards, as the host
    twin's rows are.  On the card row c is bit for bit
    ``f_toa(lam_cm, T_star[c], a_rstar[c])`` whatever C, each element
    running the same device ``expm1``; on the CPU, ATen's vector body
    and scalar tail round ``expm1`` apart, so that holds there only for
    elements that fall in the vector body at both shapes.  Within about
    ten ulp of :func:`f_toa_np`, whose numpy ``expm1`` and divisions
    round apart from the device's.  Counts the rows it builds in
    ``.rows``."""
    T_star = torch.as_tensor(T_star, dtype=torch.float64)
    device = T_star.device
    a_rstar = torch.as_tensor(a_rstar, dtype=torch.float64, device=device)
    lam_cm = torch.as_tensor(lam_cm, dtype=torch.float64, device=device)
    rows = f_toa(lam_cm, T_star[:, None], a_rstar[:, None])
    f_toa_rows.rows += rows.shape[0]
    return rows.to(dtype)


f_toa_rows.rows = 0
