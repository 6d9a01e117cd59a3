"""Grid construction: wavelength, pressure and initial temperature grids.

Host-side (numpy, float64) builders for the static grids that
parameterize a radiative-transfer solve.  They are built once per
configuration and then moved to device as compile-time constants, so
there is no reason to trace them.

Numerical parity: reproduces the reference builders
``wavelength_grid`` (`frei/core.py:34-45`),
``pressure_grid`` (`frei/tp.py:10-33`) and
``temperature_grid`` (`frei/tp.py:36-62`) exactly,
including the bottom-of-atmosphere-first pressure ordering
(`tp.py:32` reverses the logspace).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import constants as const

__all__ = [
    "wavelength_grid", "pressure_grid", "temperature_grid",
    "trapezoid_weights", "RTGrid",
]


def wavelength_grid(min_micron=0.5, max_micron=10.0, n_bins=500, lam=None):
    """Log-spaced wavelength grid, bin edges, and resolution.

    Parameters
    ----------
    min_micron, max_micron : float
        Wavelength range in microns.
    n_bins : int
        Number of log-spaced wavelength points.
    lam : ndarray or None
        Optional externally supplied wavelength grid in microns; if
        given, only the edges and resolution are derived from it.

    Returns
    -------
    lam : ndarray, shape (n_bins,)
        Bin-center wavelengths [micron].
    wl_bins : ndarray, shape (n_bins + 1,)
        Bin edges [micron], constructed exactly as the reference does
        (`core.py:40-43`): prepend ``lam[0] - dlam`` then shift
        everything up by ``dlam / 2`` with ``dlam = lam[1] - lam[0]``.
    R : float
        Spectral resolution at mid-grid (`core.py:44`).
    """
    if lam is None:
        lam = np.logspace(np.log10(min_micron), np.log10(max_micron), n_bins)
    else:
        lam = np.asarray(lam, dtype=np.float64)
        if lam.ndim != 1 or lam.shape[0] < 2:
            raise ValueError("lam must be a 1-D grid with >= 2 points")
        if not np.all(np.diff(lam) > 0):
            # wavenumber-ordered data arrives descending: reversed
            # edges silently break the ETL's searchsorted crop and
            # bin assignment — fail here, not three layers down
            raise ValueError(
                "lam must be strictly ascending in wavelength "
                "(wavenumber-ordered input? reverse it: lam[::-1])")
    dlam = lam[1] - lam[0]
    wl_bins = np.concatenate([[lam.min() - dlam], lam]) + dlam / 2
    mid = lam.shape[0] // 2
    R = float(lam[mid] / (lam[mid + 1] - lam[mid]))
    return lam, wl_bins, R


def pressure_grid(n_layers=30, log10_P_toa=-6.0, log10_P_boa=1.1):
    """Log-spaced pressure grid in bar, ordered bottom-of-atmosphere
    first (highest pressure at index 0), as in `tp.py:32`."""
    return np.logspace(log10_P_toa, log10_P_boa, n_layers)[::-1].copy()


def temperature_grid(pressures_bar, T_ref=2300.0, P_ref=0.1, alpha=0.1):
    """Power-law initial T(P) guess: ``T_ref * (P / P_ref)**alpha``
    (`tp.py:61`). ``pressures_bar`` in bar, returns Kelvin."""
    return T_ref * (np.asarray(pressures_bar) / P_ref) ** alpha


def trapezoid_weights(x):
    """Quadrature weights w such that ``dot(f, w) == np.trapz(f, x)``.

    The reference integrates bolometric fluxes with ``np.trapz``
    (`frei/twostream.py:16-20`) inside the per-layer loop.  Expressing
    the trapezoid rule as a dot product turns every bolometric integral
    of a batch of spectra into a single matrix-vector product.
    """
    x = np.asarray(x, dtype=np.float64)
    dx = np.diff(x)
    w = np.zeros_like(x)
    w[0] = dx[0] / 2
    w[-1] = dx[-1] / 2
    w[1:-1] = (dx[:-1] + dx[1:]) / 2
    return w


class RTGrid(NamedTuple):
    """Static grids for one radiative-transfer configuration, in CGS.

    All arrays are host numpy float64; the solver casts them to the
    configured compute dtype when building the jitted program.
    """

    lam_cm: np.ndarray          # (W,) wavelength bin centers [cm]
    wl_edges_cm: np.ndarray     # (W + 1,) wavelength bin edges [cm]
    pressures_cgs: np.ndarray   # (L,) layer pressures, BOA first [barye]
    init_temperatures: np.ndarray  # (L,) initial temperatures [K]
    trapz_w_cm: np.ndarray      # (W,) bolometric quadrature weights [cm]
    R: float                    # spectral resolution at mid-grid

    @property
    def n_layers(self) -> int:
        return self.pressures_cgs.shape[0]

    @property
    def n_wavelengths(self) -> int:
        return self.lam_cm.shape[0]

    @property
    def lam_micron(self) -> np.ndarray:
        return self.lam_cm / const.MICRON_TO_CM

    @property
    def pressures_bar(self) -> np.ndarray:
        return self.pressures_cgs / const.BAR_TO_CGS


def make_rt_grid(
    lam_min_micron=0.5, lam_max_micron=10.0, n_wl_bins=500,
    P_toa_bar=1e-6, P_boa_bar=200.0, n_layers=30,
    T_ref=2300.0, P_ref_bar=0.1, alpha=0.1,
    lam_micron=None, pressures_bar=None, init_temperatures=None,
) -> RTGrid:
    """Build the full static grid set (defaults match `core.py:121-125`)."""
    lam, edges, R = wavelength_grid(
        lam_min_micron, lam_max_micron, n_wl_bins, lam=lam_micron
    )
    if pressures_bar is None:
        pressures_bar = pressure_grid(
            n_layers, np.log10(P_toa_bar), np.log10(P_boa_bar)
        )
    else:
        pressures_bar = np.asarray(pressures_bar, dtype=np.float64)
    if pressures_bar.shape[0] < 3:
        # The emit sweep's top-boundary pressure extrapolation uses
        # p[-1] * p[-2] / p[-3] (`twostream.py:358-359`): three layers
        # minimum.  (The reference fails on this with an opaque
        # IndexError; we fail loudly at construction.)
        raise ValueError("the pressure grid needs at least 3 layers")
    if not np.all(np.diff(pressures_bar) < 0):
        # the solver's dtau factors are p1 - p2 per swept layer: a
        # TOA-first (ascending) grid flips every optical depth sign
        # and the solve runs to unphysical results with no error
        raise ValueError(
            "pressures must be strictly descending, "
            "bottom-of-atmosphere first (`tp.py:32` convention); got "
            "an ascending/unsorted grid — reverse it: pressures[::-1]")
    if init_temperatures is None:
        init_temperatures = temperature_grid(
            pressures_bar, T_ref=T_ref, P_ref=P_ref_bar, alpha=alpha
        )
    else:
        init_temperatures = np.asarray(init_temperatures, dtype=np.float64)
    lam_cm = lam * const.MICRON_TO_CM
    return RTGrid(
        lam_cm=lam_cm,
        wl_edges_cm=edges * const.MICRON_TO_CM,
        pressures_cgs=pressures_bar * const.BAR_TO_CGS,
        init_temperatures=init_temperatures,
        trapz_w_cm=trapezoid_weights(lam_cm),
        R=R,
    )
