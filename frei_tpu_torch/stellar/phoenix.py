"""PHOENIX stellar spectrum comparison.

Counterpart of ``frei_tpu.stellar.phoenix`` (reference
`frei/phoenix.py`): fetch a PHOENIX model atmosphere spectrum for
(T_eff, log g) and bin it onto the run's wavelength grid by per-bin
mean flux (the reference's ``resolution`` map, `phoenix.py:13-17`: the
bin integral over the bin span, a trapezoid average), zero-padding bins
beyond the model's coverage (`phoenix.py:49-51`).  Host numpy: the
comparison is a diagnostic, computed once.

The download uses the optional ``expecto`` package (network I/O to the
PHOENIX archive).  Without it, :func:`get_binned_blackbody_spectrum` is
an offline stand-in.
"""

from __future__ import annotations

import numpy as np

from .. import constants as const
from ..ops.planck import planck_lambda_np
from ..units import to_cgs_gravity, to_kelvin

# np.trapz was renamed np.trapezoid in NumPy 2.0; support both
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

__all__ = ["get_binned_phoenix_spectrum", "bin_spectrum_mean",
           "get_binned_blackbody_spectrum"]


def bin_spectrum_mean(flux, wavelength_um, wl_bins_um, n_out):
    """Per-bin mean flux on right-closed bins, zero-padded to ``n_out``:
    the reference's groupby_bins + ``resolution`` map + ``np.pad``
    (`phoenix.py:46-51`); empty or out-of-range bins are zero."""
    wav = np.asarray(wavelength_um, np.float64)
    flux = np.asarray(flux, np.float64)
    edges = np.asarray(wl_bins_um, np.float64)
    n_bins = edges.shape[0] - 1
    codes = np.searchsorted(edges, wav, side="left") - 1
    codes[(wav <= edges[0]) | (wav > edges[-1])] = -1
    out = np.zeros(max(n_bins, n_out))
    for b in range(n_bins):
        sel = codes == b
        if np.count_nonzero(sel) >= 2:
            x = wav[sel]
            y = flux[sel]
            out[b] = _trapezoid(y, x) / (x.max() - x.min())
        elif np.count_nonzero(sel) == 1:
            out[b] = flux[sel][0]
    return out[:n_out]


def get_binned_phoenix_spectrum(T_eff, g, wl_bins, lam, cache=True):
    """PHOENIX spectrum binned to the run grid [erg / s / cm^3].

    Parameters as in the reference (`phoenix.py:20-52`): ``T_eff`` in K,
    ``g`` surface gravity (plain floats in m / s^2), ``wl_bins`` bin
    edges and ``lam`` bin centres in microns.  Needs ``expecto``.
    """
    try:
        from expecto import get_spectrum
    except ImportError as err:
        raise ImportError(
            "PHOENIX comparison requires the optional 'expecto' "
            "package; use get_binned_blackbody_spectrum() for an "
            "offline stand-in or plot_phoenix=False"
        ) from err
    T_eff = to_kelvin(T_eff)
    g_cgs = to_cgs_gravity(g)
    spec = get_spectrum(float(T_eff), log_g=float(np.log10(g_cgs)),
                        cache=cache)
    flux = spec.flux.to_value("erg / (s cm3)")
    wav = spec.wavelength.to_value("um")
    return bin_spectrum_mean(flux, wav, wl_bins, len(lam))


def get_binned_blackbody_spectrum(T_eff, wl_bins, lam):
    """Offline comparison spectrum: the hemispheric blackbody flux
    ``pi B_lambda(T_eff)`` at the bin centres [erg / s / cm^3]."""
    del wl_bins  # taken to match get_binned_phoenix_spectrum
    lam_cm = np.asarray(lam, np.float64) * const.MICRON_TO_CM
    return np.pi * planck_lambda_np(to_kelvin(T_eff), lam_cm)
