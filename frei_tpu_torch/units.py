"""Unit boundary for the public API.

The reference package carries `astropy.units.Quantity` objects through
every function signature and validates them with ``@u.quantity_input``
(`frei/core.py:68-70,113-116`).  Kernels take unitless arrays, so
frei_tpu_torch enforces units *only at the API boundary* and strips
everything to a documented canonical CGS system (see
``frei_tpu_torch.constants``) before any array touches the device.

Two entry styles are supported:

* plain floats / numpy arrays, interpreted in the unit documented for the
  keyword (e.g. ``T_ref`` is Kelvin, ``P_ref`` is bar);
* `astropy.units.Quantity` values if astropy is installed — they are
  converted to the canonical unit, so users migrating from the reference
  can pass the same Quantities they already have.

The helpers below never import astropy unless the user actually passes a
Quantity-like object.
"""

from __future__ import annotations

import numpy as np

from . import constants as const

__all__ = [
    "to_value", "to_kelvin", "to_bar", "to_barye", "to_micron", "to_cm",
    "to_cgs_gravity", "to_gram", "flux_cgs", "as_quantity",
    "astropy_available",
]

#: canonical flux-density unit used throughout: erg / s / cm^3
#: (= erg s^-1 cm^-2 per cm of wavelength), matching the reference's
#: ``flux_unit`` (`frei/twostream.py:13`).
FLUX_UNIT_CGS = "erg s^-1 cm^-3"


def _is_quantity(x) -> bool:
    # Avoid importing astropy: quack-check the Quantity interface.
    return hasattr(x, "unit") and hasattr(x, "to_value")


def to_value(x, unit: str):
    """Convert ``x`` to a float / ndarray in ``unit``.

    ``unit`` is an astropy-parsable unit string.  Quantities are
    converted; plain numbers are assumed to already be in ``unit``.
    """
    if _is_quantity(x):
        import astropy.units as u
        return x.to_value(u.Unit(unit))
    return np.asarray(x) if np.ndim(x) else float(x)


def to_kelvin(x):
    return to_value(x, "K")


def to_bar(x):
    return to_value(x, "bar")


def to_barye(x):
    """Pressure in CGS barye (dyn / cm^2)."""
    return np.asarray(to_bar(x)) * const.BAR_TO_CGS


def to_micron(x):
    return to_value(x, "um")


def to_cm(x):
    """Length in cm.  Plain numbers are assumed to be microns (the
    documented API wavelength unit) and converted."""
    if _is_quantity(x):
        return to_value(x, "cm")
    return np.asarray(x) * const.MICRON_TO_CM


def to_cgs_gravity(x):
    """Surface gravity in cm / s^2.  Plain numbers are assumed to be in
    m / s^2 (SI, the most common user convention) and converted."""
    if _is_quantity(x):
        return to_value(x, "cm / s2")
    return float(x) * 100.0


def to_gram(x):
    """Mass in grams.  Plain numbers are assumed to be in units of the
    proton mass (so ``m_bar=2.4`` means 2.4 m_p, the reference default,
    `frei/twostream.py:23`)."""
    if _is_quantity(x):
        return to_value(x, "g")
    return float(x) * const.m_p


def flux_cgs(x):
    """Spectral flux density in erg / s / cm^3."""
    return to_value(x, "erg / (s cm3)")


def astropy_available() -> bool:
    try:
        import astropy.units  # noqa: F401
        return True
    except ImportError:
        return False


def as_quantity(x, unit: str):
    """Units on the way OUT: attach an astropy unit when astropy is
    installed, otherwise return ``x`` unchanged (documented canonical
    units).  The reference returns Quantity-carrying outputs
    (`frei/core.py:335-338`); with astropy installed,
    downstream ``.to(...)`` code ports unchanged."""
    try:
        import astropy.units as u
    except ImportError:
        return x
    return u.Quantity(x, u.Unit(unit), copy=False)
