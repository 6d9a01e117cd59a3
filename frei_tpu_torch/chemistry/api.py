"""Reference-parity chemistry entry point.

Counterpart of ``frei_tpu.chemistry.api``: the reference ``chemistry()``
(`frei/chemistry.py:114-205`) takes temperatures, pressures and a
collection of opacity isotopologue names and returns a dict of mass
mixing ratios (and optionally volume mixing ratios) per isotopologue,
here from this package's equilibrium solver in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
from ..units import to_barye, to_kelvin
from .fastchem import FastChemTorch
from .mocks import MockChemistry
from .names import iso_to_mass_g

__all__ = ["chemistry"]


def chemistry(temperatures, pressures, species, return_vmr=False,
              m_bar=2.4 * const.m_p, mode="exact", device="cuda"):
    """Equilibrium mass mixing ratios for each isotopologue.

    Parameters
    ----------
    temperatures : array or Quantity
        Layer temperatures [K].
    pressures : array or Quantity
        Layer pressures; plain floats in bar.
    species : iterable of str
        Isotopologue names (opacity-table keys, e.g. "1H2-16O").
    return_vmr : bool
        Also return volume mixing ratios (`chemistry.py:179-204`).
    m_bar : float or Quantity
        Mean molecular weight; plain floats in grams.
    mode : "exact" or "table" or "mock"
        Solver mode (see :class:`FastChemTorch`).
    device : where the float64 solve (or the table's build) runs: the
        card unless the caller names another device.

    Returns
    -------
    mmr : dict of isotopologue -> ndarray
    vmr : dict (only if ``return_vmr``)
    """
    T = torch.as_tensor(np.atleast_1d(to_kelvin(temperatures)),
                        dtype=torch.float64, device=device)
    P_cgs = torch.as_tensor(np.atleast_1d(to_barye(pressures)),
                            dtype=torch.float64, device=device)
    m_bar_g = float(m_bar) if not hasattr(m_bar, "unit") else \
        float(m_bar.to_value("g"))
    species = list(species)
    masses = np.array([iso_to_mass_g(s) for s in species])
    if mode == "mock":
        model = MockChemistry(masses, m_bar_g)
    else:
        model = FastChemTorch(species, m_bar_g, mode=mode,
                              build_device=device)
    vmr = model.vmr(T, P_cgs).cpu().numpy()
    # the mass mixing ratio is vmr x (m_species / m_bar): derived here
    # rather than by model.mmr(), which would solve a second time in
    # 'exact' mode
    mmr = vmr * (masses / m_bar_g).reshape((-1,) + (1,) * (vmr.ndim - 1))
    mmr_d = {s: mmr[i] for i, s in enumerate(species)}
    if return_vmr:
        return mmr_d, {s: vmr[i] for i, s in enumerate(species)}
    return mmr_d
