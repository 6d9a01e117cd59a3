"""Constant-VMR mock chemistry.

Counterpart of ``frei_tpu.chemistry.mocks`` (reference mock FastChem
path, `frei/chemistry.py:207-246`): every species gets a constant
volume mixing ratio of 1.5e-3, converted to a mass mixing ratio with
the species mass.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MockChemistry", "MOCK_VMR"]

MOCK_VMR = 1.5e-3  # `chemistry.py:243`


class MockChemistry:
    """Constant-VMR chemistry model.

    Parameters
    ----------
    species_masses_g : array (S,)
        Mass of each opacity species in grams.
    m_bar_g : float
        Mean molecular weight in grams.
    """

    def __init__(self, species_masses_g, m_bar_g):
        self.species_masses_g = np.asarray(species_masses_g, np.float64)
        self.m_bar_g = float(m_bar_g)

    def vmr(self, temperatures, pressures_cgs):
        """Volume mixing ratios, shape (S,) + T.shape."""
        shape = (self.species_masses_g.shape[0],) + tuple(temperatures.shape)
        return torch.full(shape, MOCK_VMR, dtype=temperatures.dtype,
                          device=temperatures.device)

    def mmr(self, temperatures, pressures_cgs):
        """Mass mixing ratios ``vmr * m_species / m_bar``
        (`chemistry.py:197-199`), shape (S,) + T.shape."""
        v = self.vmr(temperatures, pressures_cgs)
        scale = torch.as_tensor(self.species_masses_g / self.m_bar_g,
                                dtype=v.dtype, device=v.device)
        return v * scale.reshape(scale.shape + (1,) * (v.ndim - 1))

    def layer_ln_mmr_tables(self, pressures_cgs):
        """Layer-factored form for the whole-iteration kernels: a
        (log10 T grid (2,), ln-MMR table (L, 2, S)) pair such that
        ``mmr = exp(interp_logT(table[l]))`` with clipped interpolation
        (`frei_tpu/chemistry/mocks.py:48-58`).  Constant chemistry is a
        trivial 2-point grid.  Tensors in the pressures' dtype and on
        their device."""
        p = pressures_cgs
        L = p.shape[0]
        S = self.species_masses_g.shape[0]
        ln_mmr = torch.log(MOCK_VMR * torch.as_tensor(
            self.species_masses_g, dtype=p.dtype, device=p.device)
            / self.m_bar_g)
        tab = ln_mmr[None, None, :].expand(L, 2, S).contiguous()
        return torch.tensor([0.0, 10.0], dtype=p.dtype, device=p.device), tab
