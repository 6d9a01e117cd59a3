"""Diagnostic dashboard plot.

Counterpart of ``frei_tpu.diag.plot``: the five-panel matplotlib figure
of the reference ``dashboard`` (`frei/plot.py:16-146`): emission
spectrum against the stellar comparison, normalized contribution
function, temperature-pressure iteration history, chemistry VMR
profiles, and the opacity decomposition at 1 bar.  matplotlib is
optional: it is imported inside :func:`dashboard` only.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const

__all__ = ["contribution_function", "dashboard"]


def _np(x):
    """float64 numpy from a tensor (any device) or an array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def contribution_function(dtaus, pressures_bar, temps, lam_um):
    """Normalized emission contribution function (L, W).

    ``cf = exp(-tau) dtau (P / dP) nu^3 / expm1(h c nu / k T)``
    cumulated top-down, normalized per wavelength (`plot.py:63-79`).
    ``dtaus`` is the (L, W) final-emit optical depth array (seed row of
    ones first, layers bottom-up), pressures BOA first in bar.  Numpy
    arrays or tensors; returns numpy.
    """
    dtaus = _np(dtaus)
    pressures = _np(pressures_bar)
    temps = _np(temps)
    lam_cm = _np(lam_um) * const.MICRON_TO_CM

    tau = np.cumsum(dtaus[::-1], axis=0)           # top-down cumulation
    nus = 1.0 / lam_cm                              # [cm^-1]
    hcperk = const.h * const.c / const.k_B

    dlogP = (np.log10(pressures.max()) - np.log10(pressures.min())) \
        / (len(pressures) - 1)
    k = 10.0 ** -dlogP
    dParr = (1.0 - k) * pressures

    cf = (np.exp(-tau) * dtaus[::-1]
          * (pressures[::-1, None] / dParr[::-1, None])
          * nus[None, :] ** 3
          / np.expm1(hcperk * nus[None, :] / temps[::-1, None]))
    cf /= np.sum(cf, axis=0)
    return cf


def dashboard(grid, spec, comparison_spectrum, dtaus, final_temps,
              temperature_history):
    """Render the dashboard; returns (fig, axes).

    ``grid``: a :class:`~frei_tpu_torch.api.Grid` with opacities and
    chemistry attached; ``spec``: its ``Spectrum``;
    ``comparison_spectrum`` (W,): the stellar comparison flux (zeros to
    leave it out); ``dtaus`` (L, W) from the final emit;
    ``final_temps`` (L,) [K]; ``temperature_history`` (L, n_cols) [K].
    """
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec

    from ..chemistry.names import iso_to_species
    from ..opacity.tables import kappa_from_stack

    lam = np.asarray(grid.lam)
    pressures = np.asarray(grid.pressures)
    flux = _np(spec.flux_cgs)
    comparison_spectrum = _np(comparison_spectrum)
    final_temps = _np(final_temps)
    temperature_history = _np(temperature_history)

    fig = plt.figure(figsize=(12, 7))
    gs = GridSpec(2, 4, figure=fig)
    ax = [fig.add_subplot(a) for a in
          [gs[0, :], gs[1, 0], gs[1, 1], gs[1, 2], gs[1, 3]]]

    # --- emission spectrum (`plot.py:55-62`) ---
    if np.any(comparison_spectrum != 0):
        ax[0].loglog(lam, comparison_spectrum, color="C1",
                     label="PHOENIX")
    ax[0].loglog(lam, flux, color="C0", label="frei_tpu_torch")
    ax[0].legend()
    ax[0].set(xlabel=r"Wavelength [$\mu$m]", title="Emission spectrum")

    # --- contribution function (`plot.py:63-91`) ---
    cf = contribution_function(dtaus, pressures, final_temps, lam)
    lg, pg = np.meshgrid(lam, pressures)
    cax = ax[1].pcolormesh(lg, pg, cf[::-1], cmap="Greys",
                           shading="auto")
    plt.colorbar(cax, ax=ax[1])
    ax[1].set_yscale("log")
    ax[1].set_xscale("log")
    ax[1].invert_yaxis()
    ax[1].set(xlabel=r"Wavelength [$\mu$m]", ylabel="Pressure [bar]",
              title="Contrib Func", xlim=[lam.min(), lam.max()],
              ylim=[pressures.max(), pressures.min()])

    # --- T-P history (`plot.py:97-110`) ---
    cmap = plt.get_cmap("winter_r")
    n_hist = temperature_history.shape[1]
    for i in range(n_hist):
        if np.all(temperature_history[:, i] != 0):
            ax[2].semilogy(temperature_history[:, i], pressures,
                           c=cmap(i / max(n_hist, 1)), alpha=0.3)
    ax[2].semilogy(final_temps, pressures, "-", color="k", lw=3)
    ax[2].invert_yaxis()
    ax[2].annotate("Initial", (0.1, 0.18), color=cmap(0),
                   xycoords="axes fraction")
    ax[2].annotate("Final", (0.1, 0.1), xycoords="axes fraction")
    ax[2].set(xlabel="Temperature [K]", ylabel="Pressure [bar]")

    # --- chemistry profiles (`plot.py:112-129`), on the grid's device ---
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=grid.dtype,
                               device=grid.device)
    vmr = _np(grid.chemistry.vmr(t(final_temps),
                                 t(pressures * const.BAR_TO_CGS)))
    for s, name in enumerate(grid.opacities.species):
        ax[3].semilogy(np.log10(np.maximum(vmr[s], 1e-30)), pressures,
                       label=iso_to_species(name).replace("2", "$_2$"),
                       lw=2)
    ax[3].legend()
    ax[3].invert_yaxis()
    ax[3].set(xlabel="log(VMR)", ylabel="Pressure [bar]",
              title="Chemistry", ylim=ax[1].get_ylim())

    # --- opacity at 1 bar (`plot.py:131-141`) ---
    T_1bar = np.interp(1.0, pressures[::-1], final_temps[::-1])
    P_1bar = t([1.0 * const.BAR_TO_CGS])
    mmr = grid.chemistry.mmr(t([T_1bar]), P_1bar)
    k_tot, sigma = kappa_from_stack(grid.opacities, mmr, t([T_1bar]),
                                    P_1bar, grid._consts.sigma_scat)
    ax[4].loglog(lam, _np(k_tot)[0], label="Total")
    ax[4].loglog(lam, _np(sigma), label="Scattering")
    ax[4].set(xlabel=r"Wavelength [$\mu$m]",
              ylabel=r"Opacity [cm$^2$ g$^{-1}$]")
    ax[4].legend()

    for axis in ax:
        for sp in ["right", "top"]:
            axis.spines[sp].set_visible(False)
    fig.tight_layout()
    return fig, ax
