"""The benchmark's inputs, frozen: the grid, the opacity fixture and the
seeded draws.  Host numpy, float64.  The program and the plain
reference both receive what these functions return.

Sources of the frozen copies:
- the grid builders: frei_tpu_torch/grids.py (reference frei
  `core.py:34-45`, `tp.py:10-62`);
- the opacity fixture: frei_tpu_torch/opacity/tables.py
  `load_example_opacity` (reference `frei/opacity.py:272-342` without
  its x5 prefactor), as chip_smoke.py `make_grid` calls it;
- the Rayleigh opacity: frei_tpu_torch/opacity/rayleigh.py
  (`frei/opacity.py:173-200`);
- the irradiation: frei_tpu_torch/stellar/irradiation.py `f_toa_np`
  (`frei/core.py:48-62`);
- the initial profiles: chip_smoke.py `columns` (bench.py:108-110);
- the population draws: chip_smoke.py `population_draws`
  (bench.py:174-178).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import constants as const

#: bounds of a 64-bit seed the draws accept: numpy's Generator takes any
#: non-negative integer
SEED_MODULUS = 2 ** 64


class GridArrays(NamedTuple):
    lam_cm: np.ndarray        # (W,) bin centres [cm]
    trapz_w: np.ndarray       # (W,) trapezoid weights [cm]
    pressures: np.ndarray     # (L,) BOA first [barye]
    pressures_bar: np.ndarray  # (L,) [bar]
    init_temps: np.ndarray    # (L,) T(P) [K]


def grid_arrays(grid: dict) -> GridArrays:
    """The static grids of a configuration's ``grid`` block."""
    lam_um = np.logspace(np.log10(grid["lam_min_um"]),
                         np.log10(grid["lam_max_um"]), grid["n_wl_bins"])
    p_bar = np.logspace(np.log10(grid["P_toa_bar"]),
                        np.log10(grid["P_boa_bar"]),
                        grid["n_layers"])[::-1].copy()
    T = grid["T_ref"] * (p_bar / grid["P_ref_bar"]) ** grid["alpha"]
    lam_cm = lam_um * const.MICRON_TO_CM
    dx = np.diff(lam_cm)
    w = np.zeros_like(lam_cm)
    w[0], w[-1] = dx[0] / 2, dx[-1] / 2
    w[1:-1] = (dx[:-1] + dx[1:]) / 2
    return GridArrays(lam_cm=lam_cm, trapz_w=w,
                      pressures=p_bar * const.BAR_TO_CGS,
                      pressures_bar=p_bar, init_temps=T)


def example_opacity(ga: GridArrays, seed: int, scale_factor: float):
    """The synthetic water-like fixture: ``(values (nT, nP, W), temps_K,
    press_bar)`` on the grid's own T(P) and pressure axes."""
    lam_um = ga.lam_cm / const.MICRON_TO_CM
    rng = np.random.RandomState(seed)  # legacy MT19937, as np.random.seed
    so = (np.exp(-0.5 * (lam_um - 6.0) ** 2 / 2.0 ** 2)
          + 0.8 * np.exp(-0.5 * (lam_um - 0.3) ** 2 / 0.5 ** 2))
    amps = rng.uniform(low=0.1, high=0.2, size=15)
    wls = rng.uniform(low=0.5, high=1.0, size=15)
    for amp, wl in zip(amps, wls):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.005 ** 2)
    for amp, wl in zip([0.22, 0.2, 0.18],
                       np.logspace(np.log10(1.4), np.log10(2.7), 3)):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.13 ** 2)
    profile = scale_factor * 10.0 ** (2.5 * (so - 0.4))
    temps, press = ga.init_temps, ga.pressures_bar
    values = np.broadcast_to(
        profile, (temps.shape[0], press.shape[0], lam_um.shape[0])).copy()
    return values, temps, press


def iso_mass_amu(isotopologue: str) -> float:
    """"1H2-16O" -> 18: the isotope numbers times their multiplicities."""
    mass = 0.0
    for element in isotopologue.split("-"):
        digits = "".join(ch if ch.isdigit() else " " for ch in element)
        nums = [float(x) for x in digits.split()]
        mass += nums[0] * (nums[1] if len(nums) > 1 else 1.0)
    return mass


def rayleigh(lam_cm, m_bar_g):
    """H2 + He Rayleigh scattering opacity [cm^2 / g]."""
    lam_um = lam_cm / const.MICRON_TO_CM
    n_h2 = 13.58e-5 * (1.0 + 7.52e-11 / lam_cm ** 2) + 1.0
    n_he = 1e-8 * (2283.0 + 1.8102e13 / (1.5342e10 - lam_um ** -2)) + 1.0

    def one(n, n_ref):
        lorentz = ((n ** 2 - 1.0) / (n ** 2 + 2.0)) ** 2
        return 24.0 * np.pi ** 3 / n_ref ** 2 / lam_cm ** 4 * lorentz / m_bar_g
    return one(n_h2, 2.68678e19) + one(n_he, 2.546899e19)


def planck_np(T, lam_cm):
    return (2.0 * const.h * const.c ** 2 / lam_cm ** 5
            / np.expm1(const.hc_over_k / (lam_cm * T)))


def f_toa(lam_cm, T_star, a_rstar, f=2.0 / 3.0):
    """Top-of-atmosphere stellar flux [erg / s / cm^3]; ``T_star`` and
    ``a_rstar`` scalars or (C, 1) columns."""
    return f / (2.0 * a_rstar ** 2) * planck_np(T_star, lam_cm)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream): the profiles, the
    populations and the samples checked each draw from their own."""
    return np.random.Generator(np.random.PCG64(
        [int(seed) % SEED_MODULUS, stream]))


def profiles(ga: GridArrays, rng, n_columns: int, lo: float, hi: float):
    """(C, L) initial profiles: the grid's T(P) times U(lo, hi) per
    column."""
    return ga.init_temps[None, :] * rng.uniform(lo, hi, (n_columns, 1))


class Population(NamedTuple):
    a_rstar: np.ndarray   # (C,)
    g_si: np.ndarray      # (C,) [m / s^2]
    T_star: np.ndarray    # (C,) [K]
    alpha: np.ndarray     # (C,)


def population(rng, n: int, draws: dict) -> Population:
    """``n`` planets, each parameter uniform between its configured
    bounds."""
    return Population(*(rng.uniform(*draws[k], n)
                        for k in Population._fields))
