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

The seeded T- and P-dependent tables (``seeded_tp_opacity``) are the
benchmark's own fixture; nothing in the program or frei makes them.
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


#: features of each species the seeded fixture knows: (centre [um],
#: width [um], strength [dex over the species' continuum at T0], profile:
#: "g" Gaussian, "l" Lorentzian wings).  Assumed shapes at the species'
#: own wavelengths, not published data.
SEEDED_FEATURES = {
    "1H2-16O": ((0.94, 0.03, 1.5, "g"), (1.15, 0.04, 2.0, "g"),
                (1.4, 0.06, 2.6, "g"), (1.9, 0.08, 3.0, "g"),
                (2.7, 0.12, 3.5, "g"), (6.3, 0.5, 3.2, "g")),
    "23Na": ((0.5890, 0.002, 5.5, "l"), (0.5896, 0.002, 5.2, "l"),
             (0.8190, 0.002, 3.0, "l"), (1.1390, 0.003, 2.5, "l")),
    "39K": ((0.7665, 0.002, 5.5, "l"), (0.7699, 0.002, 5.2, "l"),
            (1.1720, 0.003, 2.5, "l"), (1.2480, 0.003, 2.5, "l")),
    "48Ti-16O": tuple((c, 0.035, s, "g") for c, s in (
        (0.45, 2.0), (0.50, 2.4), (0.55, 2.6), (0.59, 2.6), (0.63, 2.8),
        (0.67, 2.8), (0.71, 3.0), (0.77, 2.6), (0.84, 2.3), (0.89, 2.1),
        (0.95, 1.8))),
}
#: log10 of each species' continuum at T0 [cm^2 / g], assumed
SEEDED_CONTINUUM = {"1H2-16O": -1.5, "23Na": -3.0, "39K": -3.0,
                    "48Ti-16O": -2.0}
#: seeded lines a species adds on top of its features, assumed
SEEDED_LINES = {"1H2-16O": 60, "23Na": 6, "39K": 6, "48Ti-16O": 40}
#: the temperature at which the strengths are given [K], assumed
SEEDED_T0 = 2000.0
#: width of the wavelength bands whose mean the windows fill towards
#: with pressure [dex of wavelength], assumed
SEEDED_BAND_DEX = 0.05
#: the first random stream of the seeded tables: species i draws from
#: stream SEEDED_STREAM + i of the configuration's seed
SEEDED_STREAM = 100


def log_axis(spec: dict) -> np.ndarray:
    """``{"min", "max", "n"}``: ``n`` log-spaced points, ascending."""
    return np.logspace(np.log10(spec["min"]), np.log10(spec["max"]),
                       int(spec["n"]))


def _profile(lam_um, centre, width, kind):
    x = (lam_um - centre) / width
    return np.exp(-0.5 * x ** 2) if kind == "g" else 1.0 / (1.0 + x ** 2)


def _seeded_species(lam_um, band, name, rng, temps, press):
    """One species' (nT, nP, W) table: its continuum, features and lines,
    each scaled by its own Boltzmann factor exp(-E (1/T - 1/T0)), then
    each band's windows filled with pressure."""
    feats = [(None, None, 0.0, None)] + [
        (c, w, s + rng.normal(0.0, 0.2), k)
        for c, w, s, k in SEEDED_FEATURES[name]]
    lo, hi = min(f[0] for f in feats[1:]), max(f[0] for f in feats[1:])
    n = SEEDED_LINES[name]
    centres = rng.uniform(np.log(lo * 0.9), np.log(hi * 1.1), n)
    widths = rng.uniform(0.002, 0.006, n)
    strengths = rng.uniform(1.0, 3.0, n)
    feats += [(np.exp(c), np.exp(c) * w, s, "g")
              for c, w, s in zip(centres, widths, strengths)]
    energies = rng.uniform(1000.0, 6000.0, len(feats))     # E / k [K]
    inv = 1.0 / temps[:, None] - 1.0 / SEEDED_T0            # (nT, 1)
    kappa = np.zeros((temps.shape[0], lam_um.shape[0]))
    for (c, w, s, k), e in zip(feats, energies):
        shape = 1.0 if c is None else _profile(lam_um, c, w, k)
        kappa += 10.0 ** s * np.exp(-e * inv) * shape
    y = SEEDED_CONTINUUM[name] + np.log10(kappa)            # (nT, W)
    mean = np.zeros_like(y)
    for b in np.unique(band):
        sel = band == b
        mean[:, sel] = y[:, sel].mean(1, keepdims=True)
    p_s = 10.0 ** rng.uniform(-2.0, 1.0)                    # [bar]
    fill = (press / (press + p_s))[None, :, None]           # (1, nP, 1)
    return 10.0 ** ((1.0 - fill) * y[:, None] + fill * mean[:, None])


def seeded_tp_opacity(ga: GridArrays, species, seed: int, T_axis, P_axis):
    """Seeded T- and P-dependent tables of several species on shared
    axes: ``{iso: (values (nT, nP, W), temps_K, press_bar)}`` on the
    grid's own bins.  Physically plausible, not physical: each species
    has a continuum and bands at its own wavelengths
    (``SEEDED_FEATURES``: H2O near 0.94, 1.15, 1.4, 1.9, 2.7 and 6.3 um,
    the Na doublet at 0.589 um, K at 0.767 um, TiO in broad bands over
    0.4-1.0 um) with seeded lines on top; each term's strength scales by
    a Boltzmann factor exp(-E (1/T - 1/T0)) with E drawn from the seed;
    with pressure each band's windows fill, log10 kappa blended towards
    the band's mean (the wavelength axis cut into bands of
    ``SEEDED_BAND_DEX``) with the weight P / (P + P_s), P_s drawn from
    the seed.  Species i draws from its own stream of ``seed``, so that
    adding a species leaves the others' bytes unchanged.  Every level,
    width, count, T0 and the axes a configuration gives are assumed, not
    published."""
    unknown = [n for n in species if n not in SEEDED_FEATURES]
    if unknown:
        raise ValueError(f"no seeded features for {unknown} (known: "
                         f"{sorted(SEEDED_FEATURES)})")
    lam_um = ga.lam_cm / const.MICRON_TO_CM
    temps = np.asarray(T_axis, dtype=np.float64)
    press = np.asarray(P_axis, dtype=np.float64)
    band = np.floor((np.log10(lam_um) - np.log10(lam_um[0]))
                    / SEEDED_BAND_DEX)
    return {name: (_seeded_species(lam_um, band, name,
                                   rng_for(seed, SEEDED_STREAM + i), temps,
                                   press), temps, press)
            for i, name in enumerate(species)}


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
