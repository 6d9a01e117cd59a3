"""User-facing API: Planet, Grid, Spectrum, effective temperature.

Counterpart of ``frei_tpu.api`` (reference driver objects,
`frei/core.py`): constructors take plain floats in documented units
(or astropy Quantities), convert once to canonical CGS, and everything
past this module is unitless tensors on the grid's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import constants as const
from . import units
from .chemistry.fastchem import FastChemTorch
from .chemistry.mocks import MockChemistry
from .diag.telemetry import SolveMetrics
from .grids import RTGrid, make_rt_grid
from .opacity.etl import binned_opacity_stack
from .opacity.hotpath import build_kappa_model
from .opacity.rayleigh import rayleigh_total
from .opacity.tables import OpacityStack, make_opacity_stack
from .rt.physics import PhysicsParams
from .rt.solver import (RTConstants, RTResult, SolverConfig, solve_rc,
                        solve_rc_batched)
from .stellar.irradiation import f_toa_np

# np.trapz was renamed np.trapezoid in NumPy 2.0; support both
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

__all__ = ["Planet", "Grid", "Spectrum", "effective_temperature",
           "effective_temperature_milne", "effective_temperature_planck"]


def _np(x):
    return x.detach().cpu().numpy()


@dataclass
class Planet:
    """Planetary-system parameters (reference `core.py:65-106`).

    ``a_rstar``: semimajor axis over stellar radius; ``m_bar``: mean
    molecular weight (plain floats in proton masses); ``g``: surface
    gravity (plain floats in m / s^2); ``T_star`` [K]; ``alpha``: scale
    heights per mixing length.
    """

    a_rstar: float
    m_bar: float
    g: float
    T_star: float
    alpha: float = 1.0

    def __post_init__(self):
        self.a_rstar = float(self.a_rstar)
        self.m_bar = units.to_gram(self.m_bar)       # [g]
        self.g = units.to_cgs_gravity(self.g)        # [cm / s^2]
        self.T_star = units.to_kelvin(self.T_star)   # [K]
        self.alpha = float(self.alpha)

    @classmethod
    def from_hot_jupiter(cls) -> "Planet":
        """Standard hot Jupiter: a/R* for 0.03 AU around a Sun,
        m_bar = 2.4 m_p, g = g_Jup, T* = 5800 K (`core.py:92-106`)."""
        return cls(
            a_rstar=0.03 * const.au / const.R_sun,
            m_bar=2.4,
            g=const.g_jup / 100.0,  # to_cgs_gravity expects m/s^2
            T_star=5800.0,
            alpha=1.0,
        )

    def physics_params(self, n_dof: int = 5) -> PhysicsParams:
        return PhysicsParams(g=self.g, m_bar=self.m_bar,
                             alpha=self.alpha, n_dof=n_dof)


@dataclass(frozen=True)
class Spectrum:
    """Emission spectrum, duck-typing ``specutils.Spectrum1D``: bare
    numpy fields in canonical units, with astropy units attached by
    the properties when astropy is installed."""

    wavelength_um: np.ndarray   # (W,) [micron]
    flux_cgs: np.ndarray        # (W,) or (C, W) [erg / s / cm^3]

    @property
    def wavelength(self):
        return units.as_quantity(self.wavelength_um, "um")

    @property
    def spectral_axis(self):
        return units.as_quantity(self.wavelength_um, "um")

    @property
    def flux(self):
        return units.as_quantity(self.flux_cgs, "erg / (s cm3)")

    def to_spectrum1d(self):
        """An actual ``specutils.Spectrum1D`` (needs the optional
        specutils and astropy packages)."""
        from specutils import Spectrum1D
        return Spectrum1D(flux=self.flux, spectral_axis=self.spectral_axis)


class Grid:
    """Temperature / pressure / wavelength grid and solve driver
    (reference `core.py:109-338`), with the reference's defaults: 500
    wavelength bins in 0.5-10 um, 30 layers in 1e-6-200 bar, initial
    T(P) power law around T_ref = 2300 K at 0.1 bar.

    ``dtype`` and ``device`` say where and in what precision the solve
    runs.  The device is the card (``"cuda"``) unless the caller names
    another; without CUDA the default raises, and ``device="cpu"`` runs
    the solve on the CPU.
    """

    def __init__(
        self, planet: Planet,
        lam=None, pressures=None, init_temperatures=None,
        lam_min=0.5, lam_max=10.0, n_wl_bins=500,
        P_toa=1e-6, P_boa=200.0, n_layers=30,
        T_ref=2300.0, P_ref=0.1, alpha=0.1,
        dtype=torch.float32, device="cuda",
    ):
        self.planet = planet
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Grid: device {str(self.device)!r} but no CUDA device is "
                "available here; pass device=\"cpu\" to run on the CPU")
        self.rt_grid: RTGrid = make_rt_grid(
            lam_min_micron=units.to_micron(lam_min),
            lam_max_micron=units.to_micron(lam_max),
            n_wl_bins=n_wl_bins,
            P_toa_bar=units.to_bar(P_toa), P_boa_bar=units.to_bar(P_boa),
            n_layers=n_layers,
            T_ref=units.to_kelvin(T_ref), P_ref_bar=units.to_bar(P_ref),
            alpha=alpha,
            lam_micron=None if lam is None else units.to_micron(lam),
            pressures_bar=None if pressures is None
            else units.to_bar(pressures),
            init_temperatures=None if init_temperatures is None
            else units.to_kelvin(init_temperatures),
        )
        self.opacities: Optional[OpacityStack] = None
        self.chemistry = None
        self._kappa_fn = None
        self._consts = None

    # -- convenience views ------------------------------------------------
    @property
    def lam(self):
        """Wavelength bin centers [micron]."""
        return self.rt_grid.lam_micron

    @property
    def wl_bins(self):
        """Wavelength bin edges [micron]."""
        return self.rt_grid.wl_edges_cm / const.MICRON_TO_CM

    @property
    def R(self):
        return self.rt_grid.R

    @property
    def pressures(self):
        """Layer pressures, BOA first [bar]."""
        return self.rt_grid.pressures_bar

    @property
    def init_temperatures(self):
        return self.rt_grid.init_temperatures

    @property
    def lam_micron(self):
        return self.rt_grid.lam_micron

    @property
    def pressures_bar(self):
        return self.rt_grid.pressures_bar

    def __repr__(self):
        t = self.init_temperatures
        p = self.pressures
        lam = self.lam
        return (f"<Grid in T=[{t[0]:.0f}...{t[-1]:.0f}] K, "
                f"p=[{p[0]:.2g}...{p[-1]:.2g}] bar, "
                f"lam=[{lam[0]:.3g}...{lam[-1]:.3g}] um, "
                f"{self.dtype} on {self.device}>")

    def _tensor(self, x):
        if torch.is_tensor(x):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    # -- opacity / chemistry loading --------------------------------------
    def load_opacities(self, species=None, path=None, opacities=None,
                       chemistry=None, force_reload=False,
                       groupies=True, engine="auto"):
        """Attach binned opacities (reference `core.py:198-231`).

        ``opacities`` is an :class:`OpacityStack` or a dict of
        ``{isotopologue: (values, temps_K, press_bar)}`` arrays; it is
        moved to the grid's dtype and device.  When it is None (and no
        stack is attached yet) or ``force_reload`` is set, the tables are
        binned from the on-disk stores under ``path`` (default the user
        store directory), filtered by ``species``
        (``opacity.etl.binned_opacity_stack``).

        ``groupies`` selects the rebin semantics, as in the reference
        (`core.py:199` -> `opacity.py:66-170`): True for the grouped
        trapezoid-integral path (the semantics the published goldens are
        calibrated against), False for the exact per-bin average path
        (the reference's own default).  ``engine`` selects the rebin
        engine: "auto" (the threaded C++ host engine, else "eager"),
        "eager", "native" or "cuda" (the CUDA kernel, on the grid's
        device); see ``opacity.etl``.

        ``chemistry`` selects the mixing-ratio model: None or "mock" for
        the constant-VMR mock (the reference's fallback without
        pyfastchem, `chemistry.py:143-153`), "equilibrium" for the
        FastChem-equivalent solver in table mode
        (``chemistry.fastchem.FastChemTorch``: a 64 x 32 (T, P) table
        solved once here on the grid's device, read by interpolation;
        42 s on an H100), "equilibrium-exact" for
        the exact solver at every call, or any object with an
        ``mmr(temps, pressures_cgs)`` method.  None on a grid that
        already has a model keeps it (a reload must not downgrade the
        chemistry); "mock" resets it.
        """
        if (self.opacities is None and opacities is None) or force_reload:
            self.opacities = binned_opacity_stack(
                self.rt_grid, species=species, path=path, dtype=self.dtype,
                device=self.device, groupies=groupies, engine=engine)
        elif opacities is not None:
            if isinstance(opacities, OpacityStack):
                self.opacities = opacities.to(dtype=self.dtype,
                                              device=self.device)
            else:
                self.opacities = make_opacity_stack(
                    opacities, dtype=self.dtype, device=self.device)
        if chemistry is not None or self.chemistry is None:
            self.chemistry = chemistry
        self._build_solver_inputs()
        return self.opacities

    def _build_solver_inputs(self):
        stack = self.opacities
        if self.chemistry is None or self.chemistry == "mock":
            self.chemistry = MockChemistry(stack.masses_g, self.planet.m_bar)
        elif isinstance(self.chemistry, str):
            modes = {"equilibrium": "table", "equilibrium-exact": "exact"}
            if self.chemistry not in modes:
                raise ValueError(
                    f"unknown chemistry model {self.chemistry!r}")
            self.chemistry = FastChemTorch(stack.species, self.planet.m_bar,
                                           mode=modes[self.chemistry],
                                           build_device=self.device)
        g = self.rt_grid
        self._consts = RTConstants(
            lam_cm=self._tensor(g.lam_cm),
            trapz_w=self._tensor(g.trapz_w_cm),
            pressures=self._tensor(g.pressures_cgs),
            sigma_scat=self._tensor(rayleigh_total(g.lam_cm,
                                                   self.planet.m_bar)),
            F_toa=self._tensor(f_toa_np(g.lam_cm, self.planet.T_star,
                                        self.planet.a_rstar)),
        )
        self._kappa_fn = build_kappa_model(
            stack, self.chemistry, self._consts.pressures,
            self._consts.sigma_scat)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the solve ---------------------------------------------------------
    def emission_spectrum(self, n_timesteps=1, n_zero_crossings=2,
                          convergence_dT=3.0, associative=False,
                          progress=False):
        """Compute the emission spectrum (reference `core.py:233-338`).

        Returns ``(spec, final_temps (L,), temperature_history
        (L, n_recorded), dtaus (L, W))``, all numpy on the host.
        """
        if self.opacities is None:
            raise ValueError(
                "Must load opacities before computing emission spectrum.")
        cfg = SolverConfig(
            n_timesteps=int(n_timesteps),
            n_zero_crossings=int(n_zero_crossings),
            convergence_dT=units.to_kelvin(convergence_dT),
            associative=associative,
            progress=bool(progress),
        )
        t0 = time.perf_counter()
        result: RTResult = solve_rc(
            self._tensor(self.rt_grid.init_temperatures), self._consts,
            self.planet.physics_params(), self._kappa_fn, cfg)
        self._sync()
        self.last_result = result
        self.last_metrics = SolveMetrics.from_result(
            result, time.perf_counter() - t0)
        n_hist = int(result.n_history)
        spec = Spectrum(wavelength_um=np.asarray(self.lam),
                        flux_cgs=_np(result.flux))
        temp_hist = _np(result.temp_history)[:n_hist].T  # (L, cols)
        return (spec, _np(result.final_temps), temp_hist,
                _np(result.dtaus))

    def emission_spectra(self, init_temps, n_timesteps=1,
                         n_zero_crossings=2, convergence_dT=3.0,
                         associative=False, engine="auto",
                         init_fluxes=None):
        """Batched emission spectra for (C, L) initial profiles [K].

        ``engine`` is "auto", "eager", "cuda", "iteration" or "loop"
        (see ``rt.solver``); ``init_fluxes`` an optional ((C, L, W),
        (C, L, W)) warm-start pair.  Returns ``(spec with (C, W) flux,
        final_temps (C, L), temperature_history (C, L, n_recorded),
        dtaus (C, L, W))``; per-column results equal single-column
        solves.
        """
        if self.opacities is None:
            raise ValueError(
                "Must load opacities before computing emission spectra.")
        cfg = SolverConfig(
            n_timesteps=int(n_timesteps),
            n_zero_crossings=int(n_zero_crossings),
            convergence_dT=units.to_kelvin(convergence_dT),
            associative=associative,
            engine=engine,
        )
        if not torch.is_tensor(init_temps):
            init_temps = units.to_kelvin(init_temps)
        init_temps = self._tensor(init_temps)
        t0 = time.perf_counter()
        result: RTResult = solve_rc_batched(
            init_temps, self._consts, self.planet.physics_params(),
            self._kappa_fn, cfg, init_fluxes=init_fluxes)
        self._sync()
        self.last_result = result
        self.last_metrics = SolveMetrics.from_result(
            result, time.perf_counter() - t0,
            columns=init_temps.shape[0])
        n_hist = int(result.n_history.max())
        spec = Spectrum(wavelength_um=np.asarray(self.lam),
                        flux_cgs=_np(result.flux))
        temp_hist = np.swapaxes(_np(result.temp_history)[:, :n_hist, :],
                                1, 2)
        return (spec, _np(result.final_temps), temp_hist,
                _np(result.dtaus))


def effective_temperature_milne(grid: Grid, spec, dtaus, final_temps):
    """Photospheric temperature from the Milne tau = 2/3 condition
    (reference `core.py:386-405`), weighted by the lambda F_lambda flux."""
    dtaus = np.asarray(dtaus, dtype=np.float64)
    pressures = np.asarray(grid.pressures, dtype=np.float64)  # [bar]
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    flux = np.asarray(spec.flux_cgs, dtype=np.float64)

    pressure_milne = np.ones(dtaus.shape[1])
    for i in range(dtaus.shape[1]):
        pressure_milne[i] = np.interp(
            2.0 / 3.0, np.exp(-dtaus[:, i]), pressures)
    weights = flux * lam_cm
    avg_p = np.average(pressure_milne, weights=weights)
    final_temps = np.asarray(final_temps, dtype=np.float64)
    return np.interp(avg_p, pressures[::-1], final_temps[::-1])


def effective_temperature_planck(grid: Grid, spec):
    """Stefan-Boltzmann inversion of the bolometric emitted flux
    (reference `core.py:408-414`)."""
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    bol = _trapezoid(np.asarray(spec.flux_cgs, dtype=np.float64), lam_cm)
    return float((bol / const.sigma_sb) ** 0.25)


def effective_temperature(grid: Grid, spec, dtaus, final_temps):
    """Mean of the Milne and Planck estimates (reference
    `core.py:417-439`)."""
    return 0.5 * (
        effective_temperature_milne(grid, spec, dtaus, final_temps)
        + effective_temperature_planck(grid, spec))
